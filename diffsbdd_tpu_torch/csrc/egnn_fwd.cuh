// The two forward row-tile bodies, shared by the split kernels (gcl_agg.cu,
// coord_agg.cu) and the whole-block kernel (block_fused.cu); f32, for sm_90a.
//
// gcl_tile:   agg_i = (1/nf) * sum_j adj_ij * gate_ij * m_ij for the TI rows
//             of one tile, written to a TI x F destination (global or shared);
// coord_tile: dx_i of the TI rows of one tile, written to the (B, N, 3) output.
//
// Both run on the tiling of egnn_common.cuh: the block owns its rows, visits
// only the compacted active columns, and sums each row in a fixed order, so
// the results need no atomics and are deterministic.
#pragma once
#include "egnn_common.cuh"

namespace egnn {

struct GclArgs {
  PairMlp mlp;            // head = w_att, null when attention is off
  const float* b_att;     // (1) or null when attention is off
  const float* x;         // (B, N, 3) current coordinates
  const float* x0;        // (B, N, 3) EGNN input coordinates
  const float* mask;      // (B, N) row validity
  const float* col_mask;  // (B, N) column validity
  const float* is_lig;    // (B, N)
  Cutoffs cut;
  float nf;               // normalization factor
  int N;
  int update_rows;        // rows >= update_rows have no edges: zeros
  float* out;             // (B, N, F), the split kernel's output
};

// Aggregated messages of rows i0 .. i0+TI-1 of the batch item at node0 ->
// dst[r * F + n] for r < dst_rows.  S (P*F floats), Ws (KC*F) and cols (N
// ints) are shared-memory scratch.  Ends with a block sync.
template <int F>
__device__ void gcl_tile(const GclArgs& g, size_t node0, int i0, float* S, float* Ws,
                         int* cols, float* dst, int dst_rows) {
  constexpr int NC = F / 32;  // output features per lane
  __shared__ Rows rows;
  __shared__ Chunk chunk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool attention = g.mlp.head != nullptr;

  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);

  const float b_att = attention ? g.b_att[0] : 0.0f;
  float b2c[NC], wattc[NC], msum[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    b2c[n] = g.mlp.b2[lane + 32 * n];
    wattc[n] = attention ? g.mlp.head[lane + 32 * n] : 0.0f;
    msum[n] = 0.0f;
  }

  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
               c0, g.cut);
    __syncthreads();
    float acc[PPW][NC];
    pair_product<F>(g.mlp, chunk, node0, i0, S, Ws, acc);

    // ---- epilogue: silu, attention gate, gated row sum
#pragma unroll
    for (int r = 0; r < PPW; ++r) {
      float part = 0.0f;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[r][n] = siluf_(acc[r][n] + b2c[n]);
        part = fmaf(acc[r][n], wattc[n], part);
      }
      float gate = chunk.adj[warp * PPW + r];
      if (attention) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        gate *= sigmoidf_(part + b_att);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) msum[n] = fmaf(gate, acc[r][n], msum[n]);
    }
    __syncthreads();  // the chunk and S are rewritten by the next chunk
  }

  // ---- combine the warps of each row and write the tile
  float* red = S;  // (NT/32) * F
#pragma unroll
  for (int n = 0; n < NC; ++n) red[warp * F + lane + 32 * n] = msum[n];
  __syncthreads();
  constexpr int WPR = TJ / PPW;  // warps per row
  for (int e = t; e < TI * F; e += NT) {
    int r = e / F, n = e % F;
    if (r >= dst_rows) continue;
    float v = 0.0f;
    for (int w = 0; w < WPR; ++w) v += red[(r * WPR + w) * F + n];
    dst[r * F + n] = v / g.nf;
  }
  __syncthreads();  // red (S) and the rows are rewritten by the next tile
}

struct CoordArgs {
  PairMlp coord, cross;    // head = w3; cross.a_row == null: reflection-equivariant
  const float* x;          // (B, N, 3)
  const float* x0;         // (B, N, 3)
  const float* mask;       // (B, N)
  const float* is_lig;     // (B, N)
  const float* graph_mean; // (B, 3) or null
  int use_tanh;
  float coords_range, norm_constant, nf;
  Cutoffs cut;
  int N, update_rows;
  float* out;              // (B, N, 3)
};

// silu(silu(pre) @ W2 + b2) . head for the chunk's P pairs -> phi[p].
template <int F>
__device__ void mlp_head(const PairMlp& m, const Chunk& c, size_t node0, int i0,
                         float* S, float* Ws, float* phi) {
  constexpr int NC = F / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[PPW][NC];
  pair_product<F>(m, c, node0, i0, S, Ws, acc);
#pragma unroll
  for (int r = 0; r < PPW; ++r) {
    float part = 0.0f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      int k = lane + 32 * n;
      part = fmaf(siluf_(acc[r][n] + m.b2[k]), m.head[k], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) phi[warp * PPW + r] = part;
  }
  __syncthreads();
}

// Coordinate update of rows i0 .. i0+TI-1 of batch item `batch` -> g.out.
template <int F>
__device__ void coord_tile(const CoordArgs& g, int batch, int i0, float* S, float* Ws,
                           int* cols) {
  __shared__ Rows rows;
  __shared__ Chunk chunk;
  __shared__ float phi[P], phic[P], trans[P][3], mean[3];

  const int t = threadIdx.x;
  const size_t node0 = (size_t)batch * g.N;
  const bool has_cross = g.cross.a_row != nullptr;

  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (t < 3) mean[t] = has_cross ? g.graph_mean[batch * 3 + t] : 0.0f;
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.mask, g.is_lig, node0, g.N,
                                    g.cut, cols);

  float racc = 0.0f;  // row sum of component (t % 3) of row t / 3, t < 3*TI
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    mlp_head<F>(g.coord, chunk, node0, i0, S, Ws, phi);
    if (has_cross) mlp_head<F>(g.cross, chunk, node0, i0, S, Ws, phic);

    if (t < P) {
      const int k = t / TJ, j = chunk.j[t];
      float tr[3] = {0.0f, 0.0f, 0.0f};
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        float ph = phi[t];
        if (g.use_tanh) ph = tanhf(ph) * g.coords_range;
        float norm = sqrtf(chunk.d2[t] + 1e-8f) + g.norm_constant;
        float w = ph / norm * chunk.adj[t];
        for (int a = 0; a < 3; ++a) tr[a] = w * (rows.x[k][a] - xj[a]);
        if (has_cross) {
          float phc = phic[t];
          if (g.use_tanh) phc = tanhf(phc) * g.coords_range;
          float xi0 = rows.x[k][0] - mean[0], xi1 = rows.x[k][1] - mean[1],
                xi2 = rows.x[k][2] - mean[2];
          float xj0 = xj[0] - mean[0], xj1 = xj[1] - mean[1], xj2 = xj[2] - mean[2];
          float cx = xi1 * xj2 - xi2 * xj1;
          float cy = xi2 * xj0 - xi0 * xj2;
          float cz = xi0 * xj1 - xi1 * xj0;
          float cnorm = sqrtf(cx * cx + cy * cy + cz * cz + 1e-8f) + g.norm_constant;
          float wc = phc / cnorm * chunk.adj[t];
          tr[0] += wc * cx; tr[1] += wc * cy; tr[2] += wc * cz;
        }
      }
      for (int a = 0; a < 3; ++a) trans[t][a] = tr[a];
    }
    __syncthreads();
    if (t < 3 * TI) {
      const int k = t / 3, a = t % 3;
      for (int jj = 0; jj < TJ; ++jj) racc += trans[k * TJ + jj][a];
    }
    __syncthreads();  // the chunk and phi are rewritten by the next chunk
  }

  if (t < 3 * TI) {
    const int i = i0 + t / 3;
    if (i < g.N) g.out[(node0 + i) * 3 + t % 3] = racc / g.nf;
  }
}

}  // namespace egnn
