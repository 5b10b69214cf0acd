// GCL message aggregation for one EGNN layer, f32, for sm_90a.
//
// Replaces the Pallas TPU kernels `gcl_message_agg_pallas` and its compact-skip
// launch `_gcl_agg_pallas_compact` (diffsbdd_tpu/ops/egnn_pallas.py:589, :511).
// For every row node i it computes
//
//   agg_i = (1/nf) * sum_j adj_ij * gate_ij * m_ij
//   m_ij  = silu(silu(a_row_i + a_col_j + d2_ij*w_d2 + d20_ij*w_d20
//                     [+ lig_i*lig_j*delta]) @ W2 + b2)
//   gate  = sigmoid(m_ij . w_att + b_att)   (1 without attention)
//
// with d2 from the current coordinates x, and d20 and the adjacency (masks,
// per-pair-type distance cutoffs, self-edges kept) from the EGNN input
// coordinates x0.  The (B, N, N, F) message tensor never exists in memory.
//
// What bounds it on an H100: the per-pair F x F product.  At F = 256 that is
// 2*F^2 = 131k f32 operations per active pair against ~1 KB of row/column
// projections, so the kernel is bound by operations, not bytes.
//
// Design (simple and exact first), on the tiling of egnn_common.cuh:
// * one block per (batch, tile of TI rows below update_rows); the block owns
//   its rows, so the row sums need no atomics and are deterministic;
// * only the compacted active columns are visited -- inactive pairs cost
//   nothing, which replaces the TPU kernels' block-activity bits and
//   prefetched index lists;
// * the epilogue applies silu and the attention gate (a warp shuffle dot) and
//   keeps each thread's running row sums in registers across chunks;
// * f32 FMAs on the CUDA cores.  TF32/bf16 tensor-core tiers are later work.
#include "egnn_common.cuh"

namespace {

using namespace egnn;

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
  int update_rows;        // rows >= update_rows are written as zeros
  float* out;             // (B, N, F)
};

template <int F>
__global__ void __launch_bounds__(NT) gcl_agg_kernel(GclArgs g) {
  constexpr int NC = F / 32;  // output features per lane
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                  // P * F, then the row sums
  float* Ws = S + P * F;                            // KC * F
  int* cols = reinterpret_cast<int*>(Ws + KC * F);  // N
  __shared__ Rows rows;
  __shared__ Chunk chunk;

  const int i0 = blockIdx.x * TI;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t node0 = (size_t)blockIdx.y * g.N;
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
    int r = e / F, n = e % F, i = i0 + r;
    if (i >= g.N) continue;
    float v = 0.0f;
    for (int w = 0; w < WPR; ++w) v += red[(r * WPR + w) * F + n];
    g.out[(node0 + i) * F + n] = v / g.nf;
  }
  zero_rows_past_grid(g.out, node0, g.N, F);
}

template <int F>
int launch(const GclArgs& g, int B, cudaStream_t stream) {
  const size_t smem = dynamic_smem<F>(g.N);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_agg_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gcl_agg_kernel<F><<<row_tile_grid(g.N, g.update_rows, B), NT, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcl_agg_forward(
    const float* a_row, const float* a_col, const float* x, const float* x0,
    const float* mask, const float* col_mask, const float* is_lig,
    const float* w_d2, const float* w_d20, const float* delta,
    const float* w2, const float* b2, const float* w_att, const float* b_att,
    float cut_ll, float cut_pp, float cut_lp, float nf,
    int B, int N, int F, int update_rows, float* out, void* stream) {
  GclArgs g{PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w_att}, b_att,
            x, x0, mask, col_mask, is_lig, Cutoffs{cut_ll, cut_pp, cut_lp}, nf,
            N, update_rows, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 64: return launch<64>(g, B, s);
    case 256: return launch<256>(g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
