// Backward of the GCL message aggregation (gcl_agg.cu), f32, for sm_90a.
//
// Replaces the Pallas TPU kernel `gcl_agg_bwd_pallas`
// (diffsbdd_tpu/ops/egnn_pallas_bwd.py:385).  Given g = dL/d(agg) it returns
// the cotangents of every differentiable operand of
//
//   agg_i = (1/nf) * sum_j adj_ij * att_ij * m2_ij,   att = sigmoid(m2 . w_att + b_att)
//
// without saving anything but the operands: each pair MLP is recomputed in the
// kernel.  Per pair, with g_i = g_i / nf:
//
//   dattz = (g_i . m2) * adj * att * (1 - att)         (0 without attention)
//   dm2   = g_i * adj * att + dattz * w_att
//   dw_att += m2 * dattz,   db_att += dattz
//
// then the MLP runs backwards (egnn_bwd.cuh), and the squared-distance
// cotangents chain to the coordinates: dx_i += 2 dd2 (x_i - x_j), dx_j -= the
// same, and likewise dx0 from dd20.  The adjacency is piecewise constant in
// x0, so it carries no gradient; pairs with adjacency 0 give exact zeros.
// Rows >= update_rows are not visited, and g there is ignored.
//
// What bounds it on an H100: three F x F products per active pair (forward
// recompute, dW2, dm1), 6*F^2 f32 operations against ~1 KB of projections --
// bound by operations.
//
// Design: see egnn_bwd.cuh -- the forward's tiling, per-block slabs of global
// scratch plus a second summing kernel for everything that crosses row tiles
// (da_col, column-side dx/dx0, all weight cotangents), no atomics, so the
// result is deterministic.  da_row is written by the block that owns the rows.
#include "egnn_bwd.cuh"

namespace {

using namespace egnn;

struct GclBwdArgs {
  PairMlp mlp;            // head = w_att, null when attention is off
  const float* b_att;     // (1) or null
  const float* w2t;       // (F, F) transpose of w2
  const float* g;         // (B, N, F) cotangent of the aggregate
  const float* x;         // (B, N, 3)
  const float* x0;        // (B, N, 3)
  const float* mask;      // (B, N)
  const float* col_mask;  // (B, N)
  const float* is_lig;    // (B, N)
  Cutoffs cut;
  float inv_nf;
  int N, update_rows;
  int tiles;              // row tiles below update_rows
  float* da_row;          // (B, N, F), zero-initialised; live rows written here
  float* acol_part;       // (B, Q, N, F) zero-initialised slabs
  float* dx_part;         // (B, Q, N, 6) zero-initialised slabs [dx, dx0]
  float* w_part;          // (B, Q, weight_slab) zero-initialised slabs
};

template <int F>
__global__ void __launch_bounds__(NT) gcl_agg_bwd_kernel(GclBwdArgs g) {
  constexpr int NC = F / 32;
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                  // P * F
  float* D = S + P * F;                             // P * F
  float* Ws = D + P * F;                            // KC * F
  int* cols = reinterpret_cast<int*>(Ws + KC * F);  // N
  __shared__ Rows rows;
  __shared__ Chunk chunk;
  __shared__ PairD2 dd;
  __shared__ float rowc[P][6], colc[P][6];
  __shared__ float warp_dbatt[NT / 32];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int Q = gridDim.x;
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const size_t slab = (size_t)blockIdx.y * Q + blockIdx.x;
  const bool attention = g.mlp.head != nullptr;
  const float b_att = attention ? g.b_att[0] : 0.0f;
  const MlpBwd mb{g.w2t, g.w_part + slab * weight_slab(F),
                  g.acol_part + slab * (size_t)g.N * F};
  float* dx_part = g.dx_part + slab * (size_t)g.N * 6;

  FeatAcc fa{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float dbatt = 0.0f;  // the warp's sum, the same in every lane

  for (int tile = blockIdx.x; tile < g.tiles; tile += Q) {
    const int i0 = tile * TI;
    __syncthreads();  // the previous tile's rows are no longer read
    load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
    __syncthreads();
    const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                      g.cut, cols);
    float arow[TI];
#pragma unroll
    for (int r = 0; r < TI; ++r) arow[r] = 0.0f;

    for (int c0 = 0; c0 < count; c0 += TJ) {
      fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
                 c0, g.cut);
      if (t < P) { dd.dd2[t] = 0.0f; dd.dd20[t] = 0.0f; }
      __syncthreads();

      auto epi = [&](int p, const float (&m2)[NC], float (&dm2)[NC]) -> float {
        const float* gi = g.g + (node0 + i0 + p / TJ) * F;
        float gv[NC], wa[NC], pa = 0.0f, pg = 0.0f;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          gv[n] = gi[lane + 32 * n] * g.inv_nf;
          wa[n] = attention ? g.mlp.head[lane + 32 * n] : 0.0f;
          pa = fmaf(m2[n], wa[n], pa);
          pg = fmaf(gv[n], m2[n], pg);
        }
        const float adj = chunk.adj[p];
        float att = 1.0f, dattz = 0.0f;
        if (attention) {
          att = sigmoidf_(warp_sum(pa) + b_att);
          dattz = warp_sum(pg) * adj * att * (1.0f - att);
          dbatt += dattz;
        }
        const float gate = adj * att;
#pragma unroll
        for (int n = 0; n < NC; ++n) dm2[n] = fmaf(gv[n], gate, dattz * wa[n]);
        return dattz;
      };
      mlp_backward<F>(g.mlp, mb, chunk, cols, count, c0, node0, i0, S, D, Ws, dd, fa,
                      arow, epi);

      // ---- squared-distance cotangents -> coordinates
      if (t < P) {
        const int j = chunk.j[t], k = t / TJ;
        for (int a = 0; a < 6; ++a) { rowc[t][a] = 0.0f; colc[t][a] = 0.0f; }
        if (j >= 0) {
          const float* xj = g.x + (node0 + j) * 3;
          const float* x0j = g.x0 + (node0 + j) * 3;
          for (int a = 0; a < 3; ++a) {
            const float v = 2.0f * dd.dd2[t] * (rows.x[k][a] - xj[a]);
            const float v0 = 2.0f * dd.dd20[t] * (rows.x0[k][a] - x0j[a]);
            rowc[t][a] = v; colc[t][a] = -v;
            rowc[t][3 + a] = v0; colc[t][3 + a] = -v0;
          }
        }
      }
      __syncthreads();
      scatter_dx(rowc, colc, cols, count, c0, i0, g.N, dx_part);
    }

    if (t < F) {
      for (int r = 0; r < TI; ++r) {
        const int i = i0 + r;
        if (i < g.N && i < g.update_rows) g.da_row[(node0 + i) * F + t] = arow[r];
      }
    }
  }

  store_feat_acc<F>(fa, mb.w_part);
  if (lane == 0) warp_dbatt[warp] = dbatt;
  __syncthreads();
  if (t == 0) {
    float s = 0.0f;
    for (int w = 0; w < NT / 32; ++w) s += warp_dbatt[w];
    mb.w_part[(size_t)F * F + 5 * F] = s;
  }
}

template <int F>
int launch(const GclBwdArgs& g, int B, int Q, float* da_col, float* dxx0, float* w_out,
           cudaStream_t stream) {
  const size_t smem = dynamic_smem_bwd<F>(g.N);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_agg_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gcl_agg_bwd_kernel<F><<<dim3(Q, B), NT, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials(g.acol_part, da_col, B, Q, (size_t)g.N * F, stream);
  reduce_partials(g.dx_part, dxx0, B, Q, (size_t)g.N * 6, stream);
  reduce_partials(g.w_part, w_out, 1, B * Q, weight_slab(F), stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Q: blocks per batch element (1 <= Q <= row tiles below update_rows).  The
// *_part buffers and da_row must be zero on entry; da_col (B, N, F), dxx0
// (B, N, 6) and w_out (weight_slab) are written in full.
extern "C" int gcl_agg_backward(
    const float* g_out, const float* a_row, const float* a_col, const float* x,
    const float* x0, const float* mask, const float* col_mask, const float* is_lig,
    const float* w_d2, const float* w_d20, const float* delta, const float* w2,
    const float* w2t, const float* b2, const float* w_att, const float* b_att,
    float cut_ll, float cut_pp, float cut_lp, float nf,
    int B, int N, int F, int update_rows, int Q,
    float* da_row, float* acol_part, float* dx_part, float* w_part,
    float* da_col, float* dxx0, float* w_out, void* stream) {
  const int rows = update_rows < N ? update_rows : N;
  const int tiles = (rows + TI - 1) / TI;
  if (Q < 1 || Q > (tiles > 0 ? tiles : 1)) return (int)cudaErrorInvalidValue;
  GclBwdArgs g{PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w_att}, b_att, w2t,
               g_out, x, x0, mask, col_mask, is_lig, Cutoffs{cut_ll, cut_pp, cut_lp},
               1.0f / nf, N, update_rows, tiles, da_row, acol_part, dx_part, w_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 64: return launch<64>(g, B, Q, da_col, dxx0, w_out, s);
    case 256: return launch<256>(g, B, Q, da_col, dxx0, w_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
