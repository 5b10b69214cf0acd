// Backward of the equivariant coordinate update aggregation (coord_agg.cu),
// f32, for sm_90a.
//
// Replaces the Pallas TPU kernel `coord_agg_bwd_pallas`
// (diffsbdd_tpu/ops/egnn_pallas_bwd.py:908).  Given g = dL/d(out) (B, N, 3) it
// returns the cotangents of every differentiable operand of
//
//   out_i = (1/nf) * sum_j adj_ij * [ (x_i - x_j) * phi_ij / norm_ij
//                                   + c_ij * phic_ij / cnorm_ij ]
//   phi   = tanh(m2 . w3) * coords_range  (tanh optional),   norm = sqrt(d2 + 1e-8) + nc
//   c_ij  = (x_i - mean) x (x_j - mean),  cnorm = sqrt(|c|^2 + 1e-8) + nc   (optional)
//
// for the coordinate MLP and, when present, the cross-product MLP (its own
// first layer and W2; the two heads come back separately, and the caller adds
// them where they are tied).  Per pair, with g_i = g_i / nf and q = adj / norm:
//
//   dw = g_i . (x_i - x_j)     draw = dw * q * (1 - tanh^2) * coords_range
//   dm2 = draw * w3            dw3 += m2 * draw
//   dd2 = -(phi q / norm) * dw * 0.5 / sqrt(d2 + 1e-8) + (MLP terms)
//   dx_i += g_i * phi q + 2 dd2 (x_i - x_j),   dx_j -= the same
//
// and for the cross branch, with u = x_i - mean, v = x_j - mean, qc = adj / cnorm:
//
//   dwc = g_i . c      dc = phic qc g_i - (phic qc / cnorm) dwc c / sqrt(|c|^2 + 1e-8)
//   dx_i += v x dc,    dx_j += dc x u,    dmean -= (v x dc + dc x u)
//
// The +1e-8 guards keep the diagonal (x_i = x_j, c = 0) finite: there dw and
// dwc are zero and every term above is an exact zero or cancels in the sum.
// Pairs with adjacency 0 give exact zeros; rows >= update_rows are not
// visited, and g there is ignored.
//
// What bounds it on an H100: three F x F products per active pair and MLP,
// 2 * 6*F^2 f32 operations with the cross branch -- bound by operations.
//
// Design: see egnn_bwd.cuh.  The two MLPs run one after the other on the same
// shared-memory tiles; everything that crosses row tiles (da_col of both MLPs,
// dx/dx0, dmean, the weight cotangents) goes through per-block slabs and the
// summing kernel, without atomics, so the result is deterministic.
#include "egnn_bwd.cuh"

namespace {

using namespace egnn;

struct CoordBwdArgs {
  PairMlp coord, cross;    // head = w3; cross.a_row == null: reflection-equivariant
  const float* w2t;        // (F, F) transpose of coord.w2
  const float* cw2t;       // (F, F) transpose of cross.w2, or null
  const float* g;          // (B, N, 3) cotangent of the output
  const float* x;          // (B, N, 3)
  const float* x0;         // (B, N, 3)
  const float* mask;       // (B, N)
  const float* is_lig;     // (B, N)
  const float* graph_mean; // (B, 3) or null
  int use_tanh;
  float coords_range, norm_constant, inv_nf;
  Cutoffs cut;
  int N, update_rows, tiles;
  float* da_row;           // (B, N, F) zero-initialised
  float* dc_row;           // (B, N, F) zero-initialised, or null
  float* acol_part;        // (B, Q, N, F)
  float* ccol_part;        // (B, Q, N, F) or null
  float* dx_part;          // (B, Q, N, 6)
  float* mean_part;        // (B, Q, 3) or null
  float* w_part;           // (B, Q, weight_slab)
  float* cw_part;          // (B, Q, weight_slab) or null
};

// Per-pair geometry of the chunk that the epilogues and the final stage share.
struct PairGeo {
  float q[P], dw[P];    // adj / norm, g_i . (x_i - x_j)
  float qc[P], dwc[P];  // adj / cnorm, g_i . c
  float phi[P], phic[P];
};

template <int F>
__global__ void __launch_bounds__(NT) coord_agg_bwd_kernel(CoordBwdArgs g) {
  constexpr int NC = F / 32;
  extern __shared__ __align__(16) float smem[];
  float* S = smem;
  float* D = S + P * F;
  float* Ws = D + P * F;
  int* cols = reinterpret_cast<int*>(Ws + KC * F);
  __shared__ Rows rows;
  __shared__ Chunk chunk;
  __shared__ PairD2 dd;
  __shared__ PairGeo geo;
  __shared__ float rowc[P][6], colc[P][6], meanc[P][3];
  __shared__ float grow[TI][3], mean[3];

  const int t = threadIdx.x, lane = t & 31;
  const int Q = gridDim.x;
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const size_t slab = (size_t)blockIdx.y * Q + blockIdx.x;
  const bool has_cross = g.cross.a_row != nullptr;
  const float nc = g.norm_constant;
  const MlpBwd mb{g.w2t, g.w_part + slab * weight_slab(F),
                  g.acol_part + slab * (size_t)g.N * F};
  const MlpBwd cmb{g.cw2t, has_cross ? g.cw_part + slab * weight_slab(F) : nullptr,
                   has_cross ? g.ccol_part + slab * (size_t)g.N * F : nullptr};
  float* dx_part = g.dx_part + slab * (size_t)g.N * 6;

  FeatAcc fa{0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, cfa{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float dmean = 0.0f;  // thread t < 3: component t
  if (t < 3) mean[t] = has_cross ? g.graph_mean[blockIdx.y * 3 + t] : 0.0f;

  for (int tile = blockIdx.x; tile < g.tiles; tile += Q) {
    const int i0 = tile * TI;
    __syncthreads();  // the previous tile's rows are no longer read
    load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
    if (t < TI * 3) {
      const int i = i0 + t / 3;
      const bool live = i < g.N && i < g.update_rows;
      grow[t / 3][t % 3] = live ? g.g[(node0 + i) * 3 + t % 3] * g.inv_nf : 0.0f;
    }
    __syncthreads();
    const int count = compact_columns(rows, g.x0, g.mask, g.is_lig, node0, g.N,
                                      g.cut, cols);
    float arow[TI], crow[TI];
#pragma unroll
    for (int r = 0; r < TI; ++r) { arow[r] = 0.0f; crow[r] = 0.0f; }

    for (int c0 = 0; c0 < count; c0 += TJ) {
      fill_chunk(chunk, rows, g.x, g.x0, g.mask, g.is_lig, node0, cols, count, c0,
                 g.cut);
      __syncthreads();
      // ---- pair geometry
      if (t < P) {
        const int j = chunk.j[t], k = t / TJ;
        float q = 0.0f, dw = 0.0f, qc = 0.0f, dwc = 0.0f;
        if (j >= 0) {
          const float* xj = g.x + (node0 + j) * 3;
          q = chunk.adj[t] / (sqrtf(chunk.d2[t] + 1e-8f) + nc);
          for (int a = 0; a < 3; ++a) dw = fmaf(grow[k][a], rows.x[k][a] - xj[a], dw);
          if (has_cross) {
            const float u0 = rows.x[k][0] - mean[0], u1 = rows.x[k][1] - mean[1],
                        u2 = rows.x[k][2] - mean[2];
            const float v0 = xj[0] - mean[0], v1 = xj[1] - mean[1], v2 = xj[2] - mean[2];
            const float cx = u1 * v2 - u2 * v1, cy = u2 * v0 - u0 * v2,
                        cz = u0 * v1 - u1 * v0;
            qc = chunk.adj[t] / (sqrtf(cx * cx + cy * cy + cz * cz + 1e-8f) + nc);
            dwc = grow[k][0] * cx + grow[k][1] * cy + grow[k][2] * cz;
          }
        }
        geo.q[t] = q; geo.dw[t] = dw; geo.qc[t] = qc; geo.dwc[t] = dwc;
        geo.phi[t] = 0.0f; geo.phic[t] = 0.0f;
        dd.dd2[t] = 0.0f; dd.dd20[t] = 0.0f;
      }
      __syncthreads();

      // dm2 = draw * w3 for the head value raw = m2 . w3 of a pair whose
      // output weight has the cotangent dphi
      auto head_epi = [&](const PairMlp& m, float dphi, float* phi_out, int p,
                          const float (&m2)[NC], float (&dm2)[NC]) -> float {
        float w3[NC], raw = 0.0f;
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          w3[n] = m.head[lane + 32 * n];
          raw = fmaf(m2[n], w3[n], raw);
        }
        raw = warp_sum(raw);
        float phi = raw, draw = dphi;
        if (g.use_tanh) {
          const float th = tanhf(raw);
          phi = th * g.coords_range;
          draw = dphi * (1.0f - th * th) * g.coords_range;
        }
        if (lane == 0) phi_out[p] = phi;
#pragma unroll
        for (int n = 0; n < NC; ++n) dm2[n] = draw * w3[n];
        return draw;
      };

      mlp_backward<F>(g.coord, mb, chunk, cols, count, c0, node0, i0, S, D, Ws, dd, fa,
                      arow,
                      [&](int p, const float (&m2)[NC], float (&dm2)[NC]) -> float {
                        return head_epi(g.coord, geo.dw[p] * geo.q[p], geo.phi, p, m2,
                                        dm2);
                      });
      if (has_cross)
        mlp_backward<F>(g.cross, cmb, chunk, cols, count, c0, node0, i0, S, D, Ws, dd,
                        cfa, crow,
                        [&](int p, const float (&m2)[NC], float (&dm2)[NC]) -> float {
                          return head_epi(g.cross, geo.dwc[p] * geo.qc[p], geo.phic, p,
                                          m2, dm2);
                        });

      // ---- per-pair coordinate cotangents
      if (t < P) {
        const int j = chunk.j[t], k = t / TJ;
        for (int a = 0; a < 6; ++a) { rowc[t][a] = 0.0f; colc[t][a] = 0.0f; }
        for (int a = 0; a < 3; ++a) meanc[t][a] = 0.0f;
        if (j >= 0) {
          const float* xj = g.x + (node0 + j) * 3;
          const float* x0j = g.x0 + (node0 + j) * 3;
          const float sq = sqrtf(chunk.d2[t] + 1e-8f), norm = sq + nc;
          const float w = geo.phi[t] * geo.q[t];
          const float dd2 = dd.dd2[t] - (w / norm) * geo.dw[t] * (0.5f / sq);
          for (int a = 0; a < 3; ++a) {
            const float v = grow[k][a] * w + 2.0f * dd2 * (rows.x[k][a] - xj[a]);
            const float v0 = 2.0f * dd.dd20[t] * (rows.x0[k][a] - x0j[a]);
            rowc[t][a] = v; colc[t][a] = -v;
            rowc[t][3 + a] = v0; colc[t][3 + a] = -v0;
          }
          if (has_cross) {
            const float u[3] = {rows.x[k][0] - mean[0], rows.x[k][1] - mean[1],
                                rows.x[k][2] - mean[2]};
            const float v[3] = {xj[0] - mean[0], xj[1] - mean[1], xj[2] - mean[2]};
            const float c[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                                u[0] * v[1] - u[1] * v[0]};
            const float cn = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-8f);
            const float cnorm = cn + nc;
            const float wc = geo.phic[t] * geo.qc[t];
            const float dcnorm = -(wc / cnorm) * geo.dwc[t];
            float dc[3];
            for (int a = 0; a < 3; ++a) dc[a] = wc * grow[k][a] + dcnorm * c[a] / cn;
            const float du[3] = {v[1] * dc[2] - v[2] * dc[1], v[2] * dc[0] - v[0] * dc[2],
                                 v[0] * dc[1] - v[1] * dc[0]};
            const float dv[3] = {dc[1] * u[2] - dc[2] * u[1], dc[2] * u[0] - dc[0] * u[2],
                                 dc[0] * u[1] - dc[1] * u[0]};
            for (int a = 0; a < 3; ++a) {
              rowc[t][a] += du[a];
              colc[t][a] += dv[a];
              meanc[t][a] = -(du[a] + dv[a]);
            }
          }
        }
      }
      __syncthreads();
      if (t < 3 && has_cross)
        for (int p = 0; p < P; ++p) dmean += meanc[p][t];
      scatter_dx(rowc, colc, cols, count, c0, i0, g.N, dx_part);
    }

    if (t < F) {
      for (int r = 0; r < TI; ++r) {
        const int i = i0 + r;
        if (i < g.N && i < g.update_rows) {
          g.da_row[(node0 + i) * F + t] = arow[r];
          if (has_cross) g.dc_row[(node0 + i) * F + t] = crow[r];
        }
      }
    }
  }

  store_feat_acc<F>(fa, mb.w_part);
  if (has_cross) {
    store_feat_acc<F>(cfa, cmb.w_part);
    if (t < 3) g.mean_part[slab * 3 + t] = dmean;
  }
}

template <int F>
int launch(const CoordBwdArgs& g, int B, int Q, float* da_col, float* dc_col,
           float* dxx0, float* dmean, float* w_out, float* cw_out, cudaStream_t stream) {
  const size_t smem = dynamic_smem_bwd<F>(g.N);
  cudaError_t err = cudaFuncSetAttribute(
      coord_agg_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coord_agg_bwd_kernel<F><<<dim3(Q, B), NT, smem, stream>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials(g.acol_part, da_col, B, Q, (size_t)g.N * F, stream);
  reduce_partials(g.dx_part, dxx0, B, Q, (size_t)g.N * 6, stream);
  reduce_partials(g.w_part, w_out, 1, B * Q, weight_slab(F), stream);
  if (g.cross.a_row != nullptr) {
    reduce_partials(g.ccol_part, dc_col, B, Q, (size_t)g.N * F, stream);
    reduce_partials(g.cw_part, cw_out, 1, B * Q, weight_slab(F), stream);
    reduce_partials(g.mean_part, dmean, B, Q, 3, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Q: blocks per batch element (1 <= Q <= row tiles below update_rows).  The
// *_part buffers, da_row and dc_row must be zero on entry; da_col, dc_col
// (B, N, F), dxx0 (B, N, 6), dmean (B, 3), w_out and cw_out (weight_slab) are
// written in full.  Without the cross branch every cross pointer is null.
extern "C" int coord_agg_backward(
    const float* g_out,
    const float* a_row, const float* a_col, const float* w_d2, const float* w_d20,
    const float* delta, const float* w2, const float* w2t, const float* b2,
    const float* w3,
    const float* c_row, const float* c_col, const float* cw_d2, const float* cw_d20,
    const float* c_delta, const float* cw2, const float* cw2t, const float* cb2,
    const float* cw3,
    const float* x, const float* x0, const float* mask, const float* is_lig,
    const float* graph_mean, int use_tanh, float coords_range, float norm_constant,
    float nf, float cut_ll, float cut_pp, float cut_lp,
    int B, int N, int F, int update_rows, int Q,
    float* da_row, float* dc_row, float* acol_part, float* ccol_part, float* dx_part,
    float* mean_part, float* w_part, float* cw_part,
    float* da_col, float* dc_col, float* dxx0, float* dmean, float* w_out,
    float* cw_out, void* stream) {
  const int rows = update_rows < N ? update_rows : N;
  const int tiles = (rows + TI - 1) / TI;
  if (Q < 1 || Q > (tiles > 0 ? tiles : 1)) return (int)cudaErrorInvalidValue;
  CoordBwdArgs g;
  g.coord = PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w3};
  g.cross = PairMlp{c_row, c_col, cw_d2, cw_d20, c_delta, cw2, cb2, cw3};
  g.w2t = w2t; g.cw2t = cw2t; g.g = g_out;
  g.x = x; g.x0 = x0; g.mask = mask; g.is_lig = is_lig; g.graph_mean = graph_mean;
  g.use_tanh = use_tanh; g.coords_range = coords_range;
  g.norm_constant = norm_constant; g.inv_nf = 1.0f / nf;
  g.cut = Cutoffs{cut_ll, cut_pp, cut_lp};
  g.N = N; g.update_rows = update_rows; g.tiles = tiles;
  g.da_row = da_row; g.dc_row = dc_row; g.acol_part = acol_part;
  g.ccol_part = ccol_part; g.dx_part = dx_part; g.mean_part = mean_part;
  g.w_part = w_part; g.cw_part = cw_part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 64: return launch<64>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 256: return launch<256>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
