// Backward of the equivariant coordinate update aggregation (coord_agg.cu),
// f32-grade, for sm_90a.
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
// with adj_ij = mask_i * col_mask_j * (cutoff test), as in coord_agg.cu,
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
// What bounds it on an H100: three F x F products per active pair and MLP
// (forward recompute, dW2, dm1), 2 * 6*F^2 operations with the cross branch --
// bound by operations.  They run on the tensor cores in 3xTF32
// (egnn_mma_bwd.cuh: mma.sync TF32, each operand split hi + lo), 3 * 6*F^2
// tensor-core operations a pair and MLP at 495 TFLOP/s (-DEGNN_TIER=1:
// 2xTF32, =2: one bf16 pass; egnn_mma_bwd.cuh's tiers).
//
// Design: the MLP part of each chunk is egnn_mma_bwd.cuh's, piece for piece
// (fill_m1, product_sw, dw2_tc, fill_dsilu, dpre_fragments, dpre_sums, the
// swizzled S and D, W2 then W2^T through one W2BwdRing); only the epilogue of
// the forward recompute is the coordinate head's.  The block runs the two
// MLPs one after the other, each over all of its row tiles (two passes), so
// that only one MLP's state is live at a time.  Everything after the MLPs is
// linear in them: each pass scatters its own share of the coordinate
// cotangents -- 2 dd2 (x_i - x_j) and 2 dd20 (x0_i - x0_j) of its first
// layer; the g_i phi q and norm terms in the coordinate pass; the cross
// product's terms and dmean in the cross pass.  Everything that crosses row
// tiles (da_col of both MLPs, dx/dx0, dmean, the weight cotangents) goes
// through per-block slabs and the summing kernel, without atomics, so the
// result is deterministic.  F = 2048 runs each row tile and MLP on a cluster
// of two blocks, each owning half of the MLP's features, F = 4096 on a
// cluster of four, each a quarter (egnn_cluster_bwd.cuh's pieces: the head
// and the distance cotangents summed over the blocks in rank order, the
// per-pair coordinate terms, dmean and the scatter on rank 0; one slab a
// cluster).
#include "egnn_cluster_bwd.cuh"

namespace {

using namespace egnn;

struct CoordBwdArgs {
  PairMlp coord, cross;    // head = w3; cross.a_row == null: reflection-equivariant
  const float* w2t;        // (F, F) transpose of coord.w2
  const float* cw2t;       // (F, F) transpose of cross.w2, or null
  const float* g;          // (B, N, 3) cotangent of the output
  const float* x;          // (B, N, 3)
  const float* x0;         // (B, N, 3)
  const float* mask;       // (B, N) row validity
  const float* col_mask;   // (B, N) column validity
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

// The row tile's and the chunk's shared state, one copy for both passes.
template <int F>
struct CoordBwdShared {
  static constexpr int TI = tile_rows<F>(), P = mma::Layout<F>::P;
  Chunk<TI> chunk;
  Rows<TI> rows;
  PairD2<P> dd;
  float q[P], dw[P];      // adj / norm, g_i . (x_i - x_j); cross: adj / cnorm, g_i . c
  float phi[P];           // the pair's head output
  float rowc[P][6], colc[P][6], meanc[P][3];
  float b2s[F], w3s[F], wd2s[F], wd20s[F];
  float xpart[2][mma::Layout<F>::SLICES][P];  // the slices' shares of the pair dots
  float grow[TI][3], mean[3];      // g / nf of the tile's rows, 0 past update_rows
};

// One row tile of one MLP (the cross MLP when CROSS): rows i0 .. i0+TI-1 of
// the batch item at node0, slab `slab` of the per-block scratch; the body of
// egnn_mma_bwd.cuh::gcl_bwd_tile_tc with the coordinate head's epilogue.
template <int F, bool CROSS>
__device__ void coord_bwd_tile_tc(const CoordBwdArgs& g, size_t node0, size_t slab, int i0,
                                  float* S, float* D, int* cols, mma::W2BwdRing<F>& ring,
                                  mma::GclBwdState<F>& st, CoordBwdShared<F>& sh,
                                  float& dmean) {
  using L = mma::Layout<F>;
  constexpr int TI = L::TI, P = L::P, ROW_GROUPS = mma::row_groups<F>(),
                SLICES = L::SLICES, WM = L::WM;
  const PairMlp& m = CROSS ? g.cross : g.coord;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, slice = warp / ROW_GROUPS;
  const int k = t % F, q = t / F;  // the fill layout's feature and column group
  const float nc = g.norm_constant;
  const Chunk<TI>& chunk = sh.chunk;
  const Rows<TI>& rows = sh.rows;
  float* acol_part = (CROSS ? g.ccol_part : g.acol_part) + slab * (size_t)g.N * F;
  float* dx_part = g.dx_part + slab * (size_t)g.N * 6;
  float* dw2 = (CROSS ? g.cw_part : g.w_part) + slab * weight_slab(F);

  __syncthreads();  // the previous tile is no longer read
  load_rows(sh.rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (t < TI * 3) {
    const int i = i0 + t / 3;
    sh.grow[t / 3][t % 3] =
        i < g.N && i < g.update_rows ? g.g[(node0 + i) * 3 + t % 3] * g.inv_nf : 0.0f;
  }
  if (CROSS && t < 3) sh.mean[t] = g.graph_mean[blockIdx.y * 3 + t];
  for (int e = t; e < F; e += NT) {
    sh.b2s[e] = m.b2[e];
    sh.w3s[e] = m.head[e];
    sh.wd2s[e] = m.w_d2[e];
    sh.wd20s[e] = m.w_d20[e];
  }
  const PairWeights w = pair_weights(m, k);
  float a_row[TI], arow[TI];
#pragma unroll
  for (int r = 0; r < TI; ++r) {
    a_row[r] = i0 + r < g.N ? m.a_row[(node0 + i0 + r) * F + k] : 0.0f;
    arow[r] = 0.0f;
  }
  [[maybe_unused]] mma::UpperHalf<F> up;  // F = 512: feature k + NT; 1024: three more
  if constexpr (L::FE == 2) {
    mma::load_half_rows<F>(m, node0, i0, g.N, k + NT, up);
    for (int r = 0; r < TI; ++r) up.arow[r] = 0.0f;
  } else if constexpr (L::FE > 2) {
    mma::load_quarter_rows<F>(m, node0, i0, g.N, k, up);
    for (int e = 0; e < L::FE - 1; ++e)
      for (int r = 0; r < TI; ++r) up.h[e].arow[r] = 0.0f;
  }
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N, g.cut,
                                    cols);
  float a_col[L::COLS];
  if constexpr (L::FE == 1) {
    mma::load_a_col<F>(m, cols, count, 0, node0, a_col);
  } else if constexpr (L::FE == 2) {
    mma::load_a_col_half<F>(m, cols, count, 0, node0, k, a_col);
    mma::load_a_col_half<F>(m, cols, count, 0, node0, k + NT, up.a_col);
  } else {
    mma::load_a_col_half<F>(m, cols, count, 0, node0, k, a_col);
    mma::load_a_col_quarters<F>(m, cols, count, 0, node0, k, up);
  }
  const int ce = (2 * tig) ^ mma::swz(gid);  // C-fragment columns in rows gid, gid + 8

  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(sh.chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    // the chunk's k-steps of 8 pairs that hold an edge
    unsigned kmask = 0;
    if constexpr (P == 64) {
      const unsigned e0 = __ballot_sync(0xffffffffu, chunk.j[lane] >= 0),
                     e1 = __ballot_sync(0xffffffffu, chunk.j[lane + 32] >= 0);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        kmask |= (((e0 >> (8 * s)) & 0xffu) ? 1u : 0u) << s
               | (((e1 >> (8 * s)) & 0xffu) ? 1u : 0u) << (s + 4);
    } else if constexpr (P == 32) {
      kmask = mma::edge_ksteps32(chunk.j, lane);
    } else {
      kmask = mma::edge_ksteps16(chunk.j, lane);
    }
    // ---- pair geometry (read after product 1's first sync)
    if (t < P) {
      const int j = chunk.j[t], r = t / TJ;
      float qv = 0.0f, dw = 0.0f;
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        if (CROSS) {
          const float u0 = rows.x[r][0] - sh.mean[0], u1 = rows.x[r][1] - sh.mean[1],
                      u2 = rows.x[r][2] - sh.mean[2];
          const float v0 = xj[0] - sh.mean[0], v1 = xj[1] - sh.mean[1],
                      v2 = xj[2] - sh.mean[2];
          const float cx = u1 * v2 - u2 * v1, cy = u2 * v0 - u0 * v2, cz = u0 * v1 - u1 * v0;
          qv = chunk.adj[t] / (sqrtf(cx * cx + cy * cy + cz * cz + 1e-8f) + nc);
          dw = sh.grow[r][0] * cx + sh.grow[r][1] * cy + sh.grow[r][2] * cz;
        } else {
          qv = chunk.adj[t] / (sqrtf(chunk.d2[t] + 1e-8f) + nc);
          for (int a = 0; a < 3; ++a) dw = fmaf(sh.grow[r][a], rows.x[r][a] - xj[a], dw);
        }
      }
      sh.q[t] = qv;
      sh.dw[t] = dw;
    }
    if constexpr (L::FE == 1) {
      mma::fill_m1<F>(w, chunk, a_row, a_col, S);
    } else if constexpr (L::FE == 2) {
      mma::fill_m1_half<F>(w, chunk, a_row, a_col, k, S);
      mma::fill_m1_half<F>(up.w, chunk, up.a_row, up.a_col, k + NT, S);
    } else {
      mma::fill_m1_half<F>(w, chunk, a_row, a_col, k, S);
      mma::fill_m1_quarters<F>(chunk, k, up, S);
    }
    float acc[WM][L::NTN][4];
    mma::product_sw<F, mma::kTier>(S, ring, acc);  // z2 - b2 = m1 @ W2

    // ---- epilogue: z2, the head raw = m2 . w3 (a lane-quad shuffle and one
    // exchange of the slices), phi, draw, dz2 -> D
#pragma unroll
    for (int m_ = 0; m_ < WM; ++m_) {
      float pr[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < L::NTN; ++n) {
        const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = acc[m_][n][e] + sh.b2s[f + (e & 1)];
          acc[m_][n][e] = z;
          pr[e >> 1] = fmaf(mma::silu_fast(z), sh.w3s[f + (e & 1)], pr[e >> 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pr[h] += __shfl_xor_sync(0xffffffffu, pr[h], 1);
        pr[h] += __shfl_xor_sync(0xffffffffu, pr[h], 2);
        if (tig == 0) sh.xpart[0][slice][(rg * WM + m_) * 16 + gid + 8 * h] = pr[h];
      }
    }
    __syncthreads();  // the slices' dots are complete
    float draw[WM][2];  // dL/d(raw) of pairs gid, gid + 8 of each m-tile
#pragma unroll
    for (int m_ = 0; m_ < WM; ++m_)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (rg * WM + m_) * 16 + gid + 8 * h;
        float raw = 0.0f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) raw += sh.xpart[0][sl][p];
        float phi = raw, d = sh.dw[p] * sh.q[p];  // dphi
        if (g.use_tanh) {
          const float th = tanhf(raw);
          phi = th * g.coords_range;
          d *= (1.0f - th * th) * g.coords_range;
        }
        draw[m_][h] = d;
        if (slice == 0 && tig == 0) sh.phi[p] = phi;
      }
    float hv[L::NTN][2];  // the lane's share of dw3 over the chunk
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) hv[n][0] = hv[n][1] = 0.0f;
#pragma unroll
    for (int m_ = 0; m_ < WM; ++m_)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (rg * WM + m_) * 16 + gid + 8 * h;
#pragma unroll
        for (int n = 0; n < L::NTN; ++n) {
          const int f = slice * L::FW + 8 * n + 2 * tig;
          float dz2[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float z = acc[m_][n][2 * h + c];
            const float s = mma::sigmoid_fast(z);
            dz2[c] = draw[m_][h] * sh.w3s[f + c] * s * fmaf(z, 1.0f - s, 1.0f);
            hv[n][c] = fmaf(z * s, draw[m_][h], hv[n][c]);
          }
          *reinterpret_cast<float2*>(D + p * F + ((slice * L::FW + 8 * n) ^ ce)) =
              make_float2(dz2[0], dz2[1]);
        }
      }
    // the 8 lane groups' shares of dw3, added by lanes 0..3
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = hv[n][c];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (gid == 0) st.hvs[rg * F + slice * L::FW + 8 * n + 2 * tig + c] += v;
      }
    __syncthreads();  // D complete
    mma::dw2_tc<F, mma::kTier>(S, D, kmask, dw2);
    __syncthreads();  // S is no longer read
    // the next chunk's a_col, or the next tile's first: loaded during product 3
    if constexpr (L::FE == 1) {
      mma::fill_dsilu<F>(w, chunk, a_row, a_col, D, S, st.fa.b2);
      mma::load_a_col<F>(m, cols, count, c0 + TJ, node0, a_col);
    } else if constexpr (L::FE == 2) {
      mma::fill_dsilu_half<F>(w, chunk, a_row, a_col, k, D, S, st.fa.b2);
      mma::fill_dsilu_half<F>(up.w, chunk, up.a_row, up.a_col, k + NT, D, S, st.fa_hi.b2);
      mma::load_a_col_half<F>(m, cols, count, c0 + TJ, node0, k, a_col);
      mma::load_a_col_half<F>(m, cols, count, c0 + TJ, node0, k + NT, up.a_col);
    } else {
      mma::fill_dsilu_half<F>(w, chunk, a_row, a_col, k, D, S, st.fa.b2);
      mma::fill_dsilu_quarters<F>(chunk, k, up, D, S, st.fa_hi);
      mma::load_a_col_half<F>(m, cols, count, c0 + TJ, node0, k, a_col);
      mma::load_a_col_quarters<F>(m, cols, count, c0 + TJ, node0, k, up);
    }
    mma::product_sw<F, mma::kTier>(D, ring, acc);  // dm1 = dz2 @ W2^T
    mma::dpre_fragments<F>(acc, S, sh.wd2s, sh.wd20s, sh.xpart);
    __syncthreads();  // dpre and the pair dots complete
    if (t < P) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) {
        a += sh.xpart[0][sl][t];
        b += sh.xpart[1][sl][t];
      }
      sh.dd.dd2[t] = a;
      sh.dd.dd20[t] = b;
    }
    if constexpr (L::FE == 1) {
      mma::dpre_sums<F>(S, chunk, cols, count, c0, arow, st.fa, acol_part);
    } else if constexpr (L::FE == 2) {
      mma::dpre_sums_half<F>(S, chunk, cols, count, c0, k, arow, st.fa, acol_part);
      mma::dpre_sums_half<F>(S, chunk, cols, count, c0, k + NT, up.arow, st.fa_hi, acol_part);
    } else {
      mma::dpre_sums_half<F>(S, chunk, cols, count, c0, k, arow, st.fa, acol_part);
      mma::dpre_sums_quarters<F>(S, chunk, cols, count, c0, k, up, st.fa_hi, acol_part);
    }
    __syncthreads();  // dd complete

    // ---- this MLP's share of the per-pair coordinate cotangents
    if (t < P) {
      const int j = chunk.j[t], r = t / TJ;
      for (int a = 0; a < 6; ++a) { sh.rowc[t][a] = 0.0f; sh.colc[t][a] = 0.0f; }
      if (CROSS)
        for (int a = 0; a < 3; ++a) sh.meanc[t][a] = 0.0f;
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        const float* x0j = g.x0 + (node0 + j) * 3;
        float dd2 = sh.dd.dd2[t];
        const float w_ = sh.phi[t] * sh.q[t];
        if (!CROSS) {
          const float sq = sqrtf(chunk.d2[t] + 1e-8f), norm = sq + nc;
          dd2 -= (w_ / norm) * sh.dw[t] * (0.5f / sq);
        }
        for (int a = 0; a < 3; ++a) {
          float v = 2.0f * dd2 * (rows.x[r][a] - xj[a]);
          if (!CROSS) v = fmaf(sh.grow[r][a], w_, v);
          const float v0 = 2.0f * sh.dd.dd20[t] * (rows.x0[r][a] - x0j[a]);
          sh.rowc[t][a] = v; sh.colc[t][a] = -v;
          sh.rowc[t][3 + a] = v0; sh.colc[t][3 + a] = -v0;
        }
        if (CROSS) {
          const float u[3] = {rows.x[r][0] - sh.mean[0], rows.x[r][1] - sh.mean[1],
                              rows.x[r][2] - sh.mean[2]};
          const float v[3] = {xj[0] - sh.mean[0], xj[1] - sh.mean[1], xj[2] - sh.mean[2]};
          const float c[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                              u[0] * v[1] - u[1] * v[0]};
          const float cn = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-8f);
          const float dcnorm = -(w_ / (cn + nc)) * sh.dw[t];
          float dc[3];
          for (int a = 0; a < 3; ++a) dc[a] = w_ * sh.grow[r][a] + dcnorm * c[a] / cn;
          const float du[3] = {v[1] * dc[2] - v[2] * dc[1], v[2] * dc[0] - v[0] * dc[2],
                               v[0] * dc[1] - v[1] * dc[0]};
          const float dv[3] = {dc[1] * u[2] - dc[2] * u[1], dc[2] * u[0] - dc[0] * u[2],
                               dc[0] * u[1] - dc[1] * u[0]};
          for (int a = 0; a < 3; ++a) {
            sh.rowc[t][a] += du[a];
            sh.colc[t][a] += dv[a];
            sh.meanc[t][a] = -(du[a] + dv[a]);
          }
        }
      }
    }
    __syncthreads();
    if (CROSS && t < 3)
      for (int p = 0; p < P; ++p) dmean += sh.meanc[p][t];
    scatter_dx<TI>(sh.rowc, sh.colc, cols, count, c0, i0, g.N, dx_part);  // ends with a sync
  }

  // ---- da_row of the tile's rows: the column groups' row sums, in order
  if constexpr (L::FE == 2) {  // F = 512: one column group, the sums complete
    mma::store_rows_half<F>(arow, up.arow, k, node0, i0, g.N, g.update_rows,
                            CROSS ? g.dc_row : g.da_row);
    return;
  } else if constexpr (L::FE > 2) {  // F = 1024 likewise
    mma::store_rows_quarters<F>(arow, up, k, node0, i0, g.N, g.update_rows,
                                CROSS ? g.dc_row : g.da_row);
    return;
  }
  float* red = S;  // free: the last chunk ended with a sync
#pragma unroll
  for (int r = 0; r < TI; ++r) red[(q * TI + r) * F + k] = arow[r];
  __syncthreads();
  if (t < F) {
    float* da_row = CROSS ? g.dc_row : g.da_row;
    for (int r = 0; r < TI; ++r) {
      const int i = i0 + r;
      if (i >= g.N || i >= g.update_rows) continue;
      float s = 0.0f;
      for (int qq = 0; qq < NT / F; ++qq) s += red[(qq * TI + r) * F + t];
      da_row[(node0 + i) * F + t] = s;
    }
  }
}

// One MLP over every row tile of the block (q, b): tiles q, q + Q, ... of
// batch b, with one ring and one set of sums, stored into the MLP's slab.
template <int F, bool CROSS>
__device__ void coord_bwd_pass(const CoordBwdArgs& g, float* S, float* D, float* ring_buf,
                               int* cols, CoordBwdShared<F>& sh, float* hvs) {
  const PairMlp& m = CROSS ? g.cross : g.coord;
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const size_t slab = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  __syncthreads();  // the previous pass has stored its sums
  for (int e = threadIdx.x; e < mma::row_groups<F>() * F; e += NT) hvs[e] = 0.0f;
  mma::GclBwdState<F> st{FeatAcc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, hvs, 0.0f};
  mma::W2BwdRing<F> ring{m.w2, CROSS ? g.cw2t : g.w2t, ring_buf, 0};
  for (int s = 0; s < mma::NS - 1; ++s) ring.issue();
  float dmean = 0.0f;  // thread t < 3: component t
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x)
    coord_bwd_tile_tc<F, CROSS>(g, node0, slab, tile * tile_rows<F>(), S, D, cols, ring, st,
                                sh, dmean);
  mma::cp_async_wait_all();  // the ring's look-ahead stage
  // [dW2][w_d2][w_d20][delta][b2][w3][0]: the GCL's slab layout, no head bias
  mma::store_gcl_bwd_state<F>(st, (CROSS ? g.cw_part : g.w_part) + slab * weight_slab(F), S);
  if (CROSS && threadIdx.x < 3) g.mean_part[slab * 3 + threadIdx.x] = dmean;
}

// The row tile's and the chunk's shared state of one cluster block (F =
// 2048, 4096: the same sizes), one copy for both passes: the block's parts
// of the vectors.
struct ClusterCoordShared {
  static constexpr int P = mma::Layout<2048>::P, FB = mma::Layout<2048>::FB;
  Chunk<1> chunk;
  Rows<1> rows;
  float q[P], dw[P];      // adj / norm, g_i . (x_i - x_j); cross: adj / cnorm, g_i . c
  float phi[P];           // the pair's head output
  float rowc[P][6], colc[P][6], meanc[P][3];
  float b2s[FB], w3s[FB], wd2s[FB], wd20s[FB];
  float xpart[mma::Layout<2048>::SLICES][P];  // the slices' shares of the head
  float share[2][P];      // the block's shares of two pair sums, read by the peers
  float grow[3], mean[3]; // g / nf of the row, 0 past update_rows
};

// One row tile of one MLP at F = 2048 or 4096, one block of a cluster of
// C = F / 1024: the body of coord_bwd_tile_tc on egnn_cluster_bwd.cuh's
// pieces (as gcl_bwd_tile_cluster), with the coordinate head's epilogue;
// rank 0 alone computes and scatters the per-pair coordinate terms and sums
// dmean.
template <int F, bool CROSS>
__device__ void coord_bwd_tile_cluster(const CoordBwdArgs& g, size_t node0, size_t slab,
                                       int i0, float* A, float* Bt, int* cols,
                                       mma::W2BwdClusterRing<F>& ring, mma::ClusterBwdState& st,
                                       ClusterCoordShared& sh, float& dmean) {
  using L = mma::Layout<F>;
  constexpr int P = L::P, FB = L::FB, SLICES = L::SLICES;
  constexpr bool WIDE = L::CLUSTER > 2;
  const PairMlp& m = CROSS ? g.cross : g.coord;
  const unsigned rank = cluster_rank(), peer = rank ^ 1u;
  const int col0 = (int)rank * FB;
  const int t = threadIdx.x, lane = t & 31, slice = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const float nc = g.norm_constant;
  const Chunk<1>& chunk = sh.chunk;
  const Rows<1>& rows = sh.rows;
  float* acol_part = (CROSS ? g.ccol_part : g.acol_part) + slab * (size_t)g.N * F;
  float* dx_part = g.dx_part + slab * (size_t)g.N * 6;
  float* dw2 = (CROSS ? g.cw_part : g.w_part) + slab * weight_slab(F) + col0;
  float* D = WIDE ? A + P * FB : Bt;  // the block's dz2: STG, or B at 2048

  __syncthreads();  // the previous tile is no longer read
  load_rows(sh.rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (t < 3)
    sh.grow[t] = i0 < g.N && i0 < g.update_rows ? g.g[(node0 + i0) * 3 + t] * g.inv_nf : 0.0f;
  if (CROSS && t < 3) sh.mean[t] = g.graph_mean[blockIdx.y * 3 + t];
  for (int e = t; e < FB; e += NT) {
    sh.b2s[e] = m.b2[col0 + e];
    sh.w3s[e] = m.head[col0 + e];
    sh.wd2s[e] = m.w_d2[col0 + e];
    sh.wd20s[e] = m.w_d20[col0 + e];
  }
  mma::ClusterFill<F> fill;
  mma::load_fill_cluster(fill, m, node0, i0, g.N, col0);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N, g.cut,
                                    cols);
  fill.load_cols(m, cols, count, 0, node0);
  const uint32_t peer_share = peer_address(sh.share, peer);
  const int ce = (2 * tig) ^ mma::swz(gid);  // C-fragment columns in rows gid, gid + 8

  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(sh.chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    const unsigned kmask = mma::edge_ksteps16(chunk.j, lane);
    // ---- pair geometry (read after the barrier below)
    if (t < P) {
      const int j = chunk.j[t];
      float qv = 0.0f, dw = 0.0f;
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        if (CROSS) {
          const float u0 = rows.x[0][0] - sh.mean[0], u1 = rows.x[0][1] - sh.mean[1],
                      u2 = rows.x[0][2] - sh.mean[2];
          const float v0 = xj[0] - sh.mean[0], v1 = xj[1] - sh.mean[1],
                      v2 = xj[2] - sh.mean[2];
          const float cx = u1 * v2 - u2 * v1, cy = u2 * v0 - u0 * v2, cz = u0 * v1 - u1 * v0;
          qv = chunk.adj[t] / (sqrtf(cx * cx + cy * cy + cz * cz + 1e-8f) + nc);
          dw = sh.grow[0] * cx + sh.grow[1] * cy + sh.grow[2] * cz;
        } else {
          qv = chunk.adj[t] / (sqrtf(chunk.d2[t] + 1e-8f) + nc);
          for (int a = 0; a < 3; ++a) dw = fmaf(sh.grow[a], rows.x[0][a] - xj[a], dw);
        }
      }
      sh.q[t] = qv;
      sh.dw[t] = dw;
    }
    float acc[1][L::NTN][4];
    if constexpr (WIDE) {
      mma::fill_m1_own(fill, chunk, A);
      cluster_sync();  // X1: every block's part of S is filled
      ring.start(false);
      mma::product_parts<F, mma::kTier>(A, A + P * FB, rank, ring, acc);  // z2 - b2 = m1 @ W2[:, O_r]
    } else {
      mma::fill_m1_cluster(fill, chunk, A);
      cluster_sync();  // X1: both halves of S are filled
      ring.start(false);
      mma::copy_peer_cols(A, peer);
      mma::product_sw<F, mma::kTier>(A, ring, acc);  // z2 - b2 = m1 @ W2[:, O_r]
    }

    // ---- epilogue: z2, the block's share of the head raw = m2 . w3, the
    // sum over the blocks, phi, draw, dz2 -> D
    float pr[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = acc[0][n][e] + sh.b2s[f + (e & 1)];
        acc[0][n][e] = z;
        pr[e >> 1] = fmaf(mma::silu_fast(z), sh.w3s[f + (e & 1)], pr[e >> 1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pr[h] += __shfl_xor_sync(0xffffffffu, pr[h], 1);
      pr[h] += __shfl_xor_sync(0xffffffffu, pr[h], 2);
      if (tig == 0) sh.xpart[slice][gid + 8 * h] = pr[h];
    }
    __syncthreads();  // the slices' dots are complete
    if (t < P) {
      float raw = 0.0f;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) raw += sh.xpart[sl][t];
      sh.share[0][t] = raw;
    }
    cluster_sync();  // X2: the shares are written, product 1's stages read
    float draw[2];  // dL/d(raw) of pairs gid, gid + 8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = gid + 8 * h;
      float raw;
      if constexpr (WIDE)
        raw = mma::cluster_sum<F>(sh.share[0], p, 0.0f);
      else
        raw = mma::cluster_sum(sh.share[0][p], load_peer(peer_share + 4u * p), rank);
      float phi = raw, d = sh.dw[p] * sh.q[p];  // dphi
      if (g.use_tanh) {
        const float th = tanhf(raw);
        phi = th * g.coords_range;
        d *= (1.0f - th * th) * g.coords_range;
      }
      draw[h] = d;
      if (slice == 0 && tig == 0) sh.phi[p] = phi;
    }
    float hv[L::NTN][2];  // the lane's share of dw3 over the chunk
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) hv[n][0] = hv[n][1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = gid + 8 * h;
#pragma unroll
      for (int n = 0; n < L::NTN; ++n) {
        const int f = slice * L::FW + 8 * n + 2 * tig;
        float dz2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float z = acc[0][n][2 * h + c];
          const float s = mma::sigmoid_fast(z);
          dz2[c] = draw[h] * sh.w3s[f + c] * s * fmaf(z, 1.0f - s, 1.0f);
          hv[n][c] = fmaf(z * s, draw[h], hv[n][c]);
        }
        *reinterpret_cast<float2*>(D + p * FB + ((slice * L::FW + 8 * n) ^ ce)) =
            make_float2(dz2[0], dz2[1]);
      }
    }
    mma::add_head_cotangent(hv, st.hvs);
    __syncthreads();  // dz2 complete
    if constexpr (WIDE) {
      mma::add_db2(D, st.fa);
      mma::dw2_parts<F, mma::kTier>(A, D, Bt, rank, kmask, dw2);
      cluster_sync();  // X3: every dz2 part is in place, no block reads another's S
      ring.start(true);
      mma::product_parts<F, mma::kTier>(D, A, rank, ring, acc);  // dm1[:, I_r] = dz2 @ W2^T[:, I_r]
    } else {
      mma::dw2_cluster<mma::kTier>(A, Bt, kmask, dw2);
      __syncthreads();  // A and B no longer read
      mma::place_dz2_half(Bt, A, col0, st.fa);
      cluster_sync();  // X3: both halves of dz2 are placed
      ring.start(true);
      mma::copy_peer_cols(A, peer);
      mma::product_sw<F, mma::kTier>(A, ring, acc);  // dm1[:, I_r] = dz2 @ W2^T[:, I_r]
    }
    __syncthreads();  // the last stage is read
    mma::store_fragments(acc, Bt);
    __syncthreads();  // dm1 complete
    mma::dpre_cluster(fill, chunk, Bt, cols, count, c0, st.fa, acol_part);
    fill.load_cols(m, cols, count, c0 + TJ, node0);  // the next chunk's
    __syncthreads();  // dpre complete
    mma::pair_dots(Bt, sh.wd2s, sh.wd20s, sh.share);
    cluster_sync();  // X4: the pair sums' shares are written

    // ---- this MLP's share of the per-pair coordinate cotangents: rank 0
    if (rank != 0) continue;
    if (t < P) {
      const int j = chunk.j[t];
      for (int a = 0; a < 6; ++a) { sh.rowc[t][a] = 0.0f; sh.colc[t][a] = 0.0f; }
      if (CROSS)
        for (int a = 0; a < 3; ++a) sh.meanc[t][a] = 0.0f;
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        const float* x0j = g.x0 + (node0 + j) * 3;
        float dd2, dd20;
        if constexpr (WIDE) {
          dd2 = mma::cluster_sum<F>(sh.share[0], t, 0.0f);
          dd20 = mma::cluster_sum<F>(sh.share[1], t, 0.0f);
        } else {
          dd2 = mma::cluster_sum(sh.share[0][t], load_peer(peer_share + 4u * t), rank);
          dd20 = mma::cluster_sum(sh.share[1][t], load_peer(peer_share + 4u * (P + t)), rank);
        }
        const float w_ = sh.phi[t] * sh.q[t];
        if (!CROSS) {
          const float sq = sqrtf(chunk.d2[t] + 1e-8f), norm = sq + nc;
          dd2 -= (w_ / norm) * sh.dw[t] * (0.5f / sq);
        }
        for (int a = 0; a < 3; ++a) {
          float v = 2.0f * dd2 * (rows.x[0][a] - xj[a]);
          if (!CROSS) v = fmaf(sh.grow[a], w_, v);
          const float v0 = 2.0f * dd20 * (rows.x0[0][a] - x0j[a]);
          sh.rowc[t][a] = v; sh.colc[t][a] = -v;
          sh.rowc[t][3 + a] = v0; sh.colc[t][3 + a] = -v0;
        }
        if (CROSS) {
          const float u[3] = {rows.x[0][0] - sh.mean[0], rows.x[0][1] - sh.mean[1],
                              rows.x[0][2] - sh.mean[2]};
          const float v[3] = {xj[0] - sh.mean[0], xj[1] - sh.mean[1], xj[2] - sh.mean[2]};
          const float c[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                              u[0] * v[1] - u[1] * v[0]};
          const float cn = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-8f);
          const float dcnorm = -(w_ / (cn + nc)) * sh.dw[t];
          float dc[3];
          for (int a = 0; a < 3; ++a) dc[a] = w_ * sh.grow[a] + dcnorm * c[a] / cn;
          const float du[3] = {v[1] * dc[2] - v[2] * dc[1], v[2] * dc[0] - v[0] * dc[2],
                               v[0] * dc[1] - v[1] * dc[0]};
          const float dv[3] = {dc[1] * u[2] - dc[2] * u[1], dc[2] * u[0] - dc[0] * u[2],
                               dc[0] * u[1] - dc[1] * u[0]};
          for (int a = 0; a < 3; ++a) {
            sh.rowc[t][a] += du[a];
            sh.colc[t][a] += dv[a];
            sh.meanc[t][a] = -(du[a] + dv[a]);
          }
        }
      }
    }
    __syncthreads();
    if (CROSS && t < 3)
      for (int p = 0; p < P; ++p) dmean += sh.meanc[p][t];
    scatter_dx<1>(sh.rowc, sh.colc, cols, count, c0, i0, g.N, dx_part);  // ends with a sync
  }
  mma::store_row_cluster(fill, node0, i0, g.N, g.update_rows, CROSS ? g.dc_row : g.da_row);
}

// One MLP over every row tile of cluster q (blockIdx.x / C) of batch b: as
// coord_bwd_pass, with the cluster's slab.
template <int F, bool CROSS>
__device__ void coord_bwd_pass_cluster(const CoordBwdArgs& g, float* A, float* Bt, int* cols,
                                       ClusterCoordShared& sh, float* hvs) {
  using L = mma::Layout<F>;
  const PairMlp& m = CROSS ? g.cross : g.coord;
  const unsigned rank = cluster_rank();
  const int col0 = (int)rank * L::FB;
  const int Q = gridDim.x / cluster_size<F>();
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const size_t slab = (size_t)blockIdx.y * Q + cluster_tile<F>();
  __syncthreads();  // the previous pass has stored its sums
  for (int e = threadIdx.x; e < L::FB; e += NT) hvs[e] = 0.0f;
  mma::ClusterBwdState st{};
  st.hvs = hvs;
  mma::W2BwdClusterRing<F> ring{m.w2 + col0, (CROSS ? g.cw2t : g.w2t) + col0, Bt, 0};
  float dmean = 0.0f;  // rank 0's thread t < 3: component t
  for (int tile = cluster_tile<F>(); tile < g.tiles; tile += Q)
    coord_bwd_tile_cluster<F, CROSS>(g, node0, slab, tile, A, Bt, cols, ring, st, sh, dmean);
  // [dW2][w_d2][w_d20][delta][b2][w3][0]: the GCL's slab layout, no head bias
  mma::store_cluster_bwd_state<F>(st, (CROSS ? g.cw_part : g.w_part) + slab * weight_slab(F),
                                  A, rank);
  if (CROSS && rank == 0 && threadIdx.x < 3) g.mean_part[slab * 3 + threadIdx.x] = dmean;
}

// F = 2048, 4096: the two passes on cluster q's blocks; the last cluster
// barrier keeps each block's shared memory alive until the peers have read
// it.
template <int F>
__global__ void __launch_bounds__(NT) coord_agg_bwd_cluster_kernel(CoordBwdArgs g) {
  using L = mma::Layout<F>;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                // kRegionA floats
  float* Bt = A + mma::kRegionA;  // the ring, or a P x FB tile
  int* cols = reinterpret_cast<int*>(Bt + mma::NS * L::STAGE);  // N
  __shared__ __align__(16) ClusterCoordShared sh;  // 16 B: the fill passes' loads vectorise
  __shared__ float hvs[L::FB];
  coord_bwd_pass_cluster<F, false>(g, A, Bt, cols, sh, hvs);
  if (g.cross.a_row != nullptr) coord_bwd_pass_cluster<F, true>(g, A, Bt, cols, sh, hvs);
  cluster_sync();  // the peers have read this block's last shares
}

template <int F>
__global__ void __launch_bounds__(NT) coord_agg_bwd_kernel(CoordBwdArgs g) {
  using L = mma::Layout<F>;
  extern __shared__ __align__(16) float smem[];
  constexpr int P = L::P;
  float* S = smem;                     // P * F
  float* D = S + P * F;                // P * F
  float* ring_buf = D + P * F;         // NS * STAGE
  int* cols = reinterpret_cast<int*>(ring_buf + mma::NS * L::STAGE);  // N
  __shared__ __align__(16) CoordBwdShared<F> sh;  // 16 B: the fill passes' loads vectorise
  __shared__ float hvs[mma::row_groups<F>() * F];
  coord_bwd_pass<F, false>(g, S, D, ring_buf, cols, sh, hvs);
  if (g.cross.a_row != nullptr) coord_bwd_pass<F, true>(g, S, D, ring_buf, cols, sh, hvs);
}

template <int F>
int launch(CoordBwdArgs g, int B, int Q, float* da_col, float* dc_col,
           float* dxx0, float* dmean, float* w_out, float* cw_out, cudaStream_t stream) {
  constexpr int TI = tile_rows<F>();
  const int rows = g.update_rows < g.N ? g.update_rows : g.N;
  g.tiles = (rows + TI - 1) / TI;
  if (Q < 1 || Q > (g.tiles > 0 ? g.tiles : 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (cluster_size<F>() > 1) {
    err = (cudaError_t)launch_clusters<cluster_size<F>()>(
        coord_agg_bwd_cluster_kernel<F>, dim3(Q * cluster_size<F>(), B),
        mma::dynamic_smem_bwd_cluster(g.N), stream, g);
    if (err != cudaSuccess) return (int)err;
  } else {
    last_cluster_dim() = 1;
    const size_t smem = mma::dynamic_smem_bwd_tc<F>(g.N);
    err = cudaFuncSetAttribute(
        coord_agg_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    coord_agg_bwd_kernel<F><<<dim3(Q, B), NT, smem, stream>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
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

// Q: blocks per batch element, clusters of two at F = 2048 and of four at
// 4096 (1 <= Q <= row tiles below update_rows).  The *_part buffers, da_row and dc_row must be
// zero on entry; da_col, dc_col (B, N, F), dxx0 (B, N, 6), dmean (B, 3),
// w_out and cw_out (weight_slab) are written in full.  Without the cross
// branch every cross pointer is null.  w2 and cw2 (and their transposes)
// must be 16-byte aligned: they stream through cp.async.  pairs: null, or two
// counters to which the launch adds its pairs (launch_count_pairs:
// egnn_common.cuh; the two MLPs' passes walk the same chunks, counted once).
extern "C" int coord_agg_backward(
    const float* g_out,
    const float* a_row, const float* a_col, const float* w_d2, const float* w_d20,
    const float* delta, const float* w2, const float* w2t, const float* b2,
    const float* w3,
    const float* c_row, const float* c_col, const float* cw_d2, const float* cw_d20,
    const float* c_delta, const float* cw2, const float* cw2t, const float* cb2,
    const float* cw3,
    const float* x, const float* x0, const float* mask, const float* col_mask,
    const float* is_lig, const float* graph_mean, int use_tanh, float coords_range,
    float norm_constant,
    float nf, float cut_ll, float cut_pp, float cut_lp,
    int B, int N, int F, int update_rows, int Q,
    float* da_row, float* dc_row, float* acol_part, float* ccol_part, float* dx_part,
    float* mean_part, float* w_part, float* cw_part,
    float* da_col, float* dc_col, float* dxx0, float* dmean, float* w_out,
    float* cw_out, unsigned long long* pairs, void* stream) {
  CoordBwdArgs g;
  g.coord = PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w3};
  g.cross = PairMlp{c_row, c_col, cw_d2, cw_d20, c_delta, cw2, cb2, cw3};
  g.w2t = w2t; g.cw2t = cw2t; g.g = g_out;
  g.x = x; g.x0 = x0; g.mask = mask; g.col_mask = col_mask; g.is_lig = is_lig;
  g.graph_mean = graph_mean;
  g.use_tanh = use_tanh; g.coords_range = coords_range;
  g.norm_constant = norm_constant; g.inv_nf = 1.0f / nf;
  g.cut = Cutoffs{cut_ll, cut_pp, cut_lp};
  g.N = N; g.update_rows = update_rows;  // g.tiles: set by launch<F> (TI depends on F)
  g.da_row = da_row; g.dc_row = dc_row; g.acol_part = acol_part;
  g.ccol_part = ccol_part; g.dx_part = dx_part; g.mean_part = mean_part;
  g.w_part = w_part; g.cw_part = cw_part;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr) {  // on the stream before the kernel, which reads the same inputs
    const int err = launch_count_pairs(F, x0, mask, col_mask, is_lig, g.cut, B, N,
                                       update_rows, pairs, s);
    if (err != 0) return err;
  }
  switch (F) {
    case 64: return launch<64>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 128: return launch<128>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 256: return launch<256>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 512: return launch<512>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 1024: return launch<1024>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 2048: return launch<2048>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    case 4096: return launch<4096>(g, B, Q, da_col, dc_col, dxx0, dmean, w_out, cw_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
