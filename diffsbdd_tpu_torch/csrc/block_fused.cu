// One whole EGNN block (one GCL, its node MLP, the coordinate update) behind
// one entry point, f32, for sm_90a.
//
// Replaces the Pallas TPU kernel `block_fused_pallas`
// (diffsbdd_tpu/ops/egnn_block_fused.py:295).  For every node i of every batch
// item, with the pair MLPs of gcl_agg.cu and coord_agg.cu:
//
//   phase A   agg_i = (1/nf) * sum_j adj_ij * gate_ij * m_ij          (GCL)
//             h'_i  = (h_i + silu(h_i @ W_h + agg_i @ W_a + b0) @ W2n + b2n) * mask_i
//             la_row_i = h'_i @ k_i + b0 + t00 + lig_i*(t10 - t00)     (coordinate head)
//             la_col_i = h'_i @ k_j + lig_i*(t01 - t00)
//             lc_row_i, lc_col_i likewise                              (cross head)
//   phase B   dx_i = coordinate update of coord_agg.cu on la_* / lc_*, rows
//             below update_rows only; the rank-1 term delta = t11 - t10 - t01
//             + t00 of a type table stays pairwise.
//
// The node MLP and the head projections run in this file's device code: the
// (B, N, F) aggregate never leaves the chip's shared memory, and h' is read
// back only as the projections phase B needs.
//
// The barrier.  Phase B of a batch item reads la_col / lc_col of all its rows,
// so it may start only when phase A of that item is complete.  A CUDA grid has
// no order; the barrier here is the stream: one phase-A kernel and one phase-B
// kernel, launched back to back by block_fused_forward, with the four
// projections in a global scratch the caller allocates (4*B*N*F floats, which
// at the sizes in use stays in L2 between the two kernels).  A cooperative
// single launch would need the whole grid resident at once and so a persistent
// phase B; two ordered launches keep phase B's grid of row tiles, which is
// what fills the SMs when only the ligand rows move.
//
// Phase A.  Grid (ceil(N / rb), B): a block owns rb <= RB = 64 consecutive rows
// (a multiple of TI).  It runs the GCL row-tile body (gcl_tile, egnn_fwd.cuh)
// for its rb/TI tiles, the aggregates going to a RB x F shared-memory tile, and
// then does the node MLP and the projections for all its rows at once: seven
// RB x F x F products, each weight matrix streamed once per block through the
// KC-row stage (not once per row tile, which would re-read ~1.75 MB of weights
// from L2 for every 4 rows).  RB equals P, so the products reuse tile_product
// unchanged: warp w owns rows 8w .. 8w+7 and every lane F/32 features of each;
// rows past rb are zeros that nothing reads back.  One block fits an SM (its
// registers), and a block's time is its tiles' plus the products', which do
// not depend on rb; so the caller picks the smallest rb whose grid still fits
// the card at once, and the blocks finish together.
//
// Phase B.  Grid of row tiles below update_rows, the body of coord_agg.cu
// (coord_tile).  dx rows at and above update_rows are written as zeros.
#include "egnn_fwd.cuh"

namespace {

using namespace egnn;

constexpr int RB = P;  // most rows a phase-A block owns

struct Head {          // first layer of a coordinate-type head, split
  const float* k_i;    // (F, F) row part, input-major; null: head absent
  const float* k_j;    // (F, F) column part
  const float* b0;     // (F)
  const float* tb;     // (2, 2, F) edge-type table or null
  float* row;          // (B, N, F) scratch: row projections of h'
  float* col;          // (B, N, F) scratch: column projections of h'
  float* delta;        // (F) scratch: rank-1 term of the table
};

struct PhaseA {
  GclArgs gcl;
  const float* h;      // (B, N, F) block-entry node features
  const float* w_h;    // (F, F) node MLP first layer, rows of h
  const float* w_a;    // (F, F) node MLP first layer, rows of agg
  const float* nb0;    // (F)
  const float* nw2;    // (F, F)
  const float* nb2;    // (F)
  Head coord, cross;
  int rb;              // rows a block owns: a multiple of TI, at most RB
  float* out_h;        // (B, N, F)
};

// (S @ k_i + b0 [+ type fold]) -> head.row, (S @ k_j [+ type fold]) -> head.col
// for the block's rows; S holds h'.
template <int F>
__device__ void project_head(const Head& hd, const float* S, float* Ws,
                             const float* is_lig, size_t node0, int r0, int r1) {
  constexpr int NC = F / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[PPW][NC];
  for (int side = 0; side < 2; ++side) {
    tile_product<F>(S, side == 0 ? hd.k_i : hd.k_j, Ws, acc);
    float* dst = side == 0 ? hd.row : hd.col;
#pragma unroll
    for (int r = 0; r < PPW; ++r) {
      const int i = r0 + warp * PPW + r;
      if (i >= r1) continue;
      const float lig = is_lig[node0 + i];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int k = lane + 32 * n;
        float v = acc[r][n];
        if (side == 0) {
          v += hd.b0[k];
          if (hd.tb) v += hd.tb[k] + lig * (hd.tb[2 * F + k] - hd.tb[k]);
        } else if (hd.tb) {
          v += lig * (hd.tb[F + k] - hd.tb[k]);
        }
        dst[(node0 + i) * F + k] = v;
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(NT) block_phase_a(PhaseA g) {
  constexpr int NC = F / 32;
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                   // P * F
  float* Ws = S + P * F;                             // KC * F
  float* AGG = Ws + KC * F;                          // RB * F
  int* cols = reinterpret_cast<int*>(AGG + RB * F);  // N

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int N = g.gcl.N;
  const int r0 = blockIdx.x * g.rb;              // the block's rows: r0 .. r1-1
  const int r1 = r0 + g.rb < N ? r0 + g.rb : N;
  const size_t node0 = (size_t)blockIdx.y * N;

  // the rank-1 terms of the heads' type tables, for phase B
  if (blockIdx.x == 0 && blockIdx.y == 0 && t < F) {
    if (g.coord.tb)
      g.coord.delta[t] = g.coord.tb[3 * F + t] - g.coord.tb[2 * F + t]
                       - g.coord.tb[F + t] + g.coord.tb[t];
    if (g.cross.k_i && g.cross.tb)
      g.cross.delta[t] = g.cross.tb[3 * F + t] - g.cross.tb[2 * F + t]
                       - g.cross.tb[F + t] + g.cross.tb[t];
  }

  // ---- GCL: aggregates of the block's rows -> AGG
  for (int tile = 0; tile < RB / TI; ++tile) {
    const int i0 = r0 + tile * TI;
    float* dst = AGG + tile * TI * F;
    if (i0 < r1) {
      gcl_tile<F>(g.gcl, node0, i0, S, Ws, cols, dst, TI);
    } else {
      for (int e = t; e < TI * F; e += NT) dst[e] = 0.0f;
    }
  }

  // ---- node MLP on all RB rows: pre = h @ W_h + agg @ W_a + b0
  for (int e = t; e < RB * F; e += NT) {
    const int i = r0 + e / F;
    S[e] = i < r1 ? g.h[(node0 + i) * F + e % F] : 0.0f;
  }
  float acc[PPW][NC];
  tile_product<F>(S, g.w_h, Ws, acc);
  tile_product<F, false>(AGG, g.w_a, Ws, acc);
  // a warp reads only its own rows of S, and tile_product syncs the block
  // before its first read, so each warp may rewrite its rows right away
#pragma unroll
  for (int r = 0; r < PPW; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int k = lane + 32 * n;
      S[(warp * PPW + r) * F + k] = siluf_(acc[r][n] + g.nb0[k]);
    }
  tile_product<F>(S, g.nw2, Ws, acc);
  // h' = (h + upd) * mask -> out_h and S
#pragma unroll
  for (int r = 0; r < PPW; ++r) {
    const int i = r0 + warp * PPW + r;
    const float m = i < r1 ? g.gcl.mask[node0 + i] : 0.0f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int k = lane + 32 * n;
      float v = 0.0f;
      if (i < r1) {
        v = (g.h[(node0 + i) * F + k] + acc[r][n] + g.nb2[k]) * m;
        g.out_h[(node0 + i) * F + k] = v;
      }
      S[(warp * PPW + r) * F + k] = v;
    }
  }

  // ---- first-layer projections of the coordinate and cross heads
  project_head<F>(g.coord, S, Ws, g.gcl.is_lig, node0, r0, r1);
  if (g.cross.k_i) project_head<F>(g.cross, S, Ws, g.gcl.is_lig, node0, r0, r1);
}

template <int F>
__global__ void __launch_bounds__(NT) block_phase_b(CoordArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                  // P * F
  float* Ws = S + P * F;                            // KC * F
  int* cols = reinterpret_cast<int*>(Ws + KC * F);  // N

  coord_tile<F>(g, blockIdx.y, blockIdx.x * TI, S, Ws, cols);
  zero_rows_past_grid(g.out, (size_t)blockIdx.y * g.N, g.N, 3);
}

template <int F>
int launch(const PhaseA& a, const CoordArgs& b, int B, cudaStream_t stream) {
  const int N = a.gcl.N;
  const size_t smem_a = dynamic_smem<F>(N) + sizeof(float) * (size_t)RB * F;
  const size_t smem_b = dynamic_smem<F>(N);
  cudaError_t err = cudaFuncSetAttribute(
      block_phase_a<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      block_phase_b<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  if (a.rb <= 0 || a.rb > RB || a.rb % TI != 0) return (int)cudaErrorInvalidValue;
  block_phase_a<F><<<dim3((N + a.rb - 1) / a.rb, B), NT, smem_a, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // same stream: phase B starts when every block of phase A has finished
  block_phase_b<F><<<row_tile_grid(N, b.update_rows, B), NT, smem_b, stream>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: 4*B*N*F + 2*F floats (la_row, la_col, lc_row, lc_col, the two deltas).
extern "C" int block_fused_forward(
    const float* h, const float* a_row, const float* a_col, const float* x,
    const float* x0, const float* mask, const float* is_lig,
    const float* w_d2, const float* w_d20, const float* delta, const float* w2,
    const float* b2, const float* w_att, const float* b_att,
    const float* nw_h, const float* nw_a, const float* nb0, const float* nw2,
    const float* nb2,
    const float* lk_i, const float* lk_j, const float* lb0, const float* lw_d2,
    const float* lw_d20, const float* ltb, const float* lw1, const float* lb1,
    const float* lw3,
    const float* ck_i, const float* ck_j, const float* cb0, const float* cw_d2,
    const float* cw_d20, const float* ctb, const float* cw1, const float* cb1,
    const float* cw3,
    const float* graph_mean, float* scratch,
    int use_tanh, float coords_range, float norm_constant, float nf,
    float cut_ll, float cut_pp, float cut_lp,
    int B, int N, int F, int update_rows, int rows_per_block, float* out_h,
    float* out_dx, void* stream) {
  const size_t plane = (size_t)B * N * F;
  float* la_row = scratch;
  float* la_col = scratch + plane;
  float* lc_row = scratch + 2 * plane;
  float* lc_col = scratch + 3 * plane;
  float* l_delta = scratch + 4 * plane;
  float* c_delta = l_delta + F;
  const Cutoffs cut{cut_ll, cut_pp, cut_lp};
  const bool has_cross = ck_i != nullptr;

  PhaseA a;
  a.gcl = GclArgs{PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w_att}, b_att,
                  x, x0, mask, mask, is_lig, cut, nf, N, N, nullptr};
  a.h = h; a.w_h = nw_h; a.w_a = nw_a; a.nb0 = nb0; a.nw2 = nw2; a.nb2 = nb2;
  a.coord = Head{lk_i, lk_j, lb0, ltb, la_row, la_col, l_delta};
  a.cross = Head{ck_i, ck_j, cb0, ctb, lc_row, lc_col, c_delta};
  a.rb = rows_per_block;
  a.out_h = out_h;

  CoordArgs b;
  b.coord = PairMlp{la_row, la_col, lw_d2, lw_d20, ltb ? l_delta : nullptr, lw1, lb1,
                    lw3};
  b.cross = PairMlp{has_cross ? lc_row : nullptr, lc_col, cw_d2, cw_d20,
                    has_cross && ctb ? c_delta : nullptr, cw1, cb1, cw3};
  b.x = x; b.x0 = x0; b.mask = mask; b.is_lig = is_lig; b.graph_mean = graph_mean;
  b.use_tanh = use_tanh; b.coords_range = coords_range;
  b.norm_constant = norm_constant; b.nf = nf; b.cut = cut;
  b.N = N; b.update_rows = update_rows; b.out = out_dx;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 64: return launch<64>(a, b, B, s);
    case 256: return launch<256>(a, b, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
