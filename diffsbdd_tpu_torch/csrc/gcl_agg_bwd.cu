// Backward of the GCL message aggregation (gcl_agg.cu), f32-grade, for sm_90a.
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
// then the MLP runs backwards (egnn_bwd.cuh states the chain), and the
// squared-distance cotangents chain to the coordinates: dx_i += 2 dd2 (x_i -
// x_j), dx_j -= the same, and likewise dx0 from dd20.  The adjacency is
// piecewise constant in x0, so it carries no gradient; pairs with adjacency 0
// give exact zeros.  Rows >= update_rows are not visited, and g there is
// ignored.
//
// What bounds it on an H100: three F x F products per active pair (forward
// recompute, dW2, dm1), 6*F^2 operations against ~1 KB of projections --
// bound by operations.  They run on the tensor cores in 3xTF32
// (egnn_mma_bwd.cuh: mma.sync TF32, each operand split hi + lo), 3 * 6*F^2
// tensor-core operations a pair at 495 TFLOP/s (-DEGNN_TIER=1: 2xTF32, =2: one
// bf16 pass; egnn_mma_bwd.cuh's tiers).  Beside them: the fills and
// epilogues on the CUDA cores and the SFU, and the block's F x F dW2 slab,
// read and written through L2 once a chunk.
//
// Design: egnn_mma_bwd.cuh::gcl_bwd_tile_tc on the forward's tiling, S and D
// XOR-swizzled so that every fragment load of the three products is free of
// bank conflicts, W2 and W2^T through one cp.async ring; per-block slabs of
// global scratch plus a second summing kernel for everything that crosses row
// tiles (da_col, column-side dx/dx0, all weight cotangents), no atomics, so
// the result is deterministic.  da_row is written by the block that owns the
// rows.  F = 2048 runs each row tile on a cluster of two blocks, each owning
// half of the features (egnn_cluster_bwd.cuh: W2 at 16 MB, 8 MB a chunk a
// block and product; the pair sums over all features added over the two
// blocks; one slab a cluster), F = 4096 on a cluster of four, each owning a
// quarter and holding a quarter of K at a time (W2 at 64 MB, 16 MB a chunk
// a block and product; the peers' parts of S and dz2 through DSMEM).
#include "egnn_cluster_bwd.cuh"

namespace {

using namespace egnn;

// The row-tile body (gcl_bwd_tile_tc) is in egnn_mma_bwd.cuh.  Block (q, b)
// walks the row tiles q, q + Q, ... of batch b with one ring, one set of
// sums and slab q of its batch.
template <int F>
__global__ void __launch_bounds__(NT) gcl_agg_bwd_kernel(GclBwdArgs g) {
  using L = mma::Layout<F>;
  extern __shared__ __align__(16) float smem[];
  constexpr int P = L::P;
  float* S = smem;         // P * F
  float* D = S + P * F;    // P * F
  mma::W2BwdRing<F> ring{g.mlp.w2, g.w2t, D + P * F, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + mma::NS * L::STAGE);  // N
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const size_t slab = (size_t)blockIdx.y * gridDim.x + blockIdx.x;

  __shared__ float hvs[mma::row_groups<F>() * F];
  for (int e = threadIdx.x; e < mma::row_groups<F>() * F; e += NT) hvs[e] = 0.0f;
  mma::GclBwdState<F> st{FeatAcc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, hvs, 0.0f};
  for (int s = 0; s < mma::NS - 1; ++s) ring.issue();
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x)
    mma::gcl_bwd_tile_tc<F, mma::kTier>(g, node0, slab, tile * L::TI, S, D, cols, ring, st);
  mma::cp_async_wait_all();  // the ring's look-ahead stage
  mma::store_gcl_bwd_state<F>(st, g.w_part + slab * weight_slab(F), S);
}

// F = 2048, 4096: cluster q (blockIdx.x / C) walks the row tiles q, q + Q,
// ... of batch b = blockIdx.y, each on all C of its blocks
// (egnn_cluster_bwd.cuh), with slab q of its batch; the last cluster
// barrier keeps each block's shared memory alive until the peers have read
// it.
template <int F>
__global__ void __launch_bounds__(NT) gcl_agg_bwd_cluster_kernel(GclBwdArgs g) {
  using L = mma::Layout<F>;
  extern __shared__ __align__(16) float smem[];
  float* A = smem;                // kRegionA floats
  float* Bt = A + mma::kRegionA;  // the ring, or a P x FB tile
  int* cols = reinterpret_cast<int*>(Bt + mma::NS * L::STAGE);  // N
  const int col0 = (int)cluster_rank() * L::FB;
  const int Q = gridDim.x / cluster_size<F>();
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const size_t slab = (size_t)blockIdx.y * Q + cluster_tile<F>();

  __shared__ float hvs[L::FB];
  for (int e = threadIdx.x; e < L::FB; e += NT) hvs[e] = 0.0f;
  mma::ClusterBwdState st{};
  st.hvs = hvs;
  mma::W2BwdClusterRing<F> ring{g.mlp.w2 + col0, g.w2t + col0, Bt, 0};
  for (int tile = cluster_tile<F>(); tile < g.tiles; tile += Q)
    mma::gcl_bwd_tile_cluster<F, mma::kTier>(g, node0, slab, tile, A, Bt, cols, ring, st);
  mma::store_cluster_bwd_state<F>(st, g.w_part + slab * weight_slab(F), A, cluster_rank());
  cluster_sync();  // the peers have read this block's last shares
}

template <int F>
int launch(GclBwdArgs g, int B, int Q, float* da_col, float* dxx0, float* w_out,
           cudaStream_t stream) {
  constexpr int TI = tile_rows<F>();
  const int rows = g.update_rows < g.N ? g.update_rows : g.N;
  g.tiles = (rows + TI - 1) / TI;
  if (Q < 1 || Q > (g.tiles > 0 ? g.tiles : 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (cluster_size<F>() > 1) {
    err = (cudaError_t)launch_clusters<cluster_size<F>()>(
        gcl_agg_bwd_cluster_kernel<F>, dim3(Q * cluster_size<F>(), B),
        mma::dynamic_smem_bwd_cluster(g.N), stream, g);
    if (err != cudaSuccess) return (int)err;
  } else {
    last_cluster_dim() = 1;
    const size_t smem = mma::dynamic_smem_bwd_tc<F>(g.N);
    err = cudaFuncSetAttribute(
        gcl_agg_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gcl_agg_bwd_kernel<F><<<dim3(Q, B), NT, smem, stream>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials(g.acol_part, da_col, B, Q, (size_t)g.N * F, stream);
  reduce_partials(g.dx_part, dxx0, B, Q, (size_t)g.N * 6, stream);
  reduce_partials(g.w_part, w_out, 1, B * Q, weight_slab(F), stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Q: blocks per batch element, clusters of two at F = 2048 and of four at
// 4096 (1 <= Q <= row tiles below update_rows).  The *_part buffers and da_row must be zero on
// entry; da_col (B, N, F), dxx0 (B, N, 6) and w_out (weight_slab) are
// written in full.  pairs: null, or two counters to which the launch adds its
// pairs (launch_count_pairs: egnn_common.cuh).
extern "C" int gcl_agg_backward(
    const float* g_out, const float* a_row, const float* a_col, const float* x,
    const float* x0, const float* mask, const float* col_mask, const float* is_lig,
    const float* w_d2, const float* w_d20, const float* delta, const float* w2,
    const float* w2t, const float* b2, const float* w_att, const float* b_att,
    float cut_ll, float cut_pp, float cut_lp, float nf,
    int B, int N, int F, int update_rows, int Q,
    float* da_row, float* acol_part, float* dx_part, float* w_part,
    float* da_col, float* dxx0, float* w_out, unsigned long long* pairs, void* stream) {
  // tiles: set by launch<F>, whose row tile TI depends on F
  GclBwdArgs g{PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w_att}, b_att, w2t,
               g_out, x, x0, mask, col_mask, is_lig, Cutoffs{cut_ll, cut_pp, cut_lp},
               1.0f / nf, N, update_rows, 0, da_row, acol_part, dx_part, w_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr) {  // on the stream before the kernel, which reads the same inputs
    const int err = launch_count_pairs(F, x0, mask, col_mask, is_lig, g.cut, B, N,
                                       update_rows, pairs, s);
    if (err != 0) return err;
  }
  switch (F) {
    case 64: return launch<64>(g, B, Q, da_col, dxx0, w_out, s);
    case 128: return launch<128>(g, B, Q, da_col, dxx0, w_out, s);
    case 256: return launch<256>(g, B, Q, da_col, dxx0, w_out, s);
    case 512: return launch<512>(g, B, Q, da_col, dxx0, w_out, s);
    case 1024: return launch<1024>(g, B, Q, da_col, dxx0, w_out, s);
    case 2048: return launch<2048>(g, B, Q, da_col, dxx0, w_out, s);
    case 4096: return launch<4096>(g, B, Q, da_col, dxx0, w_out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
