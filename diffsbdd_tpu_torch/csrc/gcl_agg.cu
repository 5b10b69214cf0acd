// GCL message aggregation for one EGNN layer, f32-grade, for sm_90a.
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
// What bounds it on an H100: the per-pair F x F product, 2*F^2 of the 2*F^2 +
// 10*F operations a pair, against ~1 KB of row/column projections a pair.  It
// runs on the tensor cores in 3xTF32 (egnn_mma.cuh): 3 * 2*F^2 tensor-core
// operations a pair at 495 TFLOP/s (mma.sync reaches about half of that rate;
// wgmma the rest).  The bytes that compete with them are not HBM's but L2's
// and shared memory's: every chunk of P = 64 pairs streams all of W2 (256 KB
// at F = 256, 4 KB a pair; at F = 512 1 MB a chunk of 32 pairs, 32 KB a pair;
// at F = 1024 4 MB a chunk of 16 pairs, 256 KB a pair: egnn_mma.cuh's
// Layout) from L2, every warp loads its A and B fragments
// from shared memory, and the fill of S reads a 16 x F tile of a_col a chunk.
//
// Design, on the tiling of egnn_common.cuh:
// * one block per (batch, tile of TI rows below update_rows); the block owns
//   its rows, so the row sums need no atomics and are deterministic;
// * only the compacted active columns are visited -- inactive pairs cost
//   nothing, which replaces the TPU kernels' block-activity bits and
//   prefetched index lists;
// * silu(pre) @ W2 on the tensor cores, mma.sync.m16n8k8 TF32 with each
//   operand split into hi + lo TF32 parts (the TPU kernel's bf16_3x tier,
//   _dot at diffsbdd_tpu/ops/egnn_pallas.py:283, in Hopper's format), so the
//   result stays f32-grade (the library built with -DEGNN_TIER=1 drops W2's
//   low part, 2xTF32; with -DEGNN_TIER=2 it runs one bf16 pass, m16n8k16,
//   and rounds the pair MLP to bf16 as the TPU kernel's bfloat16 tier does:
//   egnn_mma.cuh's tiers); W2 is split in registers as its fragments load:
//   no extra bytes, where a split hoisted into the wrapper (W2_hi, W2_lo)
//   doubles the L2 stream and the shared-memory loads (measured slower);
// * W2 through a ring of 2 cp.async stages of 32 rows, the next in flight
//   while the tensor cores work on one, one block sync a stage;
// * a warp owns two rows' 32 pairs and a quarter of the features: the gated
//   row sums stay in registers across chunks;
// * the fill of S is branch-free, takes a_row from registers and a_col
//   loaded a chunk ahead, and silu and sigmoid run on the SFU (ex2, rcp);
// * F = 2048 runs each row tile on a cluster of two blocks, each owning half
//   of the output features (egnn_cluster.cuh: W2 at 16 MB, 8 MB a chunk a
//   block; the attention dot summed over the two blocks); F = 4096 on a
//   cluster of four, each owning a quarter and filling a quarter of S, the
//   product walking K through the peers' quarters (W2 at 64 MB, over the
//   50 MB L2, 16 MB a chunk a block).
#include "egnn_cluster.cuh"

namespace {

using namespace egnn;

// The row-tile body (gcl_tile_tc) is in egnn_mma.cuh.
template <int F>
__global__ void __launch_bounds__(NT) gcl_agg_kernel(GclArgs g) {
  constexpr int TI = tile_rows<F>();
  extern __shared__ __align__(16) float smem[];
  const int i0 = blockIdx.x * TI;
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const int left = g.N - i0;
  mma::gcl_tile_tc<F, F, mma::kTier>(g, node0, i0, smem, g.out + (node0 + i0) * F,
                                     left < TI ? left : TI);
  zero_rows_past_grid<TI>(g.out, node0, g.N, F);
}

// F = 2048 (4096): a cluster of two (four) blocks a row tile
// (egnn_cluster.cuh), block r of the cluster writing features [1024 r,
// 1024 r + 1024) of the row.
template <int F>
__global__ void __launch_bounds__(NT) gcl_agg_cluster_kernel(GclArgs g) {
  constexpr int TI = tile_rows<F>();
  extern __shared__ __align__(16) float smem[];
  const int i0 = cluster_tile<F>() * TI;
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const int left = g.N - i0;
  if constexpr (cluster_size<F>() > 2)
    mma::gcl_tile_wide<F, mma::kTier>(g, node0, i0, smem, g.out + (node0 + i0) * F,
                                      left < TI ? left : TI);
  else
    mma::gcl_tile_cluster<F, mma::kTier>(g, node0, i0, smem, g.out + (node0 + i0) * F,
                                         left < TI ? left : TI);
  zero_rows_past_clusters<F>(g.out, node0, g.N, F);
}

template <int F>
int launch(const GclArgs& g, int B, cudaStream_t stream) {
  const size_t smem = mma::dynamic_smem<F>(g.N);
  if constexpr (cluster_size<F>() > 1) {
    dim3 grid = row_tile_grid(g.N, g.update_rows, B, tile_rows<F>());
    grid.x *= cluster_size<F>();
    return launch_clusters<cluster_size<F>()>(gcl_agg_cluster_kernel<F>, grid, smem,
                                              stream, g);
  } else {
    last_cluster_dim() = 1;
    cudaError_t err = cudaFuncSetAttribute(
        gcl_agg_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gcl_agg_kernel<F><<<row_tile_grid(g.N, g.update_rows, B, tile_rows<F>()), NT, smem,
                        stream>>>(g);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// pairs: null, or two counters to which the launch adds its pairs
// (launch_count_pairs: egnn_common.cuh).
extern "C" int gcl_agg_forward(
    const float* a_row, const float* a_col, const float* x, const float* x0,
    const float* mask, const float* col_mask, const float* is_lig,
    const float* w_d2, const float* w_d20, const float* delta,
    const float* w2, const float* b2, const float* w_att, const float* b_att,
    float cut_ll, float cut_pp, float cut_lp, float nf,
    int B, int N, int F, int update_rows, float* out, unsigned long long* pairs,
    void* stream) {
  GclArgs g{PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w_att}, b_att,
            x, x0, mask, col_mask, is_lig, Cutoffs{cut_ll, cut_pp, cut_lp}, nf,
            N, update_rows, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr) {  // on the stream before the kernel, which reads the same inputs
    const int err = launch_count_pairs(F, x0, mask, col_mask, is_lig, g.cut, B, N,
                                       update_rows, pairs, s);
    if (err != 0) return err;
  }
  switch (F) {
    case 64: return launch<64>(g, B, s);
    case 128: return launch<128>(g, B, s);
    case 256: return launch<256>(g, B, s);
    case 512: return launch<512>(g, B, s);
    case 1024: return launch<1024>(g, B, s);
    case 2048: return launch<2048>(g, B, s);
    case 4096: return launch<4096>(g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
