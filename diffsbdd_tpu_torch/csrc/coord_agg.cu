// Equivariant coordinate update aggregation, f32-grade, for sm_90a.
//
// Replaces the Pallas TPU kernels `coord_update_agg_pallas` and its
// compact-skip launch `_coord_agg_pallas_compact`
// (diffsbdd_tpu/ops/egnn_pallas.py:1047, :959).  For every row node i:
//
//   dx_i = (1/nf) * sum_j adj_ij * [ (x_i - x_j) / (sqrt(d2_ij + 1e-8) + nc) * phi_ij
//                                  + c_ij / (sqrt(|c_ij|^2 + 1e-8) + nc) * phic_ij ]
//   phi  = tanh(silu(silu(pre_ij) @ W2 + b2) . w3) * coords_range   (tanh optional)
//   c_ij = (x_i - mean) x (x_j - mean)      (SE(3) cross branch, optional)
//
// The cross branch has its own first layer and W2; its head w3 is the coordinate
// head.  The +1e-8 guards stay: the diagonal (self-edge) and coincident nodes
// give diff = 0 and c = 0, and only the guard keeps those terms finite.
// d2 comes from the current coordinates x; d20 and the adjacency from the EGNN
// input coordinates x0.  adj_ij = mask_i * col_mask_j * (cutoff test): a column
// mask that keeps one block of the node axis gives that block's share of the
// row sums, and only its columns are visited (edge-axis sharding); the
// unsharded launch passes mask as col_mask.
//
// The C entry point takes `partial`, 2 * B * N * 3 floats of scratch that the
// caller allocates (null without the cross branch), and `pairs`, null or two
// counters to which the launch adds its pairs (launch_count_pairs:
// egnn_common.cuh; the two MLPs walk the same chunks, counted once).
//
// What bounds it on an H100: two per-pair F x F products (coordinate and cross
// MLPs), 2 * 2*F^2 of the 2 * (2*F^2 + 10*F) operations an active pair.  They
// run on the tensor cores in 3xTF32 (egnn_mma.cuh), 3 * 2 * 2*F^2 tensor-core
// operations a pair at 495 TFLOP/s (the library built with -DEGNN_TIER=1 runs
// them in 2xTF32, with -DEGNN_TIER=2 in one bf16 pass: egnn_mma.cuh's tiers); the f32 CUDA-core body before it ran at
// 8% of its 67 TFLOP/s bound.  As in gcl_agg.cu, the bytes that compete are
// L2's and shared memory's: every chunk of P = 64 pairs streams W2 (256 KB at
// F = 256; 1 MB a chunk of 32 pairs at F = 512, 4 MB a chunk of 16 at
// F = 1024) from L2 an MLP, and the fill of S reads a 16 x F tile of a_col.
//
// Design (mma::coord_tile_tc, on the tiling of egnn_common.cuh):
// * one block per (batch, tile of TI rows below update_rows, pair MLP): the
//   coordinate MLP's blocks (blockIdx.z = 0) and the cross MLP's (z = 1) each
//   write the row sums of their own term to a partial (B, N, 3) slab, and a
//   second kernel adds the two slabs in a fixed order; a block owns its rows,
//   so nothing needs atomics and the result is deterministic.  At the main
//   path's shape (24 ligand rows, B = 16) this is 192 blocks on 132 SMs
//   (one block, ~150 KB of shared memory, an SM), against 96 blocks with both
//   MLPs in one block, whose longest tiles left SMs idle: 0.47 against 0.60
//   ms on an H100 80GB HBM3 at 700 W (PERF.md);
// * per chunk of compacted columns the block fills the geometry, then S
//   (branch-free, a_row in registers, a_col loaded a chunk ahead), runs
//   silu(pre) @ W2 as mma.sync TF32 with hi + lo operand splits and W2
//   through a cp.async ring, and a head epilogue silu(acc + b2) . w3
//   (lane-quad shuffles, one exchange of the feature slices through shared
//   memory) in place of the GCL's gated row sum;
// * the per-pair terms (tanh, norms, cross product) and the row sums in a
//   fixed order close each chunk.
// Rows >= update_rows are written as zeros (the conditional model updates
// ligand rows only, and nodes are ligand-first).
// F = 2048 (4096) runs each row tile and pair MLP on a cluster of two (four)
// blocks, each owning half (a quarter) of the MLP's features
// (egnn_cluster.cuh: the head summed over the blocks, the per-pair terms and
// row sums on rank 0).
#include "egnn_cluster.cuh"
#include "egnn_coord.cuh"

namespace {

using namespace egnn;

// The block body (coord_update_block, on mma::coord_tile_tc), the launch and
// the sum of the partial slabs are in egnn_coord.cuh, and so are F = 2048's
// cluster kernel and its launch (launch_cluster_update).
template <int F, bool CROSS>
__global__ void __launch_bounds__(NT) coord_agg_kernel(CoordArgs g, float* partial) {
  extern __shared__ __align__(16) float smem[];
  coord_update_block<F, CROSS, mma::kTier>(g, partial, smem);
}

template <int F>
int launch(const CoordArgs& g, int B, float* partial, cudaStream_t stream) {
  if (g.cross.a_row != nullptr && partial == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (cluster_size<F>() > 1) {
    if (g.cross.a_row == nullptr) return launch_cluster_update<F, false>(g, B, partial, stream);
    return launch_cluster_update<F, true>(g, B, partial, stream);
  } else {
    last_cluster_dim() = 1;
    if (g.cross.a_row == nullptr)
      return launch_coord_update<F, false>(coord_agg_kernel<F, false>, g, B, partial, stream);
    return launch_coord_update<F, true>(coord_agg_kernel<F, true>, g, B, partial, stream);
  }
}

}  // namespace

extern "C" int coord_agg_forward(
    const float* a_row, const float* a_col, const float* w_d2, const float* w_d20,
    const float* delta, const float* w2, const float* b2, const float* w3,
    const float* c_row, const float* c_col, const float* cw_d2, const float* cw_d20,
    const float* c_delta, const float* cw2, const float* cb2, const float* cw3,
    const float* x, const float* x0, const float* mask, const float* col_mask,
    const float* is_lig, const float* graph_mean, int use_tanh, float coords_range,
    float norm_constant, float nf, float cut_ll, float cut_pp, float cut_lp,
    int B, int N, int F, int update_rows, float* partial, float* out,
    unsigned long long* pairs, void* stream) {
  CoordArgs g;
  g.coord = PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w3};
  g.cross = PairMlp{c_row, c_col, cw_d2, cw_d20, c_delta, cw2, cb2, cw3};
  g.x = x; g.x0 = x0; g.mask = mask; g.col_mask = col_mask; g.is_lig = is_lig;
  g.graph_mean = graph_mean;
  g.use_tanh = use_tanh; g.coords_range = coords_range;
  g.norm_constant = norm_constant; g.nf = nf;
  g.cut = Cutoffs{cut_ll, cut_pp, cut_lp};
  g.N = N; g.update_rows = update_rows; g.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr) {  // on the stream before the kernel, which reads the same inputs
    const int err = launch_count_pairs(F, x0, mask, col_mask, is_lig, g.cut, B, N,
                                       update_rows, pairs, s);
    if (err != 0) return err;
  }
  switch (F) {
    case 64: return launch<64>(g, B, partial, s);
    case 128: return launch<128>(g, B, partial, s);
    case 256: return launch<256>(g, B, partial, s);
    case 512: return launch<512>(g, B, partial, s);
    case 1024: return launch<1024>(g, B, partial, s);
    case 2048: return launch<2048>(g, B, partial, s);
    case 4096: return launch<4096>(g, B, partial, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
