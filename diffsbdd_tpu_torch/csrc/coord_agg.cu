// Equivariant coordinate update aggregation, f32, for sm_90a.
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
// input coordinates x0.
//
// What bounds it on an H100: two per-pair F x F products (coordinate and cross
// MLPs), 2 * 2*F^2 f32 operations per active pair -- bound by operations.
//
// Design: the tiling of egnn_common.cuh, as in gcl_agg.cu.  The two MLPs run
// one after the other on the same shared-memory tile; the per-pair head values
// are reduced across the warp and the 3-vector contributions are summed per
// row in a fixed order, so the result is deterministic.  Rows >= update_rows
// are written as zeros (the conditional model updates ligand rows only, and
// nodes are ligand-first).
#include "egnn_fwd.cuh"

namespace {

using namespace egnn;

// The row-tile body (coord_tile) is in egnn_fwd.cuh; the whole-block kernel
// runs the same body.
template <int F>
__global__ void __launch_bounds__(NT) coord_agg_kernel(CoordArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                  // P * F
  float* Ws = S + P * F;                            // KC * F
  int* cols = reinterpret_cast<int*>(Ws + KC * F);  // N

  coord_tile<F>(g, blockIdx.y, blockIdx.x * TI, S, Ws, cols);
  zero_rows_past_grid(g.out, (size_t)blockIdx.y * g.N, g.N, 3);
}

template <int F>
int launch(const CoordArgs& g, int B, cudaStream_t stream) {
  const size_t smem = dynamic_smem<F>(g.N);
  cudaError_t err = cudaFuncSetAttribute(
      coord_agg_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  coord_agg_kernel<F><<<row_tile_grid(g.N, g.update_rows, B), NT, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coord_agg_forward(
    const float* a_row, const float* a_col, const float* w_d2, const float* w_d20,
    const float* delta, const float* w2, const float* b2, const float* w3,
    const float* c_row, const float* c_col, const float* cw_d2, const float* cw_d20,
    const float* c_delta, const float* cw2, const float* cb2, const float* cw3,
    const float* x, const float* x0, const float* mask, const float* is_lig,
    const float* graph_mean, int use_tanh, float coords_range,
    float norm_constant, float nf, float cut_ll, float cut_pp, float cut_lp,
    int B, int N, int F, int update_rows, float* out, void* stream) {
  CoordArgs g;
  g.coord = PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w3};
  g.cross = PairMlp{c_row, c_col, cw_d2, cw_d20, c_delta, cw2, cb2, cw3};
  g.x = x; g.x0 = x0; g.mask = mask; g.is_lig = is_lig; g.graph_mean = graph_mean;
  g.use_tanh = use_tanh; g.coords_range = coords_range;
  g.norm_constant = norm_constant; g.nf = nf;
  g.cut = Cutoffs{cut_ll, cut_pp, cut_lp};
  g.N = N; g.update_rows = update_rows; g.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 64: return launch<64>(g, B, s);
    case 256: return launch<256>(g, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
