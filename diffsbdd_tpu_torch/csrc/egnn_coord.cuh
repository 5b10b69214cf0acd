// The coordinate update over blockIdx.z, shared by coord_agg.cu and
// block_fused.cu's phase B; f32-grade, for sm_90a.
//
// With the cross branch, block (x, y, z) runs pair MLP z (0: coordinate, 1:
// cross; mma::coord_tile_tc) on row tile x of batch item y and writes the row
// sums of its term to slab z of `partial` (2 x (B, N, 3) floats), and a
// second kernel adds the two slabs in a fixed order.  Without it the grid has
// one z and writes the output directly.  A block owns its rows, so nothing
// needs atomics and the result is deterministic.  At F = 2048 (4096) each row
// tile and pair MLP runs on a cluster of two (four) blocks
// (mma::coord_tile_cluster, coord_tile_wide), and the kernel and its launch
// are shared whole (coord_agg_cluster_kernel).
#pragma once
#include "egnn_cluster.cuh"
#include "egnn_mma.cuh"

namespace egnn {

// One block of the update: row tile blockIdx.x of batch item blockIdx.y, the
// pair MLP of blockIdx.z, and the block's share of the zeros of the rows past
// the grid.  g is the kernel's own argument (its out is set to the slab).
// smem: mma::dynamic_smem<F>(N) bytes.  TIER: coord_tile_tc's.
template <int F, bool CROSS, int TIER = mma::TF32X3>
__device__ __forceinline__ void coord_update_block(CoordArgs& g, float* partial,
                                                   float* smem) {
  constexpr int TI = tile_rows<F>();
  const int i0 = blockIdx.x * TI;
  if constexpr (CROSS) {
    g.out = partial + (size_t)blockIdx.z * gridDim.y * g.N * 3;
    if (blockIdx.z == 0)
      mma::coord_tile_tc<F, false, TIER>(g, blockIdx.y, i0, smem);
    else
      mma::coord_tile_tc<F, true, TIER>(g, blockIdx.y, i0, smem);
  } else {
    mma::coord_tile_tc<F, false, TIER>(g, blockIdx.y, i0, smem);
  }
  zero_rows_past_grid<TI>(g.out, (size_t)blockIdx.y * g.N, g.N, 3);
}

// out = partial[0] + partial[1], n floats each
__global__ void add_partials(const float* partial, size_t n, float* out) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x)
    out[e] = partial[e] + partial[n + e];
}

// add_partials on `stream`: out = partial[0] + partial[1], n floats each.
inline void launch_add_partials(const float* partial, size_t n, float* out,
                                cudaStream_t stream) {
  const int blocks = (int)((n + NT - 1) / NT < 1024 ? (n + NT - 1) / NT : 1024);
  add_partials<<<blocks, NT, 0, stream>>>(partial, n, out);
}

// Launches `kernel`, whose blocks are coord_update_block<F, CROSS>, on the row
// tiles below update_rows (times the 2 pair MLPs with CROSS), then with CROSS
// the sum of the two slabs into g.out.  Returns the CUDA error code.
template <int F, bool CROSS>
int launch_coord_update(void (*kernel)(CoordArgs, float*), const CoordArgs& g, int B,
                        float* partial, cudaStream_t stream) {
  const size_t smem = mma::dynamic_smem<F>(g.N);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid = row_tile_grid(g.N, g.update_rows, B, tile_rows<F>());
  grid.z = CROSS ? 2 : 1;
  kernel<<<grid, NT, smem, stream>>>(g, partial);
  if constexpr (CROSS) launch_add_partials(partial, (size_t)B * g.N * 3, g.out, stream);
  return (int)cudaGetLastError();
}

}  // namespace egnn

// F = 2048: the update on clusters of two blocks, one kernel for both
// libraries.  It lives in the including file's anonymous namespace, as that
// file's own kernels do, so each library names it as its own.
namespace {

// Row tile cluster_tile<F>() of batch item blockIdx.y on a cluster of two
// blocks (four at F = 4096), the pair MLP of blockIdx.z as in
// coord_update_block.
template <int F, bool CROSS>
__global__ void __launch_bounds__(egnn::NT)
    coord_agg_cluster_kernel(egnn::CoordArgs g, float* partial) {
  using namespace egnn;
  extern __shared__ __align__(16) float smem[];
  const int i0 = cluster_tile<F>() * tile_rows<F>();
  if constexpr (cluster_size<F>() > 2) {
    if constexpr (CROSS) {
      g.out = partial + (size_t)blockIdx.z * gridDim.y * g.N * 3;
      if (blockIdx.z == 0)
        mma::coord_tile_wide<F, false, mma::kTier>(g, blockIdx.y, i0, smem);
      else
        mma::coord_tile_wide<F, true, mma::kTier>(g, blockIdx.y, i0, smem);
    } else {
      mma::coord_tile_wide<F, false, mma::kTier>(g, blockIdx.y, i0, smem);
    }
  } else if constexpr (CROSS) {
    g.out = partial + (size_t)blockIdx.z * gridDim.y * g.N * 3;
    if (blockIdx.z == 0)
      mma::coord_tile_cluster<F, false, mma::kTier>(g, blockIdx.y, i0, smem);
    else
      mma::coord_tile_cluster<F, true, mma::kTier>(g, blockIdx.y, i0, smem);
  } else {
    mma::coord_tile_cluster<F, false, mma::kTier>(g, blockIdx.y, i0, smem);
  }
  zero_rows_past_clusters<F>(g.out, (size_t)blockIdx.y * g.N, g.N, 3);
}

// launch_coord_update on clusters: the row tiles (times the 2 pair MLPs with
// CROSS) in clusters of cluster_size<F>() blocks, then with CROSS the sum of
// the two slabs into g.out.  Returns the CUDA error code.
template <int F, bool CROSS>
int launch_cluster_update(const egnn::CoordArgs& g, int B, float* partial,
                          cudaStream_t stream) {
  using namespace egnn;
  dim3 grid = row_tile_grid(g.N, g.update_rows, B, tile_rows<F>());
  grid.x *= cluster_size<F>();
  grid.z = CROSS ? 2 : 1;
  const int err = launch_clusters<cluster_size<F>()>(
      coord_agg_cluster_kernel<F, CROSS>, grid, mma::dynamic_smem<F>(g.N), stream, g, partial);
  if (err != 0) return err;
  if constexpr (CROSS) launch_add_partials(partial, (size_t)B * g.N * 3, g.out, stream);
  return (int)cudaGetLastError();
}

}  // namespace
