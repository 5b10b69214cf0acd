// Device code shared by the two backward kernels, gcl_agg_bwd.cu and
// coord_agg_bwd.cu, for sm_90a: what they add up and how.
//
// Both run their pair MLPs on the tensor cores (egnn_mma_bwd.cuh) and sum
// across blocks the same way.  Hopper blocks run in no order, so nothing is
// carried from block to block.  The grid is (Q, B): block (q, b) walks the row
// tiles q, q + Q, ... of batch b and owns one slab of global scratch for every
// sum that crosses row tiles -- da_col and the column-side dx/dx0 of its
// batch, dmean, and every weight cotangent.  It adds into its slab without
// atomics (one thread per address between two block syncs), and a second
// kernel (reduce_partials) sums the slabs in index order.  The result is
// deterministic: no atomics anywhere.  At F = 2048 a row tile runs on a
// cluster of two blocks (egnn_cluster_bwd.cuh) and a slab is the
// cluster's: q counts clusters, and each block writes only its own
// features' parts (its columns of dW2 and da_col, its halves of the
// vectors), rank 0 what both hold alike (dx/dx0, dmean, the head bias).
//
// Held here: the slab layout of a pair MLP's weight cotangents (weight_slab),
// the per-thread and per-pair sums (FeatAcc, PairD2), the scatter of the
// per-pair coordinate cotangents into the dx/dx0 slab (scatter_dx) and the
// summing kernel (reduce_partials).
#pragma once
#include "egnn_common.cuh"

namespace egnn {

// One block's weight-cotangent slab of one pair MLP, in floats:
// [dW2: F*F][dw_d2: F][dw_d20: F][ddelta: F][db2: F][dhead: F][dhead_bias: 1, padded to F]
__host__ __device__ constexpr size_t weight_slab(int F) { return (size_t)F * F + 6 * (size_t)F; }

// A thread's share of the vector cotangents of the feature it fills
// (egnn_mma_bwd.cuh's fill layout), summed over every chunk the block visits;
// head is unused (the head's cotangent is summed in shared memory).
struct FeatAcc { float w_d2, w_d20, delta, b2, head; };
template <int E>
struct FeatAccs { FeatAcc a[E]; };  // F = 1024's upper features' sums

// Per-pair cotangents of the two squared distances from one MLP's chunk of P
// pairs.
template <int P>
struct PairD2 { float dd2[P], dd20[P]; };

// Adds the chunk's per-pair coordinate cotangents into the block's (N, 6) slab
// [dx: 3, dx0: 3]: rowc[p] goes to the pair's row node, colc[p] to its column
// node; both are zero for pairs without an edge.  Rows first, then columns: a
// node can be both in one chunk.  Must be called by every thread, after a sync
// that completes rowc and colc.
template <int TI>
__device__ __forceinline__ void scatter_dx(const float (*rowc)[6], const float (*colc)[6],
                                           const int* cols, int count, int c0, int i0,
                                           int N, float* dx_part) {
  const int t = threadIdx.x;
  if (t < TI * 6) {
    const int row = t / 6, a = t % 6, i = i0 + row;
    if (i < N) {
      float s = 0.0f;
      for (int jj = 0; jj < TJ; ++jj) s += rowc[row * TJ + jj][a];
      dx_part[(size_t)i * 6 + a] += s;
    }
  }
  __syncthreads();
  if (t < TJ * 6) {
    const int jj = t / 6, a = t % 6;
    if (c0 + jj < count) {
      float s = 0.0f;
      for (int row = 0; row < TI; ++row) s += colc[row * TJ + jj][a];
      dx_part[(size_t)cols[c0 + jj] * 6 + a] += s;
    }
  }
  __syncthreads();
}

// out[o][e] = sum_q part[o][q][e], q ascending: the second pass over the
// blocks' slabs.
static __global__ void reduce_partials_kernel(const float* part, float* out, int n_part,
                                              size_t len) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  const float* p = part + (size_t)blockIdx.y * n_part * len + e;
  float s = 0.0f;
  for (int q = 0; q < n_part; ++q) s += p[(size_t)q * len];
  out[(size_t)blockIdx.y * len + e] = s;
}

inline void reduce_partials(const float* part, float* out, int outer, int n_part,
                            size_t len, cudaStream_t stream) {
  const dim3 grid((unsigned)((len + 255) / 256), outer);
  reduce_partials_kernel<<<grid, 256, 0, stream>>>(part, out, n_part, len);
}

}  // namespace egnn
