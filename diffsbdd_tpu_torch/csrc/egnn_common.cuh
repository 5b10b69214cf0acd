// Device code shared by every kernel: the forward kernels gcl_agg.cu,
// coord_agg.cu and block_fused.cu through egnn_mma.cuh, the backward kernels
// through egnn_bwd.cuh; for sm_90a.
//
// All kernels tile the same way: a block works on one tile of TI rows (below
// update_rows) of one batch item at a time, TI = 4, 2 at F = 512 and 1 at
// F = 1024 (tile_rows), where a chunk of 64 (32) pairs and its stages would
// not fit a block's shared memory.  It first compacts the columns adjacent to any of
// its rows (cutoffs on the EGNN input coordinates x0, ascending j), then
// walks them in chunks of TJ columns = P = TI * TJ pairs.  For each chunk it
// computes the pair geometry and the first two layers of a pair MLP:
//
//   pre_ij = a_row_i + a_col_j + d2_ij*w_d2 + d20_ij*w_d20 [+ lig_i*lig_j*delta]
//   acc_ij = silu(pre_ij) @ W2
//
// with silu(pre) of the chunk's P pairs in shared memory and W2 (256 KB at
// F = 256, more than a block's shared memory) streamed in stages; the
// product runs on the tensor cores (egnn_mma.cuh, egnn_mma_bwd.cuh).  The
// kernels differ in what they do with acc (their epilogues).
#pragma once
#include <cuda_runtime.h>

namespace egnn {

constexpr int TJ = 16;              // compacted columns per chunk
constexpr int NT = 256;             // threads per block (8 warps)

// Rows per tile at hidden width F; a chunk has TI * TJ pairs.
template <int F>
__host__ __device__ constexpr int tile_rows() { return F > 512 ? 1 : F > 256 ? 2 : 4; }

struct Cutoffs { float ll, pp, lp; };  // squared distance cutoffs, < 0 for none

// Adjacency of one (row, col) pair: the product of the two validity masks and
// the distance cutoff of the pair's type.
__device__ __forceinline__ float pair_adj(float mi, float mj, float li, float lj,
                                          float d20, const Cutoffs& c) {
  float ll = li * lj;
  float pp = (1.0f - li) * (1.0f - lj);
  float cr = 1.0f - ll - pp;
  float ok = ll * ((c.ll < 0.0f || d20 <= c.ll) ? 1.0f : 0.0f)
           + pp * ((c.pp < 0.0f || d20 <= c.pp) ? 1.0f : 0.0f)
           + cr * ((c.lp < 0.0f || d20 <= c.lp) ? 1.0f : 0.0f);
  return mi * mj * ok;
}

// One pair MLP: its first layer split into row/column projections, its second
// layer, and the head its kernel applies to silu(acc + b2).
struct PairMlp {
  const float* a_row;  // (B, N, F), first-layer bias and type terms folded in
  const float* a_col;  // (B, N, F)
  const float* w_d2;   // (F)
  const float* w_d20;  // (F)
  const float* delta;  // (F) or null: rank-1 ligand-ligand type term
  const float* w2;     // (F, F) row-major, input-major (x @ w2)
  const float* b2;     // (F)
  const float* head;   // (F) attention weights (GCL, null without attention)
                       // or the coordinate head
};

template <int TI>
struct Rows {  // the block's TI rows
  float x[TI][3], x0[TI][3], mask[TI], lig[TI];
};

template <int TI>
struct Chunk {  // pair p: row p / TJ, compacted column p % TJ
  static constexpr int P = TI * TJ;
  float d2[P], d20[P], adj[P], ll[P];
  int j[P];  // -1: no edge (past the last column, or adjacency 0)
};

// Threads t < TI load row i0 + t.  Rows >= min(N, update_rows) get mask 0 and
// so no edges; their output is zero.
template <int TI>
__device__ __forceinline__ void load_rows(Rows<TI>& r, const float* x, const float* x0,
                                          const float* mask, const float* is_lig,
                                          size_t node0, int i0, int N,
                                          int update_rows) {
  const int t = threadIdx.x;
  if (t >= TI) return;
  const int i = i0 + t;
  const bool live = i < N && i < update_rows;
  for (int a = 0; a < 3; ++a) {
    r.x[t][a] = live ? x[(node0 + i) * 3 + a] : 0.0f;
    r.x0[t][a] = live ? x0[(node0 + i) * 3 + a] : 0.0f;
  }
  r.mask[t] = live ? mask[node0 + i] : 0.0f;
  r.lig[t] = live ? is_lig[node0 + i] : 0.0f;
}

// Writes every column adjacent to any of the block's rows to cols, in
// ascending order (a ballot and a prefix count per warp), and returns their
// number.  The rows must be loaded and synced.  With `pairs` (count_pairs_kernel
// alone passes it; in the kernels it is a constant null, and the counting
// compiles away), it adds the tile's pairs inside the cutoffs (both ends
// valid, rows below update_rows) to pairs[0] and the pairs its chunks hold,
// TI rows x TJ columns a chunk, to pairs[1]: one atomic each a tile.
template <int TI>
__device__ __forceinline__ int compact_columns(const Rows<TI>& r, const float* x0,
                                               const float* col_mask,
                                               const float* is_lig, size_t node0,
                                               int N, const Cutoffs& cut, int* cols,
                                               unsigned long long* pairs = nullptr) {
  __shared__ int warp_tot[NT / 32];
  __shared__ int n_active;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) n_active = 0;
  __syncthreads();
  int inside = 0;  // this thread's pairs inside the cutoffs
  for (int base = 0; base < N; base += NT) {
    const int j = base + t;
    bool act = false;
    if (j < N) {
      float mj = col_mask[node0 + j], lj = is_lig[node0 + j];
      float xj0 = x0[(node0 + j) * 3], xj1 = x0[(node0 + j) * 3 + 1],
            xj2 = x0[(node0 + j) * 3 + 2];
      for (int k = 0; k < TI; ++k) {
        float d0 = r.x0[k][0] - xj0, d1 = r.x0[k][1] - xj1, d2 = r.x0[k][2] - xj2;
        const bool adj = pair_adj(r.mask[k], mj, r.lig[k], lj,
                                  d0 * d0 + d1 * d1 + d2 * d2, cut) != 0.0f;
        act |= adj;
        inside += adj;
      }
    }
    unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (lane == 0) warp_tot[warp] = __popc(ballot);
    __syncthreads();
    int off = n_active;
    for (int w = 0; w < warp; ++w) off += warp_tot[w];
    if (act) cols[off + __popc(ballot & ((1u << lane) - 1u))] = j;
    __syncthreads();
    if (t == 0) {
      int tot = 0;
      for (int w = 0; w < NT / 32; ++w) tot += warp_tot[w];
      n_active += tot;
    }
    __syncthreads();
  }
  if (pairs != nullptr) {  // uniform over the block
    inside = __reduce_add_sync(0xffffffffu, inside);
    if (lane == 0) warp_tot[warp] = inside;
    __syncthreads();
    if (t == 0) {
      unsigned long long tot = 0;
      for (int w = 0; w < NT / 32; ++w) tot += (unsigned long long)warp_tot[w];
      atomicAdd(pairs, tot);
      atomicAdd(pairs + 1, (unsigned long long)TI * TJ * ((n_active + TJ - 1) / TJ));
    }
  }
  return n_active;
}

// Threads t < P fill pair t of the chunk that starts at compacted column c0:
// d2 from the current coordinates x, d20 and the adjacency from x0.
template <int TI>
__device__ __forceinline__ void fill_chunk(Chunk<TI>& c, const Rows<TI>& r, const float* x,
                                           const float* x0, const float* col_mask,
                                           const float* is_lig, size_t node0,
                                           const int* cols, int count, int c0,
                                           const Cutoffs& cut) {
  const int t = threadIdx.x;
  if (t >= Chunk<TI>::P) return;
  const int k = t / TJ, idx = c0 + t % TJ;
  int j = idx < count ? cols[idx] : -1;
  float d2 = 0.0f, d20 = 0.0f, adj = 0.0f, ll = 0.0f;
  if (j >= 0) {
    const float* xj = x + (node0 + j) * 3;
    const float* x0j = x0 + (node0 + j) * 3;
    float e0 = r.x[k][0] - xj[0], e1 = r.x[k][1] - xj[1], e2 = r.x[k][2] - xj[2];
    d2 = e0 * e0 + e1 * e1 + e2 * e2;
    float f0 = r.x0[k][0] - x0j[0], f1 = r.x0[k][1] - x0j[1], f2 = r.x0[k][2] - x0j[2];
    d20 = f0 * f0 + f1 * f1 + f2 * f2;
    float lj = is_lig[node0 + j];
    adj = pair_adj(r.mask[k], col_mask[node0 + j], r.lig[k], lj, d20, cut);
    ll = r.lig[k] * lj;
    // a column adjacent to another row of the tile, or a dead row
    if (adj == 0.0f) j = -1;
  }
  c.d2[t] = d2; c.d20[t] = d20; c.adj[t] = adj; c.ll[t] = ll; c.j[t] = j;
}

// Feature k's first-layer weights of the pair terms, held by the thread that
// computes pre[.][k].
struct PairWeights { float w_d2, w_d20, delta; };

__device__ __forceinline__ PairWeights pair_weights(const PairMlp& m, int k) {
  return PairWeights{m.w_d2[k], m.w_d20[k], m.delta ? m.delta[k] : 0.0f};
}

// Rows >= update_rows have no edges, so the grid covers only the row tiles
// below update_rows (dead blocks would crowd the live ones onto fewer SMs);
// the blocks share the zeroing of the rows past their tiles, W floats a row.
inline dim3 row_tile_grid(int N, int update_rows, int B, int TI) {
  const int rows = update_rows < N ? update_rows : N;
  const int tiles = (rows + TI - 1) / TI;
  return dim3(tiles > 0 ? tiles : 1, B);
}

// The pair counts of a launch: one block per row tile below update_rows of
// one batch item (blockIdx.x, blockIdx.y: the kernels' tiles, row_tile_grid)
// runs compact_columns, the compaction that sets the chunks every kernel
// walks, with its counting on.  A tile is counted once whatever the kernel
// does with it (a cluster of blocks, two pair MLPs, two passes).  The
// kernels themselves are not touched: their code is the same with a counter
// or without.  Dynamic shared memory: N ints.
template <int TI>
__global__ void __launch_bounds__(NT)
    count_pairs_kernel(const float* x0, const float* mask, const float* col_mask,
                       const float* is_lig, Cutoffs cut, int N, int update_rows,
                       unsigned long long* pairs) {
  extern __shared__ int count_cols[];
  __shared__ Rows<TI> rows;
  const size_t node0 = (size_t)blockIdx.y * N;
  load_rows(rows, x0, x0, mask, is_lig, node0, blockIdx.x * TI, N, update_rows);
  __syncthreads();
  compact_columns(rows, x0, col_mask, is_lig, node0, N, cut, count_cols, pairs);
}

template <int TI>
int launch_count_pairs(const float* x0, const float* mask, const float* col_mask,
                       const float* is_lig, Cutoffs cut, int B, int N, int update_rows,
                       unsigned long long* pairs, cudaStream_t stream) {
  const size_t smem = (size_t)N * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      count_pairs_kernel<TI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  count_pairs_kernel<TI><<<row_tile_grid(N, update_rows, B, TI), NT, smem, stream>>>(
      x0, mask, col_mask, is_lig, cut, N, update_rows, pairs);
  return (int)cudaGetLastError();
}

// Adds the pairs of a launch at hidden width F (64, 128, ..., 4096) to
// pairs[0] (inside the cutoffs) and pairs[1] (held by its chunks), on
// `stream`.  Returns the CUDA error code.
inline int launch_count_pairs(int F, const float* x0, const float* mask,
                              const float* col_mask, const float* is_lig, Cutoffs cut,
                              int B, int N, int update_rows, unsigned long long* pairs,
                              cudaStream_t stream) {
  if (F < 64 || F > 4096 || (F & (F - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (F > 512)
    return launch_count_pairs<tile_rows<1024>()>(x0, mask, col_mask, is_lig, cut, B, N,
                                                 update_rows, pairs, stream);
  if (F > 256)
    return launch_count_pairs<tile_rows<512>()>(x0, mask, col_mask, is_lig, cut, B, N,
                                                update_rows, pairs, stream);
  return launch_count_pairs<tile_rows<256>()>(x0, mask, col_mask, is_lig, cut, B, N,
                                              update_rows, pairs, stream);
}

template <int TI>
__device__ __forceinline__ void zero_rows_past_grid(float* out, size_t node0, int N,
                                                    int W) {
  const int tail0 = gridDim.x * TI;
  if (tail0 >= N) return;
  float* tail = out + (node0 + tail0) * W;
  const int n = (N - tail0) * W;
  for (int e = blockIdx.x * NT + threadIdx.x; e < n; e += gridDim.x * NT)
    tail[e] = 0.0f;
}

}  // namespace egnn
