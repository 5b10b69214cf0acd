// One whole EGNN block (one GCL, its node MLP, the coordinate update) behind
// one entry point, f32-grade, for sm_90a.
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
// The node MLP and the head projections run in this file's device code: up
// to F = 1024 the (B, N, F) aggregate never leaves the chip's shared memory
// (above it passes through a scratch plane, below), and h' is read back
// only as the projections phase B needs.
//
// What bounds it on an H100: the per-pair F x F products, phase A's GCL MLP
// on every active pair and phase B's coordinate and cross MLPs on the pairs
// of the rows that move, as in gcl_agg.cu and coord_agg.cu; the node MLP and
// the projections add 7 products of B*N x F x F.  Every product runs on the
// tensor cores in 3xTF32 (egnn_mma.cuh: mma.sync TF32, each operand split
// hi + lo), with its weights streamed from L2 through cp.async stages.
//
// Precision tiers.  The library is built for one tier (-DEGNN_TIER, as the
// split kernels' are; egnn_mma.cuh): 2xTF32 drops the weight's low part in
// every product, bf16 runs each as one mma.sync.m16n8k16 pass with both
// operands rounded as their fragments load (the tiles stay f32, so shared
// memory does not grow).  The pair MLPs of both phases also round at the
// JAX package's bf16 points (gcl_tile_tc, coord_tile_tc); the node MLP's
// and the projections' elementwise work (+ b0, silu, the residual, the
// mask, the head bias and the type fold) stays f32 on every tier, as the
// JAX kernel's _dot rounds the product and not its epilogue.
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
// Phase A.  A 1-D grid of G blocks (one an SM, ~207 KB of shared memory
// each; at F = 1024 S, the 8-row weight stages and AGG take 64 KB each) over
// the B*T row tiles of TI rows, taken in tile-major order (tile u
// of batch item b is tile u*B + b): block k owns tiles k, k + G, k + 2G, ...,
// at most RB/TI = 16 of them.  Dealt so, a block's tiles lie far apart in
// their graphs, and the costly ones (the ligand's rows, which see every
// ligand atom) and the free ones (the padding at each graph's end) spread
// over all blocks instead of piling up in the few that own a graph's first
// or last rows: under one wave the longest block sets the time.  A block
// runs the GCL row-tile body (mma::gcl_tile_tc) for each of its tiles, the
// aggregates going to a shared-memory tile of up to RB rows, and then the
// node MLP and the projections for all its rows at once (a product does not
// care which graph a row comes from): seven rows x F x F products (five
// without the cross head) with mma::product_tc in its one-row-group layout --
// every warp all rows and F/8 features, so that no warp idles at 24 rows --
// skipping the m-tiles of 16 rows wholly past the block's rows.  The weight
// matrices stream once per block, in product order, through one cp.async
// ring (WeightChain): each product's first stage loads during the one
// before.  h, silu(pre) and h' stay in two shared-memory tiles at the
// products' row stride, and the epilogues (silu + b0; residual, mask and
// the write of h'; head bias and type fold) work on the accumulators' C
// fragments, each row scattered to its node.
//
// Phase B.  The coordinate update of coord_agg.cu (egnn_coord.cuh): a grid of
// row tiles below update_rows, with the cross head times its 2 pair MLPs, each
// writing its own partial slab, and a third launch that adds the slabs.  dx
// rows at and above update_rows are written as zeros.
//
// F = 2048, on thread-block clusters of two blocks (egnn_cluster.cuh).  The
// GCL row-tile body alone (gcl_tile_cluster) takes 197 KB of dynamic and
// 9 KB of static shared memory a block at N = 344, so the 16 rows of
// aggregates (66 KB for a block's half, 131 KB whole) cannot stay on the chip
// beside it.  Phase A therefore runs on clusters (block_phase_a_cluster):
// * both blocks of cluster k of G walk the same row tiles k, k + G, ... (at
//   most RB_TILES of one row), and each runs gcl_tile_cluster on them, which
//   writes the block's 1024 features of a row's aggregate to a global
//   scratch plane (B*N*F floats; it stays in L2 until the node MLP reads it);
// * the node products then run over K = 2048 in the freed S region (16 x
//   2052 floats), each block computing its FB = 1024 output features from
//   those columns of each weight matrix (WeightChain<2048>, as
//   W2ClusterRing streams W2's).  The A operands: h, read whole from global
//   memory; agg, read whole from the scratch after a cluster barrier has
//   made the peer's half visible; silu(pre) and h', each block writing its
//   half into its own S and copying the peer's through distributed shared
//   memory (copy_peer_half) after a cluster barrier;
// * cluster barriers order every overwrite of S after the peer's last read
//   of it, and the block's exit after the peer's copy of its h';
// * no projection reduces over features, so each block writes only its own
//   features of out_h, la_row / la_col and lc_row / lc_col (project_head on
//   the head's pointers shifted by the block's first feature), and the
//   rank-1 type deltas are split likewise: nothing needs atomics.
// Phase B is coord_agg.cu's cluster kernel and launch on the projections
// (coord_agg_cluster_kernel, launch_cluster_update: egnn_coord.cuh; rank 0
// writes the coordinates).  Both phases launch through launch_clusters,
// which refuses when not one cluster fits the card.
//
// F = 4096, on clusters of four blocks (block_phase_a_wide; WideLayout in
// egnn_cluster.cuh, written for any C = F / 1024 > 2).  S of all K rows
// (16 x 4100 floats, 262 KB) no longer fits a block, so every node product
// walks K in C parts of 1024 rows in order, each part's k-steps
// accumulating onto the last's (mma::product_walk), in the shared memory of
// gcl_tile_wide: the block's own part buffer, a staging buffer and the
// ring's two stages (66 KB each):
// * the GCL is gcl_tile_wide on the cluster's one-row tiles, each block
//   writing its 1024 features of a row's aggregate to the scratch plane;
// * h, agg and h' lie in global memory (h' in out_h), so each part of them
//   is loaded straight into the staging buffer (load_part_rows), after a
//   fence and a cluster barrier for agg and h';
// * silu(pre) exists only as each block's quarter: each block writes its
//   own into its own buffer, and after a cluster barrier a product reads it
//   there (its part) and the peers' through DSMEM (copy_peer_part into the
//   staging buffer); the barrier after h' orders the blocks' exit after the
//   peers' copies;
// * the weight ring streams the block's 1024 columns of each matrix over
//   all F rows (WeightChain<F, true>: F / KC stages a matrix, a product
//   call taking one part's FB / KC);
// * the projections and the type deltas are split by feature as at 2048.
// Phase B is coord_agg.cu's cluster kernel at F = 4096.
#include "egnn_cluster.cuh"
#include "egnn_coord.cuh"

namespace {

using namespace egnn;

constexpr int RG = 1;  // row groups of the node products' warp layout
template <int F> using NodeLayout = mma::Layout<F, RG>;
// most rows a phase-A block owns: a chunk's P, 4 m-tiles of 16 (2 at F = 512,
// 1 at F = 1024), in RB_TILES row tiles
template <int F> constexpr int block_rows = NodeLayout<F>::P;
constexpr int RB_TILES = 16;
static_assert(block_rows<256> / tile_rows<256>() == RB_TILES &&
              block_rows<512> / tile_rows<512>() == RB_TILES &&
              block_rows<1024> / tile_rows<1024>() == RB_TILES &&
              block_rows<2048> / tile_rows<2048>() == RB_TILES &&
              block_rows<4096> / tile_rows<4096>() == RB_TILES,
              "row tiles a phase-A block (a cluster above F = 1024) owns");
template <int F>
using Acc = float[NodeLayout<F>::WM][NodeLayout<F>::NTN][4];

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
  int B;
  float* out_h;        // (B, N, F)
};

// Phase A's dynamic shared memory before its second tile: gcl_tile_tc's (S,
// which is the first tile, the ring and the column list, N rounded up to 16
// bytes); the second tile takes RB * SS floats more.
template <int F>
__host__ __device__ constexpr size_t second_tile(int N) {
  return mma::dynamic_smem<F>((N + 3) / 4 * 4) / sizeof(float);
}

// The weight matrices of phase A's products through one cp.async ring, in
// the order the products run: stage g holds rows (g % KS) * KC .. + KC of
// matrix g / KS, so each product's look-ahead stage is the next product's
// first.  Issue and acquire as mma::W2Ring's; the matrices must be 16-byte
// aligned.  (Above F = 1024, the partial specialization below.)
template <int F, bool CLUSTER = (cluster_size<F>() > 1)>
struct WeightChain {
  using L = NodeLayout<F>;
  const float* const* mats;  // shared memory: the matrices in product order
  int count;
  float* buf;                // NS * STAGE floats
  int next;                  // next stage to issue

  __device__ __forceinline__ void issue() {
    constexpr int V = F / 4;  // 16-byte vectors per row
    if (next / L::KS < count) {
      float* dst = buf + (next % mma::NS) * L::STAGE;
      const float* src = mats[next / L::KS] + (size_t)(next % L::KS) * L::KC * F;
      for (int e = threadIdx.x; e < L::KC * V; e += NT) {
        const int r = e / V, v = e % V;
        mma::cp_async16(dst + r * L::WS + 4 * v, src + (size_t)r * F + 4 * v);
      }
    }
    mma::cp_async_commit();  // an empty group past the last matrix
    ++next;
  }

  __device__ __forceinline__ const float* acquire() {
    mma::cp_async_wait<mma::NS - 2>();
    __syncthreads();
    const float* stage = buf + ((next - (mma::NS - 1)) % mma::NS) * L::STAGE;
    issue();
    return stage;
  }
};

// Above F = 1024: the ring of one block of a cluster, which streams the FB
// columns [col0, col0 + FB) of each matrix (all K = F rows), as
// W2ClusterRing does W2's: stage g holds rows (g % MS) * KC .. + KC of
// matrix g / MS, MS = F / KC stages a matrix (at 2048 one product call's
// KS; at 4096 a product call takes one part of K, KS = FB / KC, and
// product_walk four of them).  As WeightChain otherwise.
template <int F>
struct WeightChain<F, true> {
  using L = NodeLayout<F>;
  static constexpr int MS = F / L::KC;  // stages a matrix
  const float* const* mats;
  int count;
  float* buf;
  int next;
  int col0;  // the block's first column

  __device__ __forceinline__ void issue() {
    constexpr int V = L::FB / 4;  // 16-byte vectors per stage row
    if (next / MS < count) {
      float* dst = buf + (next % mma::NS) * L::STAGE;
      const float* src =
          mats[next / MS] + (size_t)(next % MS) * L::KC * F + col0;
      for (int e = threadIdx.x; e < L::KC * V; e += NT) {
        const int r = e / V, v = e % V;
        mma::cp_async16(dst + r * L::WS + 4 * v, src + (size_t)r * F + 4 * v);
      }
    }
    mma::cp_async_commit();
    ++next;
  }

  __device__ __forceinline__ const float* acquire() {
    mma::cp_async_wait<mma::NS - 2>();
    __syncthreads();
    const float* stage = buf + ((next - (mma::NS - 1)) % mma::NS) * L::STAGE;
    issue();
    return stage;
  }
};

// fn(r, f, v) for every accumulator of the warp's m-tiles below `rows`: block
// row r = 16m + gid (+8), feature f = slice*FW + 8n + 2*tig (+1).  Rows from
// `rows` to the end of the last m-tile come too.
template <int F, class Fn>
__device__ __forceinline__ void for_fragments(const Acc<F>& acc, int rows, Fn fn) {
  using L = NodeLayout<F>;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < L::WM; ++m) {
    if (16 * m >= rows) continue;
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(16 * m + gid + 8 * (e >> 1), slice * L::FW + 8 * n + 2 * tig + (e & 1),
           acc[m][n][e]);
  }
}

// acc = h' @ k_i (side 0) or h' @ k_j (side 1) of a head: (acc + b0 [+ type
// fold]) -> head.row, (acc [+ type fold]) -> head.col for the block's rows
// (row r is node node_of[r], none if < 0).
template <int F>
__device__ __forceinline__ void store_projection(const Head& hd, int side, const Acc<F>& acc,
                                                 const float* is_lig, const int* node_of,
                                                 int rows) {
  float* dst = side == 0 ? hd.row : hd.col;
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    const int node = node_of[r];
    if (node < 0) return;
    const float lig = is_lig[node];
    if (side == 0) {
      v += hd.b0[f];
      if (hd.tb) v += hd.tb[f] + lig * (hd.tb[2 * F + f] - hd.tb[f]);
    } else if (hd.tb) {
      v += lig * (hd.tb[F + f] - hd.tb[f]);
    }
    dst[(size_t)node * F + f] = v;
  });
}

// (A @ k_i + b0 [+ type fold]) -> head.row, (A @ k_j [+ type fold]) -> head.col
// for the block's rows; A holds h', the ring's next two matrices are k_i,
// k_j.
template <int F>
__device__ __forceinline__ void project_head(const Head& hd, const float* A,
                                             WeightChain<F>& ring, Acc<F>& acc,
                                             const float* is_lig, const int* node_of,
                                             int rows) {
  for (int side = 0; side < 2; ++side) {
    mma::product_tc<F, RG, true, true, mma::kTier>(A, ring, acc, rows);
    store_projection<F>(hd, side, acc, is_lig, node_of, rows);
  }
}

template <int F>
__global__ void __launch_bounds__(NT) block_phase_a(PhaseA g) {
  using L = NodeLayout<F>;
  constexpr int TI = L::TI, P = L::P, RB = block_rows<F>;
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* mats[7];
  __shared__ int node_of[RB];  // node b*N + i of each block row, -1: none
  const int N = g.gcl.N;
  float* S = smem;                            // P x SS: gcl_tile_tc's, then h, silu(pre)
  float* ring_buf = S + P * L::SS;            // gcl_tile_tc's ring, then the chain's
  float* AGG = smem + second_tile<F>(N);      // RB x SS: the aggregates, then h'

  // the block's row tiles: global tile k + s*G for slot s < slots is tile
  // (k + s*G) / B of batch item (k + s*G) % B, rows TI*s .. TI*s + TI-1
  const int t = threadIdx.x;
  const int tiles = g.B * ((N + TI - 1) / TI);
  const int slots = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int rows = slots * TI;
  if (t < RB) {
    const int s = t / TI, tile = blockIdx.x + s * gridDim.x;
    const int i = tile / g.B * TI + t % TI;
    node_of[t] = s < slots && i < N ? tile % g.B * N + i : -1;
  }

  // the rank-1 terms of the heads' type tables, for phase B
  if (blockIdx.x == 0 && t < F) {
    if (g.coord.tb)
      g.coord.delta[t] = g.coord.tb[3 * F + t] - g.coord.tb[2 * F + t]
                       - g.coord.tb[F + t] + g.coord.tb[t];
    if (g.cross.k_i && g.cross.tb)
      g.cross.delta[t] = g.cross.tb[3 * F + t] - g.cross.tb[2 * F + t]
                       - g.cross.tb[F + t] + g.cross.tb[t];
  }
  if constexpr (L::FE > 1) {  // F = 512: features t + NT too
    const int f = t + NT;
    if (blockIdx.x == 0 && f < F) {
      if (g.coord.tb)
        g.coord.delta[f] = g.coord.tb[3 * F + f] - g.coord.tb[2 * F + f]
                         - g.coord.tb[F + f] + g.coord.tb[f];
      if (g.cross.k_i && g.cross.tb)
        g.cross.delta[f] = g.cross.tb[3 * F + f] - g.cross.tb[2 * F + f]
                         - g.cross.tb[F + f] + g.cross.tb[f];
    }
  }
  if constexpr (L::FE > 2) {  // F = 1024: features t + 2 NT, t + 3 NT too
    for (int f = t + 2 * NT; blockIdx.x == 0 && f < F; f += NT) {
      if (g.coord.tb)
        g.coord.delta[f] = g.coord.tb[3 * F + f] - g.coord.tb[2 * F + f]
                         - g.coord.tb[F + f] + g.coord.tb[f];
      if (g.cross.k_i && g.cross.tb)
        g.cross.delta[f] = g.cross.tb[3 * F + f] - g.cross.tb[2 * F + f]
                         - g.cross.tb[F + f] + g.cross.tb[f];
    }
  }

  // ---- GCL: aggregates of the block's rows -> AGG
  for (int s = 0; s < slots; ++s) {
    const int tile = blockIdx.x + s * gridDim.x, i0 = tile / g.B * TI;
    mma::gcl_tile_tc<F, L::SS, mma::kTier>(g.gcl, (size_t)(tile % g.B) * N, i0, smem,
                               AGG + s * TI * L::SS, N - i0 < TI ? N - i0 : TI);
  }

  // ---- S <- h; the rows of no node, to the end of the last m-tile, are
  // zeros in both tiles (node_of is visible since the tiles' syncs)
  const int live = (rows + 15) / 16 * 16;
  for (int e = t; e < live * F; e += NT) {
    const int r = e / F, k = e % F, node = node_of[r];
    S[r * L::SS + k] = node >= 0 ? g.h[(size_t)node * F + k] : 0.0f;
    if (node < 0) AGG[r * L::SS + k] = 0.0f;
  }
  if (t == 0) {
    mats[0] = g.w_h; mats[1] = g.w_a; mats[2] = g.nw2;
    mats[3] = g.coord.k_i; mats[4] = g.coord.k_j;
    mats[5] = g.cross.k_i; mats[6] = g.cross.k_j;
  }
  __syncthreads();  // mats; the GCL tiles' ring reads are done
  WeightChain<F> ring{mats, g.cross.k_i ? 7 : 5, ring_buf, 0};
  for (int s = 0; s < mma::NS - 1; ++s) ring.issue();

  // ---- node MLP: pre = h @ W_h + agg @ W_a
  Acc<F> acc;
  mma::product_tc<F, RG, true, true, mma::kTier>(S, ring, acc, rows);
  mma::product_tc<F, RG, false, true, mma::kTier>(AGG, ring, acc, rows);
  // S <- silu(pre + b0): every warp is done with S, having passed the second
  // product's first sync
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    S[r * L::SS + f] = mma::silu_fast(v + g.nb0[f]);
  });
  mma::product_tc<F, RG, true, true, mma::kTier>(S, ring, acc, rows);
  // h' = (h + upd + b2n) * mask -> out_h and AGG, which every warp is done
  // with since the third product's first sync
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    const int node = node_of[r];
    if (node < 0) return;
    const size_t i = node;
    v = (g.h[i * F + f] + v + g.nb2[f]) * g.gcl.mask[i];
    g.out_h[i * F + f] = v;
    AGG[r * L::SS + f] = v;
  });

  // ---- first-layer projections of the coordinate and cross heads
  project_head<F>(g.coord, AGG, ring, acc, g.gcl.is_lig, node_of, rows);
  if (g.cross.k_i) project_head<F>(g.cross, AGG, ring, acc, g.gcl.is_lig, node_of, rows);
  mma::cp_async_wait_all();  // the ring's empty look-ahead group
}

// S[r] <- src[node_of[r]] (all F features; zeros for rows of no node) for
// the RB rows of a cluster block's node products.
template <int F>
__device__ __forceinline__ void load_node_rows(float* S, const float* src,
                                               const int* node_of) {
  using L = NodeLayout<F>;
  constexpr int V = F / 4;  // 16-byte vectors a row
  for (int e = threadIdx.x; e < block_rows<F> * V; e += NT) {
    const int r = e / V, v = e % V, node = node_of[r];
    *reinterpret_cast<float4*>(S + r * L::SS + 4 * v) =
        node >= 0 ? *reinterpret_cast<const float4*>(src + (size_t)node * F + 4 * v)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Phase A at F = 2048 on clusters of two blocks (the file's head): block
// rank r of cluster k computes features [FB r, FB r + FB) of every output of
// the cluster's row tiles k + s*G (G = gridDim.x / 2 clusters); the GCL
// aggregates go through `agg` (B*N*F floats).
template <int F>
__global__ void __launch_bounds__(NT) block_phase_a_cluster(PhaseA g, float* agg) {
  using L = NodeLayout<F>;
  constexpr int RB = block_rows<F>, FB = L::FB;
  static_assert(L::TI == 1 && L::P == RB && L::WM == 1, "one m-tile of one-row tiles");
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* mats[7];
  __shared__ int node_of[RB];  // node b*N + i of each block row, -1: none
  const int N = g.gcl.N;
  const unsigned rank = cluster_rank(), peer = rank ^ 1u;
  const int col0 = (int)rank * FB;
  float* S = smem;                  // gcl_tile_cluster's S, then RB x SS: h, agg,
                                    // silu(pre), h'
  float* ring_buf = S + L::P * L::SS;  // gcl_tile_cluster's ring, then the chain's

  // the cluster's row tiles: global tile k + s*G for slot s < slots is row
  // (k + s*G) / B of batch item (k + s*G) % B
  const int t = threadIdx.x;
  const int G = (int)gridDim.x / cluster_size<F>(), k = cluster_tile<F>();
  const int slots = (g.B * N - k + G - 1) / G;
  const int rows = slots;
  if (t < RB) {
    const int tile = k + t * G;
    node_of[t] = t < slots ? tile % g.B * N + tile / g.B : -1;
  }

  // the rank-1 terms of the heads' type tables (the block's features), for
  // phase B
  for (int f = col0 + t; k == 0 && f < col0 + FB; f += NT) {
    if (g.coord.tb)
      g.coord.delta[f] = g.coord.tb[3 * F + f] - g.coord.tb[2 * F + f]
                       - g.coord.tb[F + f] + g.coord.tb[f];
    if (g.cross.k_i && g.cross.tb)
      g.cross.delta[f] = g.cross.tb[3 * F + f] - g.cross.tb[2 * F + f]
                       - g.cross.tb[F + f] + g.cross.tb[f];
  }

  // ---- GCL: the block's half of the aggregates of the cluster's rows -> agg
  for (int s = 0; s < slots; ++s) {
    const int tile = k + s * G, b = tile % g.B, i = tile / g.B;
    mma::gcl_tile_cluster<F, mma::kTier>(g.gcl, (size_t)b * N, i, smem,
                                         agg + ((size_t)b * N + i) * F, 1);
  }
  // the peer's aggregate writes are visible to this block after the barrier
  __threadfence();
  cluster_sync();

  // ---- pre = h @ W_h + agg @ W_a, the block's features
  load_node_rows<F>(S, g.h, node_of);
  if (t == 0) {
    mats[0] = g.w_h; mats[1] = g.w_a; mats[2] = g.nw2;
    mats[3] = g.coord.k_i; mats[4] = g.coord.k_j;
    mats[5] = g.cross.k_i; mats[6] = g.cross.k_j;
  }
  __syncthreads();  // mats; node_of
  WeightChain<F> ring{mats, g.cross.k_i ? 7 : 5, ring_buf, 0, col0};
  for (int s = 0; s < mma::NS - 1; ++s) ring.issue();
  Acc<F> acc;
  mma::product_tc<F, RG, true, true, mma::kTier>(S, ring, acc, rows);
  __syncthreads();  // every warp is done with h
  load_node_rows<F>(S, agg, node_of);
  mma::product_tc<F, RG, false, true, mma::kTier>(S, ring, acc, rows);
  __syncthreads();  // every warp is done with agg

  // ---- S <- silu(pre + b0): the block's half, then the peer's
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    S[r * L::SS + col0 + f] = mma::silu_fast(v + g.nb0[col0 + f]);
  });
  cluster_sync();  // both halves are written
  mma::copy_peer_half<F>(S, peer);
  mma::product_tc<F, RG, true, true, mma::kTier>(S, ring, acc, rows);
  // every warp of this block is done with silu(pre), and the peer has
  // copied this block's half of it
  cluster_sync();

  // ---- h' = (h + upd + b2n) * mask -> out_h and S: the block's half, then
  // the peer's
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    const int node = node_of[r];
    if (node < 0) return;
    const size_t i = node;
    const int c = col0 + f;
    v = (g.h[i * F + c] + v + g.nb2[c]) * g.gcl.mask[i];
    g.out_h[i * F + c] = v;
    S[r * L::SS + c] = v;
  });
  cluster_sync();  // both halves are written
  mma::copy_peer_half<F>(S, peer);

  // ---- first-layer projections of the heads: the block's features (the
  // product's features are the block's own, from the ring's columns)
  auto own = [&](Head hd) {
    hd.b0 += col0;
    if (hd.tb) hd.tb += col0;
    hd.row += col0;
    hd.col += col0;
    return hd;
  };
  project_head<F>(own(g.coord), S, ring, acc, g.gcl.is_lig, node_of, rows);
  if (g.cross.k_i)
    project_head<F>(own(g.cross), S, ring, acc, g.gcl.is_lig, node_of, rows);
  mma::cp_async_wait_all();  // the ring's empty look-ahead group
  cluster_sync();  // the peer has copied this block's h'
}

// acc (ZERO: =, else +=) rows node_of[r] of `src` (nodes x F, global
// memory) @ the ring's next matrix, the block's columns over K = F, each
// part of src loaded into `buf` (WideLayout).
template <int F, bool ZERO>
__device__ __forceinline__ void product_rows(const float* src, const int* node_of, float* buf,
                                             WeightChain<F>& ring, Acc<F>& acc) {
  mma::product_walk<F, mma::kTier, ZERO>(ring, acc, [&](int q) -> const float* {
    __syncthreads();  // every warp is done with buf's last part
    mma::load_part_rows<F>(buf, src, node_of, q);
    return buf;
  });
}

// Phase A at F = 4096 on clusters of C = F / 1024 blocks (the file's head):
// as block_phase_a_cluster, block rank r computing features [FB r, FB r +
// FB) of every output of the cluster's row tiles k + s*G, but each node
// product walking K in C parts; the GCL aggregates go through `agg`
// (B*N*F floats).
template <int F>
__global__ void __launch_bounds__(NT) block_phase_a_wide(PhaseA g, float* agg) {
  using L = NodeLayout<F>;
  constexpr int RB = block_rows<F>, FB = L::FB;
  static_assert(L::TI == 1 && L::P == RB && L::WM == 1 && L::S_BUFS == 2,
                "one m-tile of one-row tiles, the own part and the staging");
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* mats[7];
  __shared__ int node_of[RB];  // node b*N + i of each block row, -1: none
  const int N = g.gcl.N;
  const unsigned rank = cluster_rank();
  const int col0 = (int)rank * FB;
  float* own = smem;                       // gcl_tile_wide's, then silu(pre)'s part
  float* staging = own + L::P * L::SS;     // gcl_tile_wide's, then every other A part
  float* ring_buf = staging + L::P * L::SS;  // gcl_tile_wide's ring, then the chain's

  // the cluster's row tiles: global tile k + s*G for slot s < slots is row
  // (k + s*G) / B of batch item (k + s*G) % B
  const int t = threadIdx.x;
  const int G = (int)gridDim.x / cluster_size<F>(), k = cluster_tile<F>();
  const int slots = (g.B * N - k + G - 1) / G;
  const int rows = slots;
  if (t < RB) {
    const int tile = k + t * G;
    node_of[t] = t < slots ? tile % g.B * N + tile / g.B : -1;
  }

  // the rank-1 terms of the heads' type tables (the block's features), for
  // phase B
  for (int f = col0 + t; k == 0 && f < col0 + FB; f += NT) {
    if (g.coord.tb)
      g.coord.delta[f] = g.coord.tb[3 * F + f] - g.coord.tb[2 * F + f]
                       - g.coord.tb[F + f] + g.coord.tb[f];
    if (g.cross.k_i && g.cross.tb)
      g.cross.delta[f] = g.cross.tb[3 * F + f] - g.cross.tb[2 * F + f]
                       - g.cross.tb[F + f] + g.cross.tb[f];
  }

  // ---- GCL: the block's part of the aggregates of the cluster's rows -> agg
  for (int s = 0; s < slots; ++s) {
    const int tile = k + s * G, b = tile % g.B, i = tile / g.B;
    mma::gcl_tile_wide<F, mma::kTier>(g.gcl, (size_t)b * N, i, smem,
                                      agg + ((size_t)b * N + i) * F, 1);
  }
  // the peers' aggregate writes are visible to this block after the barrier
  __threadfence();
  cluster_sync();

  // ---- pre = h @ W_h + agg @ W_a, the block's features
  if (t == 0) {
    mats[0] = g.w_h; mats[1] = g.w_a; mats[2] = g.nw2;
    mats[3] = g.coord.k_i; mats[4] = g.coord.k_j;
    mats[5] = g.cross.k_i; mats[6] = g.cross.k_j;
  }
  __syncthreads();  // mats; node_of
  WeightChain<F> ring{mats, g.cross.k_i ? 7 : 5, ring_buf, 0, col0};
  for (int s = 0; s < mma::NS - 1; ++s) ring.issue();
  Acc<F> acc;
  product_rows<F, true>(g.h, node_of, staging, ring, acc);
  product_rows<F, false>(agg, node_of, staging, ring, acc);

  // ---- own <- silu(pre + b0), the block's part; then the product over
  // every block's part (the peers' through DSMEM)
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    own[r * L::SS + f] = mma::silu_fast(v + g.nb0[col0 + f]);
  });
  cluster_sync();  // every block's part is written
  mma::product_walk<F, mma::kTier, true>(ring, acc, [&](int q) -> const float* {
    if (q == (int)rank) return own;
    __syncthreads();  // every warp is done with the staging's last part
    mma::copy_peer_part<F>(staging, own, (unsigned)q);
    return staging;
  });

  // ---- h' = (h + upd + b2n) * mask -> out_h, the block's features
  for_fragments<F>(acc, rows, [&](int r, int f, float v) {
    const int node = node_of[r];
    if (node < 0) return;
    const size_t i = node;
    const int c = col0 + f;
    g.out_h[i * F + c] = (g.h[i * F + c] + v + g.nb2[c]) * g.gcl.mask[i];
  });
  // the peers' h' writes are visible to this block after the barrier, and
  // every peer has copied this block's part of silu(pre): no block reads
  // another's shared memory past it
  __threadfence();
  cluster_sync();

  // ---- first-layer projections of the heads: the block's features, h'
  // read back from out_h
  auto project = [&](Head hd) {
    hd.b0 += col0;
    if (hd.tb) hd.tb += col0;
    hd.row += col0;
    hd.col += col0;
    for (int side = 0; side < 2; ++side) {
      product_rows<F, true>(g.out_h, node_of, staging, ring, acc);
      store_projection<F>(hd, side, acc, g.gcl.is_lig, node_of, rows);
    }
  };
  project(g.coord);
  if (g.cross.k_i) project(g.cross);
  mma::cp_async_wait_all();  // the ring's empty look-ahead group
}

// The body (coord_update_block) is coord_agg.cu's, in egnn_coord.cuh.
template <int F, bool CROSS>
__global__ void __launch_bounds__(NT) block_phase_b(CoordArgs g, float* partial) {
  extern __shared__ __align__(16) float smem[];
  coord_update_block<F, CROSS, mma::kTier>(g, partial, smem);
}

// Both phases above F = 1024 on clusters of C = F / 1024 blocks: `blocks` =
// C x the phase-A clusters; phase B is coord_agg.cu's launch
// (egnn_coord.cuh).
template <int F>
int launch_cluster_phases(const PhaseA& a, const CoordArgs& b, int blocks, float* partial,
                          float* agg, cudaStream_t stream) {
  constexpr int C = cluster_size<F>();
  const int N = a.gcl.N, B = a.B, tiles = B * N, clusters = blocks / C;
  if (blocks % C || clusters <= 0 || clusters > tiles ||
      (tiles + clusters - 1) / clusters > RB_TILES)
    return (int)cudaErrorInvalidValue;
  int err;
  if constexpr (C > 2)
    err = launch_clusters<C>(block_phase_a_wide<F>, dim3(blocks), mma::dynamic_smem<F>(N),
                             stream, a, agg);
  else
    err = launch_clusters<C>(block_phase_a_cluster<F>, dim3(blocks), mma::dynamic_smem<F>(N),
                             stream, a, agg);
  if (err != 0) return err;
  // same stream: phase B starts when every cluster of phase A has finished
  if (b.cross.a_row == nullptr) return launch_cluster_update<F, false>(b, B, partial, stream);
  return launch_cluster_update<F, true>(b, B, partial, stream);
}

template <int F>
int launch(const PhaseA& a, const CoordArgs& b, int blocks, float* partial, float* agg,
           cudaStream_t stream) {
  if constexpr (cluster_size<F>() > 1) {
    return launch_cluster_phases<F>(a, b, blocks, partial, agg, stream);
  } else {
    last_cluster_dim() = 1;
    constexpr int TI = tile_rows<F>();
    const int N = a.gcl.N, B = a.B;
    const int tiles = B * ((N + TI - 1) / TI);
    if (blocks <= 0 || blocks > tiles || (tiles + blocks - 1) / blocks > RB_TILES)
      return (int)cudaErrorInvalidValue;
    const size_t smem_a =
        sizeof(float) * (second_tile<F>(N) + (size_t)block_rows<F> * NodeLayout<F>::SS);
    cudaError_t err = cudaFuncSetAttribute(
        block_phase_a<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
    if (err != cudaSuccess) return (int)err;
    block_phase_a<F><<<blocks, NT, smem_a, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // same stream: phase B starts when every block of phase A has finished
    if (b.cross.a_row == nullptr)
      return launch_coord_update<F, false>(block_phase_b<F, false>, b, B, partial, stream);
    return launch_coord_update<F, true>(block_phase_b<F, true>, b, B, partial, stream);
  }
}

}  // namespace

// scratch: 4*B*N*F + 2*F + 2*B*N*3 floats (la_row, la_col, lc_row, lc_col, the
// two deltas, phase B's two partial slabs); above F = 1024 B*N*F more, the
// aggregates' plane, after the projections'.  pairs: null, or two counters to
// which both phases add their pairs (launch_count_pairs: egnn_common.cuh).
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
    int B, int N, int F, int update_rows, int blocks, float* out_h,
    float* out_dx, unsigned long long* pairs, void* stream) {
  const size_t plane = (size_t)B * N * F;
  float* la_row = scratch;
  float* la_col = scratch + plane;
  float* lc_row = scratch + 2 * plane;
  float* lc_col = scratch + 3 * plane;
  float* agg = F > 1024 ? scratch + 4 * plane : nullptr;
  float* l_delta = scratch + (F > 1024 ? 5 : 4) * plane;
  float* c_delta = l_delta + F;
  float* partial = c_delta + F;
  const Cutoffs cut{cut_ll, cut_pp, cut_lp};
  const bool has_cross = ck_i != nullptr;

  PhaseA a;
  a.gcl = GclArgs{PairMlp{a_row, a_col, w_d2, w_d20, delta, w2, b2, w_att}, b_att,
                  x, x0, mask, mask, is_lig, cut, nf, N, N, nullptr};
  a.h = h; a.w_h = nw_h; a.w_a = nw_a; a.nb0 = nb0; a.nw2 = nw2; a.nb2 = nb2;
  a.coord = Head{lk_i, lk_j, lb0, ltb, la_row, la_col, l_delta};
  a.cross = Head{ck_i, ck_j, cb0, ctb, lc_row, lc_col, c_delta};
  a.B = B;
  a.out_h = out_h;

  CoordArgs b;
  b.coord = PairMlp{la_row, la_col, lw_d2, lw_d20, ltb ? l_delta : nullptr, lw1, lb1,
                    lw3};
  b.cross = PairMlp{has_cross ? lc_row : nullptr, lc_col, cw_d2, cw_d20,
                    has_cross && ctb ? c_delta : nullptr, cw1, cb1, cw3};
  b.x = x; b.x0 = x0; b.mask = mask; b.col_mask = mask; b.is_lig = is_lig; b.graph_mean = graph_mean;
  b.use_tanh = use_tanh; b.coords_range = coords_range;
  b.norm_constant = norm_constant; b.nf = nf; b.cut = cut;
  b.N = N; b.update_rows = update_rows; b.out = out_dx;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr) {  // phase A's tiles of every row, then phase B's
    int err = launch_count_pairs(F, x0, mask, mask, is_lig, cut, B, N, N, pairs, s);
    if (err == 0)
      err = launch_count_pairs(F, x0, mask, mask, is_lig, cut, B, N, update_rows, pairs, s);
    if (err != 0) return err;
  }
  switch (F) {
    case 64: return launch<64>(a, b, blocks, partial, agg, s);
    case 128: return launch<128>(a, b, blocks, partial, agg, s);
    case 256: return launch<256>(a, b, blocks, partial, agg, s);
    case 512: return launch<512>(a, b, blocks, partial, agg, s);
    case 1024: return launch<1024>(a, b, blocks, partial, agg, s);
    case 2048: return launch<2048>(a, b, blocks, partial, agg, s);
    case 4096: return launch<4096>(a, b, blocks, partial, agg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
