// Hidden widths F = 2048 and 4096 on a thread-block cluster: the forward
// kernels' row-tile bodies (gcl_agg.cu, coord_agg.cu) with the output
// features split over the C = F / 1024 blocks of a cluster; for sm_90a.
//
// Why a cluster: at F = 2048 one block of the F = 1024 design would need S
// of its one m-tile (16 x 2052 floats, 131 KB) and a W2 ring of two 8-row
// stages (2 x 8 x 2056 floats, 132 KB): 263 KB, over the 227 KB a block may
// have; and 8 warps over 2048 features would hold 128 accumulators and 64 row
// sums a thread, over the 255-register limit that F = 1024 already reaches.
//
// Design (Layout<2048> below):
// * block r of a cluster owns output features [1024 r, 1024 r + 1024) of the
//   cluster's row tile, in F = 1024's warp layout: 8 slices of 128 features,
//   16 n-tiles a warp, STEP_SUMS, bf16 k-steps of 8: the registers of the
//   F = 1024 kernel;
// * each block fills S (silu(pre) of the chunk's 16 pairs) for its own 1024
//   features, four a thread as F = 1024 does, then, after a cluster barrier,
//   copies the peer's 1024 into its own S through distributed shared memory
//   (ld.shared::cluster, 64 KB a chunk against the 8 MB of W2 the block
//   streams a chunk): the product's K loop then reads only local shared
//   memory, where A fragments loaded from the peer would put the DSMEM
//   latency inside the tensor-core loop (the direct loads were not built);
// * the product runs over all K = 2048 rows of W2 and the ring streams the
//   block's 1024 columns (8 rows x 1032 floats a stage): each block streams
//   half of W2's 16 MB a chunk;
// * both blocks compact the same columns (the same inputs give the same
//   list), so they walk the same chunks;
// * the epilogues reduce over features through one scalar a pair: the GCL's
//   attention dot and the coordinate head.  Each block writes its 16 partial
//   sums, a cluster barrier follows, and the block that needs the sum reads
//   the peer's and adds the two in a fixed order, rank 0's first: both
//   blocks of the GCL gate a row's two halves with the same value;
// * the barrier after the partials also orders the next chunk's refill of S
//   after the peer's copy of it, and a last barrier keeps a block's shared
//   memory alive until its peer has read the last partials;
// * each block writes only its own feature slice of the output (the GCL) or
//   rank 0 alone the row's three coordinates (the coordinate update), so
//   nothing needs atomics and the result is deterministic.
//
// F = 4096 (WideLayout, gcl_tile_wide, coord_tile_wide; written for any C =
// F / 1024 > 2): S of all K rows no longer fits a block (16 x 4100 floats,
// 262 KB), so
// * block r of a cluster of C = 4 owns output features [1024 r, 1024 r +
//   1024) in F = 1024's warp layout as at 2048, and fills only its own 1024
//   features of S (its C-th of K) into its own buffer, four a thread;
// * the product walks K in C parts of 1024 rows, in rank order: part q from
//   the block's own buffer (q = r) or from peer q's, copied into a second,
//   staging buffer through DSMEM, each part's product accumulating onto the
//   last (the k-steps in the order of one K = 4096 product); the W2 ring
//   streams rows [1024 q, 1024 q + 1024) of the block's 1024 columns, its
//   look-ahead running on across the parts.  Shared memory: own part 66 KB +
//   staging 66 KB + the ring's two 8-row stages 66 KB, as at 2048;
// * the attention dot and the coordinate head are C partial sums a pair:
//   each block writes its 16, a cluster barrier follows, and the sum is
//   taken from DSMEM in rank order 0 + 1 + ... + C-1 (every block of the GCL
//   the same sum, so a row's C feature slices are gated alike; rank 0 alone
//   in the coordinate update);
// * that barrier also orders the next chunk's refill of each own buffer
//   after the last peer's copy of it, and a last barrier keeps a block's
//   shared memory alive until its peers are done.
// block_fused.cu's node products at F = 4096 walk K alike (product_walk),
// each part's A tile loaded from global memory (load_part_rows) or copied
// from a peer's own buffer (copy_peer_part).
#pragma once
#include "egnn_mma.cuh"

namespace egnn {

// Blocks a cluster at width F: F / 1024 above 1024 (2 at 2048, 4 at 4096),
// else 1 (no cluster).
template <int F>
__host__ __device__ constexpr int cluster_size() { return F > 1024 ? F / 1024 : 1; }

// ---- cluster primitives (PTX, sm_90)

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives; the shared-memory
// writes before it (release) are visible to every thread after it (acquire).
// Also a barrier of the block's own threads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (this block's shared memory) in block `rank`'s shared
// memory, for ld.shared::cluster.
__device__ __forceinline__ uint32_t peer_address(const void* p, unsigned rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ float4 load_peer4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float load_peer(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

namespace mma {

// The tiling of one block of the F = 2048 cluster: K = F rows of W2 and S,
// the block's FB = F / 2 output features.  Otherwise F = 1024's: TI = 1 row
// (P = 16 pairs, one m-tile), stages of KC = 8 rows, one row group x 8 slices
// of FW = 128 features (16 n-tiles), four fill features a thread (FE), the
// step sums.
template <> struct Layout<2048, 1> {
  static constexpr int CLUSTER = cluster_size<2048>();
  static constexpr int FB = 2048 / CLUSTER;  // output features a block owns
  static constexpr int TI = tile_rows<2048>();
  static constexpr int P = TI * TJ;
  static constexpr int M_TILES = P / 16;
  static constexpr int SLICES = NT / 32;
  static constexpr int KC = 8;           // W2 rows per stage
  static constexpr int SS = 2048 + 4;    // S row stride: all K features
  static constexpr int WS = FB + 8;      // stage row stride: the block's columns
  static constexpr int KS = 2048 / KC;   // stages per chunk
  static constexpr int WM = M_TILES;
  static constexpr int FW = FB / SLICES;
  static constexpr int NTN = FW / 8;
  static constexpr int NG = 8;
  static constexpr int FE = FB / NT;     // fill features a thread (of the block's)
  static constexpr int NQ = 1;
  static constexpr int COLS = TJ;
  static constexpr int STAGE = KC * WS;
  static constexpr int S_BUFS = 1;
#ifndef EGNN_NO_STEP_SUMS
  static constexpr bool STEP_SUMS = true;
#else
  static constexpr bool STEP_SUMS = false;
#endif
  static constexpr int NGS = 4;
  static_assert(TI == 1 && FE == 4 && NTN == 16, "F = 1024's layout on the block's half");
};

// The tiling of one block of a cluster of C = F / 1024 > 2 blocks: the
// block's FB = 1024 output features in F = 1024's layout, as Layout<2048>,
// but S a C-th of K at a time: its buffers hold FB features (SS), a product
// call runs FB / KC stages (KS, one part of K), the ring walks all F / KC
// stages of a chunk, and S has two buffers, the block's own part and the
// staging of a peer's.
template <int F>
struct WideLayout {
  static constexpr int CLUSTER = cluster_size<F>();
  static constexpr int FB = F / CLUSTER;  // output features a block owns
  static constexpr int TI = tile_rows<F>();
  static constexpr int P = TI * TJ;
  static constexpr int M_TILES = P / 16;
  static constexpr int SLICES = NT / 32;
  static constexpr int KC = 8;           // W2 rows per stage
  static constexpr int SS = FB + 4;      // S row stride: one part's features
  static constexpr int WS = FB + 8;      // stage row stride: the block's columns
  static constexpr int KS = FB / KC;     // stages a product call: one part of K
  static constexpr int WM = M_TILES;
  static constexpr int FW = FB / SLICES;
  static constexpr int NTN = FW / 8;
  static constexpr int NG = 8;
  static constexpr int FE = FB / NT;     // fill features a thread (of the block's)
  static constexpr int NQ = 1;
  static constexpr int COLS = TJ;
  static constexpr int STAGE = KC * WS;
  static constexpr int S_BUFS = 2;       // the own part and the staging
#ifndef EGNN_NO_STEP_SUMS
  static constexpr bool STEP_SUMS = true;
#else
  static constexpr bool STEP_SUMS = false;
#endif
  static constexpr int NGS = 4;
  static_assert(CLUSTER > 2 && CLUSTER <= 8 && FB == 1024,
                "3 to 8 blocks a cluster (the portable maximum)");
  static_assert(TI == 1 && FE == 4 && NTN == 16, "F = 1024's layout on the block's part");
};

template <> struct Layout<4096, 1> : WideLayout<4096> {};

// The ring of W2 stages of a cluster block: stage g holds rows (g % (F / KC))
// * KC .. + KC of W2's columns [col0, col0 + FB) in buffer g % NS.  W2 and the
// column offset must keep 16-byte alignment.  As W2Ring otherwise.
template <int F>
struct W2ClusterRing {
  using L = Layout<F>;
  const float* w2;  // W2 + col0: the block's first column
  float* buf;       // NS * STAGE floats
  int next;         // next stage to issue

  __device__ __forceinline__ void issue() {
    constexpr int V = L::FB / 4;  // 16-byte vectors per stage row
    float* dst = buf + (next % NS) * L::STAGE;
    const float* src = w2 + (size_t)(next % (F / L::KC)) * L::KC * F;
    for (int e = threadIdx.x; e < L::KC * V; e += NT) {
      const int r = e / V, v = e % V;
      cp_async16(dst + r * L::WS + 4 * v, src + (size_t)r * F + 4 * v);
    }
    cp_async_commit();
    ++next;
  }

  __device__ __forceinline__ const float* acquire() {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const float* stage = buf + ((next - (NS - 1)) % NS) * L::STAGE;
    issue();
    return stage;
  }
};

// Feature k0 + e * NT (e < FE) of the chunk's pairs: the block's share of the
// fill of S, F = 1024's four features a thread (FillHalf: the first-layer
// weights, a_row, and a_col loaded a chunk ahead).
template <int F>
struct ClusterFill {
  FillHalf<F> h[Layout<F>::FE];
  int k0;

  __device__ __forceinline__ void load_weights(const PairMlp& m, size_t node0, int i0, int N) {
#pragma unroll
    for (int e = 0; e < Layout<F>::FE; ++e) load_half_rows<F>(m, node0, i0, N, k0 + e * NT, h[e]);
  }
  __device__ __forceinline__ void load_cols(const PairMlp& m, const int* cols, int count,
                                            int c0, size_t node0) {
#pragma unroll
    for (int e = 0; e < Layout<F>::FE; ++e)
      load_a_col_half<F>(m, cols, count, c0, node0, k0 + e * NT, h[e].a_col);
  }
  template <int TIER>
  __device__ __forceinline__ void fill(const Chunk<Layout<F>::TI>& c, float* S) const {
#pragma unroll
    for (int e = 0; e < Layout<F>::FE; ++e)
      fill_s_half<F, TIER>(h[e].w, c, h[e].a_row, h[e].a_col, k0 + e * NT, S);
  }
  // fill() into a buffer of the block's FB features only (WideLayout):
  // feature k0 + e * NT at column threadIdx.x + e * NT
  template <int TIER>
  __device__ __forceinline__ void fill_own(const Chunk<Layout<F>::TI>& c, float* S) const {
#pragma unroll
    for (int e = 0; e < Layout<F>::FE; ++e)
      fill_s_half<F, TIER>(h[e].w, c, h[e].a_row, h[e].a_col, threadIdx.x + e * NT, S);
  }
};

// The peer's FB features of S (its columns [peer * FB, peer * FB + FB) of
// the P rows) into this block's S, through distributed shared memory.  The
// peer's fill must be complete (a cluster barrier before).
template <int F>
__device__ __forceinline__ void copy_peer_half(float* S, unsigned peer) {
  using L = Layout<F>;
  constexpr int V = L::FB / 4;  // 16-byte vectors a row
  const uint32_t remote = peer_address(S, peer);
  const int col0 = (int)peer * L::FB;
#pragma unroll 4
  for (int e = threadIdx.x; e < L::P * V; e += NT) {
    const int off = (e / V) * L::SS + col0 + 4 * (e % V);
    *reinterpret_cast<float4*>(S + off) = load_peer4(remote + 4u * (unsigned)off);
  }
}

// The GCL row-tile body at F = 2048, one block of a cluster of two: the
// aggregated messages of row i0 of the batch item at node0, the block's
// features [rank * FB, rank * FB + FB) -> dst[f] (dst: the row in global
// memory, dst_rows 0 past N).  smem: dynamic_smem<F>(N) bytes.  TIER: as
// gcl_tile_tc's.  Both blocks of the cluster must call it on the same row.
template <int F, int TIER = TF32X3>
__device__ void gcl_tile_cluster(const GclArgs& g, size_t node0, int i0, float* smem,
                                 float* dst, int dst_rows) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, SLICES = L::SLICES, FB = L::FB;
  static_assert(L::WM == 1 && row_groups<F>() == 1, "one m-tile, one row group");
  __shared__ Rows<TI> rows;
  __shared__ Chunk<TI> chunk;
  __shared__ float b2s[FB], watt[FB];    // the block's slice
  __shared__ float att_part[SLICES][P];  // the slices' attention dots
  __shared__ float att_blk[P];           // the block's share, read by the peer
  const unsigned rank = cluster_rank(), peer = rank ^ 1u;
  const int col0 = (int)rank * FB;
  float* S = smem;
  W2ClusterRing<F> ring{g.mlp.w2 + col0, S + P * L::SS, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + NS * L::STAGE);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int slice = warp;
  const bool attention = g.mlp.head != nullptr;

  for (int s = 0; s < NS - 1; ++s) ring.issue();
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  for (int k = t; k < FB; k += NT) {
    b2s[k] = tier_round<TIER>(g.mlp.b2[col0 + k]);
    watt[k] = attention ? tier_round<TIER>(g.mlp.head[col0 + k]) : 0.0f;
  }
  ClusterFill<F> fill;
  fill.k0 = col0 + t;
  fill.load_weights(g.mlp, node0, i0, g.N);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);
  const float b_att = attention ? g.b_att[0] : 0.0f;
  const uint32_t peer_att = peer_address(att_blk, peer);

  float msum[L::NTN][2];  // this lane's share of the row sum (pairs gid, gid + 8)
#pragma unroll
  for (int n = 0; n < L::NTN; ++n) msum[n][0] = msum[n][1] = 0.0f;

  fill.load_cols(g.mlp, cols, count, 0, node0);
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
               c0, g.cut);
    __syncthreads();
    fill.template fill<TIER>(chunk, S);
    cluster_sync();  // both halves of S are filled
    copy_peer_half<F>(S, peer);
    fill.load_cols(g.mlp, cols, count, c0 + TJ, node0);
    float acc[1][L::NTN][4];
    product_tc<F, 1, true, false, TIER>(S, ring, acc);

    // ---- epilogue: silu, attention gate (a sum over both blocks), row sum
    float part[2] = {0.0f, 0.0f};  // attention dots of pairs gid, gid + 8
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][n][e] = tier_silu<TIER>(tier_round<TIER>(acc[0][n][e] + b2s[f + (e & 1)]));
        part[e >> 1] = fmaf(acc[0][n][e], watt[f + (e & 1)], part[e >> 1]);
      }
    }
    float gate[2] = {chunk.adj[gid], chunk.adj[gid + 8]};
    if (attention) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
        if (tig == 0) att_part[slice][gid + 8 * h] = part[h];
      }
      __syncthreads();
      if (t < P) {
        float dot = 0.0f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) dot += att_part[sl][t];
        att_blk[t] = dot;
      }
    }
    // the partials are written, and the peer's copy of S is done: the next
    // chunk may refill S (the next att_blk write follows the next barrier)
    cluster_sync();
    if (attention) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = gid + 8 * h;
        const float own = att_blk[p], other = load_peer(peer_att + 4u * p);
        const float dot = b_att + (rank == 0 ? own : other) + (rank == 0 ? other : own);
        gate[h] *= sigmoid_fast(dot);
      }
    }
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        msum[n][c] = fmaf(gate[1], acc[0][n][2 + c], fmaf(gate[0], acc[0][n][c], msum[n][c]));
    // no block sync: the chunk, S and att_part are rewritten only after the
    // next fill_chunk's sync, att_blk after the next cluster barrier
  }
  cp_async_wait_all();  // the ring's look-ahead stages

#pragma unroll
  for (int n = 0; n < L::NTN; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        msum[n][c] += __shfl_xor_sync(0xffffffffu, msum[n][c], o);
  if (gid == 0 && dst_rows > 0) {
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = col0 + slice * L::FW + 8 * n + 2 * tig;
      dst[f] = msum[n][0] / g.nf;
      dst[f + 1] = msum[n][1] / g.nf;
    }
  }
  cluster_sync();  // the peer has read this block's last partials
}

// The coordinate row-tile body at F = 2048, one block of a cluster of two,
// one pair MLP a call (as coord_tile_tc): the block's share of the head
// phi_p = sum_f silu(acc_pf + b2_f) * w3_f over its features, the sum of
// the two blocks' shares on rank 0 (rank 0's first), and rank 0 alone
// computes the per-pair terms and writes the row's three coordinates to
// g.out.  smem: dynamic_smem<F>(N) bytes.  TIER: as coord_tile_tc's.
template <int F, bool CROSS, int TIER = TF32X3>
__device__ void coord_tile_cluster(const CoordArgs& g, int batch, int i0, float* smem) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, SLICES = L::SLICES, FB = L::FB;
  const PairMlp& mlp = CROSS ? g.cross : g.coord;
  __shared__ Rows<TI> rows;
  __shared__ Chunk<TI> chunk;
  __shared__ float b2s[FB], w3s[FB];     // the block's slice
  __shared__ float phi_part[SLICES][P];  // the slices' head dots
  __shared__ float phi_blk[P];           // the block's share, read by rank 0
  __shared__ float trans[P][3], mean[3];
  const unsigned rank = cluster_rank(), peer = rank ^ 1u;
  const int col0 = (int)rank * FB;
  float* S = smem;
  W2ClusterRing<F> ring{mlp.w2 + col0, S + P * L::SS, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + NS * L::STAGE);

  const int t = threadIdx.x;
  const size_t node0 = (size_t)batch * g.N;

  for (int s = 0; s < NS - 1; ++s) ring.issue();
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (CROSS && t < 3) mean[t] = g.graph_mean[batch * 3 + t];
  for (int k = t; k < FB; k += NT) {
    b2s[k] = tier_round<TIER>(mlp.b2[col0 + k]);
    w3s[k] = tier_round<TIER>(mlp.head[col0 + k]);
  }
  ClusterFill<F> fill;
  fill.k0 = col0 + t;
  fill.load_weights(mlp, node0, i0, g.N);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);
  const uint32_t peer_phi = peer_address(phi_blk, peer);

  fill.load_cols(mlp, cols, count, 0, node0);
  float racc = 0.0f;  // rank 0: row sum of component t % 3 of row t / 3, t < 3*TI
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    fill.template fill<TIER>(chunk, S);
    cluster_sync();  // both halves of S are filled
    copy_peer_half<F>(S, peer);
    fill.load_cols(mlp, cols, count, c0 + TJ, node0);
    float acc[1][L::NTN][4];
    product_tc<F, 1, true, false, TIER>(S, ring, acc);
    head_parts<F, TIER>(acc, b2s, w3s, phi_part);
    __syncthreads();  // the slices' head dots are complete
    if (t < P) {
      float dot = 0.0f;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) dot += phi_part[sl][t];
      phi_blk[t] = dot;
    }
    // the shares are written, and the peer's copy of S is done
    cluster_sync();
    if (rank != 0) continue;  // rank 1's share is read by rank 0

    if (t < P) {
      const int k = t / TJ, j = chunk.j[t];
      float tr[3] = {0.0f, 0.0f, 0.0f};
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        float phi = phi_blk[t] + load_peer(peer_phi + 4u * t);
        if (g.use_tanh) phi = tanhf(phi) * g.coords_range;
        if constexpr (CROSS) {
          const float xi0 = rows.x[k][0] - mean[0], xi1 = rows.x[k][1] - mean[1],
                      xi2 = rows.x[k][2] - mean[2];
          const float xj0 = xj[0] - mean[0], xj1 = xj[1] - mean[1],
                      xj2 = xj[2] - mean[2];
          tr[0] = xi1 * xj2 - xi2 * xj1;
          tr[1] = xi2 * xj0 - xi0 * xj2;
          tr[2] = xi0 * xj1 - xi1 * xj0;
          const float cnorm =
              sqrtf(tr[0] * tr[0] + tr[1] * tr[1] + tr[2] * tr[2] + 1e-8f) + g.norm_constant;
          const float wt = phi / cnorm * chunk.adj[t];
          for (int a = 0; a < 3; ++a) tr[a] *= wt;
        } else {
          const float norm = sqrtf(chunk.d2[t] + 1e-8f) + g.norm_constant;
          const float wt = phi / norm * chunk.adj[t];
          for (int a = 0; a < 3; ++a) tr[a] = wt * (rows.x[k][a] - xj[a]);
        }
      }
      for (int a = 0; a < 3; ++a) trans[t][a] = tr[a];
    }
    __syncthreads();
    if (t < 3 * TI) {
      const int k = t / 3, a = t % 3;
      for (int jj = 0; jj < TJ; ++jj) racc += trans[k * TJ + jj][a];
    }
    // no block sync: the next chunk rewrites the chunk, S, phi_part and trans
    // only after its fill_chunk sync, phi_blk after the next cluster barrier
  }
  cp_async_wait_all();  // the ring's look-ahead stages

  if (rank == 0 && t < 3 * TI) {
    const int i = i0 + t / 3;
    if (i < g.N) g.out[(node0 + i) * 3 + t % 3] = racc / g.nf;
  }
  cluster_sync();  // rank 0 has read rank 1's last shares
}

// ---- F = 4096: clusters of C = F / 1024 > 2 blocks (WideLayout)

// Peer `peer`'s own part of S (P rows of FB features at stride SS) into
// `dst`, through distributed shared memory.  The peer's fill must be
// complete (a cluster barrier before).
template <int F>
__device__ __forceinline__ void copy_peer_part(float* dst, const float* own, unsigned peer) {
  using L = Layout<F>;
  constexpr int V = L::FB / 4;  // 16-byte vectors a row
  const uint32_t remote = peer_address(own, peer);
#pragma unroll 4
  for (int e = threadIdx.x; e < L::P * V; e += NT) {
    const int off = (e / V) * L::SS + 4 * (e % V);
    *reinterpret_cast<float4*>(dst + off) = load_peer4(remote + 4u * (unsigned)off);
  }
}

// acc = S @ W2 of the block's FB columns over all K = F rows, one part of FB
// rows at a time in rank order: part q from the block's own buffer (q ==
// rank) or from peer q's, copied into `staging`; each part's k-steps
// accumulate onto the last's, in the order of one K = F product.  Every
// block's fill of its own part must be complete (a cluster barrier before);
// the peers read `own` until they pass the next cluster barrier.
template <int F, int TIER>
__device__ __forceinline__ void product_wide(const float* own, float* staging, unsigned rank,
                                             W2ClusterRing<F>& ring,
                                             float (&acc)[1][Layout<F>::NTN][4]) {
  using L = Layout<F>;
#pragma unroll
  for (int n = 0; n < L::NTN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.0f;
#pragma unroll 1
  for (int q = 0; q < L::CLUSTER; ++q) {
    const float* part = own;
    if (q != (int)rank) {
      __syncthreads();  // every warp is done with the staging's last part
      copy_peer_part<F>(staging, own, (unsigned)q);
      part = staging;   // complete at the product's first acquire sync
    }
    product_tc<F, 1, false, false, TIER>(part, ring, acc);
  }
}

// The sum over the cluster's blocks of `v[p]` (each block's share of pair
// p's scalar), in rank order from `init`: the same bits in every block.
template <int F>
__device__ __forceinline__ float cluster_sum(const float* v, int p, float init) {
  float sum = init;
#pragma unroll
  for (int r = 0; r < cluster_size<F>(); ++r)
    sum += load_peer(peer_address(v, (unsigned)r) + 4u * (unsigned)p);
  return sum;
}

// gcl_tile_cluster at F = 4096, one block of a cluster of C = F / 1024: the
// block's features [rank * FB, rank * FB + FB) of row i0's aggregated
// messages -> dst[f].  smem: dynamic_smem<F>(N) bytes.  Every block of the
// cluster must call it on the same row.
template <int F, int TIER = TF32X3>
__device__ void gcl_tile_wide(const GclArgs& g, size_t node0, int i0, float* smem,
                              float* dst, int dst_rows) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, SLICES = L::SLICES, FB = L::FB;
  static_assert(L::WM == 1 && row_groups<F>() == 1, "one m-tile, one row group");
  __shared__ Rows<TI> rows;
  __shared__ Chunk<TI> chunk;
  __shared__ float b2s[FB], watt[FB];    // the block's slice
  __shared__ float att_part[SLICES][P];  // the slices' attention dots
  __shared__ float att_blk[P];           // the block's share, read by every block
  const unsigned rank = cluster_rank();
  const int col0 = (int)rank * FB;
  float* own = smem;
  float* staging = own + P * L::SS;
  W2ClusterRing<F> ring{g.mlp.w2 + col0, staging + P * L::SS, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + NS * L::STAGE);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int slice = warp;
  const bool attention = g.mlp.head != nullptr;

  for (int s = 0; s < NS - 1; ++s) ring.issue();
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  for (int k = t; k < FB; k += NT) {
    b2s[k] = tier_round<TIER>(g.mlp.b2[col0 + k]);
    watt[k] = attention ? tier_round<TIER>(g.mlp.head[col0 + k]) : 0.0f;
  }
  ClusterFill<F> fill;
  fill.k0 = col0 + t;
  fill.load_weights(g.mlp, node0, i0, g.N);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);
  const float b_att = attention ? g.b_att[0] : 0.0f;

  float msum[L::NTN][2];  // this lane's share of the row sum (pairs gid, gid + 8)
#pragma unroll
  for (int n = 0; n < L::NTN; ++n) msum[n][0] = msum[n][1] = 0.0f;

  fill.load_cols(g.mlp, cols, count, 0, node0);
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
               c0, g.cut);
    __syncthreads();
    fill.template fill_own<TIER>(chunk, own);
    cluster_sync();  // every block's part of S is filled
    fill.load_cols(g.mlp, cols, count, c0 + TJ, node0);
    float acc[1][L::NTN][4];
    product_wide<F, TIER>(own, staging, rank, ring, acc);

    // ---- epilogue: silu, attention gate (a sum over the blocks), row sum
    float part[2] = {0.0f, 0.0f};  // attention dots of pairs gid, gid + 8
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][n][e] = tier_silu<TIER>(tier_round<TIER>(acc[0][n][e] + b2s[f + (e & 1)]));
        part[e >> 1] = fmaf(acc[0][n][e], watt[f + (e & 1)], part[e >> 1]);
      }
    }
    float gate[2] = {chunk.adj[gid], chunk.adj[gid + 8]};
    if (attention) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
        part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
        if (tig == 0) att_part[slice][gid + 8 * h] = part[h];
      }
      __syncthreads();
      if (t < P) {
        float dot = 0.0f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) dot += att_part[sl][t];
        att_blk[t] = dot;
      }
    }
    // the partials are written, and every peer's copy of this block's part
    // is done: the next chunk may refill it (the next att_blk write follows
    // the next chunk's first cluster barrier)
    cluster_sync();
    if (attention) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        gate[h] *= sigmoid_fast(cluster_sum<F>(att_blk, gid + 8 * h, b_att));
    }
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        msum[n][c] = fmaf(gate[1], acc[0][n][2 + c], fmaf(gate[0], acc[0][n][c], msum[n][c]));
  }
  cp_async_wait_all();  // the ring's look-ahead stages

#pragma unroll
  for (int n = 0; n < L::NTN; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        msum[n][c] += __shfl_xor_sync(0xffffffffu, msum[n][c], o);
  if (gid == 0 && dst_rows > 0) {
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = col0 + slice * L::FW + 8 * n + 2 * tig;
      dst[f] = msum[n][0] / g.nf;
      dst[f + 1] = msum[n][1] / g.nf;
    }
  }
  cluster_sync();  // every peer has read this block's last partials
}

// coord_tile_cluster at F = 4096, one block of a cluster of C = F / 1024,
// one pair MLP a call: the block's share of the head over its features, the
// sum of the C shares on rank 0 in rank order, and rank 0 alone computes the
// per-pair terms and writes the row's three coordinates to g.out.  smem:
// dynamic_smem<F>(N) bytes.
template <int F, bool CROSS, int TIER = TF32X3>
__device__ void coord_tile_wide(const CoordArgs& g, int batch, int i0, float* smem) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, SLICES = L::SLICES, FB = L::FB;
  const PairMlp& mlp = CROSS ? g.cross : g.coord;
  __shared__ Rows<TI> rows;
  __shared__ Chunk<TI> chunk;
  __shared__ float b2s[FB], w3s[FB];     // the block's slice
  __shared__ float phi_part[SLICES][P];  // the slices' head dots
  __shared__ float phi_blk[P];           // the block's share, read by rank 0
  __shared__ float trans[P][3], mean[3];
  const unsigned rank = cluster_rank();
  const int col0 = (int)rank * FB;
  float* own = smem;
  float* staging = own + P * L::SS;
  W2ClusterRing<F> ring{mlp.w2 + col0, staging + P * L::SS, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + NS * L::STAGE);

  const int t = threadIdx.x;
  const size_t node0 = (size_t)batch * g.N;

  for (int s = 0; s < NS - 1; ++s) ring.issue();
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (CROSS && t < 3) mean[t] = g.graph_mean[batch * 3 + t];
  for (int k = t; k < FB; k += NT) {
    b2s[k] = tier_round<TIER>(mlp.b2[col0 + k]);
    w3s[k] = tier_round<TIER>(mlp.head[col0 + k]);
  }
  ClusterFill<F> fill;
  fill.k0 = col0 + t;
  fill.load_weights(mlp, node0, i0, g.N);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);

  fill.load_cols(mlp, cols, count, 0, node0);
  float racc = 0.0f;  // rank 0: row sum of component t % 3 of row t / 3, t < 3*TI
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    fill.template fill_own<TIER>(chunk, own);
    cluster_sync();  // every block's part of S is filled
    fill.load_cols(mlp, cols, count, c0 + TJ, node0);
    float acc[1][L::NTN][4];
    product_wide<F, TIER>(own, staging, rank, ring, acc);
    head_parts<F, TIER>(acc, b2s, w3s, phi_part);
    __syncthreads();  // the slices' head dots are complete
    if (t < P) {
      float dot = 0.0f;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) dot += phi_part[sl][t];
      phi_blk[t] = dot;
    }
    // the shares are written, and every peer's copy of this block's part is done
    cluster_sync();
    if (rank != 0) continue;  // the other ranks' shares are read by rank 0

    if (t < P) {
      const int k = t / TJ, j = chunk.j[t];
      float tr[3] = {0.0f, 0.0f, 0.0f};
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        float phi = cluster_sum<F>(phi_blk, t, 0.0f);
        if (g.use_tanh) phi = tanhf(phi) * g.coords_range;
        if constexpr (CROSS) {
          const float xi0 = rows.x[k][0] - mean[0], xi1 = rows.x[k][1] - mean[1],
                      xi2 = rows.x[k][2] - mean[2];
          const float xj0 = xj[0] - mean[0], xj1 = xj[1] - mean[1],
                      xj2 = xj[2] - mean[2];
          tr[0] = xi1 * xj2 - xi2 * xj1;
          tr[1] = xi2 * xj0 - xi0 * xj2;
          tr[2] = xi0 * xj1 - xi1 * xj0;
          const float cnorm =
              sqrtf(tr[0] * tr[0] + tr[1] * tr[1] + tr[2] * tr[2] + 1e-8f) + g.norm_constant;
          const float wt = phi / cnorm * chunk.adj[t];
          for (int a = 0; a < 3; ++a) tr[a] *= wt;
        } else {
          const float norm = sqrtf(chunk.d2[t] + 1e-8f) + g.norm_constant;
          const float wt = phi / norm * chunk.adj[t];
          for (int a = 0; a < 3; ++a) tr[a] = wt * (rows.x[k][a] - xj[a]);
        }
      }
      for (int a = 0; a < 3; ++a) trans[t][a] = tr[a];
    }
    __syncthreads();
    if (t < 3 * TI) {
      const int k = t / 3, a = t % 3;
      for (int jj = 0; jj < TJ; ++jj) racc += trans[k * TJ + jj][a];
    }
  }
  cp_async_wait_all();  // the ring's look-ahead stages

  if (rank == 0 && t < 3 * TI) {
    const int i = i0 + t / 3;
    if (i < g.N) g.out[(node0 + i) * 3 + t % 3] = racc / g.nf;
  }
  cluster_sync();  // rank 0 has read the other ranks' last shares
}

// ---- block_fused.cu's node products at F = 4096 (WideLayout)

// Part q (features [q * FB, q * FB + FB)) of rows node_of[r] of `src`
// (nodes x F, global memory, 16-byte aligned) -> dst (P rows at stride SS);
// zeros for the rows of no node (node_of[r] < 0).
template <int F>
__device__ __forceinline__ void load_part_rows(float* dst, const float* src,
                                               const int* node_of, int q) {
  using L = Layout<F>;
  constexpr int V = L::FB / 4;  // 16-byte vectors a row's part
  for (int e = threadIdx.x; e < L::P * V; e += NT) {
    const int r = e / V, v = e % V, node = node_of[r];
    *reinterpret_cast<float4*>(dst + r * L::SS + 4 * v) =
        node >= 0
            ? *reinterpret_cast<const float4*>(src + (size_t)node * F + q * L::FB + 4 * v)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// acc (ZERO: =, else +=) A @ the ring's next matrix, the block's FB columns
// over all K = F rows: the C parts of FB rows in order q = 0 .. C-1, part
// q's A tile (P rows at stride SS) being part(q), each part's k-steps
// accumulating onto the last's (the order of one K = F product, as
// product_wide).  part(q) may refill a buffer after a block sync (every warp
// done with the last part); its writes are complete at the product's first
// acquire sync.
template <int F, int TIER, bool ZERO, class Ring, class Part>
__device__ __forceinline__ void product_walk(Ring& ring, float (&acc)[1][Layout<F>::NTN][4],
                                             Part part) {
  using L = Layout<F>;
  if constexpr (ZERO) {
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.0f;
  }
#pragma unroll 1
  for (int q = 0; q < L::CLUSTER; ++q) product_tc<F, 1, false, false, TIER>(part(q), ring, acc);
}

}  // namespace mma

// The row tile of a cluster's blocks (clusters along x, blockIdx.x / C).
template <int F>
__device__ __forceinline__ int cluster_tile() {
  return blockIdx.x / cluster_size<F>();
}

// zero_rows_past_grid for a grid of clusters: the grid covers gridDim.x / C
// row tiles of TI rows; its blocks share the zeroing of the rows past them.
template <int F>
__device__ __forceinline__ void zero_rows_past_clusters(float* out, size_t node0, int N,
                                                        int W) {
  constexpr int TI = tile_rows<F>();
  const int tail0 = gridDim.x / cluster_size<F>() * TI;
  if (tail0 >= N) return;
  float* tail = out + (node0 + tail0) * W;
  const int n = (N - tail0) * W;
  for (int e = blockIdx.x * NT + threadIdx.x; e < n; e += gridDim.x * NT) tail[e] = 0.0f;
}

// The cluster dimension (x) of the library's last kernel launch: 1 for the
// launches without a cluster; C for launch_clusters<C>.
inline int& last_cluster_dim() {
  static int dim = 1;
  return dim;
}

// Launches kernel(args...) on `grid` (x a multiple of C) of NT-thread blocks
// with `smem` bytes of dynamic shared memory, in clusters of C blocks along
// x.  Refuses the launch (cudaErrorLaunchOutOfResources) when not even one
// cluster of C such blocks fits the card.  Returns the CUDA error code.
template <int C, class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), dim3 grid, size_t smem,
                    cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  last_cluster_dim() = C;
  return (int)cudaGetLastError();
}

}  // namespace egnn

// The cluster dimension (x) of the library's last launch (1: no cluster).
extern "C" int egnn_last_cluster_dim() { return egnn::last_cluster_dim(); }
