// Hidden widths F = 2048 and 4096 for the two backward kernels
// (gcl_agg_bwd.cu, coord_agg_bwd.cu): a row tile's pair MLP backward on a
// thread-block cluster of C = F / 1024 blocks, as egnn_cluster.cuh does the
// forward; for sm_90a.
//
// Why a cluster: one block of F = 1024's backward design would hold S and
// D of its one m-tile over 2048 features (2 x 131 KB) and a W2 ring of 8-row
// stages (132 KB), over the 227 KB a block may have, and twice F = 1024's
// accumulators a thread, which already reaches 255 registers.
//
// Design.  Block r of a cluster owns features [1024 r, 1024 r + 1024) of
// the row tile (r = cluster_rank(), col0 = 1024 r) twice over: as output
// features O_r of the forward recompute and of dW2's columns, and as input
// features I_r of dm1 (the same range).  Every warp runs F = 1024's layout
// on the block's 1024 features (Layout<2048> in egnn_cluster.cuh: one
// m-tile of P = 16 pairs, 8 slices of 128 features, stages of 8 rows, the
// step sums, four fill features a thread).  Two regions of dynamic shared
// memory are reused phase by phase:
//
//   A (P x 2048 floats, 128 KB, swizzled as egnn_mma_bwd.cuh's S and D at
//     row stride 2048): S = silu(pre) of all 2048 features for products 1
//     and 2, then dz2 of all 2048 features for product 3;
//   B (66 KB): the W2 ring of products 1 and 3, else a P x 1024 tile of the
//     block's features (swizzled at row stride 1024): dz2 for product 2,
//     then dm1 and dpre.
//
// Per chunk of 16 pairs (X: a cluster barrier, barrier.cluster):
//   1. each block fills its half of S into A; X1; it copies the peer's half
//      from the peer's A through distributed shared memory (the swizzle
//      moves floats only within aligned 32-float groups, so a half sits at
//      the same positions at either row stride) while the first W2 stage
//      loads; product 1: z = S @ W2[:, O_r] (K = 2048, W2's columns O_r
//      streamed, 8 MB a chunk);
//   2. the epilogue needs two sums over all 2048 features a pair (the GCL's
//      m2 . w_att and m2 . g, the coordinate head m2 . w3): each block writes
//      its share; X2; each adds the peer's in a fixed order, rank 0's first,
//      so that both blocks compute the same gate; dz2[:, O_r] goes to B;
//   3. product 2: dW2[:, O_r] += S^T dz2[:, O_r] (both in shared memory),
//      into the cluster's dW2 slab in global memory, the block's columns;
//   4. each block writes its dz2 half into A; X3; it copies the peer's half
//      as in 1; product 3: dm1[:, I_r] = dz2 @ W2^T[:, I_r] (W2^T's columns
//      I_r streamed);
//   5. dm1 goes to B; in the fill layout silu'(pre) is recomputed from the
//      registers that filled S (pre is not kept: no room), dpre = dm1 *
//      silu'(pre), and its sums over the chunk go to da_row, the da_col slab
//      and the first-layer weights' cotangents of I_r; the pair sums dpre .
//      w_d2 and dpre . w_d20 (the distance cotangents) are each block's
//      share; X4; rank 0 adds the peer's (its own first) and scatters the
//      pair's coordinate cotangents.
// The ring starts afresh at each product (W2BwdRing<2048>::start) and
// issues no stage past it, so that B is free between the products.
//
// Ordering.  X1 also orders each fill of A after the peer's last copy from
// it (made before X4 of the previous chunk); X2 orders the dz2 writes into B
// after product 1's last stage and the peer's reads of the shares after
// their writes; X3 orders the copies of dz2 after both halves are in place;
// X4 orders the pair sums' reads after their writes, and a block reads the
// peer's shares only between the barrier after their writes and the next
// barrier, before which they are not rewritten.  A last barrier at the
// kernel's end keeps shared memory alive until the peer has read it.  Both
// blocks compact the same columns and so walk the same chunks: the barrier
// counts match.
//
// F = 4096 (written for any C = F / 1024 > 2, as egnn_cluster.cuh's
// WideLayout).  Region A would be 16 x 4096 floats, 262 KB, over a block's
// 227 KB, so a block holds a C-th of K at a time: A becomes two P x FB
// buffers, OWN and STG (swizzled at row stride FB; A's 128 KB as at 2048), B
// stays.  Block r owns O_r = I_r = [1024 r, +1024) in F = 1024's warp
// layout; every product over K = F walks the C parts of FB rows in rank
// order, part q from this block (q = r) or from peer q through DSMEM, the
// parts' k-steps accumulating in the order of one K = F product
// (product_sw<1024> of each part onto the last, the ring streaming all F
// rows of the block's columns).  Per chunk:
//   1. each block fills its quarter of S into OWN; X1; product 1: z = S @
//      W2[:, O_r], the peers' parts copied into STG;
//   2. the pair sums over all features (m2 . w_att, m2 . g, m2 . w3) add the
//      C shares in rank order, rank 0's first, from DSMEM: every block the
//      same bits; X2 before; dz2[:, O_r] goes to STG (D);
//   3. product 2: dW2[:, O_r] += S^T dz2[:, O_r], rows [1024 q, +1024) from
//      part q of S: the own part from OWN, a peer's copied into B (free
//      between the products) from the peer's OWN a second time (recomputing
//      S_q from a_row, a_col and the distances would load a C-th of the
//      fill's projections again for each peer part; a copy is 64 KB of DSMEM
//      against the 32 MB of W2 and W2^T a block streams a chunk);
//   4. X3 (every block's dz2 is in its STG, and no block reads another's
//      OWN any more); product 3: dm1[:, I_r] = dz2 @ W2^T[:, I_r], the own
//      part from STG, peer q's copied from its STG into OWN (OWN is free
//      after X3);
//   5. dm1 -> B, dpre as at 2048; the distance cotangents' C shares added in
//      rank order; X4 (every peer's reads of this block's STG are done, so
//      that the next chunk's product 1 may stage into it); rank 0 scatters.
// The roles of OWN and STG swap between products 1-2 and 3 so that a
// block's own part of S stays put until X3 and no fifth barrier is needed.
// Shared memory: 198,528 B dynamic at N = 352 (A, B, the columns), as at
// 2048.
//
// Who writes what.  Each block writes only its own features' cotangents:
// its columns of dW2 and of the da_col slab, da_row, and its halves of
// db2, the head's cotangent (w_att, w3) and the first layer's (w_d2,
// w_d20, delta).  What both blocks hold alike is written by rank 0 alone:
// the attention bias's cotangent, the dx / dx0 scatter, dmean.  The slabs
// are per cluster (Q counts clusters) and summed by egnn_bwd.cuh's
// reduce_partials as at the narrower widths: no atomics, deterministic.
#pragma once
#include "egnn_cluster.cuh"
#include "egnn_mma_bwd.cuh"

namespace egnn {
namespace mma {

// The backward ring of a cluster block: stage g holds rows (g % KS) * KC ..
// + KC of the block's columns [col0, col0 + FB) of W2 (g / KS even) or of
// W2^T (odd), KS = F / KC the stages of one product over all K = F rows; w2
// and w2t point at column col0.  A product starts it (start) and its
// acquires issue no stage past the product's last, so B holds nothing of the
// ring between the products.
template <int F>
struct W2BwdClusterRing {
  using L = Layout<F>;
  static constexpr int KS = F / L::KC;  // stages a product
  const float* w2;   // W2 + col0
  const float* w2t;  // W2^T + col0
  float* buf;        // NS * STAGE floats
  int next;          // next stage to issue

  __device__ __forceinline__ void issue() {
    constexpr int V = L::FB / 4;  // 16-byte vectors per stage row
    float* dst = buf + (next % NS) * L::STAGE;
    const float* src =
        ((next / KS) & 1 ? w2t : w2) + (size_t)(next % KS) * L::KC * F;
    for (int e = threadIdx.x; e < L::KC * V; e += NT) {
      const int r = e / V, v = e % V;
      cp_async16(dst + r * L::WS + 4 * v, src + (size_t)r * F + 4 * v);
    }
    cp_async_commit();
    ++next;
  }

  // The first stage of W2 (transpose false) or of W2^T: a product's
  // prologue.  The buffers must be free.
  __device__ __forceinline__ void start(bool transpose) {
    next = transpose ? KS : 0;
    issue();
  }

  // As W2BwdRing::acquire, without a look-ahead past the product's stages.
  __device__ __forceinline__ const float* acquire() {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const float* stage = buf + ((next - (NS - 1)) % NS) * L::STAGE;
    if (next % KS != 0) issue();
    return stage;
  }
};

// Floats of region A at either width: P x 2048 (S, then dz2, of all
// features at F = 2048; OWN and STG, P x FB each, wider).
inline constexpr int kRegionA = Layout<2048>::P * 2048;

// Dynamic shared memory of the cluster backward bodies: A, B, the columns.
inline constexpr size_t dynamic_smem_bwd_cluster(int N) {
  return sizeof(float) * ((size_t)kRegionA + (size_t)NS * Layout<2048>::STAGE)
       + sizeof(int) * (size_t)N;
}
static_assert(NS * Layout<2048>::STAGE >= Layout<2048>::P * Layout<2048>::FB,
              "B holds a P x FB tile");
static_assert(Layout<2048>::P == 2 * (NT / 32), "pair_dots: two pairs a warp");
static_assert(2 * Layout<4096>::P * Layout<4096>::FB == kRegionA &&
              Layout<4096>::STAGE == Layout<2048>::STAGE &&
              Layout<4096>::FE == Layout<2048>::FE && Layout<4096>::NTN == Layout<2048>::NTN &&
              Layout<4096>::FB == Layout<2048>::FB && Layout<4096>::P == Layout<2048>::P &&
              Layout<4096>::FW == Layout<2048>::FW && Layout<1024>::STAGE == Layout<4096>::STAGE,
              "F = 4096's block: F = 2048's regions and block layout (the pieces below "
              "that name Layout<2048> serve both), F = 1024's stages");

// A block's sums over its row tiles: features col0 + t + e * NT of the fill
// layout (head unused), the head's cotangent of the block's features (hvs:
// shared [FB], zero at the start) and the attention bias's.
struct ClusterBwdState {
  FeatAcc fa[Layout<2048>::FE];
  float* hvs;
  float dbatt;
};

// The peer's half of A (its columns [peer * FB, peer * FB + FB) of the P
// rows) into this block's A, through distributed shared memory.  The peer's
// writes must be complete (a cluster barrier before).
__device__ __forceinline__ void copy_peer_cols(float* A, unsigned peer) {
  using L = Layout<2048>;
  constexpr int V = L::FB / 4;  // 16-byte vectors a row
  const uint32_t remote = peer_address(A, peer);
  const int col0 = (int)peer * L::FB;
#pragma unroll 4
  for (int e = threadIdx.x; e < L::P * V; e += NT) {
    const int off = (e / V) * 2048 + col0 + 4 * (e % V);
    *reinterpret_cast<float4*>(A + off) = load_peer4(remote + 4u * (unsigned)off);
  }
}

// Above 2048: peer `peer`'s P x FB part at `src` (this block's address of
// the same buffer: OWN or STG, row stride FB) into `dst`, through
// distributed shared memory.  The peer's writes must be complete (a cluster
// barrier before).
template <int F>
__device__ __forceinline__ void copy_peer_quarter(float* dst, const float* src, unsigned peer) {
  constexpr int V = Layout<F>::P * Layout<F>::FB / 4;  // 16-byte vectors
  const uint32_t remote = peer_address(src, peer);
#pragma unroll 4
  for (int e = threadIdx.x; e < V; e += NT)
    *reinterpret_cast<float4*>(dst + 4 * e) = load_peer4(remote + 16u * (unsigned)e);
}

// S[p][k] = silu(pre) of the block's features k = fill.k0 + e * NT into A
// (swizzled at row stride 2048; 0 without an edge).
__device__ __forceinline__ void fill_m1_cluster(const ClusterFill<2048>& fill,
                                                const Chunk<1>& c, float* A) {
#pragma unroll
  for (int e = 0; e < Layout<2048>::FE; ++e)
    fill_m1_half<2048>(fill.h[e].w, c, fill.h[e].a_row, fill.h[e].a_col, fill.k0 + e * NT, A);
}

// fill_m1_cluster above 2048: the block's features into OWN (row stride FB,
// feature fill.k0 + e * NT at column threadIdx.x + e * NT), F = 1024's fill.
template <int F>
__device__ __forceinline__ void fill_m1_own(const ClusterFill<F>& fill, const Chunk<1>& c,
                                            float* own) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE; ++e)
    fill_m1_half<Layout<F>::FB>(fill.h[e].w, c, fill.h[e].a_row, fill.h[e].a_col,
                                threadIdx.x + e * NT, own);
}

// dw2[k][n] += sum_p S[p][k] * D[p][n] for k < K and the block's n < FB:
// S a P x K tile (row stride K: all of A at F = 2048, one part of K wider),
// D the block's dz2 tile (row stride FB), dw2 the cluster's slab at column
// col0 and at S's first feature's row (row stride F).  Bit s of kmask is
// clear when pairs 8s .. 8s+7 have no edge (their rows of S and D are zero):
// that k-step is skipped.  F = 1024's warp layout of dw2_tc over each 1024
// rows: warp w owns dW2 rows 128 w .. + 127 (8 m-tiles), one n-tile of
// every slab of 8 columns.  S and D must be complete.  TIER: as dw2_tc's.
template <int TIER, int F = 2048, int K = F>
__device__ __forceinline__ void dw2_cluster(const float* S, const float* D, unsigned kmask,
                                            float* dw2) {
  using L = Layout<F>;
  constexpr int FB = L::FB, P = L::P;
  constexpr int WM2 = 8, RG = NT / 32, SW = 8;  // m-tiles a warp, warps, columns a slab
  const int lane = threadIdx.x & 31, rg = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // swizzled columns gid, gid + 8 in pair rows tig (x0) and tig + 4 (x4)
  const int x0 = swz(tig), x4 = swz(tig + 4);
  const int g0 = gid ^ x0, g8 = (gid + 8) ^ x0, h0 = gid ^ x4, h8 = (gid + 8) ^ x4;

#pragma unroll 1
  for (int r0 = 0; r0 < K; r0 += RG * WM2 * 16) {
#pragma unroll 1
    for (int s0 = 0; s0 < FB; s0 += SW) {
      float2 old[WM2][2];
#pragma unroll
      for (int m = 0; m < WM2; ++m) {
        const float* r = dw2 + (size_t)(r0 + (rg * WM2 + m) * 16 + gid) * F + s0 + 2 * tig;
        old[m][0] = *reinterpret_cast<const float2*>(r);
        old[m][1] = *reinterpret_cast<const float2*>(r + 8 * F);
      }
      float acc[WM2][4];
#pragma unroll
      for (int m = 0; m < WM2; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

      if constexpr (TIER == BF16) {
#pragma unroll 1
        for (int kp = 0; kp < P; kp += 16) {
          if (!((kmask >> (kp / 8)) & 3u)) continue;
          const int k0 = kp + 2 * tig;  // pairs k0, k0 + 1, k0 + 8, k0 + 9
          uint32_t a[WM2][4];
#pragma unroll
          for (int m = 0; m < WM2; ++m) {
            const int f0 = r0 + (rg * WM2 + m) * 16 + gid;  // A[gid][.] = S[.][f0]
            a[m][0] = pack_bf16(S[at<K>(k0, f0)], S[at<K>(k0 + 1, f0)]);
            a[m][1] = pack_bf16(S[at<K>(k0, f0 + 8)], S[at<K>(k0 + 1, f0 + 8)]);
            a[m][2] = pack_bf16(S[at<K>(k0 + 8, f0)], S[at<K>(k0 + 9, f0)]);
            a[m][3] = pack_bf16(S[at<K>(k0 + 8, f0 + 8)], S[at<K>(k0 + 9, f0 + 8)]);
          }
          const int c = s0 + gid;  // B[.][gid] = D[.][c]
          const uint32_t b0 = pack_bf16(D[at<FB>(k0, c)], D[at<FB>(k0 + 1, c)]);
          const uint32_t b1 = pack_bf16(D[at<FB>(k0 + 8, c)], D[at<FB>(k0 + 9, c)]);
#pragma unroll
          for (int m = 0; m < WM2; ++m) mma_bf16(acc[m], a[m], b0, b1);
        }
      } else {
#pragma unroll 1
        for (int kp = 0; kp < P; kp += 8) {
          if (!((kmask >> (kp / 8)) & 1u)) continue;
          const float* s0r = S + (kp + tig) * K;
          const float* s4r = S + (kp + tig + 4) * K;
          const float* d0r = D + (kp + tig) * FB;
          const float* d4r = D + (kp + tig + 4) * FB;
          uint32_t a_hi[WM2][4], a_lo[WM2][4];
#pragma unroll
          for (int m = 0; m < WM2; ++m) {
            const int m0 = r0 + (rg * WM2 + m) * 16;
            split(s0r[m0 ^ g0], a_hi[m][0], a_lo[m][0]);  // A[gid][tig]
            split(s0r[m0 ^ g8], a_hi[m][1], a_lo[m][1]);  // A[gid + 8][tig]
            split(s4r[m0 ^ h0], a_hi[m][2], a_lo[m][2]);  // A[gid][tig + 4]
            split(s4r[m0 ^ h8], a_hi[m][3], a_lo[m][3]);  // A[gid + 8][tig + 4]
          }
          uint32_t b_hi[2], b_lo[2];
          split(d0r[s0 ^ g0], b_hi[0], b_lo[0]);  // B[tig][gid]
          split(d4r[s0 ^ h0], b_hi[1], b_lo[1]);  // B[tig + 4][gid]
#pragma unroll
          for (int m = 0; m < WM2; ++m) mma_tf32(acc[m], a_lo[m], b_hi[0], b_hi[1]);
          if constexpr (TIER == TF32X3) {
#pragma unroll
            for (int m = 0; m < WM2; ++m) mma_tf32(acc[m], a_hi[m], b_lo[0], b_lo[1]);
          }
#pragma unroll
          for (int m = 0; m < WM2; ++m) mma_tf32(acc[m], a_hi[m], b_hi[0], b_hi[1]);
        }
      }

#pragma unroll
      for (int m = 0; m < WM2; ++m) {
        float* r = dw2 + (size_t)(r0 + (rg * WM2 + m) * 16 + gid) * F + s0 + 2 * tig;
        *reinterpret_cast<float2*>(r) =
            make_float2(old[m][0].x + acc[m][0], old[m][0].y + acc[m][1]);
        *reinterpret_cast<float2*>(r + 8 * F) =
            make_float2(old[m][1].x + acc[m][2], old[m][1].y + acc[m][3]);
      }
    }
  }
}

// The fill layout's db2 sums of the block's features over the chunk: D its
// dz2 tile (row stride FB), complete.
__device__ __forceinline__ void add_db2(const float* D, FeatAcc (&fa)[Layout<2048>::FE]) {
  using L = Layout<2048>;
#pragma unroll
  for (int e = 0; e < L::FE; ++e) {
    const int k = threadIdx.x + e * NT;
#pragma unroll
    for (int p = 0; p < L::P; ++p) fa[e].b2 += D[at<L::FB>(p, k)];
  }
}

// The block's dz2 tile (B, row stride FB) into its columns [col0, col0 +
// FB) of A (row stride 2048: the same positions within each row, as the
// swizzle stays within 32-float groups), and add_db2.  B must be complete.
__device__ __forceinline__ void place_dz2_half(const float* Bt, float* A, int col0,
                                               FeatAcc (&fa)[Layout<2048>::FE]) {
  using L = Layout<2048>;
  constexpr int V = L::FB / 4;
  for (int e = threadIdx.x; e < L::P * V; e += NT) {
    const int p = e / V, v = e % V;
    *reinterpret_cast<float4*>(A + p * 2048 + col0 + 4 * v) =
        *reinterpret_cast<const float4*>(Bt + p * L::FB + 4 * v);
  }
  add_db2(Bt, fa);
}

// Product 2 above 2048: dw2 += S^T D over all F rows of dW2, rows [q FB,
// q FB + FB) from part q of S: OWN (q == rank) or peer q's OWN, copied into
// `staging` (B, free between the products).  D: the block's dz2 (row stride
// FB), complete; the peers keep their OWN until the next cluster barrier.
template <int F, int TIER>
__device__ __forceinline__ void dw2_parts(const float* own, const float* D, float* staging,
                                          unsigned rank, unsigned kmask, float* dw2) {
  using L = Layout<F>;
#pragma unroll 1
  for (int q = 0; q < L::CLUSTER; ++q) {
    const float* part = own;
    if (q != (int)rank) {
      __syncthreads();  // the staging's last part is no longer read
      copy_peer_quarter<F>(staging, own, (unsigned)q);
      __syncthreads();  // the part is complete
      part = staging;
    }
    dw2_cluster<TIER, F, L::FB>(part, D, kmask, dw2 + (size_t)q * L::FB * F);
  }
}

// Products 1 and 3 above 2048: acc = X @ M[:, the block's columns] over
// K = F in C parts of FB rows, in rank order (the k-steps of one K = F
// product): part q from `own` (q == rank) or from peer q's `own`, copied
// into `staging` through DSMEM; M streams through the ring (started).
// Every block's `own` must be complete (a cluster barrier before); the
// peers read it until the next cluster barrier.
template <int F, int TIER>
__device__ __forceinline__ void product_parts(const float* own, float* staging, unsigned rank,
                                              W2BwdClusterRing<F>& ring,
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
      copy_peer_quarter<F>(staging, own, (unsigned)q);
      part = staging;   // complete at the product's first acquire sync
    }
    product_sw<L::FB, TIER, false>(part, ring, acc);
  }
}

// The warp's C fragments (pairs gid, gid + 8; the block's features slice *
// FW + 8n + 2tig, + 1) into the P x FB tile Bt, swizzled.
__device__ __forceinline__ void store_fragments(
    const float (&acc)[1][Layout<2048>::NTN][4], float* Bt) {
  using L = Layout<2048>;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ce = (2 * tig) ^ swz(gid);  // C-fragment columns in rows gid, gid + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
      *reinterpret_cast<float2*>(Bt + (gid + 8 * h) * L::FB + ((slice * L::FW + 8 * n) ^ ce)) =
          make_float2(acc[0][n][2 * h], acc[0][n][2 * h + 1]);
}

// dpre = dm1 * silu'(pre) of the block's features in the fill layout (Bt:
// dm1 in, dpre out; pre recomputed from the registers that filled S, a_col
// still the chunk's), and its sums over the chunk: the row sums into
// h[e].arow, the first-layer weights' into fa, the column sums added into
// the cluster's da_col slab (columns fill.k0 + e * NT; the entries loaded
// first, so that the loads are in flight together).  Bt must be complete.
template <int F>
__device__ __forceinline__ void dpre_cluster(ClusterFill<F>& fill, const Chunk<1>& c,
                                             float* Bt, const int* cols, int count, int c0,
                                             FeatAcc (&fa)[Layout<F>::FE],
                                             float* acol_part) {
  using L = Layout<F>;
#pragma unroll
  for (int e = 0; e < L::FE; ++e) {
    FillHalf<F>& h = fill.h[e];
    const int k = threadIdx.x + e * NT, kg = fill.k0 + e * NT;
    float cs[TJ];
#pragma unroll
    for (int u = 0; u < TJ; ++u)
      cs[u] = c0 + u < count ? acol_part[(size_t)cols[c0 + u] * F + kg] : 0.0f;
#pragma unroll
    for (int u = 0; u < TJ; ++u) {  // pair u: TI = 1 row
      const float pre = pre_fill(h.w, c, u, h.a_row[0], h.a_col[u]);
      const float s = sigmoid_fast(pre);
      const float v = Bt[at<L::FB>(u, k)] * (s * fmaf(pre, 1.0f - s, 1.0f));
      Bt[at<L::FB>(u, k)] = v;
      cs[u] += v;
      h.arow[0] += v;
      fa[e].w_d2 = fmaf(v, c.d2[u], fa[e].w_d2);
      fa[e].w_d20 = fmaf(v, c.d20[u], fa[e].w_d20);
      fa[e].delta = fmaf(v, c.ll[u], fa[e].delta);
    }
#pragma unroll
    for (int u = 0; u < TJ; ++u)
      if (c0 + u < count) acol_part[(size_t)cols[c0 + u] * F + kg] = cs[u];
  }
}

// The block's shares of the pair sums dpre_p . w_d2 and dpre_p . w_d20 over
// its features (Bt: dpre; wd2s, wd20s: the block's parts) into share[0 /
// 1][p]: warp w sums pairs 2w and 2w + 1, each lane 32 features, then the
// lanes in a fixed order.  Bt must be complete.
__device__ __forceinline__ void pair_dots(const float* Bt, const float* wd2s,
                                          const float* wd20s,
                                          float (*share)[Layout<2048>::P]) {
  using L = Layout<2048>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = 2 * warp + i;
    float a = 0.0f, b = 0.0f;
#pragma unroll 8
    for (int f = lane; f < L::FB; f += 32) {
      const float v = Bt[at<L::FB>(p, f)];
      a = fmaf(v, wd2s[f], a);
      b = fmaf(v, wd20s[f], b);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      share[0][p] = a;
      share[1][p] = b;
    }
  }
}

// The two blocks' shares of a pair sum added in a fixed order, rank 0's
// first: the same value in both blocks (wider: egnn_cluster.cuh's
// cluster_sum<F>, the C shares in rank order).
__device__ __forceinline__ float cluster_sum(float own, float other, unsigned rank) {
  return (rank == 0 ? own : other) + (rank == 0 ? other : own);
}

// The head's cotangent of the warp's features over the chunk (hv: the
// lane's share of pairs gid, gid + 8): the 8 lane groups' shares added by
// lanes 0..3 into hvs.
__device__ __forceinline__ void add_head_cotangent(const float (&hv)[Layout<2048>::NTN][2],
                                                   float* hvs) {
  using L = Layout<2048>;
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int n = 0; n < L::NTN; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = hv[n][c];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (gid == 0) hvs[slice * L::FW + 8 * n + 2 * tig + c] += v;
    }
}

// The prologue of a row tile shared by the two bodies: the fill registers
// of the block's features (first-layer weights, a_row, zeroed row sums).
template <int F>
__device__ __forceinline__ void load_fill_cluster(ClusterFill<F>& fill, const PairMlp& m,
                                                  size_t node0, int i0, int N, int col0) {
  fill.k0 = col0 + threadIdx.x;
  fill.load_weights(m, node0, i0, N);
#pragma unroll
  for (int e = 0; e < Layout<F>::FE; ++e) fill.h[e].arow[0] = 0.0f;
}

// The block's da_row of row i0 (its features), when the row is live.
template <int F>
__device__ __forceinline__ void store_row_cluster(const ClusterFill<F>& fill, size_t node0,
                                                  int i0, int N, int update_rows,
                                                  float* da_row) {
  if (i0 >= N || i0 >= update_rows) return;
#pragma unroll
  for (int e = 0; e < Layout<F>::FE; ++e)
    da_row[(node0 + i0) * F + fill.k0 + e * NT] = fill.h[e].arow[0];
}

// One row tile of the GCL backward at F = 2048 or 4096, one block of a
// cluster of C = F / 1024 (the header): row i0 of the batch item at node0,
// slab `slab` of the per-cluster scratch.  A, Bt: the regions of dynamic
// shared memory (A: OWN, then STG, above 2048); cols: N ints.  Every block
// of the cluster must call it on the same row.  TIER: the precision tier of
// the three products.
template <int F, int TIER = TF32X3>
__device__ void gcl_bwd_tile_cluster(const GclBwdArgs& g, size_t node0, size_t slab, int i0,
                                     float* A, float* Bt, int* cols, W2BwdClusterRing<F>& ring,
                                     ClusterBwdState& st) {
  using L = Layout<F>;
  constexpr int P = L::P, FB = L::FB, SLICES = L::SLICES;
  constexpr bool WIDE = L::CLUSTER > 2;
  __shared__ Rows<1> rows;
  __shared__ __align__(16) Chunk<1> chunk;
  __shared__ float rowc[P][6], colc[P][6];
  __shared__ float b2s[FB], watt[FB], wd2s[FB], wd20s[FB];  // the block's parts
  __shared__ float gs[FB];                 // g / nf of the row's block features
  __shared__ float xpart[2][SLICES][P];    // the slices' shares of two pair sums
  __shared__ float share[2][P];            // the block's shares, read by the peers

  const unsigned rank = cluster_rank(), peer = rank ^ 1u;
  const int col0 = (int)rank * FB;
  const int t = threadIdx.x, lane = t & 31, slice = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const bool attention = g.mlp.head != nullptr;
  const float b_att = attention ? g.b_att[0] : 0.0f;
  const bool live = i0 < g.N && i0 < g.update_rows;
  float* acol_part = g.acol_part + slab * (size_t)g.N * F;
  float* dx_part = g.dx_part + slab * (size_t)g.N * 6;
  float* dw2 = g.w_part + slab * weight_slab(F) + col0;
  float* D = WIDE ? A + P * FB : Bt;  // the block's dz2: STG, or B at 2048

  __syncthreads();  // the previous tile is no longer read
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  for (int e = t; e < FB; e += NT) {
    b2s[e] = g.mlp.b2[col0 + e];
    watt[e] = attention ? g.mlp.head[col0 + e] : 0.0f;
    wd2s[e] = g.mlp.w_d2[col0 + e];
    wd20s[e] = g.mlp.w_d20[col0 + e];
    gs[e] = live ? g.g[(node0 + i0) * F + col0 + e] * g.inv_nf : 0.0f;
  }
  ClusterFill<F> fill;
  load_fill_cluster(fill, g.mlp, node0, i0, g.N, col0);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);
  fill.load_cols(g.mlp, cols, count, 0, node0);
  const uint32_t peer_share = peer_address(share, peer);
  const int ce = (2 * tig) ^ swz(gid);  // C-fragment columns in rows gid, gid + 8

  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
               c0, g.cut);
    __syncthreads();
    const unsigned kmask = edge_ksteps16(chunk.j, lane);
    float acc[1][L::NTN][4];
    if constexpr (WIDE) {
      fill_m1_own(fill, chunk, A);
      cluster_sync();  // X1: every block's part of S is filled
      ring.start(false);
      product_parts<F, TIER>(A, A + P * FB, rank, ring, acc);  // z2 - b2 = m1 @ W2[:, O_r]
    } else {
      fill_m1_cluster(fill, chunk, A);
      cluster_sync();  // X1: both halves of S are filled
      ring.start(false);
      copy_peer_cols(A, peer);
      product_sw<F, TIER>(A, ring, acc);  // z2 - b2 = m1 @ W2[:, O_r]
    }

    // ---- epilogue: m2, the attention gate and its cotangent, dz2 -> B
    float pa[2] = {0.0f, 0.0f}, pg[2] = {0.0f, 0.0f};  // m2 . w_att, m2 . g
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = acc[0][n][e] + b2s[f + (e & 1)];
        acc[0][n][e] = z;
        const float m2 = silu_fast(z);
        pa[e >> 1] = fmaf(m2, watt[f + (e & 1)], pa[e >> 1]);
        pg[e >> 1] = fmaf(m2, gs[f + (e & 1)], pg[e >> 1]);
      }
    }
    if (attention) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 1);
        pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 2);
        pg[h] += __shfl_xor_sync(0xffffffffu, pg[h], 1);
        pg[h] += __shfl_xor_sync(0xffffffffu, pg[h], 2);
        if (tig == 0) {
          xpart[0][slice][gid + 8 * h] = pa[h];
          xpart[1][slice][gid + 8 * h] = pg[h];
        }
      }
      __syncthreads();
      if (t < P) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) {
          a += xpart[0][sl][t];
          b += xpart[1][sl][t];
        }
        share[0][t] = a;
        share[1][t] = b;
      }
    }
    cluster_sync();  // X2: the shares are written, product 1's stages read
    float gate[2], dattz[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = gid + 8 * h;
      gate[h] = chunk.adj[p];
      if (attention) {
        float dot, pgs;
        if constexpr (WIDE) {
          dot = cluster_sum<F>(share[0], p, b_att);
          pgs = cluster_sum<F>(share[1], p, 0.0f);
        } else {
          dot = b_att + cluster_sum(share[0][p], load_peer(peer_share + 4u * p), rank);
          pgs = cluster_sum(share[1][p], load_peer(peer_share + 4u * (P + p)), rank);
        }
        const float att = sigmoid_fast(dot), adj = gate[h];
        dattz[h] = pgs * adj * att * (1.0f - att);
        gate[h] = adj * att;
        if (slice == 0 && tig == 0) st.dbatt += dattz[h];
      }
    }
    float hv[L::NTN][2];  // the lane's share of dw_att over the chunk
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) hv[n][0] = hv[n][1] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = gid + 8 * h;
#pragma unroll
      for (int n = 0; n < L::NTN; ++n) {
        const int f = slice * L::FW + 8 * n + 2 * tig;
        float dz2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float z = acc[0][n][2 * h + c];
          const float s = sigmoid_fast(z);
          const float dm2 = fmaf(gs[f + c], gate[h], dattz[h] * watt[f + c]);
          dz2[c] = dm2 * s * fmaf(z, 1.0f - s, 1.0f);
          hv[n][c] = fmaf(z * s, dattz[h], hv[n][c]);
        }
        *reinterpret_cast<float2*>(D + p * FB + ((slice * L::FW + 8 * n) ^ ce)) =
            make_float2(dz2[0], dz2[1]);
      }
    }
    if (attention) add_head_cotangent(hv, st.hvs);
    __syncthreads();  // dz2 complete
    if constexpr (WIDE) {
      add_db2(D, st.fa);
#ifndef EGNN_SKIP_DW2  // defined only in a timing build (chip_smoke.py 20i): dW2 stays 0
      dw2_parts<F, TIER>(A, D, Bt, rank, kmask, dw2);
#endif
      cluster_sync();  // X3: every dz2 part is in place, no block reads another's S
      ring.start(true);
      product_parts<F, TIER>(D, A, rank, ring, acc);  // dm1[:, I_r] = dz2 @ W2^T[:, I_r]
    } else {
#ifndef EGNN_SKIP_DW2  // defined only in a timing build (chip_smoke.py 20i): dW2 stays 0
      dw2_cluster<TIER>(A, Bt, kmask, dw2);
#endif
      __syncthreads();  // A and B no longer read
      place_dz2_half(Bt, A, col0, st.fa);
      cluster_sync();  // X3: both halves of dz2 are placed
      ring.start(true);
      copy_peer_cols(A, peer);
      product_sw<F, TIER>(A, ring, acc);  // dm1[:, I_r] = dz2 @ W2^T[:, I_r]
    }
    __syncthreads();  // the last stage is read
    store_fragments(acc, Bt);
    __syncthreads();  // dm1 complete
    dpre_cluster(fill, chunk, Bt, cols, count, c0, st.fa, acol_part);
    fill.load_cols(g.mlp, cols, count, c0 + TJ, node0);  // the next chunk's
    __syncthreads();  // dpre complete
    pair_dots(Bt, wd2s, wd20s, share);
    cluster_sync();  // X4: the pair sums' shares are written

    // ---- squared-distance cotangents -> coordinates: rank 0
    if (rank != 0) continue;
    if (t < P) {
      const int j = chunk.j[t];
      for (int a = 0; a < 6; ++a) { rowc[t][a] = 0.0f; colc[t][a] = 0.0f; }
      if (j >= 0) {
        float dd2, dd20;
        if constexpr (WIDE) {
          dd2 = cluster_sum<F>(share[0], t, 0.0f);
          dd20 = cluster_sum<F>(share[1], t, 0.0f);
        } else {
          dd2 = cluster_sum(share[0][t], load_peer(peer_share + 4u * t), rank);
          dd20 = cluster_sum(share[1][t], load_peer(peer_share + 4u * (P + t)), rank);
        }
        const float* xj = g.x + (node0 + j) * 3;
        const float* x0j = g.x0 + (node0 + j) * 3;
        for (int a = 0; a < 3; ++a) {
          const float v = 2.0f * dd2 * (rows.x[0][a] - xj[a]);
          const float v0 = 2.0f * dd20 * (rows.x0[0][a] - x0j[a]);
          rowc[t][a] = v; colc[t][a] = -v;
          rowc[t][3 + a] = v0; colc[t][3 + a] = -v0;
        }
      }
    }
    __syncthreads();
    scatter_dx<1>(rowc, colc, cols, count, c0, i0, g.N, dx_part);  // ends with a sync
  }
  store_row_cluster(fill, node0, i0, g.N, g.update_rows, g.da_row);
}

// Writes the block's vector cotangents into its cluster's weight slab
// (weight_slab: [dW2][w_d2][w_d20][delta][b2][head][head bias]): its
// features' parts, and rank 0 the head bias (the attention bias's
// cotangent, summed over the block in a fixed order).  scratch: NT floats
// of shared memory the peers no longer read.
template <int F>
__device__ __forceinline__ void store_cluster_bwd_state(const ClusterBwdState& st,
                                                        float* w_part, float* scratch,
                                                        unsigned rank) {
  using L = Layout<F>;
  const int t = threadIdx.x, col0 = (int)rank * L::FB;
  __syncthreads();  // scratch is no longer read, hvs complete
  scratch[t] = st.dbatt;
  __syncthreads();
  float* v = w_part + (size_t)F * F;
#pragma unroll
  for (int e = 0; e < L::FE; ++e) {
    const FeatAcc& a = st.fa[e];
    const int f = t + e * NT;
    const float vals[5] = {a.w_d2, a.w_d20, a.delta, a.b2, st.hvs[f]};
#pragma unroll
    for (int j = 0; j < 5; ++j) v[j * F + col0 + f] = vals[j];
  }
  if (rank == 0 && t == 0) {
    float s = 0.0f;
    for (int e = 0; e < NT; ++e) s += scratch[e];
    v[5 * F] = s;
  }
}

}  // namespace mma
}  // namespace egnn
