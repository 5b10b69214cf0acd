// The GCL backward row-tile body on Hopper's tensor cores (gcl_agg_bwd.cu),
// f32-grade, for sm_90a.
//
// Per chunk of P = 64 pairs (egnn_common.cuh's tiling) and one pair MLP,
// three F x F products, each in 3xTF32 on mma.sync.m16n8k8 (egnn_mma.cuh:
// operands split hi + lo, lo*hi + hi*lo + hi*hi):
//
//   1. the forward recompute  acc = m1 @ W2,   m1 = silu(pre) in S;
//   2. dW2 += m1^T dz2,       dz2 in D (the epilogue of 1 writes it);
//   3. dm1  = dz2 @ W2^T,     then dpre = dm1 * silu'(pre).
//
// Products 1 and 3 run egnn_mma.cuh's warp layout (2 row groups x 4 feature
// slices, the C fragments of a warp = 2 rows' 32 pairs x F/4 features) with
// W2 and then W2^T streamed through one 2-stage cp.async ring of KC = 32
// rows (W2BwdRing: two matrices a chunk, the next stage in flight while the
// tensor cores work on this one; the next chunk's first W2 stage loads during
// the dpre sums).  Product 2 has both operands in shared memory and K = P:
// the warps cover dW2 in column slabs of 32 (at F = 256, 2 m-tiles x 4
// n-tiles a warp; at F = 512 slabs of 16, 4 m-tiles x 2 n-tiles), and each
// slab is added into the block's F x F slab in
// global scratch, one read and one write a chunk, no atomics; a slab's
// entries are loaded before its products, so that the loads are in flight
// while the tensor cores work (with slabs of 64 the read's latency stood
// bare and cost more than the extra splits of narrower slabs save).
//
// Shared-memory layout.  S and D are P x F tiles, row stride F, each row
// XOR-swizzled: element (p, k) lives at p*F + (k ^ swz(p)), swz(p) =
// g(p & 7) << 2 with g(v) = ((v & 3) << 1) | (v >> 2).  The swizzle moves
// 4-float groups within each aligned 32-float group, so a row stays a row:
//  * row-major A fragments (products 1 and 3: lane (gid, tig) reads row
//    gid, column tig) hit bank 4*((c ^ g(gid)) & 7) + tig: g is a bijection,
//    32 banks;
//  * transposed A and row-major B fragments of product 2 (lane reads row
//    tig or tig + 4, column gid) hit bank gid ^ (g(tig) << 2): g's two high
//    bits, (v & 3), differ over the four tig and g's low bit is the same, so
//    they move the four rows' 8-column groups onto distinct banks;
//  * float2 stores and loads of C fragments (rows gid, columns 2tig, 2tig+1)
//    fall on 16 distinct 8-byte bank pairs a half-warp, and the fill passes
//    (32 consecutive features of one pair a warp) on 32 banks.
// No pad works for both fragment patterns (row-major reads need a row
// stride = 4 mod 8 banks, transposed ones 8 mod 16), hence the swizzle.
// The W2 stages keep egnn_mma.cuh's +8 row pad.
//
// Shared memory at F = 256, N = 352: S and D 64 KB each, the ring 66 KB, the
// column list 1.4 KB (200,064 B dynamic) and 17,328 B static, 217,392 B of
// the 232,448 a block may have: one block (8 warps) an SM.  At F = 512
// (egnn_mma.cuh's Layout: P = 32 pairs, stages of 16 rows) S and D stay 64
// KB each and the ring 65 KB (199,040 B dynamic at N = 352).  At F = 1024
// (P = 16 pairs, one m-tile; stages of 8 rows) S and D take 64 KB each and
// the ring 64.5 KB: 197,120 B + 4N dynamic and ~25 KB static, so N up to
// about 2,000.  Empty 8-pair k-steps of product 2 are skipped (about a fifth
// on the training batch).
//
// Around the products, per chunk:
//  * fill passes (thread t owns feature t % F of pairs t / F + NT/F * u;
//    at F = 512 features t and t + 256 of every pair):
//    S = silu(pre) before product 1 and S = silu'(pre) before product 3,
//    pre recomputed branch-free from a_row in registers and a_col loaded a
//    chunk ahead, as egnn_mma.cuh's fill_s (F = 1024: four features a
//    thread, the *_quarters fills);
//  * the epilogue of 1 in the C-fragment layout (the GCL's in
//    gcl_bwd_tile_tc): per pair two dots over the features, each a lane-quad
//    shuffle plus one exchange of the four slices through shared memory; g of
//    the tile's rows is loaded once a tile into shared memory;
//  * dpre = dm1 * silu'(pre) on the C fragments of 3, with the pair dots
//    dpre . w_d2 and dpre . w_d20 reduced as above;
//  * the dpre sums over rows (da_col, added into the block's slab), over
//    columns (da_row, in registers until the tile ends) and the vector weight
//    sums, in the fill layout.
//
// Everything but gcl_bwd_tile_tc's epilogue is the pair MLP's and not the
// GCL's: coord_agg_bwd.cu runs the same pieces once per MLP.
// W2BwdRing and product_sw repeat egnn_mma.cuh's W2Ring and product_tc with
// a second matrix and the swizzle: changing those would change the forward
// kernels' code.
//
// Precision tiers (egnn_mma.cuh's TIER, one a library): the three products
// run in 3xTF32 (TF32X3), in 2xTF32 with the second operand's low part
// dropped (TF32X2: W2's in 1, dz2's in 2, W2^T's in 3, as the JAX package's
// "float32_x2" _dot and _dotT drop theirs), or in one bf16 pass of
// m16n8k16 with each operand rounded as its fragment loads (BF16); the fills
// and epilogues stay f32 on every tier, as the JAX package's _mlp_bwd.
#pragma once
#include "egnn_mma.cuh"
#include "egnn_bwd.cuh"

namespace egnn {

struct GclBwdArgs {
  PairMlp mlp;            // head = w_att, null when attention is off
  const float* b_att;     // (1) or null
  const float* w2t;       // (F, F) transpose of w2
  const float* g;         // (B, N, F) cotangent of the aggregate
  const float* x;         // (B, N, 3)
  const float* x0;        // (B, N, 3)
  const float* mask;      // (B, N)
  const float* col_mask;  // (B, N)
  const float* is_lig;    // (B, N)
  Cutoffs cut;
  float inv_nf;
  int N, update_rows;
  int tiles;              // row tiles below update_rows
  float* da_row;          // (B, N, F), zero-initialised; live rows written here
  float* acol_part;       // (B, Q, N, F) zero-initialised slabs
  float* dx_part;         // (B, Q, N, 6) zero-initialised slabs [dx, dx0]
  float* w_part;          // (B, Q, weight_slab) zero-initialised slabs
};

namespace mma {

// The XOR mask of pair row p in S and D (see above).
__device__ __forceinline__ int swz(int p) {
  const int v = p & 7;
  return (((v & 3) << 1) | (v >> 2)) << 2;
}

template <int F>
__device__ __forceinline__ int at(int p, int k) {
  return p * F + (k ^ swz(p));
}

// Dynamic shared memory of the backward body: S, D, the ring, the columns.
template <int F>
constexpr size_t dynamic_smem_bwd_tc(int N) {
  return sizeof(float) * (2 * (size_t)Layout<F>::P * F + (size_t)NS * Layout<F>::STAGE)
       + sizeof(int) * (size_t)N;
}

// Bit s set: pairs 8s .. 8s+7 of a chunk of 32 pairs (F = 512's) hold an
// edge, from each pair's column (-1: none); every lane of the warp calls it.
// Chunks of 64 take two ballots in the tile bodies.
__device__ __forceinline__ unsigned edge_ksteps32(const int* j, int lane) {
  const unsigned e0 = __ballot_sync(0xffffffffu, j[lane] >= 0);
  unsigned kmask = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) kmask |= (((e0 >> (8 * s)) & 0xffu) ? 1u : 0u) << s;
  return kmask;
}

// edge_ksteps32 for F = 1024's chunks of 16 pairs: bits 0 and 1.
__device__ __forceinline__ unsigned edge_ksteps16(const int* j, int lane) {
  const unsigned e0 = __ballot_sync(0xffffffffu, lane < 16 && j[lane] >= 0);
  return ((e0 & 0xffu) ? 1u : 0u) | ((e0 & 0xff00u) ? 2u : 0u);
}

// The ring of a chunk's two streamed matrices: stage g holds rows
// (g % KS) * KC .. + KC of W2 (g / KS even) or of W2^T (odd), in buffer
// g % NS.  Both must be 16-byte aligned.
template <int F>
struct W2BwdRing {
  using L = Layout<F>;
  const float* w2;
  const float* w2t;
  float* buf;  // NS * STAGE floats
  int next;    // next stage to issue

  __device__ __forceinline__ void issue() {
    constexpr int V = F / 4;  // 16-byte vectors per row
    float* dst = buf + (next % NS) * L::STAGE;
    const float* src =
        ((next / L::KS) & 1 ? w2t : w2) + (size_t)(next % L::KS) * L::KC * F;
    for (int e = threadIdx.x; e < L::KC * V; e += NT) {
      const int r = e / V, v = e % V;
      cp_async16(dst + r * L::WS + 4 * v, src + (size_t)r * F + 4 * v);
    }
    cp_async_commit();
    ++next;
  }

  // As W2Ring::acquire: the stage has landed for every thread, the buffer
  // of the one before it is free and refilled.
  __device__ __forceinline__ const float* acquire() {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const float* stage = buf + ((next - (NS - 1)) % NS) * L::STAGE;
    issue();
    return stage;
  }
};

// acc = A @ M for the warp's C fragments (product_tc's layout), A a swizzled
// P x F tile, M the ring's next KS stages.  A must be complete before the
// first acquire's sync.  TIER: the product's precision tier (the swizzle
// keeps a bf16 fragment's column pair 2tig, 2tig + 1 adjacent: one float2;
// stages of 8 rows take k-steps of 8).  ZERO false: the products add onto
// acc as it is, and Ring is any ring whose stages are Layout<F>'s
// (egnn_cluster_bwd.cuh above F = 2048: each C-th of K a product_sw<1024>
// onto the last, from the cluster ring).
template <int F, int TIER = TF32X3, bool ZERO = true, class Ring = W2BwdRing<F>>
__device__ __forceinline__ void product_sw(const float* A, Ring& ring,
                                           float (&acc)[Layout<F>::WM][Layout<F>::NTN][4]) {
  using L = Layout<F>;
  constexpr int KC = L::KC, ROW_GROUPS = row_groups<F>(), WM = L::WM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, slice = warp / ROW_GROUPS;
  if constexpr (ZERO) {
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int n = 0; n < L::NTN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
  }

  const int xg = swz(gid);  // rows gid and gid + 8 of every m-tile
  if constexpr (TIER == BF16 && KC < 16) {
    const float* a_row = A + (rg * WM * 16 + gid) * F;
    for (int ks = 0; ks < L::KS; ++ks) {
      const float* stage = ring.acquire();
      const float* b = stage + 2 * tig * L::WS + slice * L::FW + gid;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        const int c0 = (ks * KC + kk + 2 * tig) ^ xg;
        uint32_t a[WM][2];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const float* r = a_row + m * 16 * F;
          const float2 v0 = *reinterpret_cast<const float2*>(r + c0);
          const float2 v1 = *reinterpret_cast<const float2*>(r + 8 * F + c0);
          a[m][0] = pack_bf16(v0.x, v0.y);
          a[m][1] = pack_bf16(v1.x, v1.y);
        }
#pragma unroll
        for (int n0 = 0; n0 < L::NTN; n0 += L::NG) {
          uint32_t bb[L::NG];
#pragma unroll
          for (int n = 0; n < L::NG; ++n) {
            const float* c = b + kk * L::WS + 8 * (n0 + n);
            bb[n] = pack_bf16(c[0], c[L::WS]);
          }
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NG; ++n) {
              float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // the step's sum apart
              mma_bf16_k8(t, a[m][0], a[m][1], bb[n]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][n0 + n][e] += t[e];
            }
        }
      }
    }
    return;
  } else if constexpr (TIER == BF16) {
    const float* a_row = A + (rg * WM * 16 + gid) * F;
    for (int ks = 0; ks < L::KS; ++ks) {
      const float* stage = ring.acquire();
      const float* b_base = stage + 2 * tig * L::WS + slice * L::FW + gid;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const int c0 = (ks * KC + kk + 2 * tig) ^ xg, c8 = (ks * KC + kk + 8 + 2 * tig) ^ xg;
        uint32_t a[WM][4];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const float* r = a_row + m * 16 * F;
          const float2 v0 = *reinterpret_cast<const float2*>(r + c0);
          const float2 v1 = *reinterpret_cast<const float2*>(r + 8 * F + c0);
          const float2 v2 = *reinterpret_cast<const float2*>(r + c8);
          const float2 v3 = *reinterpret_cast<const float2*>(r + 8 * F + c8);
          a[m][0] = pack_bf16(v0.x, v0.y);
          a[m][1] = pack_bf16(v1.x, v1.y);
          a[m][2] = pack_bf16(v2.x, v2.y);
          a[m][3] = pack_bf16(v3.x, v3.y);
        }
        const float* b = b_base + kk * L::WS;
#pragma unroll
        for (int n0 = 0; n0 < L::NTN; n0 += L::NG) {
          uint32_t bb[L::NG][2];
#pragma unroll
          for (int n = 0; n < L::NG; ++n) {
            const float* c = b + 8 * (n0 + n);
            bb[n][0] = pack_bf16(c[0], c[L::WS]);
            bb[n][1] = pack_bf16(c[8 * L::WS], c[9 * L::WS]);
          }
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NG; ++n) mma_bf16(acc[m][n0 + n], a[m], bb[n][0], bb[n][1]);
        }
      }
    }
    return;
  }
  const float* a_base = A + (rg * WM * 16 + gid) * F + tig;
  if constexpr (L::STEP_SUMS) {  // egnn_mma.cuh's Layout
    for (int ks = 0; ks < L::KS; ++ks) {
      const float* stage = ring.acquire();
      const float* b_base = stage + tig * L::WS + slice * L::FW + gid;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        const int c0 = (ks * KC + kk) ^ xg, c4 = (ks * KC + kk + 4) ^ xg;
        uint32_t a_hi[WM][4], a_lo[WM][4];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const float* a = a_base + m * 16 * F;
          split(a[c0], a_hi[m][0], a_lo[m][0]);
          split(a[8 * F + c0], a_hi[m][1], a_lo[m][1]);
          split(a[c4], a_hi[m][2], a_lo[m][2]);
          split(a[8 * F + c4], a_hi[m][3], a_lo[m][3]);
        }
        const float* b = b_base + kk * L::WS;
#pragma unroll
        for (int n0 = 0; n0 < L::NTN; n0 += L::NGS) {
          uint32_t b_hi[L::NGS][2], b_lo[L::NGS][2];
          float t[WM][L::NGS][4];
#pragma unroll
          for (int n = 0; n < L::NGS; ++n) {
            split(b[8 * (n0 + n)], b_hi[n][0], b_lo[n][0]);
            split(b[4 * L::WS + 8 * (n0 + n)], b_hi[n][1], b_lo[n][1]);
#pragma unroll
            for (int m = 0; m < WM; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) t[m][n][e] = 0.0f;
          }
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NGS; ++n) mma_tf32(t[m][n], a_lo[m], b_hi[n][0], b_hi[n][1]);
          if constexpr (TIER == TF32X3) {
#pragma unroll
            for (int m = 0; m < WM; ++m)
#pragma unroll
              for (int n = 0; n < L::NGS; ++n)
                mma_tf32(t[m][n], a_hi[m], b_lo[n][0], b_lo[n][1]);
          }
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NGS; ++n) {
              mma_tf32(t[m][n], a_hi[m], b_hi[n][0], b_hi[n][1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][n0 + n][e] += t[m][n][e];
            }
        }
      }
    }
    return;
  }
  for (int ks = 0; ks < L::KS; ++ks) {
    const float* stage = ring.acquire();
    const float* b_base = stage + tig * L::WS + slice * L::FW + gid;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      const int c0 = (ks * KC + kk) ^ xg, c4 = (ks * KC + kk + 4) ^ xg;
      uint32_t a_hi[WM][4], a_lo[WM][4];
#pragma unroll
      for (int m = 0; m < WM; ++m) {
        const float* a = a_base + m * 16 * F;
        split(a[c0], a_hi[m][0], a_lo[m][0]);
        split(a[8 * F + c0], a_hi[m][1], a_lo[m][1]);
        split(a[c4], a_hi[m][2], a_lo[m][2]);
        split(a[8 * F + c4], a_hi[m][3], a_lo[m][3]);
      }
      const float* b = b_base + kk * L::WS;
#pragma unroll
      for (int n0 = 0; n0 < L::NTN; n0 += L::NG) {
        uint32_t b_hi[L::NG][2], b_lo[L::NG][2];
#pragma unroll
        for (int n = 0; n < L::NG; ++n) {
          split(b[8 * (n0 + n)], b_hi[n][0], b_lo[n][0]);
          split(b[4 * L::WS + 8 * (n0 + n)], b_hi[n][1], b_lo[n][1]);
        }
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int n = 0; n < L::NG; ++n)
            mma_tf32(acc[m][n0 + n], a_lo[m], b_hi[n][0], b_hi[n][1]);
        if constexpr (TIER == TF32X3) {
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NG; ++n)
              mma_tf32(acc[m][n0 + n], a_hi[m], b_lo[n][0], b_lo[n][1]);
        }
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int n = 0; n < L::NG; ++n)
            mma_tf32(acc[m][n0 + n], a_hi[m], b_hi[n][0], b_hi[n][1]);
      }
    }
  }
}

// dw2[k][n] += sum_p S[p][k] * D[p][n]: this block's F x F slab in global
// memory.  Bit s of kmask is clear when pairs 8s .. 8s+7 have no edge: their
// rows of S and D are zero, and their k-step is skipped.  Warp w covers
// m-tiles (dW2 rows) WM2*(w % RG) .. + WM2 - 1 and n-tiles NN * (w / RG) ..
// + NN - 1 of each SW-column slab (WM2 = 2 and SW = 32, at F = 512 WM2 = 4
// and SW = 16, at F = 1024 WM2 = 8 and SW = 8: the accumulators and the
// slab's loaded entries stay at 32 registers each; at 1024 the 8 warps are
// 8 row groups of 128 dW2 rows, one n-tile a slab); K = the chunk's P pairs
// (zero rows for pairs without an
// edge).  S and D must be complete.  TIER: the product's precision tier
// (BF16: k-steps of 16 pairs, each fragment element its own load, a step
// skipped when both its 8-pair bits are clear).
template <int F, int TIER = TF32X3>
__device__ __forceinline__ void dw2_tc(const float* S, const float* D, unsigned kmask,
                                       float* dw2) {
  constexpr int P = Layout<F>::P;
  constexpr int WM2 = F > 512 ? 8 : F > 256 ? 4 : 2;   // m-tiles a warp owns
  constexpr int RG = F / 16 / WM2;       // warp row groups
  constexpr int CG = (NT / 32) / RG;     // warp column groups
  constexpr int SW = F > 512 ? 8 : F > 256 ? 16 : 32;  // columns a slab
  constexpr int NN = SW / 8 / CG;        // n-tiles a warp owns in a slab
  static_assert(RG * CG == NT / 32 && NN >= 1 && F % SW == 0, "dW2 warp layout");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, cg = warp / RG;
  // swizzled columns gid, gid + 8 in pair rows tig (x0) and tig + 4 (x4)
  const int x0 = swz(tig), x4 = swz(tig + 4);
  const int g0 = gid ^ x0, g8 = (gid + 8) ^ x0, h0 = gid ^ x4, h8 = (gid + 8) ^ x4;

#pragma unroll 1
  for (int s0 = 0; s0 < F; s0 += SW) {
    float2 old[WM2][NN][2];
#pragma unroll
    for (int m = 0; m < WM2; ++m) {
      const float* r = dw2 + (size_t)((rg * WM2 + m) * 16 + gid) * F + s0 + cg * NN * 8 + 2 * tig;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        old[m][n][0] = *reinterpret_cast<const float2*>(r + 8 * n);
        old[m][n][1] = *reinterpret_cast<const float2*>(r + 8 * n + 8 * F);
      }
    }
    float acc[WM2][NN][4];
#pragma unroll
    for (int m = 0; m < WM2; ++m)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

    if constexpr (TIER == BF16) {
#pragma unroll 1
      for (int kp = 0; kp < P; kp += 16) {
        if (!((kmask >> (kp / 8)) & 3u)) continue;
        const int k0 = kp + 2 * tig;  // pairs k0, k0 + 1, k0 + 8, k0 + 9
        uint32_t a[WM2][4];
#pragma unroll
        for (int m = 0; m < WM2; ++m) {
          const int f0 = (rg * WM2 + m) * 16 + gid;  // A[gid][.] = S[.][f0]
          a[m][0] = pack_bf16(S[at<F>(k0, f0)], S[at<F>(k0 + 1, f0)]);
          a[m][1] = pack_bf16(S[at<F>(k0, f0 + 8)], S[at<F>(k0 + 1, f0 + 8)]);
          a[m][2] = pack_bf16(S[at<F>(k0 + 8, f0)], S[at<F>(k0 + 9, f0)]);
          a[m][3] = pack_bf16(S[at<F>(k0 + 8, f0 + 8)], S[at<F>(k0 + 9, f0 + 8)]);
        }
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int c = s0 + (cg * NN + n) * 8 + gid;  // B[.][gid] = D[.][c]
          const uint32_t b0 = pack_bf16(D[at<F>(k0, c)], D[at<F>(k0 + 1, c)]);
          const uint32_t b1 = pack_bf16(D[at<F>(k0 + 8, c)], D[at<F>(k0 + 9, c)]);
#pragma unroll
          for (int m = 0; m < WM2; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
        }
      }
    } else {
#pragma unroll 1
      for (int kp = 0; kp < P; kp += 8) {
        if (!((kmask >> (kp / 8)) & 1u)) continue;
        const float* s0r = S + (kp + tig) * F;
        const float* s4r = S + (kp + tig + 4) * F;
        const float* d0r = D + (kp + tig) * F;
        const float* d4r = D + (kp + tig + 4) * F;
        uint32_t a_hi[WM2][4], a_lo[WM2][4];
#pragma unroll
        for (int m = 0; m < WM2; ++m) {
          const int m0 = (rg * WM2 + m) * 16;
          split(s0r[m0 ^ g0], a_hi[m][0], a_lo[m][0]);  // A[gid][tig]
          split(s0r[m0 ^ g8], a_hi[m][1], a_lo[m][1]);  // A[gid + 8][tig]
          split(s4r[m0 ^ h0], a_hi[m][2], a_lo[m][2]);  // A[gid][tig + 4]
          split(s4r[m0 ^ h8], a_hi[m][3], a_lo[m][3]);  // A[gid + 8][tig + 4]
        }
        uint32_t b_hi[NN][2], b_lo[NN][2];
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int n0 = s0 + (cg * NN + n) * 8;
          split(d0r[n0 ^ g0], b_hi[n][0], b_lo[n][0]);  // B[tig][gid]
          split(d4r[n0 ^ h0], b_hi[n][1], b_lo[n][1]);  // B[tig + 4][gid]
        }
#pragma unroll
        for (int m = 0; m < WM2; ++m)
#pragma unroll
          for (int n = 0; n < NN; ++n) mma_tf32(acc[m][n], a_lo[m], b_hi[n][0], b_hi[n][1]);
        if constexpr (TIER == TF32X3) {
#pragma unroll
          for (int m = 0; m < WM2; ++m)
#pragma unroll
            for (int n = 0; n < NN; ++n) mma_tf32(acc[m][n], a_hi[m], b_lo[n][0], b_lo[n][1]);
        }
#pragma unroll
        for (int m = 0; m < WM2; ++m)
#pragma unroll
          for (int n = 0; n < NN; ++n) mma_tf32(acc[m][n], a_hi[m], b_hi[n][0], b_hi[n][1]);
      }
    }

#pragma unroll
    for (int m = 0; m < WM2; ++m) {
      float* r = dw2 + (size_t)((rg * WM2 + m) * 16 + gid) * F + s0 + cg * NN * 8 + 2 * tig;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        *reinterpret_cast<float2*>(r + 8 * n) =
            make_float2(old[m][n][0].x + acc[m][n][0], old[m][n][0].y + acc[m][n][1]);
        *reinterpret_cast<float2*>(r + 8 * n + 8 * F) =
            make_float2(old[m][n][1].x + acc[m][n][2], old[m][n][1].y + acc[m][n][3]);
      }
    }
  }
}

// pre of the fill layout's pair p, feature t % F: fill_s's expression.
template <int TI>
__device__ __forceinline__ float pre_fill(const PairWeights& w, const Chunk<TI>& c, int p,
                                          float a_row, float a_col) {
  return fmaf(c.ll[p], w.delta, a_row + a_col + c.d2[p] * w.w_d2 + c.d20[p] * w.w_d20);
}

// S = silu(pre) of the chunk's pairs (0 without an edge), swizzled.  F <= 256
// (wider: fill_m1_half).
template <int F>
__device__ __forceinline__ void fill_m1(const PairWeights& w, const Chunk<Layout<F>::TI>& c,
                                        const float (&a_row)[Layout<F>::TI],
                                        const float (&a_col)[Layout<F>::COLS], float* S) {
  constexpr int TI = Layout<F>::TI;
  static_assert(NT % F == 0 && TJ % (NT / F) == 0, "column groups");
  const int k = threadIdx.x % F, q = threadIdx.x / F;
#pragma unroll
  for (int u = 0; u < Layout<F>::COLS; ++u)
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      const int p = r * TJ + q + u * (NT / F);
      const float v = silu_fast(pre_fill(w, c, p, a_row[r], a_col[u]));
      S[at<F>(p, k)] = c.j[p] >= 0 ? v : 0.0f;
    }
}

// S = silu'(pre) (any finite value without an edge: dm1 is 0 there), and
// db2 += the thread's sum of dz2 (D) over the chunk.  F <= 256 (wider:
// fill_dsilu_half).
template <int F>
__device__ __forceinline__ void fill_dsilu(const PairWeights& w, const Chunk<Layout<F>::TI>& c,
                                           const float (&a_row)[Layout<F>::TI],
                                           const float (&a_col)[Layout<F>::COLS],
                                           const float* D, float* S, float& db2) {
  constexpr int TI = Layout<F>::TI;
  const int k = threadIdx.x % F, q = threadIdx.x / F;
#pragma unroll
  for (int u = 0; u < Layout<F>::COLS; ++u)
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      const int p = r * TJ + q + u * (NT / F);
      const float pre = pre_fill(w, c, p, a_row[r], a_col[u]);
      const float s = sigmoid_fast(pre);
      S[at<F>(p, k)] = s * fmaf(pre, 1.0f - s, 1.0f);
      db2 += D[at<F>(p, k)];
    }
}

// S = dpre = dm1 * S on the warp's C fragments (acc = dm1, S = silu'(pre)),
// and part[0 / 1][slice][p] = the warp's share of dpre_p . w_d2 / . w_d20.
template <int F>
__device__ __forceinline__ void dpre_fragments(
    const float (&acc)[Layout<F>::WM][Layout<F>::NTN][4], float* S, const float* wd2s,
    const float* wd20s, float (&part)[2][Layout<F>::SLICES][Layout<F>::P]) {
  using L = Layout<F>;
  constexpr int ROW_GROUPS = row_groups<F>(), WM = L::WM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, slice = warp / ROW_GROUPS;
  const int ce = (2 * tig) ^ swz(gid);
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (rg * WM + m) * 16 + gid + 8 * h;
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int n = 0; n < L::NTN; ++n) {
        const int f = slice * L::FW + 8 * n + 2 * tig;
        float2* sp = reinterpret_cast<float2*>(S + p * F + ((slice * L::FW + 8 * n) ^ ce));
        const float2 ds = *sp;
        const float v0 = acc[m][n][2 * h] * ds.x, v1 = acc[m][n][2 * h + 1] * ds.y;
        *sp = make_float2(v0, v1);
        a = fmaf(v1, wd2s[f + 1], fmaf(v0, wd2s[f], a));
        b = fmaf(v1, wd20s[f + 1], fmaf(v0, wd20s[f], b));
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if (tig == 0) {
        part[0][slice][p] = a;
        part[1][slice][p] = b;
      }
    }
}

// The fill layout's sums of dpre (S): the row sums into arow, the weight
// sums into fa, and the column sums added into the block's da_col slab (its
// entries loaded first, so that the loads are in flight together).  F <= 256
// (wider: dpre_sums_half).
template <int F>
__device__ __forceinline__ void dpre_sums(const float* S, const Chunk<Layout<F>::TI>& c,
                                          const int* cols, int count, int c0,
                                          float (&arow)[Layout<F>::TI], FeatAcc& fa,
                                          float* acol_part) {
  constexpr int COLS = Layout<F>::COLS, TI = Layout<F>::TI;
  const int k = threadIdx.x % F, q = threadIdx.x / F;
  float cs[COLS];
#pragma unroll
  for (int u = 0; u < COLS; ++u) {
    const int col = q + u * (NT / F);
    cs[u] = c0 + col < count ? acol_part[(size_t)cols[c0 + col] * F + k] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < COLS; ++u) {
    const int col = q + u * (NT / F);
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      const int p = r * TJ + col;
      const float v = S[at<F>(p, k)];
      cs[u] += v;
      arow[r] += v;
      fa.w_d2 = fmaf(v, c.d2[p], fa.w_d2);
      fa.w_d20 = fmaf(v, c.d20[p], fa.w_d20);
      fa.delta = fmaf(v, c.ll[p], fa.delta);
    }
  }
#pragma unroll
  for (int u = 0; u < COLS; ++u) {
    const int col = q + u * (NT / F);
    if (c0 + col < count) acol_part[(size_t)cols[c0 + col] * F + k] = cs[u];
  }
}

// fill_m1, fill_dsilu and dpre_sums at F = 512 for one half of the fill
// layout (egnn_mma.cuh's UpperHalf): feature k of every pair of the chunk.
template <int F>
__device__ __forceinline__ void fill_m1_half(const PairWeights& w,
                                             const Chunk<Layout<F>::TI>& c,
                                             const float (&a_row)[Layout<F>::TI],
                                             const float (&a_col)[Layout<F>::COLS], int k,
                                             float* S) {
  static_assert(Layout<F>::NQ == 1 && Layout<F>::COLS == TJ, "one column group");
#pragma unroll
  for (int u = 0; u < TJ; ++u)
#pragma unroll
    for (int r = 0; r < Layout<F>::TI; ++r) {
      const int p = r * TJ + u;
      const float v = silu_fast(pre_fill(w, c, p, a_row[r], a_col[u]));
      S[at<F>(p, k)] = c.j[p] >= 0 ? v : 0.0f;
    }
}

template <int F>
__device__ __forceinline__ void fill_dsilu_half(const PairWeights& w,
                                                const Chunk<Layout<F>::TI>& c,
                                                const float (&a_row)[Layout<F>::TI],
                                                const float (&a_col)[Layout<F>::COLS],
                                                int k, const float* D, float* S,
                                                float& db2) {
#pragma unroll
  for (int u = 0; u < TJ; ++u)
#pragma unroll
    for (int r = 0; r < Layout<F>::TI; ++r) {
      const int p = r * TJ + u;
      const float pre = pre_fill(w, c, p, a_row[r], a_col[u]);
      const float s = sigmoid_fast(pre);
      S[at<F>(p, k)] = s * fmaf(pre, 1.0f - s, 1.0f);
      db2 += D[at<F>(p, k)];
    }
}

template <int F>
__device__ __forceinline__ void dpre_sums_half(const float* S, const Chunk<Layout<F>::TI>& c,
                                               const int* cols, int count, int c0, int k,
                                               float (&arow)[Layout<F>::TI], FeatAcc& fa,
                                               float* acol_part) {
  float cs[TJ];
#pragma unroll
  for (int u = 0; u < TJ; ++u)
    cs[u] = c0 + u < count ? acol_part[(size_t)cols[c0 + u] * F + k] : 0.0f;
#pragma unroll
  for (int u = 0; u < TJ; ++u)
#pragma unroll
    for (int r = 0; r < Layout<F>::TI; ++r) {
      const int p = r * TJ + u;
      const float v = S[at<F>(p, k)];
      cs[u] += v;
      arow[r] += v;
      fa.w_d2 = fmaf(v, c.d2[p], fa.w_d2);
      fa.w_d20 = fmaf(v, c.d20[p], fa.w_d20);
      fa.delta = fmaf(v, c.ll[p], fa.delta);
    }
#pragma unroll
  for (int u = 0; u < TJ; ++u)
    if (c0 + u < count) acol_part[(size_t)cols[c0 + u] * F + k] = cs[u];
}

// fill_m1_half, fill_dsilu_half and dpre_sums_half for F = 1024's upper
// three features of thread feature k (q.h[e], fa.a[e]: feature k + (e + 1) * NT).
template <int F>
__device__ __forceinline__ void fill_m1_quarters(const Chunk<Layout<F>::TI>& c, int k,
                                                 const FillQuarters<F>& q, float* S) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e)
    fill_m1_half<F>(q.h[e].w, c, q.h[e].a_row, q.h[e].a_col, k + (e + 1) * NT, S);
}

template <int F>
__device__ __forceinline__ void fill_dsilu_quarters(const Chunk<Layout<F>::TI>& c, int k,
                                                    const FillQuarters<F>& q, const float* D,
                                                    float* S,
                                                    FeatAccs<Layout<F>::FE - 1>& fa) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e)
    fill_dsilu_half<F>(q.h[e].w, c, q.h[e].a_row, q.h[e].a_col, k + (e + 1) * NT, D, S,
                       fa.a[e].b2);
}

template <int F>
__device__ __forceinline__ void dpre_sums_quarters(const float* S,
                                                   const Chunk<Layout<F>::TI>& c,
                                                   const int* cols, int count, int c0, int k,
                                                   FillQuarters<F>& q,
                                                   FeatAccs<Layout<F>::FE - 1>& fa,
                                                   float* acol_part) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e)
    dpre_sums_half<F>(S, c, cols, count, c0, k + (e + 1) * NT, q.h[e].arow, fa.a[e],
                      acol_part);
}

// A block's sums over its row tiles.
template <int F>
struct GclBwdState {
  FeatAcc fa;   // fill layout; head unused
  float* hvs;   // shared [row_groups<F>()][F], zero at the start: dw_att by warp row group
  float dbatt;
  // F = 512: the sums of feature t + NT (fa holds feature t's); F = 1024:
  // of features t + e * NT in fa_hi.a[e - 1]
  std::conditional_t<(Layout<F>::FE == 2), FeatAcc,
                     std::conditional_t<(Layout<F>::FE > 2), FeatAccs<Layout<F>::FE - 1>,
                                        NoHalf>> fa_hi;
};

// F = 512's da_row of the tile's rows: arow (feature k) and arow_hi (feature
// k + NT) hold whole row sums, one column group filling every column.
template <int F>
__device__ __forceinline__ void store_rows_half(const float (&arow)[Layout<F>::TI],
                                                const float (&arow_hi)[Layout<F>::TI], int k,
                                                size_t node0, int i0, int N, int update_rows,
                                                float* da_row) {
#pragma unroll
  for (int r = 0; r < Layout<F>::TI; ++r) {
    const int i = i0 + r;
    if (i >= N || i >= update_rows) continue;
    da_row[(node0 + i) * F + k] = arow[r];
    da_row[(node0 + i) * F + k + NT] = arow_hi[r];
  }
}

// store_rows_half at F = 1024: features k and k + e * NT (q.h[e - 1].arow).
template <int F>
__device__ __forceinline__ void store_rows_quarters(const float (&arow)[Layout<F>::TI],
                                                    const FillQuarters<F>& q, int k,
                                                    size_t node0, int i0, int N,
                                                    int update_rows, float* da_row) {
#pragma unroll
  for (int r = 0; r < Layout<F>::TI; ++r) {
    const int i = i0 + r;
    if (i >= N || i >= update_rows) continue;
    da_row[(node0 + i) * F + k] = arow[r];
#pragma unroll
    for (int e = 0; e < Layout<F>::FE - 1; ++e)
      da_row[(node0 + i) * F + k + (e + 1) * NT] = q.h[e].arow[r];
  }
}

// One row tile of the GCL backward: rows i0 .. i0+TI-1 of the batch item at
// node0, slab `slab` of the per-block scratch.  S, D: swizzled P x F tiles;
// cols: N ints; all dynamic shared memory.  The ring runs on across tiles.
// TIER: the precision tier of the three products.
template <int F, int TIER = TF32X3>
__device__ void gcl_bwd_tile_tc(const GclBwdArgs& g, size_t node0, size_t slab, int i0,
                                float* S, float* D, int* cols, W2BwdRing<F>& ring,
                                GclBwdState<F>& st) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, ROW_GROUPS = row_groups<F>(), SLICES = L::SLICES;
  constexpr int WM = L::WM;
  __shared__ Rows<TI> rows;
  __shared__ __align__(16) Chunk<TI> chunk;  // 16 B: the fill passes' loads vectorise
  __shared__ PairD2<P> dd;
  __shared__ float rowc[P][6], colc[P][6];
  __shared__ float b2s[F], watt[F], wd2s[F], wd20s[F];
  __shared__ float xpart[2][SLICES][P];  // the slices' shares of two pair dots
  __shared__ __align__(8) float gs[TI][F];  // g / nf of the tile's rows, 0 past update_rows

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, slice = warp / ROW_GROUPS;
  const int k = t % F, q = t / F;  // the fill layout's feature and column group
  const bool attention = g.mlp.head != nullptr;
  const float b_att = attention ? g.b_att[0] : 0.0f;
  float* acol_part = g.acol_part + slab * (size_t)g.N * F;
  float* dx_part = g.dx_part + slab * (size_t)g.N * 6;
  float* dw2 = g.w_part + slab * weight_slab(F);

  __syncthreads();  // the previous tile is no longer read
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  for (int e = t; e < F; e += NT) {
    b2s[e] = g.mlp.b2[e];
    watt[e] = attention ? g.mlp.head[e] : 0.0f;
    wd2s[e] = g.mlp.w_d2[e];
    wd20s[e] = g.mlp.w_d20[e];
  }
  const PairWeights w = pair_weights(g.mlp, k);
  float a_row[TI], arow[TI];
#pragma unroll
  for (int r = 0; r < TI; ++r) {
    a_row[r] = i0 + r < g.N ? g.mlp.a_row[(node0 + i0 + r) * F + k] : 0.0f;
    arow[r] = 0.0f;
  }
  [[maybe_unused]] UpperHalf<F> up;  // F = 512: feature k + NT; 1024: three more
  if constexpr (L::FE == 2) {
    load_half_rows<F>(g.mlp, node0, i0, g.N, k + NT, up);
    for (int r = 0; r < TI; ++r) up.arow[r] = 0.0f;
  } else if constexpr (L::FE > 2) {
    load_quarter_rows<F>(g.mlp, node0, i0, g.N, k, up);
    for (int e = 0; e < L::FE - 1; ++e)
      for (int r = 0; r < TI; ++r) up.h[e].arow[r] = 0.0f;
  }
  // g of the tile's rows, loaded once a tile (in shared memory: held in
  // registers, its 32 a thread at F = 256 spill)
  for (int e = t; e < TI * F; e += NT) {
    const int i = i0 + e / F;
    gs[e / F][e % F] =
        i < g.N && i < g.update_rows ? g.g[(node0 + i) * F + e % F] * g.inv_nf : 0.0f;
  }
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);
  float a_col[L::COLS];
  if constexpr (L::FE == 1) {
    load_a_col<F>(g.mlp, cols, count, 0, node0, a_col);
  } else if constexpr (L::FE == 2) {
    load_a_col_half<F>(g.mlp, cols, count, 0, node0, k, a_col);
    load_a_col_half<F>(g.mlp, cols, count, 0, node0, k + NT, up.a_col);
  } else {
    load_a_col_half<F>(g.mlp, cols, count, 0, node0, k, a_col);
    load_a_col_quarters<F>(g.mlp, cols, count, 0, node0, k, up);
  }
  const int ce = (2 * tig) ^ swz(gid);  // C-fragment columns in rows gid, gid + 8

  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
               c0, g.cut);
    __syncthreads();
    // the chunk's k-steps of 8 pairs that hold an edge
    unsigned kmask = 0;
    if constexpr (P == 64) {
      const unsigned e0 = __ballot_sync(0xffffffffu, chunk.j[lane] >= 0),
                     e1 = __ballot_sync(0xffffffffu, chunk.j[lane + 32] >= 0);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        kmask |= (((e0 >> (8 * s)) & 0xffu) ? 1u : 0u) << s
               | (((e1 >> (8 * s)) & 0xffu) ? 1u : 0u) << (s + 4);
    } else if constexpr (P == 32) {
      kmask = edge_ksteps32(chunk.j, lane);
    } else {
      kmask = edge_ksteps16(chunk.j, lane);
    }
    if constexpr (L::FE == 1) {
      fill_m1<F>(w, chunk, a_row, a_col, S);
    } else if constexpr (L::FE == 2) {
      fill_m1_half<F>(w, chunk, a_row, a_col, k, S);
      fill_m1_half<F>(up.w, chunk, up.a_row, up.a_col, k + NT, S);
    } else {
      fill_m1_half<F>(w, chunk, a_row, a_col, k, S);
      fill_m1_quarters<F>(chunk, k, up, S);
    }
    float acc[WM][L::NTN][4];
    product_sw<F, TIER>(S, ring, acc);  // z2 - b2 = m1 @ W2

    // ---- epilogue: m2, the attention gate and its cotangent, dz2 -> D
    float gate[WM][2], dattz[WM][2];
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      float pa[2] = {0.0f, 0.0f}, pg[2] = {0.0f, 0.0f};  // m2 . w_att, m2 . g
#pragma unroll
      for (int n = 0; n < L::NTN; ++n) {
        const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = acc[m][n][e] + b2s[f + (e & 1)];
          acc[m][n][e] = z;
          const float m2 = silu_fast(z);
          pa[e >> 1] = fmaf(m2, watt[f + (e & 1)], pa[e >> 1]);
          pg[e >> 1] = fmaf(m2, gs[rg * WM + m][f + (e & 1)], pg[e >> 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (rg * WM + m) * 16 + gid + 8 * h;
        gate[m][h] = chunk.adj[p];
        dattz[m][h] = 0.0f;
        if (attention) {
          pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 1);
          pa[h] += __shfl_xor_sync(0xffffffffu, pa[h], 2);
          pg[h] += __shfl_xor_sync(0xffffffffu, pg[h], 1);
          pg[h] += __shfl_xor_sync(0xffffffffu, pg[h], 2);
          if (tig == 0) {
            xpart[0][slice][p] = pa[h];
            xpart[1][slice][p] = pg[h];
          }
        }
      }
    }
    if (attention) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (rg * WM + m) * 16 + gid + 8 * h;
          float dot = b_att, pgs = 0.0f;
#pragma unroll
          for (int sl = 0; sl < SLICES; ++sl) {
            dot += xpart[0][sl][p];
            pgs += xpart[1][sl][p];
          }
          const float att = sigmoid_fast(dot), adj = gate[m][h];
          dattz[m][h] = pgs * adj * att * (1.0f - att);
          gate[m][h] = adj * att;
          if (slice == 0 && tig == 0) st.dbatt += dattz[m][h];
        }
    }
    float hv[L::NTN][2];  // the lane's share of dw_att over the chunk
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) hv[n][0] = hv[n][1] = 0.0f;
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (rg * WM + m) * 16 + gid + 8 * h;
#pragma unroll
        for (int n = 0; n < L::NTN; ++n) {
          const int f = slice * L::FW + 8 * n + 2 * tig;
          float dz2[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float z = acc[m][n][2 * h + c];
            const float s = sigmoid_fast(z);
            const float dm2 =
                fmaf(gs[rg * WM + m][f + c], gate[m][h], dattz[m][h] * watt[f + c]);
            dz2[c] = dm2 * s * fmaf(z, 1.0f - s, 1.0f);
            hv[n][c] = fmaf(z * s, dattz[m][h], hv[n][c]);
          }
          *reinterpret_cast<float2*>(D + p * F + ((slice * L::FW + 8 * n) ^ ce)) =
              make_float2(dz2[0], dz2[1]);
        }
      }
    if (attention) {  // the 8 lane groups' shares, added by lanes 0..3
#pragma unroll
      for (int n = 0; n < L::NTN; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = hv[n][c];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (gid == 0) st.hvs[rg * F + slice * L::FW + 8 * n + 2 * tig + c] += v;
        }
    }
    __syncthreads();  // D complete
#ifndef EGNN_SKIP_DW2  // defined only in a timing build (chip_smoke.py 20i): dW2 stays 0
    dw2_tc<F, TIER>(S, D, kmask, dw2);
#endif
    __syncthreads();  // S is no longer read
    if constexpr (L::FE == 1) {
      fill_dsilu<F>(w, chunk, a_row, a_col, D, S, st.fa.b2);
      load_a_col<F>(g.mlp, cols, count, c0 + TJ, node0, a_col);  // the next chunk's
    } else if constexpr (L::FE == 2) {
      fill_dsilu_half<F>(w, chunk, a_row, a_col, k, D, S, st.fa.b2);
      fill_dsilu_half<F>(up.w, chunk, up.a_row, up.a_col, k + NT, D, S, st.fa_hi.b2);
      load_a_col_half<F>(g.mlp, cols, count, c0 + TJ, node0, k, a_col);
      load_a_col_half<F>(g.mlp, cols, count, c0 + TJ, node0, k + NT, up.a_col);
    } else {
      fill_dsilu_half<F>(w, chunk, a_row, a_col, k, D, S, st.fa.b2);
      fill_dsilu_quarters<F>(chunk, k, up, D, S, st.fa_hi);
      load_a_col_half<F>(g.mlp, cols, count, c0 + TJ, node0, k, a_col);
      load_a_col_quarters<F>(g.mlp, cols, count, c0 + TJ, node0, k, up);
    }
    product_sw<F, TIER>(D, ring, acc);  // dm1 = dz2 @ W2^T
    dpre_fragments<F>(acc, S, wd2s, wd20s, xpart);
    __syncthreads();  // dpre and the pair dots complete
    if (t < P) {
      float a = 0.0f, b = 0.0f;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) {
        a += xpart[0][sl][t];
        b += xpart[1][sl][t];
      }
      dd.dd2[t] = a;
      dd.dd20[t] = b;
    }
    if constexpr (L::FE == 1) {
      dpre_sums<F>(S, chunk, cols, count, c0, arow, st.fa, acol_part);
    } else if constexpr (L::FE == 2) {
      dpre_sums_half<F>(S, chunk, cols, count, c0, k, arow, st.fa, acol_part);
      dpre_sums_half<F>(S, chunk, cols, count, c0, k + NT, up.arow, st.fa_hi, acol_part);
    } else {
      dpre_sums_half<F>(S, chunk, cols, count, c0, k, arow, st.fa, acol_part);
      dpre_sums_quarters<F>(S, chunk, cols, count, c0, k, up, st.fa_hi, acol_part);
    }
    __syncthreads();  // dd complete

    // ---- squared-distance cotangents -> coordinates
    if (t < P) {
      const int j = chunk.j[t], r = t / TJ;
      for (int a = 0; a < 6; ++a) { rowc[t][a] = 0.0f; colc[t][a] = 0.0f; }
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        const float* x0j = g.x0 + (node0 + j) * 3;
        for (int a = 0; a < 3; ++a) {
          const float v = 2.0f * dd.dd2[t] * (rows.x[r][a] - xj[a]);
          const float v0 = 2.0f * dd.dd20[t] * (rows.x0[r][a] - x0j[a]);
          rowc[t][a] = v; colc[t][a] = -v;
          rowc[t][3 + a] = v0; colc[t][3 + a] = -v0;
        }
      }
    }
    __syncthreads();
    scatter_dx<TI>(rowc, colc, cols, count, c0, i0, g.N, dx_part);  // ends with a sync
  }

  // ---- da_row of the tile's rows: the column groups' row sums, in order
  if constexpr (L::FE == 2) {  // F = 512: one column group, the sums complete
    store_rows_half<F>(arow, up.arow, k, node0, i0, g.N, g.update_rows, g.da_row);
    return;
  } else if constexpr (L::FE > 2) {  // F = 1024 likewise
    store_rows_quarters<F>(arow, up, k, node0, i0, g.N, g.update_rows, g.da_row);
    return;
  }
  float* red = S;  // free: the last chunk ended with a sync
#pragma unroll
  for (int r = 0; r < TI; ++r) red[(q * TI + r) * F + k] = arow[r];
  __syncthreads();
  if (t < F) {
    for (int r = 0; r < TI; ++r) {
      const int i = i0 + r;
      if (i >= g.N || i >= g.update_rows) continue;
      float s = 0.0f;
      for (int qq = 0; qq < NT / F; ++qq) s += red[(qq * TI + r) * F + t];
      g.da_row[(node0 + i) * F + t] = s;
    }
  }
}

// store_gcl_bwd_state at F = 512: one column group, so every thread's sums
// (features t and t + NT) are whole; only db_att is summed over the block.
template <int F>
__device__ void store_gcl_bwd_state_half(const GclBwdState<F>& st, float* w_part, float* S) {
  static_assert(row_groups<F>() == 1, "one warp row group");
  const int t = threadIdx.x;
  float* bred = S;  // [NT]
  __syncthreads();  // S is no longer read, hvs complete
  bred[t] = st.dbatt;
  __syncthreads();
  float* v = w_part + (size_t)F * F;
  const float lo[5] = {st.fa.w_d2, st.fa.w_d20, st.fa.delta, st.fa.b2, st.hvs[t]};
  const float hi[5] = {st.fa_hi.w_d2, st.fa_hi.w_d20, st.fa_hi.delta, st.fa_hi.b2,
                       st.hvs[t + NT]};
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    v[j * F + t] = lo[j];
    v[j * F + t + NT] = hi[j];
  }
  if (t == 0) {
    float s = 0.0f;
    for (int e = 0; e < NT; ++e) s += bred[e];
    v[5 * F] = s;
  }
}

// store_gcl_bwd_state_half at F = 1024: features t + e * NT, e < 4.
template <int F>
__device__ void store_gcl_bwd_state_quarters(const GclBwdState<F>& st, float* w_part,
                                             float* S) {
  static_assert(row_groups<F>() == 1, "one warp row group");
  const int t = threadIdx.x;
  float* bred = S;  // [NT]
  __syncthreads();  // S is no longer read, hvs complete
  bred[t] = st.dbatt;
  __syncthreads();
  float* v = w_part + (size_t)F * F;
  const float lo[5] = {st.fa.w_d2, st.fa.w_d20, st.fa.delta, st.fa.b2, st.hvs[t]};
#pragma unroll
  for (int j = 0; j < 5; ++j) v[j * F + t] = lo[j];
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e) {
    const FeatAcc& a = st.fa_hi.a[e];
    const int f = t + (e + 1) * NT;
    const float hi[5] = {a.w_d2, a.w_d20, a.delta, a.b2, st.hvs[f]};
#pragma unroll
    for (int j = 0; j < 5; ++j) v[j * F + f] = hi[j];
  }
  if (t == 0) {
    float s = 0.0f;
    for (int e = 0; e < NT; ++e) s += bred[e];
    v[5 * F] = s;
  }
}

// Writes the block's vector cotangents into its weight slab (weight_slab:
// [dW2][w_d2][w_d20][delta][b2][w_att][b_att]), each summed in a fixed
// order.  S (P x F floats) is scratch.
template <int F>
__device__ void store_gcl_bwd_state(const GclBwdState<F>& st, float* w_part, float* S) {
  if constexpr (Layout<F>::FE == 2) {
    store_gcl_bwd_state_half<F>(st, w_part, S);
    return;
  } else if constexpr (Layout<F>::FE > 2) {
    store_gcl_bwd_state_quarters<F>(st, w_part, S);
    return;
  }
  const int t = threadIdx.x, k = t % F, q = t / F;
  static_assert(4 * NT + NT <= Layout<F>::P * F, "scratch");
  float* fred = S;           // [4][NT / F][F]
  float* bred = S + 4 * NT;  // [NT]
  __syncthreads();  // S is no longer read, hvs complete
  const float fv[4] = {st.fa.w_d2, st.fa.w_d20, st.fa.delta, st.fa.b2};
#pragma unroll
  for (int j = 0; j < 4; ++j) fred[(j * (NT / F) + q) * F + k] = fv[j];
  bred[t] = st.dbatt;
  __syncthreads();
  float* v = w_part + (size_t)F * F;
  if (t < F) {
    for (int j = 0; j < 4; ++j) {
      float s = 0.0f;
      for (int qq = 0; qq < NT / F; ++qq) s += fred[(j * (NT / F) + qq) * F + t];
      v[j * F + t] = s;
    }
    float h = 0.0f;
    for (int r = 0; r < row_groups<F>(); ++r) h += st.hvs[r * F + t];
    v[4 * F + t] = h;
  }
  if (t == 0) {
    float s = 0.0f;
    for (int e = 0; e < NT; ++e) s += bred[e];
    v[5 * F] = s;
  }
}

}  // namespace mma
}  // namespace egnn
