// The per-pair product on Hopper's tensor cores, and the two row-tile bodies
// that run on it, GCL (gcl_agg.cu, block_fused.cu's phase A) and coordinate
// update (coord_agg.cu, block_fused.cu's phase B); f32-grade, for sm_90a.
//
// Product: silu(pre) (P x F, shared memory) @ W2 (F x F, global memory) with
// warp-level mma.sync.m16n8k8 in TF32, each operand split into hi + lo TF32
// parts (round to nearest, ties away: cvt.rna's rounding) and accumulated in
// f32 as lo*hi + hi*lo + hi*hi, small terms first, lo*lo dropped ("3xTF32":
// ~22 significant bits against TF32's 11).
//
// Warp layout (8 warps = 2 row groups x 4 feature slices): a chunk's TJ = 16
// columns make one m-tile a row, and warp w owns the WM = 2 m-tiles (rows) of
// row group w % 2 and the F/4 features of slice w / 2: 2 x F/32 n-tiles of 8,
// 4 f32 accumulators each.  The gated row sums stay in the warp's registers
// across chunks; the attention dot is a lane-quad shuffle plus one exchange
// of the four slices through shared memory.  (One row and F/2 a warp loads
// and splits each W2 element in four warps, two rows and F/4 in two.)  The
// node products of block_fused.cu take the other layout of product_tc, one
// row group x 8 slices (every warp all rows, F/8 features), and skip the
// m-tiles past the rows a block owns.
//
// F = 512 (Layout): 64 pairs a chunk would need the backward's S and D at
// 128 KB each and stages of 32 rows at 65 KB each, over the 227 KB a block
// may have; so a tile there has TI = 2 rows (P = 32 pairs, two m-tiles),
// stages KC = 16 W2 rows (two TF32 k-steps, one bf16), and the
// pair MLPs take the one-row-group layout: every warp both rows and F/8 = 64
// features, 8 n-tiles, the registers of F = 256's 2 x 64.  The fill layout
// gives each thread F / 256 = 2 features (t and t + 256).
//
// F = 1024: S and D of one m-tile (16 pairs) take 64 KB each, so a tile
// has TI = 1 row (P = 16 pairs, one m-tile), W2 stages take KC = 8 rows
// (one TF32 k-step; the bf16 tier's k-steps of 8 run m16n8k8), every warp
// owns the one m-tile and F/8 = 128 features (16 n-tiles: the registers of
// F = 512's 2 x 8), and each thread fills four features (t + e * 256,
// FillQuarters).  Its products also sum each k-step's passes into a zeroed
// fragment and add that to the accumulators with f32 adds (Layout's
// STEP_SUMS): mma.sync's accumulation truncates, so a product that adds all
// 3 x K/8 passes into its accumulators drifts with K -- gcl_agg's error
// against float64 is 1.2e-6 of the largest output at F = 256, 3.8e-6 at
// 512 and 8.9e-6 at 1024 without the step sums, 1.2e-7 with them (the
// float32 plain version's: 1.9e-7; H100, chip_smoke.py 20i).  F = 2048
// would need 256 KB for one m-tile's S and D.
//
// W2 streams through a ring of NS shared-memory stages of KC rows filled with
// cp.async (16 B, commit/wait groups): the copy of the next stage is in
// flight while the tensor cores work on this one, one block sync a stage.
// The ring runs on across chunks (W2's rows are the same for every chunk),
// so the next chunk's first stage loads during the epilogue and the fill.
// Row strides are padded (S: F + 4, stages: F + 8 floats) so that the A and B
// fragment loads are free of bank conflicts.
//
// Precision tiers (template parameter TIER of the products and of the
// forward fill and epilogues; each kernel's library is built for one tier,
// -DEGNN_TIER, block_fused.cu's node products included):
//  * TF32X3 (0): the 3xTF32 product above, f32-grade;
//  * TF32X2 (1): lo*hi + hi*hi, the second operand's low part dropped (W2's
//    in the forward products), as the JAX package's "float32_x2" drops the
//    weight's (~1e-3 relative);
//  * BF16 (2): one pass of mma.sync.m16n8k16 bf16 with f32 accumulation, each
//    operand rounded to bf16 (nearest even) as its fragment loads from the
//    f32 tiles; the forward bodies also compute the pair MLP at the JAX
//    package's "bfloat16" rounding points (_pair_mlp): a_row, a_col and the
//    edge bias each rounded, pre = (a_row + a_col) + bias in two bf16 adds,
//    silu as x * (1 / (1 + e^-x)) with every operation's result rounded,
//    z = acc + b2 rounded, the head (w_att, w3) and b2 rounded.  Each
//    operation is f32 arithmetic on bf16 inputs, rounded once.  The
//    elementwise work of the backward bodies stays f32.
#pragma once
#include <cstdint>
#include <type_traits>
#include "egnn_common.cuh"

namespace egnn {

// The arguments of the two row-tile bodies below.
struct GclArgs {
  PairMlp mlp;            // head = w_att, null when attention is off
  const float* b_att;     // (1) or null when attention is off
  const float* x;         // (B, N, 3) current coordinates
  const float* x0;        // (B, N, 3) EGNN input coordinates
  const float* mask;      // (B, N) row validity
  const float* col_mask;  // (B, N) column validity
  const float* is_lig;    // (B, N)
  Cutoffs cut;
  float nf;               // normalization factor
  int N;
  int update_rows;        // rows >= update_rows have no edges: zeros
  float* out;             // (B, N, F), the split kernel's output
};

struct CoordArgs {
  PairMlp coord, cross;    // head = w3; cross.a_row == null: reflection-equivariant
  const float* x;          // (B, N, 3)
  const float* x0;         // (B, N, 3)
  const float* mask;       // (B, N) row validity
  const float* col_mask;   // (B, N) column validity
  const float* is_lig;     // (B, N)
  const float* graph_mean; // (B, 3) or null
  int use_tanh;
  float coords_range, norm_constant, nf;
  Cutoffs cut;
  int N, update_rows;
  float* out;              // (B, N, 3)
};

namespace mma {

enum Tier : int { TF32X3 = 0, TF32X2 = 1, BF16 = 2 };
#ifndef EGNN_TIER
#define EGNN_TIER 0
#endif
constexpr int kTier = EGNN_TIER;  // the tier a kernel's library is built for
static_assert(kTier >= TF32X3 && kTier <= BF16, "EGNN_TIER: 0, 1 or 2");

constexpr int NS = 2;   // stages in the ring
constexpr int WM = 2;   // m-tiles (rows) a warp owns in the pair MLPs' layout

// Row groups of the pair MLPs' warp layout at width F: 2, or 1 at F = 512
// (two m-tiles a warp) and at F = 1024 (one).
template <int F>
__host__ __device__ constexpr int row_groups() {
  return F > 512 ? 1 : tile_rows<F>() * TJ / 16 / WM;
}

// The tiling at width F, in the warp layout of RG row groups (the pair MLPs'
// row_groups<F>(), or 1 for block_fused.cu's node products: every warp all
// rows, F/8 features).
template <int F, int RG = row_groups<F>()> struct Layout {
  static constexpr int TI = tile_rows<F>();  // rows per tile
  static constexpr int P = TI * TJ;      // pairs per chunk
  static constexpr int M_TILES = P / 16;  // one m-tile a row (TJ = 16)
  static constexpr int SLICES = (NT / 32) / RG;  // feature slices
  static constexpr int KC = F > 512 ? 8 : F > 256 ? 16 : 32;  // W2 rows per stage
  static constexpr int SS = F + 4;       // S row stride (floats)
  static constexpr int WS = F + 8;       // stage row stride (floats)
  static constexpr int KS = F / KC;      // stages per chunk
  static constexpr int WM = M_TILES / RG;          // m-tiles a warp owns
  static constexpr int FW = F / SLICES;  // features a warp owns
  static constexpr int NTN = FW / 8;     // its n-tiles of 8
  static constexpr int NG = NTN < 8 ? NTN : 8;  // n-tiles split at a time
  // the fill layout: thread t fills features t % F + e * NT (e < FE) of the
  // chunk's columns t / F + u * NQ (u < COLS)
  static constexpr int FE = F > NT ? F / NT : 1;
  static constexpr int NQ = F < NT ? NT / F : 1;
  static constexpr int COLS = TJ / NQ;
  static constexpr int STAGE = KC * WS;  // floats per stage
  static constexpr int S_BUFS = 1;       // P x SS buffers of S (2 above 2048)
  // F = 1024: each k-step's products summed apart, into a zeroed fragment,
  // and added to the accumulators on the CUDA cores, NGS n-tiles at a time
  // (the header; -DEGNN_NO_STEP_SUMS only in a measurement build,
  // chip_smoke.py 20i)
#ifndef EGNN_NO_STEP_SUMS
  static constexpr bool STEP_SUMS = F > 512;
#else
  static constexpr bool STEP_SUMS = false;
#endif
  static constexpr int NGS = 4;
  static_assert(TJ == 16 && M_TILES % RG == 0 && (NT / 32) % RG == 0 &&
                (F < NT ? NT % F : F % NT) == 0, "warps = row groups x feature slices");
};

// Dynamic shared memory of gcl_tile_tc: S, the W2 ring, the column list
// (above F = 2048 two buffers of S: egnn_cluster.cuh's WideLayout).
template <int F>
__host__ __device__ constexpr size_t dynamic_smem(int N) {
  return sizeof(float) * ((size_t)Layout<F>::S_BUFS * Layout<F>::P * Layout<F>::SS
                          + (size_t)NS * Layout<F>::STAGE)
       + sizeof(int) * (size_t)N;
}

// The nearest TF32 value, ties away from zero: what cvt.rna.tf32.f32 gives
// for finite x, in two integer operations (cvt.rna compiles to more).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> the bf16x2 register of a fragment: lo in the low half, each
// rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// x rounded to the nearest bf16 (ties to even), as a float; finite x.
// Integer arithmetic: with cvt.rn.bf16.f32 and a shift instead, gcl_agg's
// bf16 tier took 1.52 ms at F = 256 against 1.40 (H100, two runs)
__device__ __forceinline__ float bf16_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// x on the BF16 tier's rounding points, unchanged on the others
template <int TIER>
__device__ __forceinline__ float tier_round(float x) {
  if constexpr (TIER == BF16) return bf16_rne(x);
  return x;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m16n8k8 bf16: the first k-half of mma_bf16's fragments (a[0], a[1]; b0)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The ring of W2 stages.  Stage g (counted over the block's tile) holds W2
// rows (g % KS) * KC .. + KC in buffer g % NS.  W2 must be 16-byte aligned.
template <int F>
struct W2Ring {
  using L = Layout<F>;
  const float* w2;
  float* buf;  // NS * STAGE floats
  int next;    // next stage to issue

  // Issues stage `next` (one commit group per call, so the wait counts hold).
  __device__ __forceinline__ void issue() {
    constexpr int V = F / 4;  // 16-byte vectors per row
    float* dst = buf + (next % NS) * L::STAGE;
    const float* src = w2 + (size_t)(next % L::KS) * L::KC * F;
    for (int e = threadIdx.x; e < L::KC * V; e += NT) {
      const int r = e / V, v = e % V;
      cp_async16(dst + r * L::WS + 4 * v, src + (size_t)r * F + 4 * v);
    }
    cp_async_commit();
    ++next;
  }

  // Stage s = next - (NS - 1) has landed for every thread, and every thread
  // is done with stage s - 1, whose buffer the next issue refills.
  __device__ __forceinline__ const float* acquire() {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const float* stage = buf + ((next - (NS - 1)) % NS) * L::STAGE;
    issue();
    return stage;
  }
};

// acc[m][n][.] = S @ W2 (ZERO; else +=) for the C fragment of the warp's
// m-tile m and n-tile n in Layout<F, RG>: rows 16*(rg*WM + m) + (gid, gid,
// gid+8, gid+8) and features slice*FW + 8n + 2*tig + (0, 1, 0, 1), where
// warp = slice*RG + rg.  S (rows at stride SS) must be complete before the
// first acquire's sync.  With PARTIAL only the m-tiles that start below
// `rows` are computed; the others' accumulators are left as they are.  Ring:
// W2Ring, or any ring with its acquire().  TIER: the product's precision tier
// (the BF16 tier's k-steps of 16 take the A pairs as float2 loads of S, the B
// pairs as two rows of the stage; stages of 8 rows take k-steps of 8).
template <int F, int RG = row_groups<F>(), bool ZERO = true, bool PARTIAL = false,
          int TIER = TF32X3, class Ring>
__device__ __forceinline__ void product_tc(
    const float* S, Ring& ring, float (&acc)[Layout<F, RG>::WM][Layout<F, RG>::NTN][4],
    int rows = Layout<F, RG>::P) {
  using L = Layout<F, RG>;
  constexpr int WM = L::WM, KC = L::KC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, slice = warp / RG;
  bool live[WM];
#pragma unroll
  for (int m = 0; m < WM; ++m) live[m] = !PARTIAL || (rg * WM + m) * 16 < rows;
  if (ZERO) {
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int n = 0; n < L::NTN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
  }

  if constexpr (TIER == BF16 && KC < 16) {
    const float* a_base = S + (rg * WM * 16 + gid) * L::SS + 2 * tig;
    for (int ks = 0; ks < L::KS; ++ks) {
      const float* stage = ring.acquire();
      const float* b = stage + 2 * tig * L::WS + slice * L::FW + gid;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        uint32_t a[WM][2];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          if (!live[m]) continue;
          const float* p = a_base + m * 16 * L::SS + ks * KC + kk;
          const float2 v0 = *reinterpret_cast<const float2*>(p);
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * L::SS);
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
            for (int n = 0; n < L::NG; ++n)
              if (live[m]) {
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
    const float* a_base = S + (rg * WM * 16 + gid) * L::SS + 2 * tig;
    for (int ks = 0; ks < L::KS; ++ks) {
      const float* stage = ring.acquire();
      const float* b_base = stage + 2 * tig * L::WS + slice * L::FW + gid;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[WM][4];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          if (!live[m]) continue;
          const float* p = a_base + m * 16 * L::SS + ks * KC + kk;
          const float2 v0 = *reinterpret_cast<const float2*>(p);
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * L::SS);
          const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * L::SS + 8);
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
            for (int n = 0; n < L::NG; ++n)
              if (live[m]) mma_bf16(acc[m][n0 + n], a[m], bb[n][0], bb[n][1]);
        }
      }
    }
    return;
  }
  const float* a_base = S + (rg * WM * 16 + gid) * L::SS + tig;
  if constexpr (L::STEP_SUMS) {
    for (int ks = 0; ks < L::KS; ++ks) {
      const float* stage = ring.acquire();
      const float* b_base = stage + tig * L::WS + slice * L::FW + gid;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 8) {
        uint32_t a_hi[WM][4], a_lo[WM][4];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          if (!live[m]) continue;
          const float* a = a_base + m * 16 * L::SS + ks * KC + kk;
          split(a[0], a_hi[m][0], a_lo[m][0]);
          split(a[8 * L::SS], a_hi[m][1], a_lo[m][1]);
          split(a[4], a_hi[m][2], a_lo[m][2]);
          split(a[8 * L::SS + 4], a_hi[m][3], a_lo[m][3]);
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
            for (int n = 0; n < L::NGS; ++n)
              if (live[m]) mma_tf32(t[m][n], a_lo[m], b_hi[n][0], b_hi[n][1]);
          if constexpr (TIER == TF32X3) {
#pragma unroll
            for (int m = 0; m < WM; ++m)
#pragma unroll
              for (int n = 0; n < L::NGS; ++n)
                if (live[m]) mma_tf32(t[m][n], a_hi[m], b_lo[n][0], b_lo[n][1]);
          }
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NGS; ++n)
              if (live[m]) {
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
      uint32_t a_hi[WM][4], a_lo[WM][4];
#pragma unroll
      for (int m = 0; m < WM; ++m) {
        if (!live[m]) continue;
        const float* a = a_base + m * 16 * L::SS + ks * KC + kk;
        split(a[0], a_hi[m][0], a_lo[m][0]);
        split(a[8 * L::SS], a_hi[m][1], a_lo[m][1]);
        split(a[4], a_hi[m][2], a_lo[m][2]);
        split(a[8 * L::SS + 4], a_hi[m][3], a_lo[m][3]);
      }
      const float* b = b_base + kk * L::WS;
      // NG n-tiles at a time, each of the three passes over all of them
      // before the next, so that an accumulator's products are WM*NG issues
      // apart
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
            if (live[m]) mma_tf32(acc[m][n0 + n], a_lo[m], b_hi[n][0], b_hi[n][1]);
        if constexpr (TIER == TF32X3) {
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int n = 0; n < L::NG; ++n)
              if (live[m]) mma_tf32(acc[m][n0 + n], a_hi[m], b_lo[n][0], b_lo[n][1]);
        }
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int n = 0; n < L::NG; ++n)
            if (live[m]) mma_tf32(acc[m][n0 + n], a_hi[m], b_hi[n][0], b_hi[n][1]);
      }
    }
  }
}

// silu and sigmoid on the SFU (ex2, rcp): ~1e-7 relative error, a few
// instructions where expf and an IEEE division take some twenty
__device__ __forceinline__ float exp_neg(float v) {  // e^-v
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(-1.4426950408889634f * v));
  return y;
}
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + exp_neg(v));
}
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.0f, 1.0f + exp_neg(v));
}

// silu at the tier's rounding points: on BF16 the JAX package's bf16 _silu,
// x * (1 / (1 + e^-x)) with each operation's result rounded to bf16 (x a
// bf16 value); silu_fast on the others
template <int TIER>
__device__ __forceinline__ float tier_silu(float x) {
  if constexpr (TIER == BF16) {
    const float s = bf16_rne(__fdividef(1.0f, bf16_rne(1.0f + bf16_rne(exp_neg(x)))));
    return bf16_rne(x * s);
  }
  return silu_fast(x);
}

// Thread t fills feature t % F of the chunk's columns t / F + u * NT/F: loads
// the a_col entries of the chunk at compacted column c0 (all issued before any
// is used; 0 past the last column).  F <= 256; wider takes load_a_col_half.
template <int F>
__device__ __forceinline__ void load_a_col(const PairMlp& m, const int* cols, int count,
                                           int c0, size_t node0,
                                           float (&a_col)[Layout<F>::COLS]) {
  const int k = threadIdx.x % F, q = threadIdx.x / F;
#pragma unroll
  for (int u = 0; u < Layout<F>::COLS; ++u) {
    const int idx = c0 + q + u * (NT / F);
    a_col[u] = idx < count ? __ldg(m.a_col + (node0 + cols[idx]) * F + k) : 0.0f;
  }
}

// S[p][k] = silu(pre_p[k]) of the chunk's P pairs (0 for pairs without an
// edge), from a_col of load_a_col and a_row in registers: each a_col entry
// serves the TI rows.  Branch-free (w.delta is 0 without a delta, and a pair
// without an edge has finite operands), so that the pair loads batch.  The
// BF16 tier computes pre and its silu at the JAX package's bf16 rounding
// points (the header).  F <= 256; wider takes fill_s_half.
template <int F, int TIER = TF32X3>
__device__ __forceinline__ void fill_s(const PairWeights& w, const Chunk<Layout<F>::TI>& c,
                                       const float (&a_row)[Layout<F>::TI],
                                       const float (&a_col)[Layout<F>::COLS], float* S) {
  constexpr int TI = Layout<F>::TI;
  static_assert(NT % F == 0 && TJ % (NT / F) == 0, "column groups");
  const int k = threadIdx.x % F, q = threadIdx.x / F;
#pragma unroll
  for (int u = 0; u < Layout<F>::COLS; ++u) {
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      const int p = r * TJ + q + u * (NT / F);
      float pre;
      if constexpr (TIER == BF16) {
        const float bias = fmaf(c.ll[p], w.delta, c.d2[p] * w.w_d2 + c.d20[p] * w.w_d20);
        pre = bf16_rne(bf16_rne(bf16_rne(a_row[r]) + bf16_rne(a_col[u])) + bf16_rne(bias));
      } else {
        pre = fmaf(c.ll[p], w.delta, a_row[r] + a_col[u] + c.d2[p] * w.w_d2
                                         + c.d20[p] * w.w_d20);
      }
      const float v = tier_silu<TIER>(pre);
      S[p * Layout<F>::SS + k] = c.j[p] >= 0 ? v : 0.0f;
    }
  }
}

// F = 512's fill layout (Layout::FE = 2): every thread fills all TJ columns
// of a chunk for two features, t (the narrow functions' state w, a_row,
// a_col, at F = 512 of the lower half) and t + NT (an UpperHalf).  Below 512
// UpperHalf is empty.
struct NoHalf {};
template <int F>
struct FillHalf {
  PairWeights w;
  float a_row[Layout<F>::TI];
  float a_col[Layout<F>::COLS];
  float arow[Layout<F>::TI];  // the backward's row sums of dpre
};
// F = 1024's (FE = 4): features t + e * NT, e = 1 .. 3, in h[e - 1].
template <int F>
struct FillQuarters {
  FillHalf<F> h[Layout<F>::FE - 1];
};
template <int F>
using UpperHalf = std::conditional_t<
    (Layout<F>::FE == 2), FillHalf<F>,
    std::conditional_t<(Layout<F>::FE > 2), FillQuarters<F>, NoHalf>>;

// The first-layer weights of feature k and a_row of the tile's rows (0 past
// N): the tile bodies' prologue, for F = 512's upper half.
template <int F>
__device__ __forceinline__ void load_half_rows(const PairMlp& m, size_t node0, int i0, int N,
                                               int k, FillHalf<F>& h) {
  h.w = pair_weights(m, k);
#pragma unroll
  for (int r = 0; r < Layout<F>::TI; ++r)
    h.a_row[r] = i0 + r < N ? m.a_row[(node0 + i0 + r) * F + k] : 0.0f;
}

// load_a_col at F = 512 for one half: feature k of every column of the chunk.
template <int F>
__device__ __forceinline__ void load_a_col_half(const PairMlp& m, const int* cols, int count,
                                                int c0, size_t node0, int k,
                                                float (&a_col)[Layout<F>::COLS]) {
  static_assert(Layout<F>::NQ == 1 && Layout<F>::COLS == TJ, "one column group");
#pragma unroll
  for (int u = 0; u < TJ; ++u) {
    const int idx = c0 + u;
    a_col[u] = idx < count ? __ldg(m.a_col + (node0 + cols[idx]) * F + k) : 0.0f;
  }
}

// fill_s at F = 512 for one half: S[p][k] of every pair of the chunk.
template <int F, int TIER = TF32X3>
__device__ __forceinline__ void fill_s_half(const PairWeights& w,
                                            const Chunk<Layout<F>::TI>& c,
                                            const float (&a_row)[Layout<F>::TI],
                                            const float (&a_col)[Layout<F>::COLS], int k,
                                            float* S) {
  static_assert(Layout<F>::NQ == 1 && Layout<F>::COLS == TJ, "one column group");
#pragma unroll
  for (int u = 0; u < TJ; ++u) {
#pragma unroll
    for (int r = 0; r < Layout<F>::TI; ++r) {
      const int p = r * TJ + u;
      float pre;
      if constexpr (TIER == BF16) {
        const float bias = fmaf(c.ll[p], w.delta, c.d2[p] * w.w_d2 + c.d20[p] * w.w_d20);
        pre = bf16_rne(bf16_rne(bf16_rne(a_row[r]) + bf16_rne(a_col[u])) + bf16_rne(bias));
      } else {
        pre = fmaf(c.ll[p], w.delta, a_row[r] + a_col[u] + c.d2[p] * w.w_d2
                                         + c.d20[p] * w.w_d20);
      }
      const float v = tier_silu<TIER>(pre);
      S[p * Layout<F>::SS + k] = c.j[p] >= 0 ? v : 0.0f;
    }
  }
}

// load_half_rows, load_a_col_half and fill_s_half for F = 1024's upper
// three features of thread feature k (q.h[e]: feature k + (e + 1) * NT).
template <int F>
__device__ __forceinline__ void load_quarter_rows(const PairMlp& m, size_t node0, int i0,
                                                  int N, int k, FillQuarters<F>& q) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e)
    load_half_rows<F>(m, node0, i0, N, k + (e + 1) * NT, q.h[e]);
}

template <int F>
__device__ __forceinline__ void load_a_col_quarters(const PairMlp& m, const int* cols,
                                                    int count, int c0, size_t node0, int k,
                                                    FillQuarters<F>& q) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e)
    load_a_col_half<F>(m, cols, count, c0, node0, k + (e + 1) * NT, q.h[e].a_col);
}

template <int F, int TIER = TF32X3>
__device__ __forceinline__ void fill_s_quarters(const Chunk<Layout<F>::TI>& c, int k,
                                                const FillQuarters<F>& q, float* S) {
#pragma unroll
  for (int e = 0; e < Layout<F>::FE - 1; ++e)
    fill_s_half<F, TIER>(q.h[e].w, c, q.h[e].a_row, q.h[e].a_col, k + (e + 1) * NT, S);
}

// The GCL row-tile body on the tensor cores: the aggregated messages of rows
// i0 .. i0+TI-1 of the batch item at node0 -> dst[r * DS + n] for r <
// dst_rows (global or shared memory).  smem: dynamic_smem<F>(N) bytes.
// TIER: the precision tier of the product and of the pair MLP's rounding.
template <int F, int DS = F, int TIER = TF32X3>
__device__ void gcl_tile_tc(const GclArgs& g, size_t node0, int i0, float* smem,
                            float* dst, int dst_rows) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, ROW_GROUPS = row_groups<F>(), SLICES = L::SLICES;
  constexpr int WM = L::WM;
  __shared__ Rows<TI> rows;
  __shared__ Chunk<TI> chunk;
  __shared__ float b2s[F], watt[F];
  __shared__ float att_part[SLICES][P];  // the slices' attention dots
  float* S = smem;
  W2Ring<F> ring{g.mlp.w2, S + P * L::SS, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + NS * L::STAGE);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, slice = warp / ROW_GROUPS;
  const bool attention = g.mlp.head != nullptr;

  // W2 needs nothing else: the first stage loads during the compaction
  for (int s = 0; s < NS - 1; ++s) ring.issue();
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  for (int k = t; k < F; k += NT) {
    b2s[k] = tier_round<TIER>(g.mlp.b2[k]);
    watt[k] = attention ? tier_round<TIER>(g.mlp.head[k]) : 0.0f;
  }
  const int kS = t % F;  // the feature this thread fills in S
  const PairWeights w = pair_weights(g.mlp, kS);
  float a_row[TI];
#pragma unroll
  for (int r = 0; r < TI; ++r)
    a_row[r] = i0 + r < g.N ? g.mlp.a_row[(node0 + i0 + r) * F + kS] : 0.0f;
  [[maybe_unused]] UpperHalf<F> up;  // F = 512: feature kS + NT; 1024: three more
  if constexpr (L::FE == 2) load_half_rows<F>(g.mlp, node0, i0, g.N, kS + NT, up);
  else if constexpr (L::FE > 2) load_quarter_rows<F>(g.mlp, node0, i0, g.N, kS, up);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);
  const float b_att = attention ? g.b_att[0] : 0.0f;

  // msum[m][n][c]: this lane's share of the row sum of row rg*WM + m,
  // feature column c of n-tile n, over pairs gid and gid + 8 of every chunk
  float msum[WM][L::NTN][2];
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) msum[m][n][0] = msum[m][n][1] = 0.0f;

  // a_col of the chunk to fill: loaded one chunk ahead, so that the loads
  // are in flight during the product
  float a_col[L::COLS];
  if constexpr (L::FE == 1) {
    load_a_col<F>(g.mlp, cols, count, 0, node0, a_col);
  } else if constexpr (L::FE == 2) {
    load_a_col_half<F>(g.mlp, cols, count, 0, node0, kS, a_col);
    load_a_col_half<F>(g.mlp, cols, count, 0, node0, kS + NT, up.a_col);
  } else {
    load_a_col_half<F>(g.mlp, cols, count, 0, node0, kS, a_col);
    load_a_col_quarters<F>(g.mlp, cols, count, 0, node0, kS, up);
  }
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count,
               c0, g.cut);
    __syncthreads();
    if constexpr (L::FE == 1) {
      fill_s<F, TIER>(w, chunk, a_row, a_col, S);
      load_a_col<F>(g.mlp, cols, count, c0 + TJ, node0, a_col);
    } else if constexpr (L::FE == 2) {
      fill_s_half<F, TIER>(w, chunk, a_row, a_col, kS, S);
      fill_s_half<F, TIER>(up.w, chunk, up.a_row, up.a_col, kS + NT, S);
      load_a_col_half<F>(g.mlp, cols, count, c0 + TJ, node0, kS, a_col);
      load_a_col_half<F>(g.mlp, cols, count, c0 + TJ, node0, kS + NT, up.a_col);
    } else {
      fill_s_half<F, TIER>(w, chunk, a_row, a_col, kS, S);
      fill_s_quarters<F, TIER>(chunk, kS, up, S);
      load_a_col_half<F>(g.mlp, cols, count, c0 + TJ, node0, kS, a_col);
      load_a_col_quarters<F>(g.mlp, cols, count, c0 + TJ, node0, kS, up);
    }
    float acc[WM][L::NTN][4];
    product_tc<F, ROW_GROUPS, true, false, TIER>(S, ring, acc);

    // ---- epilogue: silu, attention gate, gated row sum
    float part[WM][2];  // attention dots of pairs gid, gid + 8 of each m-tile
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      part[m][0] = part[m][1] = 0.0f;
#pragma unroll
      for (int n = 0; n < L::NTN; ++n) {
        const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m][n][e] = tier_silu<TIER>(tier_round<TIER>(acc[m][n][e] + b2s[f + (e & 1)]));
          part[m][e >> 1] = fmaf(acc[m][n][e], watt[f + (e & 1)], part[m][e >> 1]);
        }
      }
    }
    float gate[WM][2];
#pragma unroll
    for (int m = 0; m < WM; ++m) {
      const int p0 = (rg * WM + m) * 16 + gid;
      gate[m][0] = chunk.adj[p0];
      gate[m][1] = chunk.adj[p0 + 8];
    }
    if (attention) {
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[m][h] += __shfl_xor_sync(0xffffffffu, part[m][h], 1);
          part[m][h] += __shfl_xor_sync(0xffffffffu, part[m][h], 2);
          if (tig == 0) att_part[slice][(rg * WM + m) * 16 + gid + 8 * h] = part[m][h];
        }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = (rg * WM + m) * 16 + gid + 8 * h;
          float dot = b_att;
#pragma unroll
          for (int sl = 0; sl < SLICES; ++sl) dot += att_part[sl][p];
          gate[m][h] *= sigmoid_fast(dot);
        }
    }
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int n = 0; n < L::NTN; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          msum[m][n][c] = fmaf(gate[m][1], acc[m][n][2 + c],
                               fmaf(gate[m][0], acc[m][n][c], msum[m][n][c]));
    __syncthreads();  // the chunk, S and att_part are rewritten by the next chunk
  }
  cp_async_wait_all();  // the ring's look-ahead stages

  // ---- the warp's rows: add the 8 lane groups, lanes 0..3 write
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int n = 0; n < L::NTN; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          msum[m][n][c] += __shfl_xor_sync(0xffffffffu, msum[m][n][c], o);
#pragma unroll
  for (int m = 0; m < WM; ++m) {
    const int r = rg * WM + m;
    if (gid != 0 || r >= dst_rows) continue;
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = slice * L::FW + 8 * n + 2 * tig;
      dst[r * DS + f] = msum[m][n][0] / g.nf;
      dst[r * DS + f + 1] = msum[m][n][1] / g.nf;
    }
  }
}

// The head of a pair MLP on the warp's C fragments: its share of
// phi_p = sum_f silu(acc_pf + b2_f) * w3_f over its FW features, added over
// the lane quad and written to part[slice][p]; the reader adds the slices.
// The BF16 tier rounds z and computes silu(z) at its rounding points.
template <int F, int TIER = TF32X3>
__device__ __forceinline__ void head_parts(float (&acc)[Layout<F>::WM][Layout<F>::NTN][4],
                                           const float* b2s, const float* w3s,
                                           float (*part)[Layout<F>::P]) {
  using L = Layout<F>;
  constexpr int ROW_GROUPS = row_groups<F>(), WM = L::WM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % ROW_GROUPS, slice = warp / ROW_GROUPS;
#pragma unroll
  for (int m = 0; m < WM; ++m) {
    float dot[2] = {0.0f, 0.0f};  // pairs gid, gid + 8 of m-tile m
#pragma unroll
    for (int n = 0; n < L::NTN; ++n) {
      const int f = slice * L::FW + 8 * n + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dot[e >> 1] = fmaf(tier_silu<TIER>(tier_round<TIER>(acc[m][n][e] + b2s[f + (e & 1)])),
                           w3s[f + (e & 1)], dot[e >> 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 1);
      dot[h] += __shfl_xor_sync(0xffffffffu, dot[h], 2);
      if (tig == 0) part[slice][(rg * WM + m) * 16 + gid + 8 * h] = dot[h];
    }
  }
}

// The coordinate row-tile body on the tensor cores, one pair MLP a call: the
// term of the coordinate MLP (CROSS false) or of the SE(3) cross MLP (CROSS
// true) in the coordinate update of rows i0 .. i0+TI-1 of batch item `batch`
// -> g.out (egnn_coord.cuh runs the two over blockIdx.z and adds their terms
// in a second kernel).  Per chunk: the geometry, S from the MLP's
// projections (a_col loaded a chunk ahead), product_tc and the head; then the
// per-pair term (tanh, norm, cross product) and the row sums in a fixed
// order.
// smem: dynamic_smem<F>(N) bytes.  TIER: as gcl_tile_tc's.
template <int F, bool CROSS, int TIER = TF32X3>
__device__ void coord_tile_tc(const CoordArgs& g, int batch, int i0, float* smem) {
  using L = Layout<F>;
  constexpr int TI = L::TI, P = L::P, ROW_GROUPS = row_groups<F>(), SLICES = L::SLICES;
  constexpr int WM = L::WM;
  const PairMlp& mlp = CROSS ? g.cross : g.coord;
  __shared__ Rows<TI> rows;
  __shared__ Chunk<TI> chunk;
  __shared__ float b2s[F], w3s[F];
  __shared__ float phi_part[SLICES][P];  // the slices' head dots
  __shared__ float trans[P][3], mean[3];
  float* S = smem;
  W2Ring<F> ring{mlp.w2, S + P * L::SS, 0};
  int* cols = reinterpret_cast<int*>(ring.buf + NS * L::STAGE);

  const int t = threadIdx.x;
  const size_t node0 = (size_t)batch * g.N;

  // W2 needs nothing else: the first stage loads during the compaction
  for (int s = 0; s < NS - 1; ++s) ring.issue();
  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (CROSS && t < 3) mean[t] = g.graph_mean[batch * 3 + t];
  for (int k = t; k < F; k += NT) {
    b2s[k] = tier_round<TIER>(mlp.b2[k]);
    w3s[k] = tier_round<TIER>(mlp.head[k]);
  }
  const int kS = t % F;  // the feature this thread fills in S
  const PairWeights w = pair_weights(mlp, kS);
  float a_row[TI];
#pragma unroll
  for (int r = 0; r < TI; ++r)
    a_row[r] = i0 + r < g.N ? mlp.a_row[(node0 + i0 + r) * F + kS] : 0.0f;
  [[maybe_unused]] UpperHalf<F> up;  // F = 512: feature kS + NT; 1024: three more
  if constexpr (L::FE == 2) load_half_rows<F>(mlp, node0, i0, g.N, kS + NT, up);
  else if constexpr (L::FE > 2) load_quarter_rows<F>(mlp, node0, i0, g.N, kS, up);
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.col_mask, g.is_lig, node0, g.N,
                                    g.cut, cols);

  // a_col of the chunk to fill: loaded one chunk ahead, so that the loads
  // are in flight during the product
  float a_col[L::COLS];
  if constexpr (L::FE == 1) {
    load_a_col<F>(mlp, cols, count, 0, node0, a_col);
  } else if constexpr (L::FE == 2) {
    load_a_col_half<F>(mlp, cols, count, 0, node0, kS, a_col);
    load_a_col_half<F>(mlp, cols, count, 0, node0, kS + NT, up.a_col);
  } else {
    load_a_col_half<F>(mlp, cols, count, 0, node0, kS, a_col);
    load_a_col_quarters<F>(mlp, cols, count, 0, node0, kS, up);
  }
  float racc = 0.0f;  // row sum of component (t % 3) of row t / 3, t < 3*TI
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.col_mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    if constexpr (L::FE == 1) {
      fill_s<F, TIER>(w, chunk, a_row, a_col, S);
      load_a_col<F>(mlp, cols, count, c0 + TJ, node0, a_col);
    } else if constexpr (L::FE == 2) {
      fill_s_half<F, TIER>(w, chunk, a_row, a_col, kS, S);
      fill_s_half<F, TIER>(up.w, chunk, up.a_row, up.a_col, kS + NT, S);
      load_a_col_half<F>(mlp, cols, count, c0 + TJ, node0, kS, a_col);
      load_a_col_half<F>(mlp, cols, count, c0 + TJ, node0, kS + NT, up.a_col);
    } else {
      fill_s_half<F, TIER>(w, chunk, a_row, a_col, kS, S);
      fill_s_quarters<F, TIER>(chunk, kS, up, S);
      load_a_col_half<F>(mlp, cols, count, c0 + TJ, node0, kS, a_col);
      load_a_col_quarters<F>(mlp, cols, count, c0 + TJ, node0, kS, up);
    }
    float acc[WM][L::NTN][4];
    product_tc<F, ROW_GROUPS, true, false, TIER>(S, ring, acc);
    head_parts<F, TIER>(acc, b2s, w3s, phi_part);
    __syncthreads();  // the head dots are complete

    if (t < P) {
      const int k = t / TJ, j = chunk.j[t];
      float tr[3] = {0.0f, 0.0f, 0.0f};
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        float phi = 0.0f;
#pragma unroll
        for (int sl = 0; sl < SLICES; ++sl) phi += phi_part[sl][t];
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
    // no sync: the next chunk rewrites the chunk, S, phi_part and trans only
    // after its fill_chunk sync
  }
  cp_async_wait_all();  // the ring's look-ahead stages

  if (t < 3 * TI) {
    const int i = i0 + t / 3;
    if (i < g.N) g.out[(node0 + i) * 3 + t % 3] = racc / g.nf;
  }
}

}  // namespace mma
}  // namespace egnn
