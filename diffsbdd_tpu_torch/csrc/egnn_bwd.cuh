// Device code shared by gcl_agg_bwd.cu and coord_agg_bwd.cu, f32, for sm_90a.
//
// Both backward kernels keep the forward's tiling (egnn_common.cuh): a tile of
// TI rows, its compacted active columns walked in chunks of TJ columns = P
// pairs.  For each chunk and each pair MLP they recompute the forward
//
//   m1 = silu(pre),  z2 = m1 @ W2 + b2,  m2 = silu(z2)
//
// take dm2 from the kernel's epilogue, and run the MLP backwards:
//
//   dz2  = dm2 * silu'(z2)        dW2 += m1^T dz2      db2 += sum_p dz2
//   dm1  = dz2 @ W2^T             dpre = dm1 * silu'(pre)
//   da_row_i += sum_j dpre        da_col_j += sum_i dpre
//   dw_d2 += sum dpre*d2          dw_d20 += sum dpre*d20     ddelta += sum dpre*ll
//   dd2_p = dpre_p . w_d2         dd20_p = dpre_p . w_d20
//
// Three P x F x F products per chunk and MLP (forward, dW2, dm1); m1 and dz2
// of the chunk sit in two P x F shared-memory tiles, W2 and its transpose are
// streamed through the KC-row stage as in the forward.
//
// Sums across blocks.  Hopper blocks run in no order, so nothing is carried
// from block to block.  The grid is (Q, B): block (q, b) walks the row tiles
// q, q + Q, ... of batch b and owns one slab of global scratch for every sum
// that crosses row tiles -- da_col and the column-side dx/dx0 of its batch,
// dmean, and every weight cotangent.  It adds into its slab without atomics
// (one thread per address between two block syncs), and a second kernel
// (reduce_partials) sums the slabs in index order.  The result is
// deterministic: no atomics anywhere.
//
// dW2 does not fit a block (F x F f32 = 256 KB at F = 256): each chunk's
// m1^T dz2 is computed in column slabs of 64, a T x T register tile per
// thread, and added to the block's F x F slab in global scratch.  That costs
// one read and one write of the slab per chunk through L2 (2 * 256 KB against
// 3 * 8.4 MFLOP of products), and Q * B * F * F floats of scratch.
#pragma once
#include "egnn_common.cuh"

namespace egnn {

__device__ __forceinline__ float dsiluf_(float z) {
  const float s = sigmoidf_(z);
  return s * (1.0f + z * (1.0f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block's weight-cotangent slab of one pair MLP, in floats:
// [dW2: F*F][dw_d2: F][dw_d20: F][ddelta: F][db2: F][dhead: F][dhead_bias: 1, padded to F]
__host__ __device__ constexpr size_t weight_slab(int F) { return (size_t)F * F + 6 * (size_t)F; }

// What the backward of one pair MLP needs beside its PairMlp.
struct MlpBwd {
  const float* w2t;   // (F, F) transpose of w2
  float* w_part;      // this block's weight slab
  float* acol_part;   // this block's (N, F) slab of da_col
};

// Thread k < F owns feature k of the block's vector cotangents, summed over
// every chunk the block visits.
struct FeatAcc { float w_d2, w_d20, delta, b2, head; };

// Per-pair cotangents of the two squared distances, summed over the MLPs.
struct PairD2 { float dd2[P], dd20[P]; };

// dW2 slab += m1^T dz2 over the chunk's pairs with an edge.
template <int F>
__device__ __forceinline__ void dw2_accumulate(const float* S, const float* D,
                                               const Chunk& c, float* dw2) {
  constexpr int T = F >= 256 ? 8 : 4;  // a thread's T x T tile of dW2
  constexpr int KT = F / T;            // threads along the rows of dW2
  constexpr int NTN = NT / KT;         // threads along a column slab
  constexpr int SW = NTN * T;          // columns per slab
  static_assert(NT % KT == 0 && F % SW == 0 && T % 4 == 0, "dW2 tiling");
  const int t = threadIdx.x, k0 = (t % KT) * T, tn = t / KT;
  for (int nb = 0; nb < F; nb += SW) {
    const int n0 = nb + tn * T;
    float w[T][T];
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int b = 0; b < T; ++b) w[a][b] = 0.0f;
    for (int p = 0; p < P; ++p) {
      if (c.j[p] < 0) continue;  // both rows are zero
      float sa[T], db[T];
#pragma unroll
      for (int q = 0; q < T; q += 4) {
        const float4 u = *reinterpret_cast<const float4*>(S + p * F + k0 + q);
        const float4 v = *reinterpret_cast<const float4*>(D + p * F + n0 + q);
        sa[q] = u.x; sa[q + 1] = u.y; sa[q + 2] = u.z; sa[q + 3] = u.w;
        db[q] = v.x; db[q + 1] = v.y; db[q + 2] = v.z; db[q + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < T; ++a)
#pragma unroll
        for (int b = 0; b < T; ++b) w[a][b] = fmaf(sa[a], db[b], w[a][b]);
    }
#pragma unroll
    for (int a = 0; a < T; ++a)
#pragma unroll
      for (int q = 0; q < T; q += 4) {
        float4* gp = reinterpret_cast<float4*>(dw2 + (size_t)(k0 + a) * F + n0 + q);
        float4 v = *gp;
        v.x += w[a][q]; v.y += w[a][q + 1]; v.z += w[a][q + 2]; v.w += w[a][q + 3];
        *gp = v;
      }
  }
}

// Forward and backward of one pair MLP over the chunk's P pairs.
//
// epi(p, m2, dm2) is called by the whole warp that owns pair p (which has an
// edge) with the lane's NC features of m2; it fills dm2 = dL/dm2 and returns
// the pair's head scalar hs, for dhead += sum_p hs_p * m2_p.
//
// Adds dpre . w_d2 / w_d20 into dd (which the caller zeroes per chunk), the row
// sums of dpre into arow[TI] (thread k < F: feature k of the tile's TI rows),
// the column sums into the block's da_col slab, and the weight sums into fa
// and the block's dW2 slab.  The chunk must be filled and synced; S, D, Ws are
// free again when it returns.
template <int F, class Epi>
__device__ __forceinline__ void mlp_backward(const PairMlp& m, const MlpBwd& mb,
                                             const Chunk& c, const int* cols, int count,
                                             int c0, size_t node0, int i0, float* S,
                                             float* D, float* Ws, PairD2& dd, FeatAcc& fa,
                                             float (&arow)[TI], Epi epi) {
  static_assert(F <= NT && (NT / 32) * F <= KC * F, "thread k owns feature k");
  constexpr int NC = F / 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  float acc[PPW][NC];
  pair_product<F>(m, c, node0, i0, S, Ws, acc);  // S = m1, acc = m1 @ W2

  // ---- dz2 of the chunk into D, and the lane's part of dhead
  float hv[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) hv[n] = 0.0f;
#pragma unroll
  for (int r = 0; r < PPW; ++r) {
    const int p = warp * PPW + r;
    if (c.j[p] < 0) {
#pragma unroll
      for (int n = 0; n < NC; ++n) D[p * F + lane + 32 * n] = 0.0f;
      continue;
    }
    float z2[NC], m2[NC], dm2[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      z2[n] = acc[r][n] + m.b2[lane + 32 * n];
      m2[n] = siluf_(z2[n]);
    }
    const float hs = epi(p, m2, dm2);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      D[p * F + lane + 32 * n] = dm2[n] * dsiluf_(z2[n]);
      hv[n] = fmaf(m2[n], hs, hv[n]);
    }
  }
  __syncthreads();  // the last W2 stage is consumed: Ws is free
#pragma unroll
  for (int n = 0; n < NC; ++n) Ws[warp * F + lane + 32 * n] = hv[n];
  __syncthreads();  // D and the staged dhead parts are complete
  if (t < F) {
    float h = 0.0f, b = 0.0f;
    for (int w = 0; w < NT / 32; ++w) h += Ws[w * F + t];
    for (int p = 0; p < P; ++p) b += D[p * F + t];
    fa.head += h;
    fa.b2 += b;
  }
  dw2_accumulate<F>(S, D, c, mb.w_part);

  // ---- dm1 = dz2 @ W2^T, dpre = dm1 * silu'(pre)
  tile_product<F>(D, mb.w2t, Ws, acc);
  PairWeights pw[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) pw[n] = pair_weights(m, lane + 32 * n);
#pragma unroll
  for (int r = 0; r < PPW; ++r) {
    const int p = warp * PPW + r;
    float a = 0.0f, b = 0.0f;
    if (c.j[p] >= 0) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float pre = pre_value<F>(m, pw[n], c, p, lane + 32 * n, node0, i0);
        const float v = acc[r][n] * dsiluf_(pre);
        acc[r][n] = v;
        a = fmaf(v, pw[n].w_d2, a);
        b = fmaf(v, pw[n].w_d20, b);
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) { dd.dd2[p] += a; dd.dd20[p] += b; }
    } else {
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] = 0.0f;
    }
  }
  __syncthreads();  // every warp is done reading S and D
#pragma unroll
  for (int r = 0; r < PPW; ++r)
#pragma unroll
    for (int n = 0; n < NC; ++n) S[(warp * PPW + r) * F + lane + 32 * n] = acc[r][n];
  __syncthreads();  // S = dpre

  // ---- sums of dpre over pairs, feature t
  if (t < F) {
    for (int row = 0; row < TI; ++row) {
      float rs = 0.0f;
      for (int jj = 0; jj < TJ; ++jj) {
        const int p = row * TJ + jj;
        const float v = S[p * F + t];
        rs += v;
        fa.w_d2 = fmaf(v, c.d2[p], fa.w_d2);
        fa.w_d20 = fmaf(v, c.d20[p], fa.w_d20);
        fa.delta = fmaf(v, c.ll[p], fa.delta);
      }
      arow[row] += rs;
    }
    for (int jj = 0; jj < TJ && c0 + jj < count; ++jj) {
      float cs = 0.0f;
      for (int row = 0; row < TI; ++row) cs += S[(row * TJ + jj) * F + t];
      mb.acol_part[(size_t)cols[c0 + jj] * F + t] += cs;
    }
  }
  __syncthreads();  // S, D and Ws are free
}

// Thread t < F writes feature t of the block's vector cotangents into its slab.
template <int F>
__device__ __forceinline__ void store_feat_acc(const FeatAcc& fa, float* w_part) {
  const int t = threadIdx.x;
  if (t >= F) return;
  float* v = w_part + (size_t)F * F;
  v[t] = fa.w_d2; v[F + t] = fa.w_d20; v[2 * F + t] = fa.delta;
  v[3 * F + t] = fa.b2; v[4 * F + t] = fa.head;
}

// Adds the chunk's per-pair coordinate cotangents into the block's (N, 6) slab
// [dx: 3, dx0: 3]: rowc[p] goes to the pair's row node, colc[p] to its column
// node; both are zero for pairs without an edge.  Rows first, then columns: a
// node can be both in one chunk.  Must be called by every thread, after a sync
// that completes rowc and colc.
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

// Dynamic shared memory of either backward kernel: S (m1, then dpre), D (dz2),
// the W2 stage and the compacted column list.
template <int F>
constexpr size_t dynamic_smem_bwd(int N) {
  return sizeof(float) * (2 * (size_t)P * F + (size_t)KC * F) + sizeof(int) * (size_t)N;
}

}  // namespace egnn
