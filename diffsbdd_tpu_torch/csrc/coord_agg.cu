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
#include "egnn_common.cuh"

namespace {

using namespace egnn;

struct CoordArgs {
  PairMlp coord, cross;    // head = w3; cross.a_row == null: reflection-equivariant
  const float* x;          // (B, N, 3)
  const float* x0;         // (B, N, 3)
  const float* mask;       // (B, N)
  const float* is_lig;     // (B, N)
  const float* graph_mean; // (B, 3) or null
  int use_tanh;
  float coords_range, norm_constant, nf;
  Cutoffs cut;
  int N, update_rows;
  float* out;              // (B, N, 3)
};

// silu(silu(pre) @ W2 + b2) . head for the chunk's P pairs -> phi[p].
template <int F>
__device__ void mlp_head(const PairMlp& m, const Chunk& c, size_t node0, int i0,
                         float* S, float* Ws, float* phi) {
  constexpr int NC = F / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[PPW][NC];
  pair_product<F>(m, c, node0, i0, S, Ws, acc);
#pragma unroll
  for (int r = 0; r < PPW; ++r) {
    float part = 0.0f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      int k = lane + 32 * n;
      part = fmaf(siluf_(acc[r][n] + m.b2[k]), m.head[k], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) phi[warp * PPW + r] = part;
  }
  __syncthreads();
}

template <int F>
__global__ void __launch_bounds__(NT) coord_agg_kernel(CoordArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* S = smem;                                  // P * F
  float* Ws = S + P * F;                            // KC * F
  int* cols = reinterpret_cast<int*>(Ws + KC * F);  // N
  __shared__ Rows rows;
  __shared__ Chunk chunk;
  __shared__ float phi[P], phic[P], trans[P][3], mean[3];

  const int i0 = blockIdx.x * TI;
  const int t = threadIdx.x;
  const size_t node0 = (size_t)blockIdx.y * g.N;
  const bool has_cross = g.cross.a_row != nullptr;

  load_rows(rows, g.x, g.x0, g.mask, g.is_lig, node0, i0, g.N, g.update_rows);
  if (t < 3) mean[t] = has_cross ? g.graph_mean[blockIdx.y * 3 + t] : 0.0f;
  __syncthreads();
  const int count = compact_columns(rows, g.x0, g.mask, g.is_lig, node0, g.N,
                                    g.cut, cols);

  float racc = 0.0f;  // row sum of component (t % 3) of row t / 3, t < 3*TI
  for (int c0 = 0; c0 < count; c0 += TJ) {
    fill_chunk(chunk, rows, g.x, g.x0, g.mask, g.is_lig, node0, cols, count, c0,
               g.cut);
    __syncthreads();
    mlp_head<F>(g.coord, chunk, node0, i0, S, Ws, phi);
    if (has_cross) mlp_head<F>(g.cross, chunk, node0, i0, S, Ws, phic);

    if (t < P) {
      const int k = t / TJ, j = chunk.j[t];
      float tr[3] = {0.0f, 0.0f, 0.0f};
      if (j >= 0) {
        const float* xj = g.x + (node0 + j) * 3;
        float ph = phi[t];
        if (g.use_tanh) ph = tanhf(ph) * g.coords_range;
        float norm = sqrtf(chunk.d2[t] + 1e-8f) + g.norm_constant;
        float w = ph / norm * chunk.adj[t];
        for (int a = 0; a < 3; ++a) tr[a] = w * (rows.x[k][a] - xj[a]);
        if (has_cross) {
          float phc = phic[t];
          if (g.use_tanh) phc = tanhf(phc) * g.coords_range;
          float xi0 = rows.x[k][0] - mean[0], xi1 = rows.x[k][1] - mean[1],
                xi2 = rows.x[k][2] - mean[2];
          float xj0 = xj[0] - mean[0], xj1 = xj[1] - mean[1], xj2 = xj[2] - mean[2];
          float cx = xi1 * xj2 - xi2 * xj1;
          float cy = xi2 * xj0 - xi0 * xj2;
          float cz = xi0 * xj1 - xi1 * xj0;
          float cnorm = sqrtf(cx * cx + cy * cy + cz * cz + 1e-8f) + g.norm_constant;
          float wc = phc / cnorm * chunk.adj[t];
          tr[0] += wc * cx; tr[1] += wc * cy; tr[2] += wc * cz;
        }
      }
      for (int a = 0; a < 3; ++a) trans[t][a] = tr[a];
    }
    __syncthreads();
    if (t < 3 * TI) {
      const int k = t / 3, a = t % 3;
      for (int jj = 0; jj < TJ; ++jj) racc += trans[k * TJ + jj][a];
    }
    __syncthreads();  // the chunk and phi are rewritten by the next chunk
  }

  if (t < 3 * TI) {
    const int i = i0 + t / 3;
    if (i < g.N) g.out[(node0 + i) * 3 + t % 3] = racc / g.nf;
  }
  zero_rows_past_grid(g.out, node0, g.N, 3);
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
