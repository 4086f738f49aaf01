// Shared parts of K5 vislayer_fwd and K6 vislayer_bwd, the full ViS-MP layer
// of ai2bmd_tpu/ops/pallas/vislayer.py: the argument block, the LayerNorm
// rows, and the node-side products that both directions compute (the TPU
// kernels ran them in their `it == 0` prologues, vislayer.py:110-129 and
// :212-231).
//
// Layouts (sphere-major, as the JAX package's fused_layer):
//   x [B,A,H]   vec [B,S,A,H]   edge [B,A,A,H]   dsh [B,S,A,A]   dist, adj [B,A,A]
// and the scratch the stages hand to each other (rows x columns):
//   qkv   [B*A][3H]      q | k | v
//   proj  [B*S*A][NP*H]  vec1 | vec2 | vec3 (| wt | wsrc), NP = 5, or 3 for the last layer
// All weights are row-major [in][out], as in JAX.
#pragma once

#include "common.cuh"

namespace ai2bmd {

// Node rows per block of the node-side products.  B*A and B*S*A are
// multiples of 8 (A is), so a tile holds 8 or 16 rows.
constexpr int NODE_ROWS = 16;

// Pointer fields first, in the order of PTR_FIELDS in ops/vislayer.py; a
// pointer a direction does not use is null.
struct Layer {
  // inputs
  const float *x, *vec, *edge, *dsh, *dist, *adj;
  const float *ln_s, *ln_b, *vln_w, *w_qkv, *b_qkv, *w_vp, *w_dkv, *b_dkv, *w_s, *b_s, *w_o,
      *b_o, *w_t, *w_src, *w_f, *b_f;
  // backward only: transposed weights, the forward's xagg, the cotangents
  const float *w_qkvT, *w_oT, *w_catT, *w_dkvT, *w_sT, *w_fT;
  const float *xagg_in, *gx2, *gvec2, *gedge2;
  // scratch
  float *qkv, *proj, *vecagg, *o, *gxagg, *gqkv, *gw, *gvecn, *gk_e, *gv_e, *s1_e, *gs_e;
  // outputs
  float *x2, *vec2, *edge2, *xagg;          // forward
  float *gx, *gvec, *gedge, *gdsh, *gdist;  // backward
  int B, A, H, S, NP;
  float cutoff;
};
constexpr int LAYER_PTRS = 53;

__device__ __forceinline__ float ln_eps() { return 1e-5f; }

// X[r] <- (X[r] - mean) / sqrt(var + eps) for the n rows of X ([n][H], shared
// memory), one warp per row, sums in a fixed order; rstd[r] kept if asked.
__device__ __forceinline__ void normalize_rows(float* X, int n, int H, float* rstd) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, NW = blockDim.x / 32;
  for (int r = w; r < n; r += NW) {
    float* row = X + r * H;
    float s = 0.0f;
    for (int k = lane; k < H; k += 32) s += row[k];
    const float mu = warp_sum(s) / H;
    float ss = 0.0f;
    for (int k = lane; k < H; k += 32) {
      const float d = row[k] - mu;
      ss = fmaf(d, d, ss);
    }
    const float rs = rsqrtf(warp_sum(ss) / H + ln_eps());
    for (int k = lane; k < H; k += 32) row[k] = (row[k] - mu) * rs;
    if (rstd != nullptr && lane == 0) rstd[r] = rs;
  }
}

// Y[row][g*H + t] = (LN ? LayerNorm(src[row]) : src[row]) @ W[:, g*H + t] + bias,
// for the node rows of one tile; grid (tiles, column groups), H threads.
// qkv = LayerNorm(x) @ W_qkv + b_qkv (vislayer.py:113-117) and, in the
// backward, o = xagg @ W_o + b_o (:233).
template <bool LN>
static __global__ void __launch_bounds__(256) node_proj(const float* __restrict__ src,
                                                 const float* __restrict__ ln_s,
                                                 const float* __restrict__ ln_b,
                                                 const float* __restrict__ W,
                                                 const float* __restrict__ bias,
                                                 float* __restrict__ Y, int M, int H, int ldw) {
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;  // [NODE_ROWS][H]
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * NODE_ROWS, n = min(NODE_ROWS, M - r0);
  const int col[1] = {(int)blockIdx.y * H + t};
  for (int e = t; e < n * H; e += blockDim.x) sX[e] = src[(size_t)r0 * H + e];
  __syncthreads();
  if (LN) {
    normalize_rows(sX, n, H, nullptr);
    __syncthreads();
    for (int e = t; e < n * H; e += blockDim.x) {
      const int k = e % H;
      sX[e] = fmaf(sX[e], ln_s[k], ln_b[k]);
    }
    __syncthreads();
  }
  float acc[1][NODE_ROWS];
  rows_times_cols<1, NODE_ROWS>(sX, n, H, W, ldw, col, acc);
  const float bc = bias[col[0]];
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r)
    if (r < n) Y[(size_t)(r0 + r) * ldw + col[0]] = acc[0][r] + bc;
}

// proj[row][g*H + t] = vecn[row] @ [W_vp | W_t | W_src][:, g*H + t] with
// vecn = vec * w_vln, over the B*S*A sphere-major rows of vec; grid (tiles,
// NP).  vislayer.py:118-129: vec1|vec2|vec3 and, for a layer that is not
// the last, wt and wsrc.
static __global__ void __launch_bounds__(256) vec_proj(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;  // [NODE_ROWS][H]
  const int t = threadIdx.x, H = p.H, g = blockIdx.y;
  const int M = p.B * p.S * p.A;
  const int r0 = blockIdx.x * NODE_ROWS, n = min(NODE_ROWS, M - r0);
  for (int e = t; e < n * H; e += blockDim.x)
    sX[e] = p.vec[(size_t)r0 * H + e] * p.vln_w[e % H];
  __syncthreads();
  const float* W = g < 3 ? p.w_vp : (g == 3 ? p.w_t : p.w_src);
  const int ldw = g < 3 ? 3 * H : H;
  const int col[1] = {(g < 3 ? g * H : 0) + t};
  float acc[1][NODE_ROWS];
  rows_times_cols<1, NODE_ROWS>(sX, n, H, W, ldw, col, acc);
  const int ldp = p.NP * H;
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r)
    if (r < n) p.proj[(size_t)(r0 + r) * ldp + g * H + t] = acc[0][r];
}

inline int node_tiles(int rows) { return (rows + NODE_ROWS - 1) / NODE_ROWS; }

// The node prologue both directions share: qkv and proj.
static inline cudaError_t launch_node_prologue(const Layer& p, cudaStream_t stream) {
  const int M = p.B * p.A, Mv = p.B * p.S * p.A;
  const size_t smem = (size_t)NODE_ROWS * p.H * sizeof(float);
  node_proj<true><<<dim3(node_tiles(M), 3), p.H, smem, stream>>>(p.x, p.ln_s, p.ln_b, p.w_qkv,
                                                                  p.b_qkv, p.qkv, M, p.H,
                                                                  3 * p.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vec_proj<<<dim3(node_tiles(Mv), p.NP), p.H, smem, stream>>>(p);
  return cudaGetLastError();
}

// Grants a kernel the dynamic shared memory it needs (above 48 KB only
// after this call).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool layer_shapes_ok(int A, int H, int S) {
  return A <= MAXA && A % RCHUNK == 0 && S <= MAXS && H % 32 == 0 && H <= 256 && H >= 32;
}

}  // namespace ai2bmd
