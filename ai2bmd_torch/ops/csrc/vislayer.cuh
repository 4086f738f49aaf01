// Shared parts of K5 vislayer_fwd and K6 vislayer_bwd, the full ViS-MP layer
// of ai2bmd_tpu/ops/pallas/vislayer.py: the argument block, the node rows
// both directions prepare, the node-side products that both compute (the
// TPU kernels ran them in their `it == 0` prologues, vislayer.py:110-129
// and :212-231), and the per-centre pieces of the edge stage.
//
// Layouts (sphere-major, as the JAX package's fused_layer):
//   x [B,A,H]   vec [B,S,A,H]   edge [B,A,A,H]   dsh [B,S,A,A]   dist, adj [B,A,A]
// and the scratch the stages hand to each other (rows x columns; E = B*A*A
// flattened edge rows (b, i, j), node rows (b, a), vector rows (b, c, a)):
//   xn    [B*A][H]       LayerNorm(x)
//   vecn  [B*S*A][H]     vec * w_vln
//   qkv   [B*A][3H]      q | k | v
//   proj  [B*S*A][NP*H]  vec1 | vec2 | vec3 (| wt | wsrc), NP = 5, or 3 for the last layer
//   o     [B*A][3H]      x_agg @ W_o + b_o
// All weights are row-major [in][out], as in JAX, and every product reads
// them as stored (row_tile, common.cuh).
#pragma once

#include "common.cuh"

namespace ai2bmd {

// Pointer fields first, in the order of PTR_FIELDS in ops/vislayer.py; a
// pointer a direction does not use is null.
struct Layer {
  // inputs
  const float *x, *vec, *edge, *dsh, *dist, *adj;
  const float *ln_s, *ln_b, *vln_w, *w_qkv, *b_qkv, *w_vp, *w_dkv, *b_dkv, *w_s, *b_s, *w_o,
      *b_o, *w_t, *w_src, *w_f, *b_f;
  // backward only: the forward's xagg, the cotangents
  const float *xagg_in, *gx2, *gvec2, *gedge2;
  // scratch: node rows, then per-edge rows (see the .cu files), then the
  // backward's node rows
  float *xn, *vecn, *qkv, *proj, *o;
  float *z, *v_e, *s_e, *g_e, *gS_e;
  float *xo, *xv, *gxagg, *gqkv, *gvecn, *gxh;
  // outputs
  float *x2, *vec2, *edge2, *xagg;          // forward
  float *gx, *gvec, *gedge, *gdsh, *gdist;  // backward
  int B, A, H, S, NP;
  float cutoff;
};
constexpr int LAYER_PTRS = 51;

__device__ __forceinline__ float ln_eps() { return 1e-5f; }

// The flattened edge row r = (b A + i) A + j.
struct EdgeRow {
  size_t bi, b0;  // b A + i, b A
  int b, i, j;
  __device__ EdgeRow(size_t r, int A) {
    bi = r / A;
    j = (int)(r - bi * A);
    b = (int)(bi / A);
    i = (int)(bi - (size_t)b * A);
    b0 = (size_t)b * A;
  }
};

// Mean and 1 / sqrt(var + eps) of one row of H floats, by one warp, in a
// fixed order; every lane gets both.
__device__ __forceinline__ void row_stats(const float* row, int H, float& mu, float& rs) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int k = lane; k < H; k += 32) s += row[k];
  mu = warp_sum(s) / H;
  float ss = 0.0f;
  for (int k = lane; k < H; k += 32) {
    const float d = row[k] - mu;
    ss = fmaf(d, d, ss);
  }
  rs = rsqrtf(warp_sum(ss) / H + ln_eps());
}

// The products' X rows, one warp a row: xn = LayerNorm(x) for the B*A node
// rows, then vecn = vec * w_vln for the B*S*A vector rows.
static __global__ void __launch_bounds__(256) node_prep(const Layer p) {
  const int H = p.H, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const size_t M = (size_t)p.B * p.A, Mv = (size_t)p.B * p.S * p.A;
  if (row < M) {
    const float* x = p.x + row * H;
    float mu, rs;
    row_stats(x, H, mu, rs);
    for (int k = lane; k < H; k += 32) p.xn[row * H + k] = fmaf((x[k] - mu) * rs, p.ln_s[k], p.ln_b[k]);
  } else if (row < M + Mv) {
    const size_t v = (row - M) * H;
    for (int k = lane; k < H; k += 32) p.vecn[v + k] = p.vec[v + k] * p.vln_w[k];
  }
}

// y[r][n] = acc + bias[n] (bias may be null).
struct BiasStore {
  float* y;
  int ldy;
  const float* bias;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    if (bias != nullptr) {
      v0 += bias[n];
      v1 += bias[n + 1];
    }
    *reinterpret_cast<float2*>(y + r * ldy + n) = make_float2(v0, v1);
  }
};

// Node rows take 16-row tiles (Chignolin's batches have B*A = 48-160
// rows, so 36-120 blocks at N = 3H = 768; larger tiles would leave most
// SMs idle); the B*S*A vector rows 64-row tiles; edge rows 128-row tiles.
constexpr int NODE_TM = 16, VEC_TM = 64, EDGE_TM = 128;

// The node prologue both directions share: xn and vecn, then
// qkv = xn @ W_qkv + b_qkv and proj = vecn @ [W_vp | W_t | W_src].
static inline cudaError_t launch_node_prologue(const Layer& p, cudaStream_t stream) {
  const int H = p.H;
  const size_t M = (size_t)p.B * p.A, Mv = (size_t)p.B * p.S * p.A;
  node_prep<<<(unsigned)((M + Mv + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, false>(p.xn, H, M, H, 3 * H, wseg(p.w_qkv, 3 * H),
                                        BiasStore{p.qkv, 3 * H, p.b_qkv}, stream);
  if (err != cudaSuccess) return err;
  return launch_row_tile<VEC_TM, false>(
      p.vecn, H, Mv, H, p.NP * H, wseg(p.w_vp, 3 * H, 3 * H, p.w_t, H, 4 * H, p.w_src, H),
      BiasStore{p.proj, p.NP * H, nullptr}, stream);
}

// Per-centre pieces: one block per (fragment b, centre atom i), one thread
// per channel; the head of channel t is t / DH (DH = H / nh channels, 8, 16,
// 32 or 64, a template parameter of the kernels that sum a head).  A centre
// walks its sources in chunks of at most ECHUNK rows (common.cuh), so its
// shared memory follows the chunk and not A.
// sGate[r] = cutoff(dist_ir) * adj_ir for the n rows of the chunk that
// starts at edge row e0 = (b A + i) A + c0.
__device__ __forceinline__ void load_gate(const float* dist, const float* adj, int n,
                                          float cutoff, size_t e0, float* sGate) {
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    sGate[r] = cosine_cutoff(dist[e0 + r], cutoff) * adj[e0 + r];
}

// The attention head sum a_ij = sum_head q_i k_j dk (dk = silu(zk)); K5 and
// K6 evaluate it alike, so K6's recomputed a equals K5's bitwise.
template <int DH>
__device__ __forceinline__ float head_pre(float qi, float kr, float dk) {
  return head_sum<DH>(qi * kr * dk);
}

inline bool layer_shapes_ok(int A, int H, int S) {
  return A <= EDGE_MAXA && A % RCHUNK == 0 && S <= MAXS && H % 32 == 0 && H <= 256 && H >= 32;
}

}  // namespace ai2bmd
