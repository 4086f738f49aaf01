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
  float *z, *v_e, *s_e, *g_e, *gS_e, *a_e;
  float *xo, *xv, *gxagg, *gqkv, *gvecn, *gxh;
  // outputs
  float *x2, *vec2, *edge2, *xagg;          // forward
  float *gx, *gvec, *gedge, *gdsh, *gdist;  // backward
  int B, A, H, S, NP;
  float cutoff;
};
constexpr int LAYER_PTRS = 52;

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
// The wide instantiation's products promote each k-slab's sums (row_tile's
// PROMOTE), which takes a second set of accumulators: its edge rows take
// 64-row tiles, so that they stay within the 128 registers of two blocks
// an SM.
constexpr int EDGE_TM_WIDE = 64;

// The node-side products of the prologue, on rows of W floats (H, or Hp
// in the wide instantiation, PROMOTE): qkv = xn @ W_qkv + b_qkv and
// proj = vecn @ [W_vp | W_t | W_src].
template <bool PROMOTE = false>
static inline cudaError_t launch_node_products(const Layer& p, int W, cudaStream_t stream) {
  const size_t M = (size_t)p.B * p.A, Mv = (size_t)p.B * p.S * p.A;
  cudaError_t err = launch_row_tile<NODE_TM, false, PROMOTE>(
      p.xn, W, M, W, 3 * W, wseg(p.w_qkv, 3 * W), BiasStore{p.qkv, 3 * W, p.b_qkv}, stream);
  if (err != cudaSuccess) return err;
  return launch_row_tile<VEC_TM, false, PROMOTE>(
      p.vecn, W, Mv, W, p.NP * W, wseg(p.w_vp, 3 * W, 3 * W, p.w_t, W, 4 * W, p.w_src, W),
      BiasStore{p.proj, p.NP * W, nullptr}, stream);
}

// The node prologue both directions share: xn and vecn, then the products.
static inline cudaError_t launch_node_prologue(const Layer& p, cudaStream_t stream) {
  const size_t M = (size_t)p.B * p.A, Mv = (size_t)p.B * p.S * p.A;
  node_prep<<<(unsigned)((M + Mv + 7) / 8), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_node_products(p, p.H, stream);
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

// The shapes K5 and K6 take (``layer_shapes`` and ``check_layer_shapes`` in
// ops/vismp.py): any A % 8 == 0, S <= 8, and every H that the head count
// H / dh divides.  The narrow instantiations take narrow_shapes(H, H / dh)
// (common.cuh, as K1, K2 and K7 choose), the wide ones the rest.
inline bool layer_shapes_ok(int A, int H, int S, int dh) {
  return A > 0 && A % RCHUNK == 0 && S <= MAXS && H > 0 && dh > 0 && H % dh == 0;
}

// ---------------------------------------------------------------------------
// The wide instantiation of K5 and K6
// ---------------------------------------------------------------------------
//
// Every shape but the narrow ones: heads of any width, any H.  As the edge
// kernels' wide instantiations (common.cuh):
// - every scratch row (xn, vecn, qkv, proj, o, x_agg, z, v_e, s_e, g_e,
//   gS_e, xo, xv, g_xagg, g_qkv, g_vecn, g_xhat) is Hp = wide_width(H)
//   floats a segment, and every weight and bias is zero-padded to Hp a
//   segment (W_qkv [Hp][3 Hp], b_qkv [3 Hp], ..., ln_s [Hp]; the model pads
//   them once, ops/vislayer.padded_layer_weights), so every product is a
//   row_tile as in the narrow kernels, K a multiple of 32 and rows 16-byte
//   aligned;
// - the residual streams stay at H, as the model holds them: x, vec and
//   edge in, x', vec' and edge' out, and the cotangents gx2, gvec2, gedge2
//   in and gx, gvec, gedge out.  A stage reads a stream's channel c < H
//   only and writes none past it.  At H % 32 != 0 the edge rows, which the
//   edge products read as X, are first copied into a padded scratch
//   (v_e, free until the message fills it: pad_rows); at H % 32 == 0 the
//   products read the stream itself.  Working at Hp throughout instead
//   would pad the [B, A, A, H] edge stream and slice its cotangent around
//   every layer stack, and carry padded channels through the residuals;
// - a padded channel of a scratch row is 0 after every stage that writes
//   it (the products read it, and 0 times an unwritten NaN is NaN);
// - at most 256 threads a block (wide_threads), each looping over the
//   channels t, t + 256, ...; a sum a thread carries over a centre's
//   sources (x_agg, g_q) goes to its output after each chunk and is read
//   back for the next, one chain over the rows in order, so no thread holds
//   an array of channels; the LayerNorm statistics run over the H
//   channels, not Hp;
// - the head terms go to a scratch row in device memory (v_e, or g_e in
//   K6's centre pass, free at that stage) and a head sums its dh channels
//   in order from k-tiles of them staged in shared memory
//   (block_head_sums, common.cuh), one (row, head) a thread; a_ij go to
//   s_e's rows (free until the product that fills them), K6's centre pass
//   takes a_ij and the cotangents' head sums in a_e.  K5 and K6 stage the
//   same terms (layer_term) in the same order, so K6's recomputed a_ij
//   equals K5's bitwise;
// - the centre passes take chunks of ECHUNK sources, their shared memory
//   static (a k-tile, gates, the warps' partials): none grows with H;
// - the sums over all channels (g_dist, g_d_sh) take each thread's channels
//   in order, then the warp (warp_sum), then the warps in order.
// Every sum runs in a fixed order: the wide kernels are bitwise repeatable.

// One channel's term of the attention pre-activation a_ij = sum_head
// q_i k_j dk, as both directions' wide instantiations stage it.
__device__ __forceinline__ float layer_term(float qi, float kr, float dk) { return qi * kr * dk; }

// xn = LayerNorm(x) (statistics over the H channels) and vecn = vec * w_vln
// at Hp, 0 past H; one warp a row, as node_prep.
static __global__ void __launch_bounds__(256) node_prep_wide(const Layer p, int Hp) {
  const int H = p.H, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  const size_t M = (size_t)p.B * p.A, Mv = (size_t)p.B * p.S * p.A;
  if (row < M) {
    const float* x = p.x + row * H;
    float mu, rs;
    row_stats(x, H, mu, rs);
    for (int k = lane; k < Hp; k += 32)
      p.xn[row * Hp + k] = k < H ? fmaf((x[k] - mu) * rs, p.ln_s[k], p.ln_b[k]) : 0.0f;
  } else if (row < M + Mv) {
    const size_t v = row - M;
    for (int k = lane; k < Hp; k += 32)
      p.vecn[v * Hp + k] = k < H ? p.vec[v * H + k] * p.vln_w[k] : 0.0f;
  }
}

// dst [rows][Hp] = src [rows][H], 0 past H.
static __global__ void __launch_bounds__(256) pad_rows(float* __restrict__ dst,
                                                       const float* __restrict__ src,
                                                       size_t rows, int H, int Hp) {
  const size_t n = rows * Hp;
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += (size_t)gridDim.x * blockDim.x) {
    const size_t r = x / Hp;
    const int c = (int)(x - r * Hp);
    dst[x] = c < H ? src[r * H + c] : 0.0f;
  }
}

// The X rows of the edge products: the edge stream itself at H == Hp, else
// its copy at Hp in `scratch`.
static inline cudaError_t padded_edge_rows(const Layer& p, int Hp, float* scratch,
                                           const float** X, cudaStream_t stream) {
  *X = p.edge;
  if (Hp == p.H) return cudaSuccess;
  const size_t E = (size_t)p.B * p.A * p.A, blocks = (E * Hp + 255) / 256;
  pad_rows<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, stream>>>(
      scratch, p.edge, E, p.H, Hp);
  *X = scratch;
  return cudaGetLastError();
}

// The wide node prologue: xn and vecn at Hp, then the products at Hp.
static inline cudaError_t launch_node_prologue_wide(const Layer& p, int Hp,
                                                    cudaStream_t stream) {
  const size_t M = (size_t)p.B * p.A, Mv = (size_t)p.B * p.S * p.A;
  node_prep_wide<<<(unsigned)((M + Mv + 7) / 8), 256, 0, stream>>>(p, Hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_node_products<true>(p, Hp, stream);
}

}  // namespace ai2bmd
