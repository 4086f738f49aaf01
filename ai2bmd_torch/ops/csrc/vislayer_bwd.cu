// K6 vislayer_bwd: the recompute-mode VJP of one complete ViS-MP layer.
//
// Replaces _bwd_kernel (ai2bmd_tpu/ops/pallas/vislayer.py:187), launched by
// _bwd_call's pallas_call (:518).  From the layer inputs (x, vec, edge, d_sh,
// dist, adj), the forward's x_agg and the cotangents (gx2, gvec2, gedge2) it
// gives gx, gvec, gedge, gd_sh and gdist; the weights get no gradient.
// gedge includes the residual passthrough gedge2 in both the updating and
// the last layer.
//
// What bounds it on the H100: the products, 10 H^2 multiply-adds per edge
// cell (the forward's edge @ [W_dkv | W_f] and v_ij @ W_s recomputed, 5
// H^2, then g_s @ W_s^T and [g_dkv | g_zf] @ [W_dkv ; W_f]^T, 5 H^2) and
// 92 H^2 per atom on the node side, on the tensor cores as 3xTF32 (165
// TFLOP/s in float32 products); the bytes (edge and gedge2 in, gedge out)
// take about a third of the products' time at H = 256.  Recomputing
// instead of reading a stash of zdkv/zs/zf (K2/K3's route) costs about
// 1.5x the edge arithmetic and saves 5 H floats per edge cell of device
// memory written and read.
// Design: every product is a row_tile (common.cuh) with its row-local work
// in the epilogue, over the flattened edge rows (128-row tiles), the
// vector rows (64) or the node rows (16), each grid (row tiles x 64-column
// blocks); what couples rows runs in passes between them.  Stages, in
// stream order, with the [E, .] rows each moves (floats per edge row):
//   (a) node prologue (vislayer.cuh): xn, vecn; qkv; proj; then
//       o = x_agg @ W_o + b_o; a node pass builds the X rows of the two
//       node-update products, xo = [sum_c gvec2 vec3 | gx2 vdot | gx2] and
//       the first 3H columns of xv = [g_vdot vec2 | g_vdot vec1 | gvec2 o1
//       | g_wt | g_wsrc]; g_xagg = xo @ W_o^T.
//   (b) edge @ [W_dkv | W_f]: z[:, :2H] = zdkv; for a layer that is not
//       the last, the edge update's backward in the epilogue:
//       g_Sij = gedge2 adj silu(zf) -> gS_e, g_zf = gedge2 adj S_ij
//       silu'(zf) -> z[:, 2H:] (reads H + gedge2 H, writes 4H);
//   (c) edge-row pass, one block per edge row: a_ij, v_ij -> v_e; the
//       sums over c of g_s, [sum_c gvec2_i vecn_j | sum_c gvec2_i
//       d_sh_ij] -> g_e (reads 2H, writes 3H); and a centre pass
//       g_wt_i = sum_j g_Sij ws_j -> xv (reads H);
//   (d) v_e @ W_s: s = silu(zs) adj -> s_e, g_s = g_e adj silu'(zs) -> g_e
//       in place (reads 3H, writes 4H);
//   (e) g_e @ W_s^T: g_vij = . + g_xagg_i -> v_e (reads 2H, writes H);
//   (f) centre pass: the attention backward: g_q_i, g_dist, g_d_sh
//       (from s2); g_k, g_v terms -> g_e; g_dkv -> z[:, :2H] in place
//       (reads 5H, writes 4H);
//   (g) [g_dkv | g_zf] @ [W_dkv ; W_f]^T (K = 3H, 2H for the last layer):
//       gedge = . + gedge2 (reads 3H + H, writes H);
//   (h) source pass, one block per (fragment, source atom j): the sums
//       over i of g_k, g_v, g_vecn (s1 gvec2_i) and g_wsrc (g_Sij wt_i ->
//       xv), in a fixed order, no float atomics (reads 4H); the S sums of
//       a source atom are split over four blocks;
//   (i) g_xhat = (g_qkv @ W_qkv^T) * ln_s, then the LayerNorm's row pass:
//       gx = gx2 + rstd (g_xhat - mean(g_xhat) - xhat mean(g_xhat xhat));
//       gvec = gvec2 + (g_vecn + xv @ [W_vp | W_t | W_src]^T) * w_vln.
// About 42 H floats move per edge cell, most from L2 at fragment shapes.
// The centre pass (f) walks the sources in chunks of ECHUNK = 48 rows
// (common.cuh): it stages a chunk's adj, gates and cutoff derivatives, and
// reduces the chunk's cross-warp partials of g_dist and g_d_sh (per edge,
// so no sum crosses a chunk) before the next chunk; g_q is one register
// chain over all rows.  So it takes any A % 8 == 0 (no cap), and at
// A <= 48 gives the single-chunk kernel's bits.  The head sums (a_ij and its
// cotangent) take DH = H / nh lanes, a template parameter (head_sum<DH>).
// Every sum runs in a fixed order: the kernel is bitwise repeatable.

#include <cstddef>
#include <cstring>

#include "vislayer.cuh"

using namespace ai2bmd;

namespace {

// y[r][n] = acc (+ add[r][n]) (* scale[n]), in place where y is add.
struct Store {
  float* y;
  int ldy;
  const float* add;    // [.][ldy] or null
  const float* scale;  // [N] or null
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    float* o = y + r * ldy + n;
    if (add != nullptr) {
      const float2 a = *reinterpret_cast<const float2*>(add + r * ldy + n);
      v0 += a.x;
      v1 += a.y;
    }
    if (scale != nullptr) {
      v0 *= scale[n];
      v1 *= scale[n + 1];
    }
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  }
};

// (a) the node-update products' X rows, one block per node row (b, a), a
// thread per channel.
__global__ void __launch_bounds__(256) vislayer_bwd_node_rows(const Layer p) {
  const int t = threadIdx.x, H = p.H, A = p.A, S = p.S, ldp = p.NP * H;
  const size_t row = blockIdx.x, b = row / A, a = row % A;
  const float gxv = p.gx2[row * H + t];
  const float o1 = p.o[row * 3 * H + t], gvd = gxv * p.o[row * 3 * H + H + t];
  float g1 = 0.0f, vdot = 0.0f;
  for (int c = 0; c < S; ++c) {
    const size_t v = (b * S + c) * A + a;
    const float* pr = p.proj + v * ldp;
    const float gv2 = p.gvec2[v * H + t];
    g1 = fmaf(gv2, pr[2 * H + t], g1);
    vdot = fmaf(pr[t], pr[H + t], vdot);
    float* xv = p.xv + v * ldp;
    xv[t] = gvd * pr[H + t];
    xv[H + t] = gvd * pr[t];
    xv[2 * H + t] = gv2 * o1;
  }
  float* xo = p.xo + row * 3 * H;
  xo[t] = g1;
  xo[H + t] = gxv * vdot;
  xo[2 * H + t] = gxv;
}

// (b): n < 2H: z[r][n] = acc + b_dkv[n];  n >= 2H: the edge update's
// backward (vislayer.py:314-332), df = silu(zf) * S_ij * adj with
// S_ij = <wt_i, ws_j>_c.
struct EdgeEpi {
  Layer p;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const int H = p.H, H3 = 3 * H;
    if (n < 2 * H) {
      *reinterpret_cast<float2*>(p.z + r * H3 + n) =
          make_float2(v0 + p.b_dkv[n], v1 + p.b_dkv[n + 1]);
      return;
    }
    const int ch = n - 2 * H, A = p.A, S = p.S, ldp = p.NP * H;
    const EdgeRow e(r, A);
    float2 sdot = make_float2(0.0f, 0.0f);
    for (int c = 0; c < S; ++c) {
      const size_t v = (size_t)e.b * S + c;
      const float2 wt = *reinterpret_cast<const float2*>(p.proj + (v * A + e.i) * ldp + 3 * H + ch);
      const float2 ws = *reinterpret_cast<const float2*>(p.proj + (v * A + e.j) * ldp + 4 * H + ch);
      sdot.x = fmaf(wt.x, ws.x, sdot.x);
      sdot.y = fmaf(wt.y, ws.y, sdot.y);
    }
    const float a = p.adj[r];
    const float2 ge = *reinterpret_cast<const float2*>(p.gedge2 + r * H + ch);
    const float z0 = v0 + p.b_f[ch], z1 = v1 + p.b_f[ch + 1];
    const float g0 = ge.x * a, g1 = ge.y * a;
    *reinterpret_cast<float2*>(p.gS_e + r * H + ch) = make_float2(g0 * silu(z0), g1 * silu(z1));
    *reinterpret_cast<float2*>(p.z + r * H3 + 2 * H + ch) =
        make_float2(g0 * sdot.x * dsilu(z0), g1 * sdot.y * dsilu(z1));
  }
};

// (d): zs = acc + b_s; s = silu(zs) * adj -> s_e; the backward through
// vec_agg_i[c] = sum_j s1 * vecn_j[c] + s2 * d_sh_ij[c] (vislayer.py:281-292):
// g_s = g_e * adj * silu'(zs), in place over the sums over c that the
// edge-row pass left in g_e.
struct SEpi {
  Layer p;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const float a = p.adj[r];
    const float z0 = v0 + p.b_s[n], z1 = v1 + p.b_s[n + 1];
    *reinterpret_cast<float2*>(p.s_e + r * 2 * p.H + n) = make_float2(silu(z0) * a, silu(z1) * a);
    float2* g = reinterpret_cast<float2*>(p.g_e + r * 2 * p.H + n);
    const float2 gs = *g;
    *g = make_float2(gs.x * a * dsilu(z0), gs.y * a * dsilu(z1));
  }
};

// (e): g_vij = g_s @ W_s^T + g_xagg_i -> v_e.
struct GvEpi {
  Layer p;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const size_t bi = r / p.A;
    const float2 gx = *reinterpret_cast<const float2*>(p.gxagg + bi * p.H + n);
    *reinterpret_cast<float2*>(p.v_e + r * p.H + n) = make_float2(v0 + gx.x, v1 + gx.y);
  }
};

// (c) edge-row pass, one block per flattened edge row (b, i, j), a thread
// per channel (all of it is row-local, so the grid is B A A blocks):
// v_ij = v_j * dv * silu(a) * gate -> v_e, and the sums over c of g_s,
// g_e = [sum_c gvec2_i[c] vecn_j[c] | sum_c gvec2_i[c] d_sh_ij[c]].
template <int DH>
__global__ void __launch_bounds__(256) vislayer_bwd_rows(const Layer p) {
  const int t = threadIdx.x, A = p.A, H = p.H, H3 = 3 * H, S = p.S;
  const size_t e = blockIdx.x;
  const EdgeRow r(e, A);
  const size_t bj = r.b0 + r.j;
  const float gate = cosine_cutoff(p.dist[e], p.cutoff) * p.adj[e];
  const float a =
      head_pre<DH>(p.qkv[r.bi * H3 + t], p.qkv[bj * H3 + H + t], silu(p.z[e * H3 + t]));
  p.v_e[e * H + t] = p.qkv[bj * H3 + 2 * H + t] * silu(p.z[e * H3 + H + t]) * (silu(a) * gate);
  float g1 = 0.0f, g2 = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXS; ++c) {
    if (c < S) {
      const size_t v = ((size_t)r.b * S + c) * A;
      const float gv = p.gvec2[(v + r.i) * H + t];
      g1 = fmaf(gv, p.vecn[(v + r.j) * H + t], g1);
      g2 = fmaf(gv, p.dsh[(v + r.i) * A + r.j], g2);
    }
  }
  p.g_e[e * 2 * H + t] = g1;
  p.g_e[e * 2 * H + H + t] = g2;
}

// (c) below the last layer: g_wt_i[c] = sum_j g_Sij * ws_j[c] -> xv[:, 3H:4H],
// one block per (fragment, centre atom i), fixed order over j.
__global__ void __launch_bounds__(256) vislayer_bwd_gwt(const Layer p) {
  const int t = threadIdx.x, A = p.A, H = p.H, S = p.S, ldp = p.NP * H;
  const size_t b = blockIdx.y, i = blockIdx.x, bi = b * A + i;
  float acc[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) acc[c] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < A; ++r) {
    const float gS = p.gS_e[(bi * A + r) * H + t];
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) acc[c] = fmaf(gS, p.proj[((b * S + c) * A + r) * ldp + 4 * H + t], acc[c]);
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) p.xv[((b * S + c) * A + i) * ldp + 3 * H + t] = acc[c];
}

// (f): the backward through v_ij = v_j * dv * silu(a) * gate and
// a = sum_head q_i k_j dk (vislayer.py:293-311), from g_vij (v_e):
// g_k and g_v terms -> g_e; g_q_i -> gqkv; g_dist; g_dkv -> z[:, :2H];
// and g_d_sh_ij[c] = sum_h gvec2_i[c] * s2 (vislayer.py:288).
template <int DH>
__global__ void __launch_bounds__(256) vislayer_bwd_centre(const Layer p) {
  __shared__ float sAdj[ECHUNK], sGate[ECHUNK], sDcut[ECHUNK];
  __shared__ float sRedCut[8 * ECHUNK], sRedDsh[8 * MAXS * ECHUNK];
  const int t = threadIdx.x, w = t / 32, lane = t % 32, NW = blockDim.x / 32;
  const int A = p.A, H = p.H, H3 = 3 * H, S = p.S;
  const size_t bi = (size_t)blockIdx.y * p.A + blockIdx.x, b0 = bi - blockIdx.x, b = blockIdx.y, i = blockIdx.x;
  const float kpi = 3.14159265358979323846f / p.cutoff;
  float gva[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) gva[c] = c < S ? p.gvec2[((b * S + c) * A + i) * H + t] : 0.0f;
  const float qi = p.qkv[bi * H3 + t];
  float gqi = 0.0f;
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    const size_t e0 = bi * A + c0;  // the chunk's first edge row (b, i, c0)
    // every thread is done with the last chunk's rows and partials
    if (c0) __syncthreads();
    for (int r = t; r < n; r += blockDim.x) {
      const float a = p.adj[e0 + r], d = p.dist[e0 + r];
      sAdj[r] = a;
      sGate[r] = cosine_cutoff(d, p.cutoff) * a;
      sDcut[r] = d < p.cutoff ? -0.5f * kpi * sinf(d * kpi) : 0.0f;
    }
    __syncthreads();
    for (int c8 = 0; c8 < n; c8 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 + rr;  // the row in the chunk; the source is c0 + r
        const size_t e = e0 + r;
        const float gvij = p.v_e[e * H + t];
        const float zk = p.z[e * H3 + t], zv = p.z[e * H3 + H + t];
        const float dk = silu(zk), dv = silu(zv);
        const float kr = p.qkv[(b0 + c0 + r) * H3 + H + t];
        const float vr = p.qkv[(b0 + c0 + r) * H3 + 2 * H + t];
        const float a = head_pre<DH>(qi, kr, dk), att = silu(a), gate = sGate[r];
        const float g3 = att * gate;
        const float g_dv = gvij * vr * g3;
        const float g_g3 = gvij * vr * dv;
        const float red = warp_sum(g_g3 * att);
        if (lane == 0) sRedCut[w * n + r] = red;
        const float g_a = head_sum<DH>(g_g3 * gate) * dsilu(a);
        gqi = fmaf(g_a * kr, dk, gqi);
        p.g_e[e * 2 * H + t] = g_a * qi * dk;
        p.g_e[e * 2 * H + H + t] = gvij * dv * g3;
        p.z[e * H3 + t] = g_a * qi * kr * dsilu(zk);
        p.z[e * H3 + H + t] = g_dv * dsilu(zv);
        const float s2 = p.s_e[e * 2 * H + H + t];
#pragma unroll
        for (int c = 0; c < MAXS; ++c) {
          if (c < S) {
            const float rd = warp_sum(gva[c] * s2);
            if (lane == 0) sRedDsh[(w * S + c) * n + r] = rd;
          }
        }
      }
    }
    __syncthreads();  // the chunk's partials are written
    for (int r = t; r < n; r += blockDim.x) {
      float sum = 0.0f;
      for (int ww = 0; ww < NW; ++ww) sum += sRedCut[ww * n + r];
      p.gdist[e0 + r] = sum * sAdj[r] * sDcut[r];
    }
    for (int x = t; x < S * n; x += blockDim.x) {
      const int c = x / n, r = x % n;
      float sum = 0.0f;
      for (int ww = 0; ww < NW; ++ww) sum += sRedDsh[(ww * S + c) * n + r];
      p.gdsh[((b * S + c) * A + i) * A + c0 + r] = sum;
    }
  }
  p.gqkv[bi * H3 + t] = gqi;
}

// (h) source pass: fixed-order sums over the centre atoms i, four kinds of
// block (blockIdx.z; 2 and 3 only below the last layer), each with half of
// the S sums, so that each thread's chain stays short and the grid fills
// the card:  0: g_k, g_v and g_vecn[c < S/2];  1: g_vecn[c >= S/2];
// 2, 3: g_wsrc likewise (-> xv[:, 4H:]).  g_vecn_j[c] = sum_i s1 * gvec2_i[c],
// g_wsrc_j[c] = sum_i g_Sij * wt_i[c].
__global__ void __launch_bounds__(256) vislayer_bwd_source(const Layer p) {
  constexpr int HS = MAXS / 2;
  const int t = threadIdx.x, j = blockIdx.x, A = p.A, H = p.H, S = p.S, ldp = p.NP * H;
  const int part = blockIdx.z, half = (S + 1) / 2;
  const int c0 = part & 1 ? half : 0, nc = part & 1 ? S - half : half;
  const bool wsrc = part >= 2;
  const size_t b = blockIdx.y, b0 = b * A;
  float sk = 0.0f, sv = 0.0f, sc[HS];
#pragma unroll
  for (int c = 0; c < HS; ++c) sc[c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < A; ++i) {
    const size_t e = (b0 + i) * A + j;
    if (part == 0) {
      sk += p.g_e[e * 2 * H + t];
      sv += p.g_e[e * 2 * H + H + t];
    }
    const float f = wsrc ? p.gS_e[e * H + t] : p.s_e[e * 2 * H + t];
#pragma unroll
    for (int cc = 0; cc < HS; ++cc) {
      if (cc < nc) {
        const size_t v = (b * S + c0 + cc) * A + i;
        sc[cc] = fmaf(f, wsrc ? p.proj[v * ldp + 3 * H + t] : p.gvec2[v * H + t], sc[cc]);
      }
    }
  }
  if (part == 0) {
    p.gqkv[(b0 + j) * 3 * H + H + t] = sk;
    p.gqkv[(b0 + j) * 3 * H + 2 * H + t] = sv;
  }
#pragma unroll
  for (int cc = 0; cc < HS; ++cc) {
    if (cc < nc) {
      const size_t v = (b * S + c0 + cc) * A + j;
      if (wsrc)
        p.xv[v * ldp + 4 * H + t] = sc[cc];
      else
        p.gvecn[v * H + t] = sc[cc];
    }
  }
}

// (i) the LayerNorm's backward (vislayer.py:336-350), one warp a node row:
// gx = gx2 + rstd * (g_xhat - mean(g_xhat) - xhat * mean(g_xhat * xhat)).
__global__ void __launch_bounds__(256) vislayer_bwd_ln_rows(const Layer p) {
  const int H = p.H, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (size_t)p.B * p.A) return;
  const float* x = p.x + row * H;
  const float* gxh = p.gxh + row * H;
  float mu, rs;
  row_stats(x, H, mu, rs);
  float m1 = 0.0f, m2 = 0.0f;
  for (int k = lane; k < H; k += 32) {
    m1 += gxh[k];
    m2 = fmaf(gxh[k], (x[k] - mu) * rs, m2);
  }
  m1 = warp_sum(m1) / H;
  m2 = warp_sum(m2) / H;
  for (int k = lane; k < H; k += 32)
    p.gx[row * H + k] = p.gx2[row * H + k] + rs * (gxh[k] - m1 - (x[k] - mu) * rs * m2);
}

// (i): gvec = gvec2 + (g_vecn + xv @ [W_vp | W_t | W_src]^T) * w_vln.
struct GvecEpi {
  Layer p;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const size_t o = r * p.H + n;
    const float2 g2 = *reinterpret_cast<const float2*>(p.gvec2 + o);
    const float2 gn = *reinterpret_cast<const float2*>(p.gvecn + o);
    *reinterpret_cast<float2*>(p.gvec + o) =
        make_float2(g2.x + (gn.x + v0) * p.vln_w[n], g2.y + (gn.y + v1) * p.vln_w[n + 1]);
  }
};

template <int DH>
cudaError_t launch_bwd(const Layer& p, cudaStream_t stream) {
  const int H = p.H, H3 = 3 * H;
  const bool last = p.NP == 3;
  const size_t M = (size_t)p.B * p.A, Mv = M * p.S, E = M * p.A;
  const dim3 centres(p.A, p.B);
  cudaError_t err = launch_node_prologue(p, stream);
  if (err != cudaSuccess) return err;
  // (a) o1|o2 (o3 is not needed), the node rows, g_xagg
  err = launch_row_tile<NODE_TM, false>(p.xagg_in, H, M, H, 2 * H, wseg(p.w_o, H3),
                                        BiasStore{p.o, H3, p.b_o}, stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_node_rows<<<(unsigned)M, H, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, true>(p.xo, H3, M, H3, H, wseg(p.w_o, H3),
                                       Store{p.gxagg, H, nullptr, nullptr}, stream);
  if (err != cudaSuccess) return err;
  // (b)-(g) the edge stage
  err = launch_row_tile<EDGE_TM, false>(p.edge, H, E, H, last ? 2 * H : H3,
                                        wseg(p.w_dkv, 2 * H, 2 * H, p.w_f, H), EdgeEpi{p},
                                        stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_rows<DH><<<(unsigned)E, H, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!last) {
    vislayer_bwd_gwt<<<centres, H, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  err = launch_row_tile<EDGE_TM, false>(p.v_e, H, E, H, 2 * H, wseg(p.w_s, 2 * H), SEpi{p},
                                        stream);
  if (err != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM, true>(p.g_e, 2 * H, E, 2 * H, H, wseg(p.w_s, 2 * H), GvEpi{p},
                                       stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_centre<DH><<<centres, H, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM, true>(p.z, H3, E, last ? 2 * H : H3, H,
                                       wseg(p.w_dkv, 2 * H, 2 * H, p.w_f, H),
                                       Store{p.gedge, H, p.gedge2, nullptr}, stream);
  if (err != cudaSuccess) return err;
  // (h), (i)
  vislayer_bwd_source<<<dim3(p.A, p.B, last ? 2 : 4), H, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, true>(p.gqkv, H3, M, H3, H, wseg(p.w_qkv, H3),
                                       Store{p.gxh, H, nullptr, p.ln_s}, stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_ln_rows<<<(unsigned)((M + 7) / 8), 256, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_row_tile<VEC_TM, true>(
      p.xv, p.NP * H, Mv, p.NP * H, H, wseg(p.w_vp, H3, H3, p.w_t, H, 4 * H, p.w_src, H),
      GvecEpi{p}, stream);
}

// ---------------------------------------------------------------------------
// The wide instantiation (vislayer.cuh): the same stages at Hp; the per-row,
// per-centre and per-source passes loop a thread over its channels, heads
// sum through shared memory, and the cotangents of the streams are written
// at H.
// ---------------------------------------------------------------------------

// (a), wide: the node-update products' X rows at Hp (0 past H).
__global__ void __launch_bounds__(256) vislayer_bwd_node_rows_wide(const Layer p, int Hp) {
  const int t = threadIdx.x, T = blockDim.x, H = p.H, A = p.A, S = p.S, ldp = p.NP * Hp;
  const size_t row = blockIdx.x, b = row / A, a = row % A;
  for (int ch = t; ch < Hp; ch += T) {
    const float gxv = ch < H ? p.gx2[row * H + ch] : 0.0f;
    const float o1 = p.o[row * 3 * Hp + ch], gvd = gxv * p.o[row * 3 * Hp + Hp + ch];
    float g1 = 0.0f, vdot = 0.0f;
    for (int c = 0; c < S; ++c) {
      const size_t v = (b * S + c) * A + a;
      const float* pr = p.proj + v * ldp;
      const float gv2 = ch < H ? p.gvec2[v * H + ch] : 0.0f;
      g1 = fmaf(gv2, pr[2 * Hp + ch], g1);
      vdot = fmaf(pr[ch], pr[Hp + ch], vdot);
      float* xv = p.xv + v * ldp;
      xv[ch] = gvd * pr[Hp + ch];
      xv[Hp + ch] = gvd * pr[ch];
      xv[2 * Hp + ch] = gv2 * o1;
    }
    float* xo = p.xo + row * 3 * Hp;
    xo[ch] = g1;
    xo[Hp + ch] = gxv * vdot;
    xo[2 * Hp + ch] = gxv;
  }
}

// (b), wide: as EdgeEpi at Hp; gedge2 is read at H (0 past it).
struct EdgeEpiWide {
  Layer p;
  int Hp;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const int H3 = 3 * Hp;
    if (n < 2 * Hp) {
      *reinterpret_cast<float2*>(p.z + r * H3 + n) =
          make_float2(v0 + p.b_dkv[n], v1 + p.b_dkv[n + 1]);
      return;
    }
    const int ch = n - 2 * Hp, H = p.H, A = p.A, S = p.S, ldp = p.NP * Hp;
    const EdgeRow e(r, A);
    float2 sdot = make_float2(0.0f, 0.0f);
    for (int c = 0; c < S; ++c) {
      const size_t v = (size_t)e.b * S + c;
      const float2 wt = *reinterpret_cast<const float2*>(p.proj + (v * A + e.i) * ldp + 3 * Hp + ch);
      const float2 ws = *reinterpret_cast<const float2*>(p.proj + (v * A + e.j) * ldp + 4 * Hp + ch);
      sdot.x = fmaf(wt.x, ws.x, sdot.x);
      sdot.y = fmaf(wt.y, ws.y, sdot.y);
    }
    const float a = p.adj[r];
    const float ge0 = ch < H ? p.gedge2[r * H + ch] : 0.0f;
    const float ge1 = ch + 1 < H ? p.gedge2[r * H + ch + 1] : 0.0f;
    const float z0 = v0 + p.b_f[ch], z1 = v1 + p.b_f[ch + 1];
    const float g0 = ge0 * a, g1 = ge1 * a;
    *reinterpret_cast<float2*>(p.gS_e + r * Hp + ch) = make_float2(g0 * silu(z0), g1 * silu(z1));
    *reinterpret_cast<float2*>(p.z + r * H3 + 2 * Hp + ch) =
        make_float2(g0 * sdot.x * dsilu(z0), g1 * sdot.y * dsilu(z1));
  }
};

// (d), wide: as SEpi at Hp.
struct SEpiWide {
  Layer p;
  int Hp;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const float a = p.adj[r];
    const float z0 = v0 + p.b_s[n], z1 = v1 + p.b_s[n + 1];
    *reinterpret_cast<float2*>(p.s_e + r * 2 * Hp + n) = make_float2(silu(z0) * a, silu(z1) * a);
    float2* g = reinterpret_cast<float2*>(p.g_e + r * 2 * Hp + n);
    const float2 gs = *g;
    *g = make_float2(gs.x * a * dsilu(z0), gs.y * a * dsilu(z1));
  }
};

// (e), wide: g_vij = g_s @ W_s^T + g_xagg_i -> v_e at Hp.
struct GvEpiWide {
  Layer p;
  int Hp;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const size_t bi = r / p.A;
    const float2 gx = *reinterpret_cast<const float2*>(p.gxagg + bi * Hp + n);
    *reinterpret_cast<float2*>(p.v_e + r * Hp + n) = make_float2(v0 + gx.x, v1 + gx.y);
  }
};

// (g) and (i), wide: y[r][n] = acc + add[r][n] (add may be null), or
// gvec = gvec2 + (g_vecn + acc) * w_vln (gvecn set), for the H channels of
// a stream (row stride H), one channel at a time.
struct StreamStore {
  Layer p;
  int Hp;
  float* y;
  const float* add;
  bool gvec;
  __device__ __forceinline__ void put(size_t r, int n, float v) const {
    const size_t o = r * p.H + n;
    y[o] = gvec ? p.gvec2[o] + (p.gvecn[r * Hp + n] + v) * p.vln_w[n]
                : (add != nullptr ? v + add[o] : v);
  }
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    if (n < p.H) put(r, n, v0);
    if (n + 1 < p.H) put(r, n + 1, v1);
  }
};

// (c), wide: one block per edge row, as vislayer_bwd_rows; the row's head
// terms into its v_e row, their head sums into its s_e row (block_head_sums
// over k-tiles staged in sX; s_e is free until (d) fills it), then a thread
// a channel at a time: v_ij over the terms (0 past H), the sums over c.
__global__ void __launch_bounds__(256) vislayer_bwd_rows_wide(const Layer p, int Hp, int nh) {
  __shared__ __align__(16) float sX[XTILE_LD];  // a k-tile of the row's terms
  const int t = threadIdx.x, T = blockDim.x, A = p.A, H = p.H, dh = H / nh, H3 = 3 * Hp,
            S = p.S;
  const size_t e = blockIdx.x;
  const EdgeRow r(e, A);
  const size_t bj = r.b0 + r.j;
  float* terms = p.v_e + e * Hp;
  float* sA = p.s_e + e * 2 * Hp;  // [nh] a_ij
  for (int ch = t; ch < H; ch += T)
    terms[ch] = layer_term(p.qkv[r.bi * H3 + ch], p.qkv[bj * H3 + Hp + ch],
                           silu(p.z[e * H3 + ch]));
  block_head_sums(sX, terms, Hp, 1, H, nh, dh, sA);
  const float gate = cosine_cutoff(p.dist[e], p.cutoff) * p.adj[e];
  for (int ch = t; ch < Hp; ch += T) {
    float vij = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if (ch < H) {
      vij = p.qkv[bj * H3 + 2 * Hp + ch] * silu(p.z[e * H3 + Hp + ch]) *
            (silu(sA[ch / dh]) * gate);
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          const size_t v = ((size_t)r.b * S + c) * A;
          const float gv = p.gvec2[(v + r.i) * H + ch];
          g1 = fmaf(gv, p.vecn[(v + r.j) * Hp + ch], g1);
          g2 = fmaf(gv, p.dsh[(v + r.i) * A + r.j], g2);
        }
      }
    }
    p.v_e[e * Hp + ch] = vij;
    p.g_e[e * 2 * Hp + ch] = g1;
    p.g_e[e * 2 * Hp + Hp + ch] = g2;
  }
}

// (c) below the last layer, wide: g_wt_i[c] = sum_j g_Sij ws_j[c] -> xv at
// Hp, a thread a channel at a time, fixed order over j.
__global__ void __launch_bounds__(256) vislayer_bwd_gwt_wide(const Layer p, int Hp) {
  const int t = threadIdx.x, T = blockDim.x, A = p.A, S = p.S, ldp = p.NP * Hp;
  const size_t b = blockIdx.y, i = blockIdx.x, bi = b * A + i;
  for (int ch = t; ch < Hp; ch += T) {
    float acc[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < A; ++r) {
      const float gS = p.gS_e[(bi * A + r) * Hp + ch];
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) acc[c] = fmaf(gS, p.proj[((b * S + c) * A + r) * ldp + 4 * Hp + ch], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) p.xv[((b * S + c) * A + i) * ldp + 3 * Hp + ch] = acc[c];
  }
}

// (f), wide: the attention backward of vislayer_bwd_centre, per chunk of
// ECHUNK sources: the head terms into the chunk's g_e rows (free until
// this pass writes its outputs there) and a_ij into a_e (block_head_sums
// over k-tiles staged in sX, as K5 stages them); then a row at a time, each
// thread over its channels, g_g3 gate into the g_e rows and the terms of
// g_dist and g_d_sh summed over the thread's channels, the warp (warp_sum)
// and, after the chunk, the warps in order; the head sums of g_g3 gate
// into a_e; then a thread a channel at a time: g_q_i (one chain a channel
// over all rows, carried from chunk to chunk in g_qkv itself), the g_k and
// g_v terms -> g_e, g_dkv -> z[:, :2 Hp] (0 past H).
__global__ void __launch_bounds__(256) vislayer_bwd_centre_wide(const Layer p, int Hp, int nh) {
  __shared__ __align__(16) float sX[ECHUNK * XTILE_LD];  // a k-tile of the chunk's terms
  __shared__ float sAdj[ECHUNK], sGate[ECHUNK], sDcut[ECHUNK];
  __shared__ float sRedCut[8 * ECHUNK], sRedDsh[8 * MAXS * ECHUNK];  // [NW][CH], [NW][S][CH]
  constexpr int CH = ECHUNK;
  const int t = threadIdx.x, T = blockDim.x, w = t / 32, lane = t % 32, NW = T / 32;
  const int A = p.A, H = p.H, dh = H / nh, H3 = 3 * Hp, S = p.S, ldt = 2 * Hp;
  const size_t bi = (size_t)blockIdx.y * A + blockIdx.x, b0 = bi - blockIdx.x, b = blockIdx.y,
               i = blockIdx.x;
  const float kpi = 3.14159265358979323846f / p.cutoff;
  for (int c0 = 0; c0 < A; c0 += CH) {
    const int n = A - c0 < CH ? A - c0 : CH;
    const size_t e0 = bi * A + c0, s0 = b0 + c0;
    float* terms = p.g_e + e0 * ldt;     // [n] rows at stride 2 Hp: head terms, then g_g3 gate
    float* sA = p.a_e + e0 * 2 * nh;     // [n][nh] a_ij
    float* sGa = sA + (size_t)n * nh;    // [n][nh] head sums of g_g3 gate
    if (c0) __syncthreads();  // every thread is done with the last chunk's rows and partials
    for (int r = t; r < n; r += T) {
      const float a = p.adj[e0 + r], d = p.dist[e0 + r];
      sAdj[r] = a;
      sGate[r] = cosine_cutoff(d, p.cutoff) * a;
      sDcut[r] = d < p.cutoff ? -0.5f * kpi * sinf(d * kpi) : 0.0f;
    }
    for (int ch = t; ch < H; ch += T) {
      const float qi = p.qkv[bi * H3 + ch];
      for (int r = 0; r < n; ++r)
        terms[r * ldt + ch] = layer_term(qi, p.qkv[(s0 + r) * H3 + Hp + ch],
                                         silu(p.z[(e0 + r) * H3 + ch]));
    }
    block_head_sums(sX, terms, ldt, n, H, nh, dh, sA);
    for (int r = 0; r < n; ++r) {
      const size_t e = e0 + r;
      const float gate = sGate[r];
      float cut = 0.0f, dsh[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) dsh[c] = 0.0f;
      for (int ch = t; ch < H; ch += T) {
        const float gvij = p.v_e[e * Hp + ch];
        const float vr = p.qkv[(s0 + r) * H3 + 2 * Hp + ch];
        const float g_g3 = gvij * vr * silu(p.z[e * H3 + Hp + ch]);
        cut = fmaf(g_g3, silu(sA[r * nh + ch / dh]), cut);
        terms[r * ldt + ch] = g_g3 * gate;
        const float s2 = p.s_e[e * 2 * Hp + Hp + ch];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) dsh[c] = fmaf(p.gvec2[((b * S + c) * A + i) * H + ch], s2, dsh[c]);
      }
      cut = warp_sum(cut);
      if (lane == 0) sRedCut[w * CH + r] = cut;
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          const float rd = warp_sum(dsh[c]);
          if (lane == 0) sRedDsh[(w * S + c) * CH + r] = rd;
        }
      }
    }
    block_head_sums(sX, terms, ldt, n, H, nh, dh, sGa);
    for (int ch = t; ch < Hp; ch += T) {
      if (ch >= H) {
        for (int r = 0; r < n; ++r) {
          const size_t e = e0 + r;
          p.g_e[e * 2 * Hp + ch] = p.g_e[e * 2 * Hp + Hp + ch] = 0.0f;
          p.z[e * H3 + ch] = p.z[e * H3 + Hp + ch] = 0.0f;
        }
        if (c0 == 0) p.gqkv[bi * H3 + ch] = 0.0f;
        continue;
      }
      const float qi = p.qkv[bi * H3 + ch];
      const int h = ch / dh;
      float gqi = c0 ? p.gqkv[bi * H3 + ch] : 0.0f;
      for (int r = 0; r < n; ++r) {
        const size_t e = e0 + r;
        const float gvij = p.v_e[e * Hp + ch];
        const float zk = p.z[e * H3 + ch], zv = p.z[e * H3 + Hp + ch];
        const float dk = silu(zk), dv = silu(zv);
        const float kr = p.qkv[(s0 + r) * H3 + Hp + ch];
        const float vr = p.qkv[(s0 + r) * H3 + 2 * Hp + ch];
        const float a = sA[r * nh + h], g3 = silu(a) * sGate[r];
        const float g_a = sGa[r * nh + h] * dsilu(a);
        gqi = fmaf(g_a * kr, dk, gqi);
        p.g_e[e * 2 * Hp + ch] = g_a * qi * dk;
        p.g_e[e * 2 * Hp + Hp + ch] = gvij * dv * g3;
        p.z[e * H3 + ch] = g_a * qi * kr * dsilu(zk);
        p.z[e * H3 + Hp + ch] = gvij * vr * g3 * dsilu(zv);
      }
      p.gqkv[bi * H3 + ch] = gqi;
    }
    // the chunk's partials are written (block_head_sums ends with a barrier)
    for (int r = t; r < n; r += T) {
      float sum = 0.0f;
      for (int ww = 0; ww < NW; ++ww) sum += sRedCut[ww * CH + r];
      p.gdist[e0 + r] = sum * sAdj[r] * sDcut[r];
    }
    for (int x = t; x < S * n; x += T) {
      const int c = x / n, r = x % n;
      float sum = 0.0f;
      for (int ww = 0; ww < NW; ++ww) sum += sRedDsh[(ww * S + c) * CH + r];
      p.gdsh[((b * S + c) * A + i) * A + c0 + r] = sum;
    }
  }
}

// (h), wide: as vislayer_bwd_source, a thread a channel at a time at Hp;
// gvec2 is read at H (0 past it).
__global__ void __launch_bounds__(256) vislayer_bwd_source_wide(const Layer p, int Hp) {
  constexpr int HS = MAXS / 2;
  const int t = threadIdx.x, T = blockDim.x, j = blockIdx.x, A = p.A, H = p.H, S = p.S,
            ldp = p.NP * Hp;
  const int part = blockIdx.z, half = (S + 1) / 2;
  const int c0 = part & 1 ? half : 0, nc = part & 1 ? S - half : half;
  const bool wsrc = part >= 2;
  const size_t b = blockIdx.y, b0 = b * A;
  for (int ch = t; ch < Hp; ch += T) {
    const bool real = ch < H;
    float sk = 0.0f, sv = 0.0f, sc[HS];
#pragma unroll
    for (int c = 0; c < HS; ++c) sc[c] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < A; ++i) {
      const size_t e = (b0 + i) * A + j;
      if (part == 0) {
        sk += p.g_e[e * 2 * Hp + ch];
        sv += p.g_e[e * 2 * Hp + Hp + ch];
      }
      const float f = wsrc ? p.gS_e[e * Hp + ch] : p.s_e[e * 2 * Hp + ch];
#pragma unroll
      for (int cc = 0; cc < HS; ++cc) {
        if (cc < nc) {
          const size_t v = (b * S + c0 + cc) * A + i;
          const float g = wsrc ? p.proj[v * ldp + 3 * Hp + ch] : real ? p.gvec2[v * H + ch] : 0.0f;
          sc[cc] = fmaf(f, g, sc[cc]);
        }
      }
    }
    if (part == 0) {
      p.gqkv[(b0 + j) * 3 * Hp + Hp + ch] = sk;
      p.gqkv[(b0 + j) * 3 * Hp + 2 * Hp + ch] = sv;
    }
#pragma unroll
    for (int cc = 0; cc < HS; ++cc) {
      if (cc < nc) {
        const size_t v = (b * S + c0 + cc) * A + j;
        if (wsrc)
          p.xv[v * ldp + 4 * Hp + ch] = sc[cc];
        else
          p.gvecn[v * Hp + ch] = sc[cc];
      }
    }
  }
}

// (i), wide: the LayerNorm's backward over the H channels, one warp a node
// row; g_xhat at Hp, gx at H.
__global__ void __launch_bounds__(256) vislayer_bwd_ln_rows_wide(const Layer p, int Hp) {
  const int H = p.H, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (size_t)p.B * p.A) return;
  const float* x = p.x + row * H;
  const float* gxh = p.gxh + row * Hp;
  float mu, rs;
  row_stats(x, H, mu, rs);
  float m1 = 0.0f, m2 = 0.0f;
  for (int k = lane; k < H; k += 32) {
    m1 += gxh[k];
    m2 = fmaf(gxh[k], (x[k] - mu) * rs, m2);
  }
  m1 = warp_sum(m1) / H;
  m2 = warp_sum(m2) / H;
  for (int k = lane; k < H; k += 32)
    p.gx[row * H + k] = p.gx2[row * H + k] + rs * (gxh[k] - m1 - (x[k] - mu) * rs * m2);
}

cudaError_t launch_bwd_wide(const Layer& p, int nh, cudaStream_t stream) {
  const int H = p.H, Hp = wide_width(H), H3 = 3 * Hp, T = wide_threads(H);
  const bool last = p.NP == 3;
  const size_t M = (size_t)p.B * p.A, Mv = M * p.S, E = M * p.A;
  const dim3 centres(p.A, p.B);
  cudaError_t err = launch_node_prologue_wide(p, Hp, stream);
  if (err != cudaSuccess) return err;
  // (a) o1|o2, the node rows, g_xagg
  err = launch_row_tile<NODE_TM, false, true>(p.xagg_in, Hp, M, Hp, 2 * Hp, wseg(p.w_o, H3),
                                        BiasStore{p.o, H3, p.b_o}, stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_node_rows_wide<<<(unsigned)M, T, 0, stream>>>(p, Hp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, true, true>(p.xo, H3, M, H3, Hp, wseg(p.w_o, H3),
                                       Store{p.gxagg, Hp, nullptr, nullptr}, stream);
  if (err != cudaSuccess) return err;
  // (b)-(g) the edge stage; v_e holds the padded edge rows until (c)
  const float* X;
  if ((err = padded_edge_rows(p, Hp, p.v_e, &X, stream)) != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM_WIDE, false, true>(X, Hp, E, Hp, last ? 2 * Hp : H3,
                                        wseg(p.w_dkv, 2 * Hp, 2 * Hp, p.w_f, Hp),
                                        EdgeEpiWide{p, Hp}, stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_rows_wide<<<(unsigned)E, T, 0, stream>>>(p, Hp, nh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!last) {
    vislayer_bwd_gwt_wide<<<centres, T, 0, stream>>>(p, Hp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  err = launch_row_tile<EDGE_TM_WIDE, false, true>(p.v_e, Hp, E, Hp, 2 * Hp, wseg(p.w_s, 2 * Hp),
                                        SEpiWide{p, Hp}, stream);
  if (err != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM_WIDE, true, true>(p.g_e, 2 * Hp, E, 2 * Hp, Hp, wseg(p.w_s, 2 * Hp),
                                       GvEpiWide{p, Hp}, stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_centre_wide<<<centres, T, 0, stream>>>(p, Hp, nh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM_WIDE, true, true>(p.z, H3, E, last ? 2 * Hp : H3, Hp,
                                       wseg(p.w_dkv, 2 * Hp, 2 * Hp, p.w_f, Hp),
                                       StreamStore{p, Hp, p.gedge, p.gedge2, false}, stream);
  if (err != cudaSuccess) return err;
  // (h), (i)
  vislayer_bwd_source_wide<<<dim3(p.A, p.B, last ? 2 : 4), T, 0, stream>>>(p, Hp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, true, true>(p.gqkv, H3, M, H3, Hp, wseg(p.w_qkv, H3),
                                       Store{p.gxh, Hp, nullptr, p.ln_s}, stream);
  if (err != cudaSuccess) return err;
  vislayer_bwd_ln_rows_wide<<<(unsigned)((M + 7) / 8), 256, 0, stream>>>(p, Hp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_row_tile<VEC_TM, true, true>(
      p.xv, p.NP * Hp, Mv, p.NP * Hp, Hp, wseg(p.w_vp, H3, H3, p.w_t, Hp, 4 * Hp, p.w_src, Hp),
      StreamStore{p, Hp, p.gvec, nullptr, true}, stream);
}

}  // namespace

// ptrs: the LAYER_PTRS pointers of Layer in field order (ops/vislayer.py,
// PTR_FIELDS).  The backward reads x..b_f, xagg_in and the cotangents;
// uses the scratch xn, vecn, qkv, proj, o, z ([E][3H]), v_e ([E][H]), s_e
// and g_e ([E][2H]), gS_e ([E][H], below the last layer), xo, xv, gxagg,
// gqkv, gvecn and gxh; and writes gx, gvec, gedge, gdsh and gdist.  dh =
// H / nh, the channels of a head.  The wide instantiation (every shape but
// narrow_shapes(H, nh)) takes its scratch, xagg_in and every weight at Hp =
// wide_width(H) a segment, and a_e ([E][2 nh]; null for the narrow one)
// (vislayer.cuh).
extern "C" int vislayer_bwd_launch(const void* const* ptrs, int n_ptrs, int B, int A, int H,
                                   int S, float cutoff, int last, int dh, cudaStream_t stream) {
  static_assert(offsetof(Layer, B) == LAYER_PTRS * sizeof(void*), "Layer: pointers first");
  if (n_ptrs != LAYER_PTRS || !layer_shapes_ok(A, H, S, dh)) return (int)cudaErrorInvalidValue;
  Layer p;
  std::memcpy(&p, ptrs, LAYER_PTRS * sizeof(void*));
  p.B = B, p.A = A, p.H = H, p.S = S, p.NP = last ? 3 : 5, p.cutoff = cutoff;
  if (!narrow_shapes(H, H / dh)) return (int)launch_bwd_wide(p, H / dh, stream);
  return with_head_width(dh, [&](auto d) {
    return (int)launch_bwd<decltype(d)::value>(p, stream);
  });
}

// shared memory, blocks per SM, registers and spill bytes of one stage:
// 0 g_xagg and g_xhat (node rows, X @ W^T), 1 edge @ [W_dkv | W_f],
// 2 edge-row pass, 3 v_e @ W_s, 4 g_e @ W_s^T, 5 centre pass,
// 6 [g_dkv | g_zf] @ [W_dkv ; W_f]^T, 7 source pass, 8 gvec (vector rows),
// 9 g_wt
extern "C" int vislayer_bwd_occupancy(int A, int H, int S, int stage, int* out) {
  (void)A, (void)S;
  switch (stage) {
    case 0: return occupancy(row_tile<NODE_TM, true, Store>, 256, tile_smem<NODE_TM>(), out);
    case 1: return occupancy(row_tile<EDGE_TM, false, EdgeEpi>, 256, tile_smem<EDGE_TM>(), out);
    case 2: return occupancy(vislayer_bwd_rows<32>, H, 0, out);
    case 3: return occupancy(row_tile<EDGE_TM, false, SEpi>, 256, tile_smem<EDGE_TM>(), out);
    case 4: return occupancy(row_tile<EDGE_TM, true, GvEpi>, 256, tile_smem<EDGE_TM>(), out);
    case 5: return occupancy(vislayer_bwd_centre<32>, H, 0, out);
    case 6: return occupancy(row_tile<EDGE_TM, true, Store>, 256, tile_smem<EDGE_TM>(), out);
    case 7: return occupancy(vislayer_bwd_source, H, 0, out);
    case 8: return occupancy(row_tile<VEC_TM, true, GvecEpi>, 256, tile_smem<VEC_TM>(), out);
    case 9: return occupancy(vislayer_bwd_gwt, H, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same for the wide instantiation at H channels, S spherical components
// and nh heads: 0 node rows, 1 edge @ [W_dkv | W_f], 2 edge-row pass, 3
// g_wt, 4 v_e @ W_s, 5 g_e @ W_s^T, 6 centre pass, 7 [g_dkv | g_zf] @
// [W_dkv ; W_f]^T, 8 source pass, 9 the LayerNorm's rows, 10 gvec (vector
// rows); out[4] receives the rows of the centre pass's source chunk, out[5]
// the columns of its k-tiles (its shared memory is static: no H or nh
// changes it)
extern "C" int vislayer_bwd_wide_occupancy(int H, int S, int nh, int stage, int* out) {
  (void)S, (void)nh;
  const int T = wide_threads(H);
  out[4] = ECHUNK;
  out[5] = XTILE;
  switch (stage) {
    case 0: return occupancy(vislayer_bwd_node_rows_wide, T, 0, out);
    case 1: return occupancy(row_tile<EDGE_TM_WIDE, false, EdgeEpiWide, float, true>, 256,
                                    tile_smem<EDGE_TM_WIDE>(), out);
    case 2: return occupancy(vislayer_bwd_rows_wide, T, 0, out);
    case 3: return occupancy(vislayer_bwd_gwt_wide, T, 0, out);
    case 4: return occupancy(row_tile<EDGE_TM_WIDE, false, SEpiWide, float, true>, 256,
                                    tile_smem<EDGE_TM_WIDE>(), out);
    case 5: return occupancy(row_tile<EDGE_TM_WIDE, true, GvEpiWide, float, true>, 256,
                                    tile_smem<EDGE_TM_WIDE>(), out);
    case 6: return occupancy(vislayer_bwd_centre_wide, T, 0, out);
    case 7: return occupancy(row_tile<EDGE_TM_WIDE, true, StreamStore, float, true>, 256,
                                    tile_smem<EDGE_TM_WIDE>(), out);
    case 8: return occupancy(vislayer_bwd_source_wide, T, 0, out);
    case 9: return occupancy(vislayer_bwd_ln_rows_wide, 256, 0, out);
    case 10: return occupancy(row_tile<VEC_TM, true, StreamStore, float, true>, 256,
                                     tile_smem<VEC_TM>(), out);
    default: return (int)cudaErrorInvalidValue;
  }
}
