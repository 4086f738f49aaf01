// K6 vislayer_bwd: the recompute-mode VJP of one complete ViS-MP layer.
//
// Replaces _bwd_kernel (ai2bmd_tpu/ops/pallas/vislayer.py:187), launched by
// _bwd_call's pallas_call (:518).  From the layer inputs (x, vec, edge, d_sh,
// dist, adj), the forward's x_agg and the cotangents (gx2, gvec2, gedge2) it
// gives gx, gvec, gedge, gd_sh and gdist; the weights get no gradient.
// gedge includes the residual passthrough gedge2 in both the updating and
// the last layer.
//
// What bounds it on the H100: float32 arithmetic on the CUDA cores: 10 H^2
// multiply-adds per edge cell (the forward's edge @ W_dkv, v_ij @ W_s and
// edge @ W_f recomputed, 5 H^2, then g_s @ W_s^T, g_dkv @ W_dkv^T and
// g_zf @ W_f^T, 5 H^2) and 92 H^2 per atom on the node side.  Recomputing
// instead of reading a stash of zdkv/zs/zf (K2/K3's route) costs about 1.5x
// the edge arithmetic and saves 5 H floats per edge cell of device memory
// written and read.
// Design: the TPU kernel ran a sequential grid over 8-row centre tiles,
// with a node prologue at it == 0, an epilogue at it == nit-1 and sums over
// centre tiles carried in VMEM (s_gk, s_gv, s_gvecn, s_gwsrc).  GPU blocks
// run in no order, so the launcher issues the stages in order:
//   (a) node recompute, one block per 16 node rows and column group: qkv,
//       vec1|vec2|vec3|wt|wsrc (vislayer.cuh), o = x_agg @ W_o + b_o, and the
//       node-update backward g_xagg = [g_o1|g_o2|g_o3] @ W_o^T;
//   (b) centre pass, one block per (fragment, centre atom i), one thread per
//       channel: the edge stage recomputed from the edge rows and then
//       differentiated (the device functions below; K7 in edge_bwd_msg.cu
//       takes the same steps in the edge core's layouts).  Centre-indexed
//       results (g_q, g_edge, g_d_sh, g_dist, g_wt) are final; the per-edge
//       terms of the source-indexed sums go to scratch (g_k, g_v terms, s1,
//       g_Sij);
//   (c) source pass, one block per (fragment, source atom j): the sums over
//       i of g_k, g_v, g_vecn (s1 * gvec2_i) and g_wsrc (g_Sij * wt_i), in a
//       fixed order, no float atomics;
//   (d) the projections' and the LayerNorm's backward, one block per 16 node
//       rows: gx = gx2 + LN'(g_qkv @ W_qkv^T) and
//       gvec = gvec2 + (g_vecn + [g_v123|g_wt|g_wsrc] @ [W_vp|W_t|W_src]^T) * w_vln.
// The centre pass keeps the edge rows, zv and a work buffer [A][2H] in
// shared memory (4 A H floats, 196 KB at A = 48, H = 256, so one block per
// SM) and zk in registers.  Every sum runs in a fixed order: the kernel is
// bitwise repeatable.

#include <cstddef>
#include <cstring>

#include "vislayer.cuh"

using namespace ai2bmd;

namespace {

// ---------------------------------------------------------------------------
// (a) node-side backward pieces
// ---------------------------------------------------------------------------

// g_xagg = [sum_c gvec2 * vec3 | gx2 * vdot | gx2] @ W_o^T   (vislayer.py:238-247)
__global__ void __launch_bounds__(256) vislayer_bwd_gxagg(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, H = p.H, A = p.A, S = p.S, ldp = p.NP * H, K = 3 * H;
  float* sX = smem;  // [NODE_ROWS][3H]
  const int M = p.B * A, r0 = blockIdx.x * NODE_ROWS, n = min(NODE_ROWS, M - r0);
  for (int e = t; e < n * H; e += blockDim.x) {
    const int r = e / H, k = e % H, row = r0 + r, b = row / A, a = row % A;
    float g1 = 0.0f, vdot = 0.0f;
    for (int c = 0; c < S; ++c) {
      const size_t v = ((size_t)b * S + c) * A + a;
      const float* pr = p.proj + v * ldp;
      g1 = fmaf(p.gvec2[v * H + k], pr[2 * H + k], g1);
      vdot = fmaf(pr[k], pr[H + k], vdot);
    }
    const float gxv = p.gx2[(size_t)row * H + k];
    sX[r * K + k] = g1;
    sX[r * K + H + k] = gxv * vdot;
    sX[r * K + 2 * H + k] = gxv;
  }
  __syncthreads();
  const int col[1] = {t};
  float acc[1][NODE_ROWS];
  rows_times_cols<1, NODE_ROWS>(sX, n, K, p.w_oT, H, col, acc);
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r)
    if (r < n) p.gxagg[(size_t)(r0 + r) * H + t] = acc[0][r];
}

// ---------------------------------------------------------------------------
// (b) centre pass: the edge stage recomputed and differentiated
// ---------------------------------------------------------------------------

// Shared memory of one centre block (fragment b, centre atom i).
struct Centre {
  float* E;       // [A][H]  edge rows of i; v_ij once the edge products are done
  float* Zv;      // [A][H]  zdkv[:, H:]
  float* W;       // [A][2H] work rows: g_zf, then g_s, then g_dkv
  float* Dsh;     // [S][A]  d_sh[c][i][:]
  float* Adj;     // [A]
  float* Gate;    // [A]     cutoff(r) * adj
  float* Dcut;    // [A]     d cutoff / d r
  float* Pre;     // [A][NW] head pre-activations a_ij
  float* RedCut;  // [NW][A] per-warp sums for g_dist
  float* RedDsh;  // [NW][S][A] per-warp sums for g_d_sh
  int b, i, NW;
  size_t bi;      // b * A + i
};

size_t centre_smem_bytes(int A, int H, int S) {
  const int NW = H / 32;
  return ((size_t)4 * A * H + S * A + 3 * A + 2 * A * NW + NW * S * A) * sizeof(float);
}

__device__ __forceinline__ Centre carve(float* smem, const Layer& p) {
  const int A = p.A, H = p.H, S = p.S;
  Centre s;
  s.NW = H / 32;
  s.b = blockIdx.y;
  s.i = blockIdx.x;
  s.bi = (size_t)s.b * A + s.i;
  s.E = smem;
  s.Zv = s.E + A * H;
  s.W = s.Zv + A * H;
  s.Dsh = s.W + 2 * A * H;
  s.Adj = s.Dsh + S * A;
  s.Gate = s.Adj + A;
  s.Dcut = s.Gate + A;
  s.Pre = s.Dcut + A;
  s.RedCut = s.Pre + A * s.NW;
  s.RedDsh = s.RedCut + s.NW * A;
  return s;
}

// The centre's edge rows, d_sh row and pair scalars.
__device__ __forceinline__ void centre_load(const Layer& p, const Centre& s) {
  const int t = threadIdx.x, A = p.A, H = p.H, S = p.S;
  const float kpi = 3.14159265358979323846f / p.cutoff;
  const float4* E4 = reinterpret_cast<const float4*>(p.edge + s.bi * A * H);
  for (int e = t; e < A * H / 4; e += blockDim.x) reinterpret_cast<float4*>(s.E)[e] = E4[e];
  for (int e = t; e < S * A; e += blockDim.x) {
    const int c = e / A, r = e % A;
    s.Dsh[e] = p.dsh[(((size_t)s.b * S + c) * A + s.i) * A + r];
  }
  for (int r = t; r < A; r += blockDim.x) {
    const float a = p.adj[s.bi * A + r], d = p.dist[s.bi * A + r];
    s.Adj[r] = a;
    s.Gate[r] = cosine_cutoff(d, p.cutoff) * a;
    s.Dcut[r] = d < p.cutoff ? -0.5f * kpi * sinf(d * kpi) : 0.0f;
  }
}

// zdkv = edge @ W_dkv + b_dkv: zv to shared memory, zk to registers.
__device__ __forceinline__ void recompute_dkv(const Layer& p, const Centre& s,
                                              float (&zk)[MAXA], float (&acc)[1][MAXA]) {
  const int t = threadIdx.x, A = p.A, H = p.H;
  const int col_lo[1] = {t}, col_hi[1] = {H + t};
  rows_times_cols<1>(s.E, A, H, p.w_dkv, 2 * H, col_hi, acc);
  const float bv = p.b_dkv[H + t], bk = p.b_dkv[t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        s.Zv[r * H + t] = acc[0][r] + bv;
      }
    }
  }
  rows_times_cols<1>(s.E, A, H, p.w_dkv, 2 * H, col_lo, acc);
#pragma unroll
  for (int r = 0; r < MAXA; ++r) zk[r] = acc[0][r] + bk;
}

// Edge-update backward (vislayer.py:314-332), df = silu(zf) * S_ij * adj with
// zf = edge @ W_f + b_f recomputed and S_ij = <wt_i, ws_j>_c:
//   g_Sij = gedge2 * adj * silu(zf)                 -> scratch gs_e (for g_wsrc)
//   g_wt_i[c] = sum_j g_Sij * ws_j[c]                -> gw[:, :H]
//   gedge = (gedge2 * adj * S_ij * silu'(zf)) @ W_f^T + gedge2
__device__ __forceinline__ void update_backward(const Layer& p, const Centre& s,
                                                float (&acc)[1][MAXA]) {
  const int t = threadIdx.x, A = p.A, H = p.H, S = p.S, ldp = p.NP * H;
  const size_t b = s.b;
  float wti[MAXS], gwti[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) {
    wti[c] = c < S ? p.proj[((b * S + c) * A + s.i) * ldp + 3 * H + t] : 0.0f;
    gwti[c] = 0.0f;
  }
  const int col[1] = {t};
  rows_times_cols<1>(s.E, A, H, p.w_f, H, col, acc);
  const float bft = p.b_f[t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const size_t e = (s.bi * A + r) * H + t;
        const float z = acc[0][r] + bft;
        float wsr[MAXS];
        float sdot = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXS; ++c) {
          wsr[c] = c < S ? p.proj[((b * S + c) * A + r) * ldp + 4 * H + t] : 0.0f;
          sdot = fmaf(wti[c], wsr[c], sdot);
        }
        const float gdfm = p.gedge2[e] * s.Adj[r];
        const float gS = gdfm * silu(z);
        p.gs_e[e] = gS;
#pragma unroll
        for (int c = 0; c < MAXS; ++c) gwti[c] = fmaf(gS, wsr[c], gwti[c]);
        s.W[r * 2 * H + t] = gdfm * sdot * dsilu(z);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) p.gw[((b * S + c) * A + s.i) * 2 * H + t] = gwti[c];
  __syncthreads();
  rows_times_cols_ld<1>(s.W, 2 * H, A, H, p.w_fT, H, col, acc);
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const size_t e = (s.bi * A + r) * H + t;
        p.gedge[e] = acc[0][r] + p.gedge2[e];
      }
    }
  }
}

// v_ij = v_j * dv * silu(a) * gate with a = sum_head q_i k_j dk, into s.E
// (the edge rows are no longer needed); a goes to s.Pre.
__device__ __forceinline__ void recompute_vij(const Layer& p, const Centre& s,
                                              const float (&zk)[MAXA]) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32, A = p.A, H = p.H, H3 = 3 * H;
  const size_t b0 = (size_t)s.b * A;
  const float qi = p.qkv[s.bi * H3 + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float kr = p.qkv[(b0 + r) * H3 + H + t];
        const float vr = p.qkv[(b0 + r) * H3 + 2 * H + t];
        const float a = warp_sum(qi * kr * silu(zk[r]));
        if (lane == 0) s.Pre[r * s.NW + w] = a;
        s.E[r * H + t] = vr * silu(s.Zv[r * H + t]) * (silu(a) * s.Gate[r]);
      }
    }
  }
}

// zs = v_ij @ W_s + b_s recomputed, and the backward through
// vec_agg_i[c] = sum_j s1 * vecn_j[c] + s2 * d_sh_ij[c] (vislayer.py:281-292):
//   g_s = [sum_c gvec2_i[c] vecn_j[c], sum_c gvec2_i[c] d_sh_ij[c]] * adj * silu'(zs) -> s.W
//   s1 -> scratch s1_e (g_vecn_j = sum_i s1 * gvec2_i, in the source pass)
//   g_d_sh_ij[c] = sum_h gvec2_i[c] * s2, per-warp partial sums -> s.RedDsh
__device__ __forceinline__ void message_backward_s(const Layer& p, const Centre& s,
                                                   float (&acc)[1][MAXA]) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32, A = p.A, H = p.H, S = p.S;
  const size_t b = s.b;
  float gva[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) gva[c] = c < S ? p.gvec2[((b * S + c) * A + s.i) * H + t] : 0.0f;
  const int col_lo[1] = {t}, col_hi[1] = {H + t};
  rows_times_cols<1>(s.E, A, H, p.w_s, 2 * H, col_hi, acc);
  const float b2 = p.b_s[H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float z2 = acc[0][r] + b2, a = s.Adj[r];
        const float s2 = silu(z2) * a;
        float g2 = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXS; ++c) {
          if (c < S) {
            g2 = fmaf(gva[c], s.Dsh[c * A + r], g2);
            const float red = warp_sum(gva[c] * s2);
            if (lane == 0) s.RedDsh[(w * S + c) * A + r] = red;
          }
        }
        s.W[r * 2 * H + H + t] = g2 * a * dsilu(z2);
      }
    }
  }
  rows_times_cols<1>(s.E, A, H, p.w_s, 2 * H, col_lo, acc);
  const float b1 = p.b_s[t], wv = p.vln_w[t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float z1 = acc[0][r] + b1, a = s.Adj[r];
        p.s1_e[(s.bi * A + r) * H + t] = silu(z1) * a;
        float g1 = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) g1 = fmaf(gva[c], p.vec[((b * S + c) * A + r) * H + t] * wv, g1);
        s.W[r * 2 * H + t] = g1 * a * dsilu(z1);
      }
    }
  }
}

// g_vij = g_s @ W_s^T + g_xagg_i, then the backward through
// v_ij = v_j * dv * silu(a) * gate and a = sum_head q_i k_j dk
// (vislayer.py:293-311):  g_v and g_k terms -> scratch gv_e, gk_e;  g_q_i;
// g_dist per-warp partial sums -> s.RedCut;  g_dkv -> s.W.
__device__ __forceinline__ void message_backward_attn(const Layer& p, const Centre& s,
                                                      const float (&zk)[MAXA],
                                                      float (&acc)[1][MAXA]) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32, A = p.A, H = p.H, H3 = 3 * H;
  const size_t b0 = (size_t)s.b * A;
  const int col[1] = {t};
  rows_times_cols<1>(s.W, A, 2 * H, p.w_sT, H, col, acc);
  __syncthreads();  // every thread has read s.W
  const float gxi = p.gxagg[s.bi * H + t];
  const float qi = p.qkv[s.bi * H3 + t];
  float gqi = 0.0f;
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const size_t e = (s.bi * A + r) * H + t;
        const float gvij = acc[0][r] + gxi;
        const float zkr = zk[r], zv = s.Zv[r * H + t];
        const float dk = silu(zkr), dv = silu(zv);
        const float kr = p.qkv[(b0 + r) * H3 + H + t];
        const float vr = p.qkv[(b0 + r) * H3 + 2 * H + t];
        const float a = s.Pre[r * s.NW + w], att = silu(a), gate = s.Gate[r];
        const float g3 = att * gate;
        p.gv_e[e] = gvij * dv * g3;
        const float g_dv = gvij * vr * g3;
        const float g_g3 = gvij * vr * dv;
        const float red = warp_sum(g_g3 * att);
        if (lane == 0) s.RedCut[w * A + r] = red;
        const float g_a = warp_sum(g_g3 * gate) * dsilu(a);
        gqi = fmaf(g_a * kr, dk, gqi);
        p.gk_e[e] = g_a * qi * dk;
        s.W[r * 2 * H + t] = g_a * qi * kr * dsilu(zkr);
        s.W[r * 2 * H + H + t] = g_dv * dsilu(zv);
      }
    }
  }
  p.gqkv[s.bi * H3 + t] = gqi;
}

// gedge = g_dkv @ W_dkv^T + (the update's part and passthrough, or gedge2
// for the last layer); the cross-warp sums of g_dist and g_d_sh.
template <bool LAST>
__device__ __forceinline__ void edge_grad_out(const Layer& p, const Centre& s,
                                              float (&acc)[1][MAXA]) {
  const int t = threadIdx.x, A = p.A, H = p.H, S = p.S;
  const int col[1] = {t};
  rows_times_cols<1>(s.W, A, 2 * H, p.w_dkvT, H, col, acc);
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const size_t e = (s.bi * A + r) * H + t;
        p.gedge[e] = acc[0][r] + (LAST ? p.gedge2[e] : p.gedge[e]);
      }
    }
  }
  for (int r = t; r < A; r += blockDim.x) {
    float sum = 0.0f;
    for (int w = 0; w < s.NW; ++w) sum += s.RedCut[w * A + r];
    p.gdist[s.bi * A + r] = sum * s.Adj[r] * s.Dcut[r];
  }
  for (int e = t; e < S * A; e += blockDim.x) {
    const int c = e / A, r = e % A;
    float sum = 0.0f;
    for (int w = 0; w < s.NW; ++w) sum += s.RedDsh[(w * S + c) * A + r];
    p.gdsh[(((size_t)s.b * S + c) * A + s.i) * A + r] = sum;
  }
}

template <bool LAST>
__global__ void __launch_bounds__(256) vislayer_bwd_centre(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  const Centre s = carve(smem, p);
  float zk[MAXA];
  float acc[1][MAXA];
  centre_load(p, s);
  __syncthreads();
  recompute_dkv(p, s, zk, acc);
  if (!LAST) update_backward(p, s, acc);
  __syncthreads();  // every thread is done with the edge rows
  recompute_vij(p, s, zk);
  __syncthreads();
  message_backward_s(p, s, acc);
  __syncthreads();
  message_backward_attn(p, s, zk, acc);
  __syncthreads();
  edge_grad_out<LAST>(p, s, acc);
}

// ---------------------------------------------------------------------------
// (c) source pass: fixed-order sums over the centre atoms i
// ---------------------------------------------------------------------------

template <bool LAST>
__global__ void __launch_bounds__(256) vislayer_bwd_source(const Layer p) {
  const int t = threadIdx.x, j = blockIdx.x, A = p.A, H = p.H, S = p.S, ldp = p.NP * H;
  const size_t b = blockIdx.y, b0 = b * A;
  float sk = 0.0f, sv = 0.0f, sc[MAXS], sw[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) sc[c] = sw[c] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < A; ++i) {
    const size_t e = ((b0 + i) * A + j) * H + t;
    sk += p.gk_e[e];
    sv += p.gv_e[e];
    const float s1 = p.s1_e[e];
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) sc[c] = fmaf(s1, p.gvec2[((b * S + c) * A + i) * H + t], sc[c]);
    if (!LAST) {
      const float gS = p.gs_e[e];
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) sw[c] = fmaf(gS, p.proj[((b * S + c) * A + i) * ldp + 3 * H + t], sw[c]);
    }
  }
  p.gqkv[(b0 + j) * 3 * H + H + t] = sk;
  p.gqkv[(b0 + j) * 3 * H + 2 * H + t] = sv;
#pragma unroll
  for (int c = 0; c < MAXS; ++c) {
    if (c < S) {
      const size_t v = (b * S + c) * A + j;
      p.gvecn[v * H + t] = sc[c];
      if (!LAST) p.gw[v * 2 * H + H + t] = sw[c];
    }
  }
}

// ---------------------------------------------------------------------------
// (d) projections' and LayerNorm's backward (vislayer.py:336-374)
// ---------------------------------------------------------------------------

// gx = gx2 + rstd * (g_xhat - mean(g_xhat) - xhat * mean(g_xhat * xhat)),
// g_xhat = (g_qkv @ W_qkv^T) * ln_s
__global__ void __launch_bounds__(256) vislayer_bwd_ln(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, w = t / 32, lane = t % 32, NW = blockDim.x / 32, H = p.H;
  const int K = 3 * H, M = p.B * p.A, r0 = blockIdx.x * NODE_ROWS, n = min(NODE_ROWS, M - r0);
  float* sG = smem;                   // [NODE_ROWS][3H] g_qkv rows
  float* sXh = sG + NODE_ROWS * K;    // [NODE_ROWS][H]  x rows, then xhat
  float* sRstd = sXh + NODE_ROWS * H; // [NODE_ROWS]
  float* sRed = sRstd + NODE_ROWS;    // [2][NW][NODE_ROWS]
  for (int e = t; e < n * K; e += blockDim.x) sG[e] = p.gqkv[(size_t)r0 * K + e];
  for (int e = t; e < n * H; e += blockDim.x) sXh[e] = p.x[(size_t)r0 * H + e];
  __syncthreads();
  normalize_rows(sXh, n, H, sRstd);
  __syncthreads();
  const int col[1] = {t};
  float acc[1][NODE_ROWS];
  rows_times_cols<1, NODE_ROWS>(sG, n, K, p.w_qkvT, H, col, acc);
  const float lns = p.ln_s[t];
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r) {
    if (r < n) {
      const float gxh = acc[0][r] * lns;
      acc[0][r] = gxh;
      const float m1 = warp_sum(gxh), m2 = warp_sum(gxh * sXh[r * H + t]);
      if (lane == 0) {
        sRed[w * NODE_ROWS + r] = m1;
        sRed[(NW + w) * NODE_ROWS + r] = m2;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r) {
    if (r < n) {
      float m1 = 0.0f, m2 = 0.0f;
      for (int ww = 0; ww < NW; ++ww) {
        m1 += sRed[ww * NODE_ROWS + r];
        m2 += sRed[(NW + ww) * NODE_ROWS + r];
      }
      m1 /= H;
      m2 /= H;
      const size_t x = (size_t)(r0 + r) * H + t;
      p.gx[x] = p.gx2[x] + sRstd[r] * (acc[0][r] - m1 - sXh[r * H + t] * m2);
    }
  }
}

// gvec = gvec2 + (g_vecn + [g_vdot*vec2 | g_vdot*vec1 | gvec2*o1 | g_wt | g_wsrc]
//                          @ [W_vp | W_t | W_src]^T) * w_vln,  g_vdot = gx2 * o2
__global__ void __launch_bounds__(256) vislayer_bwd_gvec(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, H = p.H, A = p.A, S = p.S, K = p.NP * H;
  float* sX = smem;  // [NODE_ROWS][NP*H]
  const int M = p.B * S * A, r0 = blockIdx.x * NODE_ROWS, n = min(NODE_ROWS, M - r0);
  for (int e = t; e < n * H; e += blockDim.x) {
    const int r = e / H, k = e % H, row = r0 + r;
    const size_t ba = (size_t)(row / (S * A)) * A + row % A;
    const float* pr = p.proj + (size_t)row * K;
    const float gvd = p.gx2[ba * H + k] * p.o[ba * 3 * H + H + k];
    float* x = sX + r * K;
    x[k] = gvd * pr[H + k];
    x[H + k] = gvd * pr[k];
    x[2 * H + k] = p.gvec2[(size_t)row * H + k] * p.o[ba * 3 * H + k];
    if (p.NP == 5) {
      x[3 * H + k] = p.gw[(size_t)row * 2 * H + k];
      x[4 * H + k] = p.gw[(size_t)row * 2 * H + H + k];
    }
  }
  __syncthreads();
  const int col[1] = {t};
  float acc[1][NODE_ROWS];
  rows_times_cols<1, NODE_ROWS>(sX, n, K, p.w_catT, H, col, acc);
  const float wv = p.vln_w[t];
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r) {
    if (r < n) {
      const size_t v = (size_t)(r0 + r) * H + t;
      p.gvec[v] = p.gvec2[v] + (p.gvecn[v] + acc[0][r]) * wv;
    }
  }
}

template <bool LAST>
cudaError_t launch_bwd(const Layer& p, cudaStream_t stream) {
  const int H = p.H, M = p.B * p.A, Mv = p.B * p.S * p.A, NW = H / 32;
  const size_t node_smem = (size_t)NODE_ROWS * H * sizeof(float);
  cudaError_t err = launch_node_prologue(p, stream);
  if (err != cudaSuccess) return err;
  node_proj<false><<<dim3(node_tiles(M), 3), H, node_smem, stream>>>(
      p.xagg_in, nullptr, nullptr, p.w_o, p.b_o, p.o, M, H, 3 * H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t gxagg_smem = (size_t)NODE_ROWS * 3 * H * sizeof(float);
  if ((err = allow_smem(vislayer_bwd_gxagg, gxagg_smem)) != cudaSuccess) return err;
  vislayer_bwd_gxagg<<<node_tiles(M), H, gxagg_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t centre_smem = centre_smem_bytes(p.A, H, p.S);
  if ((err = allow_smem(vislayer_bwd_centre<LAST>, centre_smem)) != cudaSuccess) return err;
  vislayer_bwd_centre<LAST><<<dim3(p.A, p.B), H, centre_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  vislayer_bwd_source<LAST><<<dim3(p.A, p.B), H, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t ln_smem = ((size_t)NODE_ROWS * 4 * H + NODE_ROWS + 2 * NW * NODE_ROWS) * sizeof(float);
  if ((err = allow_smem(vislayer_bwd_ln, ln_smem)) != cudaSuccess) return err;
  vislayer_bwd_ln<<<node_tiles(M), H, ln_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t gvec_smem = (size_t)NODE_ROWS * p.NP * H * sizeof(float);
  if ((err = allow_smem(vislayer_bwd_gvec, gvec_smem)) != cudaSuccess) return err;
  vislayer_bwd_gvec<<<node_tiles(Mv), H, gvec_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the LAYER_PTRS pointers of Layer in field order (ops/vislayer.py,
// PTR_FIELDS).  The backward reads x..b_f, w_qkvT..w_fT, xagg_in and the
// cotangents, uses every scratch pointer but vecagg (gs_e and gw only below
// the last layer), and writes gx, gvec, gedge, gdsh and gdist.
extern "C" int vislayer_bwd_launch(const void* const* ptrs, int n_ptrs, int B, int A, int H,
                                   int S, float cutoff, int last, cudaStream_t stream) {
  static_assert(offsetof(Layer, B) == LAYER_PTRS * sizeof(void*), "Layer: pointers first");
  if (n_ptrs != LAYER_PTRS || !layer_shapes_ok(A, H, S)) return (int)cudaErrorInvalidValue;
  if (centre_smem_bytes(A, H, S) > 232448) return (int)cudaErrorInvalidValue;
  Layer p;
  std::memcpy(&p, ptrs, LAYER_PTRS * sizeof(void*));
  p.B = B, p.A = A, p.H = H, p.S = S, p.NP = last ? 3 : 5, p.cutoff = cutoff;
  return (int)(last ? launch_bwd<true>(p, stream) : launch_bwd<false>(p, stream));
}
