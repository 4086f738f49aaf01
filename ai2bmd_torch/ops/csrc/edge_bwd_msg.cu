// K2 edge_bwd_msg and K7 edge_bwd_msg_rc: backward of the edge core's message
// path (x_agg, vec_agg).  Outputs g_q, g_k, g_v, g_vec, g_edge, g_d_sh and
// g_dist (through the cosine cutoff).  One pair of kernels, a template on RC:
//
//   RC = false, K2: from the pre-activations zdkv and zs that K1 stores with
//     `store`.  Replaces _bwd_msg_kernel_sa (ai2bmd_tpu/ops/pallas/vismp.py:757),
//     launched by _bwd_msg_call_sa (:896).
//   RC = true, K7: recompute mode.  zdkv = edge @ W_dkv + b_dkv and
//     zs = v_ij @ W_s + b_s are rebuilt from the edge rows inside the kernel,
//     so nothing is stored between the forward and the backward.  Replaces
//     _bwd_msg_kernel (:615), launched by _bwd_msg_call's pallas_call (:1018).
//
// What bounds it on the H100: float32 multiply-adds on the CUDA cores, per
// edge cell 4 H^2 for K2 (the transposed products g_s @ W_s^T and
// g_dkv @ W_dkv^T) and 8 H^2 for K7 (the two recomputed products edge @ W_dkv
// and v_ij @ W_s as well); the rest is elementwise.  K7 moves 5 H fewer
// floats per edge cell than K2 (no zdkv/zs read) for twice the arithmetic.
// Design: pass 1 runs one block per (fragment, centre atom i), one thread per
// channel, and writes every centre-indexed output (g_q, g_edge, g_d_sh,
// g_dist).  The source-indexed outputs (g_k, g_v, g_vec) are sums over the
// centre atoms.  The TPU kernel accumulated them across its sequential grid
// (:804-808, :819-821, :829-831, :843-845); GPU blocks run in parallel and
// in no order, so pass 1 writes the per-edge terms of g_k and g_v to scratch,
// and pass 2 runs one block per (fragment, source atom j) and sums them over
// i in a fixed order.  g_vec's term, s1_ij * g_vec_agg_i, is rebuilt there
// from the stored zs (K2), or read from scratch (K7: pass 2 cannot rebuild s1
// without the product).  No float atomics: bitwise repeatable.
// K7's pass 1 keeps K6's centre-pass layout (vislayer_bwd.cu:88-147): the
// edge rows (then v_ij), zv and the [A][2H] work buffer in shared memory, zk
// in registers; 4 A H floats, 160 KB at A = 40, so one block per SM.
// The cross-channel sums (g_d_sh, g_dist) reduce each warp with shuffles and
// then the warps in a fixed order through shared memory.  Rows go in chunks
// of 8 so that a chunk's loads and warp reductions are in flight together.
// The transposed products take W^T ([2H][H]) so that a warp reads 32
// neighbouring floats.

#include "common.cuh"

using namespace ai2bmd;

template <bool RC>
__global__ void __launch_bounds__(256) edge_bwd_msg_centre(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ vec, const float* __restrict__ zdkv,
    const float* __restrict__ zs, const float* __restrict__ edge,
    const float* __restrict__ wdkv, const float* __restrict__ bdkv,
    const float* __restrict__ ws, const float* __restrict__ bs,
    const float* __restrict__ dsh, const float* __restrict__ dist,
    const float* __restrict__ adj, const float* __restrict__ wdkvT,
    const float* __restrict__ wsT, const float* __restrict__ gx,
    const float* __restrict__ gva, float* __restrict__ gq, float* __restrict__ gedge,
    float* __restrict__ gdsh, float* __restrict__ gdist, float* __restrict__ gk_e,
    float* __restrict__ gv_e, float* __restrict__ s1_e, int A, int H, int S, float cutoff) {
  extern __shared__ __align__(16) float smem[];
  const int NW = blockDim.x / 32;
  const int AH = RC ? A * H : 0;
  float* sE = smem;                     // RC: [A][H] edge rows of i, then v_ij
  float* sZv = sE + AH;                 // RC: [A][H] zdkv[:, H:]
  float* sW = sZv + AH;                 // [A][2H] g_s, then g_dkv
  float* sDsh = sW + 2 * A * H;         // [A][S]
  float* sAdj = sDsh + A * S;           // [A]
  float* sGate = sAdj + A;              // [A]  cutoff(r) * adj
  float* sDcut = sGate + A;             // [A]  d cutoff / d r
  float* sRedCut = sDcut + A;           // [NW][A]
  float* sRedDsh = sRedCut + NW * A;    // [NW][A][S]
  float* sPre = sRedDsh + NW * A * S;   // RC: [A][NW] head pre-activations a_ij

  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int i = blockIdx.x, b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;
  const float kpi = 3.14159265358979323846f / cutoff;

  if constexpr (RC) {
    const float4* E4 = reinterpret_cast<const float4*>(edge + bi * A * H);
    for (int x = t; x < A * H / 4; x += blockDim.x) reinterpret_cast<float4*>(sE)[x] = E4[x];
  }
  for (int x = t; x < A * S; x += blockDim.x) sDsh[x] = dsh[bi * A * S + x];
  for (int r = t; r < A; r += blockDim.x) {
    const float a = adj[bi * A + r], d = dist[bi * A + r];
    sAdj[r] = a;
    sGate[r] = cosine_cutoff(d, cutoff) * a;
    sDcut[r] = d < cutoff ? -0.5f * kpi * sinf(d * kpi) : 0.0f;
  }
  float gvai[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) gvai[c] = c < S ? gva[(bi * S + c) * H + t] : 0.0f;
  __syncthreads();

  float acc[1][MAXA];
  const int col_lo[1] = {t}, col_hi[1] = {H + t};
  const float qi = q[bi * H + t];
  float zk[RC ? MAXA : 1];
  if constexpr (RC) {
    // zdkv = edge @ W_dkv + b_dkv: zv to shared memory, zk to registers
    rows_times_cols<1>(sE, A, H, wdkv, H2, col_hi, acc);
    const float bv = bdkv[H + t], bk = bdkv[t];
#pragma unroll
    for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          sZv[r * H + t] = acc[0][r] + bv;
        }
      }
    }
    rows_times_cols<1>(sE, A, H, wdkv, H2, col_lo, acc);
#pragma unroll
    for (int r = 0; r < MAXA; ++r) zk[r] = acc[0][r] + bk;
    __syncthreads();  // every thread has read the edge rows

    // v_ij = v_j * dv * silu(a) * gate with a = sum_head q_i k_j dk, into sE
#pragma unroll
    for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          const float kr = k[(b0 + r) * H + t], vr = v[(b0 + r) * H + t];
          const float a = warp_sum(qi * kr * silu(zk[r]));
          if (lane == 0) sPre[r * NW + w] = a;
          sE[r * H + t] = vr * silu(sZv[r * H + t]) * (silu(a) * sGate[r]);
        }
      }
    }
    __syncthreads();
  }

  // g_s = [sum_c g_vec_agg_i[c] vec_j[c], sum_c g_vec_agg_i[c] d_sh_ij[c]] * adj * silu'(zs);
  // g_d_sh_ij[c] = sum_h g_vec_agg_i[c] * s2.  One half of g_s at a time:
  auto g_s2 = [&](int r, float z2) {
    const float a = sAdj[r];
    const float s2 = silu(z2) * a;
    float g2 = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      if (c < S) {
        g2 = fmaf(gvai[c], sDsh[r * S + c], g2);
        const float red = warp_sum(gvai[c] * s2);
        if (lane == 0) sRedDsh[(w * A + r) * S + c] = red;
      }
    }
    sW[r * H2 + H + t] = g2 * a * dsilu(z2);
  };
  auto g_s1 = [&](int r, float z1) {
    float g1 = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) g1 = fmaf(gvai[c], vec[((b0 + r) * S + c) * H + t], g1);
    sW[r * H2 + t] = g1 * sAdj[r] * dsilu(z1);
  };
  if constexpr (RC) {
    // zs = v_ij @ W_s + b_s, one half at a time; s1 -> scratch for g_vec
    rows_times_cols<1>(sE, A, H, ws, H2, col_hi, acc);
    const float b2 = bs[H + t];
#pragma unroll
    for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          g_s2(r, acc[0][r] + b2);
        }
      }
    }
    rows_times_cols<1>(sE, A, H, ws, H2, col_lo, acc);
    const float b1 = bs[t];
#pragma unroll
    for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          const float z1 = acc[0][r] + b1;
          s1_e[(bi * A + r) * H + t] = silu(z1) * sAdj[r];
          g_s1(r, z1);
        }
      }
    }
  } else {
    for (int r0 = 0; r0 < A; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const size_t e = bi * A + r;
        g_s2(r, zs[e * H2 + H + t]);
        g_s1(r, zs[e * H2 + t]);
      }
    }
  }
  __syncthreads();

  // g_vij = g_s @ W_s^T + g_x_agg_i, parked in sW's first half (each thread
  // reads back only its own column, so acc is free for the chain below)
  rows_times_cols<1>(sW, A, H2, wsT, H, col_lo, acc);
  __syncthreads();  // every thread has read sW
  const float gxi = gx[bi * H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        sW[r * H2 + t] = acc[0][r] + gxi;
      }
    }
  }

  // the attention chain
  float gqi = 0.0f;
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const size_t e = (bi * A + r) * H + t;
        const float gvij = sW[r * H2 + t];
        float zkr, zv;
        if constexpr (RC) {
          zkr = zk[r];
          zv = sZv[r * H + t];
        } else {
          zkr = zdkv[(bi * A + r) * H2 + t];
          zv = zdkv[(bi * A + r) * H2 + H + t];
        }
        const float dk = silu(zkr), dv = silu(zv);
        const float kr = k[(b0 + r) * H + t], vr = v[(b0 + r) * H + t];
        float a;
        if constexpr (RC) {
          a = sPre[r * NW + w];
        } else {
          a = warp_sum(qi * kr * dk);
        }
        const float att = silu(a), gate = sGate[r];
        const float g3 = att * gate;
        gv_e[e] = gvij * dv * g3;
        const float g_dv = gvij * vr * g3;
        const float g_g3 = gvij * vr * dv;
        const float red = warp_sum(g_g3 * att);
        if (lane == 0) sRedCut[w * A + r] = red;
        const float g_a = warp_sum(g_g3 * gate) * dsilu(a);
        gqi = fmaf(g_a * kr, dk, gqi);
        gk_e[e] = g_a * qi * dk;
        sW[r * H2 + t] = g_a * qi * kr * dsilu(zkr);
        sW[r * H2 + H + t] = g_dv * dsilu(zv);
      }
    }
  }
  gq[bi * H + t] = gqi;
  __syncthreads();

  // g_edge = g_dkv @ W_dkv^T; the cross-warp sums of g_dist and g_d_sh
  rows_times_cols<1>(sW, A, H2, wdkvT, H, col_lo, acc);
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        gedge[(bi * A + r) * H + t] = acc[0][r];
      }
    }
  }
  for (int r = t; r < A; r += blockDim.x) {
    float s = 0.0f;
    for (int ww = 0; ww < NW; ++ww) s += sRedCut[ww * A + r];
    gdist[bi * A + r] = s * sAdj[r] * sDcut[r];
  }
  for (int x = t; x < A * S; x += blockDim.x) {
    float s = 0.0f;
    for (int ww = 0; ww < NW; ++ww) s += sRedDsh[ww * A * S + x];
    gdsh[bi * A * S + x] = s;
  }
}

// Pass 2: one block per (fragment, source atom j); fixed-order sums over i.
template <bool RC>
__global__ void __launch_bounds__(256) edge_bwd_msg_source(
    const float* __restrict__ zs, const float* __restrict__ adj,
    const float* __restrict__ s1_e, const float* __restrict__ gva,
    const float* __restrict__ gk_e, const float* __restrict__ gv_e, float* __restrict__ gk,
    float* __restrict__ gv, float* __restrict__ gvec, int A, int H, int S) {
  const int t = threadIdx.x, j = blockIdx.x, b = blockIdx.y;
  const size_t b0 = (size_t)b * A;
  float sk = 0.0f, sv = 0.0f;
  float sc[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) sc[c] = 0.0f;
#pragma unroll 8
  for (int i = 0; i < A; ++i) {
    const size_t e = (b0 + i) * A + j;
    sk += gk_e[e * H + t];
    sv += gv_e[e * H + t];
    float s1;
    if constexpr (RC) {
      s1 = s1_e[e * H + t];
    } else {
      s1 = silu(zs[e * 2 * H + t]) * adj[e];
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) sc[c] = fmaf(s1, gva[((b0 + i) * S + c) * H + t], sc[c]);
  }
  gk[(b0 + j) * H + t] = sk;
  gv[(b0 + j) * H + t] = sv;
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gvec[((b0 + j) * S + c) * H + t] = sc[c];
}

template <bool RC>
static int launch_msg(const float* q, const float* k, const float* v, const float* vec,
                  const float* zdkv, const float* zs, const float* edge, const float* wdkv,
                  const float* bdkv, const float* ws, const float* bs, const float* dsh,
                  const float* dist, const float* adj, const float* wdkvT, const float* wsT,
                  const float* gx, const float* gva, float* gq, float* gk, float* gv,
                  float* gvec, float* gedge, float* gdsh, float* gdist, float* gk_e,
                  float* gv_e, float* s1_e, int B, int A, int H, int S, float cutoff,
                  cudaStream_t stream) {
  if (A > MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  const int NW = H / 32;
  const size_t smem = (size_t)(2 * A * H + (RC ? 2 * A * H + A * NW : 0) + A * S + 3 * A +
                               NW * A + NW * A * S) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_msg_centre<RC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_bwd_msg_centre<RC><<<dim3(A, B), H, smem, stream>>>(
      q, k, v, vec, zdkv, zs, edge, wdkv, bdkv, ws, bs, dsh, dist, adj, wdkvT, wsT, gx, gva, gq,
      gedge, gdsh, gdist, gk_e, gv_e, s1_e, A, H, S, cutoff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_msg_source<RC><<<dim3(A, B), H, 0, stream>>>(zs, adj, s1_e, gva, gk_e, gv_e, gk, gv,
                                                        gvec, A, H, S);
  return (int)cudaGetLastError();
}

extern "C" int edge_bwd_msg_launch(const float* q, const float* k, const float* v,
                                   const float* vec, const float* zdkv, const float* zs,
                                   const float* dsh, const float* dist, const float* adj,
                                   const float* wdkvT, const float* wsT, const float* gx,
                                   const float* gva, float* gq, float* gk, float* gv,
                                   float* gvec, float* gedge, float* gdsh, float* gdist,
                                   float* gk_e, float* gv_e, int B, int A, int H, int S,
                                   float cutoff, cudaStream_t stream) {
  return launch_msg<false>(q, k, v, vec, zdkv, zs, nullptr, nullptr, nullptr, nullptr, nullptr, dsh,
                       dist, adj, wdkvT, wsT, gx, gva, gq, gk, gv, gvec, gedge, gdsh, gdist,
                       gk_e, gv_e, nullptr, B, A, H, S, cutoff, stream);
}

extern "C" int edge_bwd_msg_rc_launch(
    const float* q, const float* k, const float* v, const float* vec, const float* edge,
    const float* dsh, const float* dist, const float* adj, const float* wdkv, const float* bdkv,
    const float* ws, const float* bs, const float* wdkvT, const float* wsT, const float* gx,
    const float* gva, float* gq, float* gk, float* gv, float* gvec, float* gedge, float* gdsh,
    float* gdist, float* gk_e, float* gv_e, float* s1_e, int B, int A, int H, int S,
    float cutoff, cudaStream_t stream) {
  return launch_msg<true>(q, k, v, vec, nullptr, nullptr, edge, wdkv, bdkv, ws, bs, dsh, dist, adj,
                      wdkvT, wsT, gx, gva, gq, gk, gv, gvec, gedge, gdsh, gdist, gk_e, gv_e, s1_e,
                      B, A, H, S, cutoff, stream);
}
