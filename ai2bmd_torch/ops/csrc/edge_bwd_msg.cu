// K2 edge_bwd_msg: backward of the edge core's message path (x_agg, vec_agg)
// from the stored pre-activations zdkv and zs.
//
// Replaces _bwd_msg_kernel_sa (ai2bmd_tpu/ops/pallas/vismp.py:757), launched
// by _bwd_msg_call_sa (:896).  Outputs g_q, g_k, g_v, g_vec, g_edge, g_d_sh
// and g_dist (through the cosine cutoff).
//
// What bounds it on the H100: the two transposed edge products
// g_s @ W_s^T and g_dkv @ W_dkv^T, 4 H^2 multiply-adds per edge cell, on the
// CUDA cores in float32; the rest is elementwise.
// Design: pass 1 runs one block per (fragment, centre atom i), one thread per
// channel, and writes every centre-indexed output (g_q, g_edge, g_d_sh,
// g_dist).  The source-indexed outputs (g_k, g_v, g_vec) are sums over the
// centre atoms.  The TPU kernel accumulated them across its sequential grid
// (:804-808, :819-821, :829-831, :843-845); GPU blocks run in parallel and
// in no order, so pass 1 writes the per-edge terms of g_k and g_v to scratch,
// and pass 2 runs one block per (fragment, source atom j) and sums them over
// i in a fixed order (g_vec's term, s1_ij * g_vec_agg_i, is recomputed there
// from the stored zs).  No float atomics: the kernel is bitwise repeatable.
// The cross-channel sums (g_d_sh, g_dist) reduce each warp with shuffles and
// then the warps in a fixed order through shared memory.  Rows go in chunks
// of 8 so that a chunk's loads and warp reductions are in flight together.
// The weights come transposed ([2H][H]) so that a warp reads 32
// neighbouring floats.

#include "common.cuh"

using namespace ai2bmd;

__global__ void __launch_bounds__(256) edge_bwd_msg_centre(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ vec, const float* __restrict__ zdkv,
    const float* __restrict__ zs, const float* __restrict__ dsh,
    const float* __restrict__ dist, const float* __restrict__ adj,
    const float* __restrict__ wdkvT, const float* __restrict__ wsT,
    const float* __restrict__ gx, const float* __restrict__ gva,
    float* __restrict__ gq, float* __restrict__ gedge, float* __restrict__ gdsh,
    float* __restrict__ gdist, float* __restrict__ gk_e, float* __restrict__ gv_e,
    int A, int H, int S, float cutoff) {
  extern __shared__ __align__(16) float smem[];
  const int NW = blockDim.x / 32;
  float* sG = smem;                  // [A][2H] g_s, later g_dkv
  float* sDsh = sG + A * 2 * H;      // [A][S]
  float* sAdj = sDsh + A * S;        // [A]
  float* sGate = sAdj + A;           // [A]  cutoff(r) * adj
  float* sDcut = sGate + A;          // [A]  d cutoff / d r
  float* sRedCut = sDcut + A;        // [NW][A]
  float* sRedDsh = sRedCut + NW * A; // [NW][A][S]

  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int i = blockIdx.x, b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;
  const float kpi = 3.14159265358979323846f / cutoff;

  for (int x = t; x < A * S; x += blockDim.x) sDsh[x] = dsh[bi * A * S + x];
  for (int r = t; r < A; r += blockDim.x) {
    const float a = adj[bi * A + r], d = dist[bi * A + r];
    const float inside = d < cutoff ? 1.0f : 0.0f;
    sAdj[r] = a;
    sGate[r] = cosine_cutoff(d, cutoff) * a;
    sDcut[r] = -0.5f * kpi * sinf(d * kpi) * inside;
  }
  float gvai[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) gvai[c] = c < S ? gva[(bi * S + c) * H + t] : 0.0f;
  __syncthreads();

  // g_s1 = sum_c g_vec_agg_i[c] * vec_j[c],  g_s2 = sum_c g_vec_agg_i[c] * d_sh_ij[c];
  // g_s = [g_s1, g_s2] * adj * silu'(zs).  g_d_sh_ij[c] = sum_h g_vec_agg_i[c] * s2.
  for (int r0 = 0; r0 < A; r0 += RCHUNK) {
#pragma unroll
    for (int rr = 0; rr < RCHUNK; ++rr) {
      const int r = r0 + rr;
      const size_t e = bi * A + r;
      const float z1 = zs[e * H2 + t], z2 = zs[e * H2 + H + t];
      const float a = sAdj[r];
      const float s2 = silu(z2) * a;
      float g1 = 0.0f, g2 = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          g1 = fmaf(gvai[c], vec[((b0 + r) * S + c) * H + t], g1);
          g2 = fmaf(gvai[c], sDsh[r * S + c], g2);
          const float red = warp_sum(gvai[c] * s2);
          if (lane == 0) sRedDsh[(w * A + r) * S + c] = red;
        }
      }
      sG[r * H2 + t] = g1 * a * dsilu(z1);
      sG[r * H2 + H + t] = g2 * a * dsilu(z2);
    }
  }
  __syncthreads();

  // g_vij = g_s @ W_s^T + g_x_agg_i
  float acc[1][MAXA];
  const int col[1] = {t};
  rows_times_cols<1>(sG, A, H2, wsT, H, col, acc);
  __syncthreads();  // every thread has read sG
  const float gxi = gx[bi * H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        sG[r * H2 + t] = acc[0][r] + gxi;
      }
    }
  }

  const float qi = q[bi * H + t];
  float gqi = 0.0f;
  for (int r0 = 0; r0 < A; r0 += RCHUNK) {
#pragma unroll
    for (int rr = 0; rr < RCHUNK; ++rr) {
      const int r = r0 + rr;
      const size_t e = bi * A + r;
      const float gvij = sG[r * H2 + t];
      const float zk = zdkv[e * H2 + t], zv = zdkv[e * H2 + H + t];
      const float dk = silu(zk), dv = silu(zv);
      const float kr = k[(b0 + r) * H + t], vr = v[(b0 + r) * H + t];
      const float a = warp_sum(qi * kr * dk);
      const float att = silu(a);
      const float gate = sGate[r];
      const float g3 = att * gate;
      gv_e[e * H + t] = gvij * dv * g3;
      const float g_dv = gvij * vr * g3;
      const float g_g3 = gvij * vr * dv;
      const float red = warp_sum(g_g3 * att);
      if (lane == 0) sRedCut[w * A + r] = red;
      const float g_a = warp_sum(g_g3 * gate) * dsilu(a);
      gqi = fmaf(g_a * kr, dk, gqi);
      gk_e[e * H + t] = g_a * qi * dk;
      const float g_dk = g_a * qi * kr;
      sG[r * H2 + t] = g_dk * dsilu(zk);
      sG[r * H2 + H + t] = g_dv * dsilu(zv);
    }
  }
  gq[bi * H + t] = gqi;
  __syncthreads();

  // g_edge = g_dkv @ W_dkv^T
  rows_times_cols<1>(sG, A, H2, wdkvT, H, col, acc);
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
__global__ void __launch_bounds__(256) edge_bwd_msg_source(
    const float* __restrict__ zs, const float* __restrict__ adj,
    const float* __restrict__ gva, const float* __restrict__ gk_e,
    const float* __restrict__ gv_e, float* __restrict__ gk, float* __restrict__ gv,
    float* __restrict__ gvec, int A, int H, int S) {
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
    const float s1 = silu(zs[e * 2 * H + t]) * adj[e];
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

extern "C" int edge_bwd_msg_launch(const float* q, const float* k, const float* v,
                                   const float* vec, const float* zdkv, const float* zs,
                                   const float* dsh, const float* dist, const float* adj,
                                   const float* wdkvT, const float* wsT, const float* gx,
                                   const float* gva, float* gq, float* gk, float* gv,
                                   float* gvec, float* gedge, float* gdsh, float* gdist,
                                   float* gk_e, float* gv_e, int B, int A, int H, int S,
                                   float cutoff, cudaStream_t stream) {
  if (A > MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  const int NW = H / 32;
  const size_t smem = (size_t)(2 * A * H + A * S + 3 * A + NW * A + NW * A * S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_msg_centre,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_bwd_msg_centre<<<dim3(A, B), H, smem, stream>>>(q, k, v, vec, zdkv, zs, dsh, dist, adj,
                                                       wdkvT, wsT, gx, gva, gq, gedge, gdsh,
                                                       gdist, gk_e, gv_e, A, H, S, cutoff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_msg_source<<<dim3(A, B), H, 0, stream>>>(zs, adj, gva, gk_e, gv_e, gk, gv, gvec, A,
                                                    H, S);
  return (int)cudaGetLastError();
}
