// K3 edge_bwd_upd and K8 edge_bwd_upd_rc: backward of the edge update
//   df_ij = silu(zf_ij) * sum_c wt_i[c] * wsrc_j[c] * adj_ij,  zf = edge @ W_f + b_f.
// Outputs g_edge, g_wt and g_wsrc.  One pair of kernels, a template on RC:
//
//   RC = false, K3: from the pre-activation zf that K1 stores with `store`.
//     Replaces _bwd_upd_kernel_sa (ai2bmd_tpu/ops/pallas/vismp.py:852),
//     launched by _bwd_upd_call_sa (:951).
//   RC = true, K8: recompute mode, zf rebuilt from the edge rows inside the
//     kernel.  Replaces _bwd_upd_kernel (:714), launched by _bwd_upd_call's
//     pallas_call (:1086).
//
// What bounds it on the H100: float32 multiply-adds on the CUDA cores, per
// edge cell H^2 for K3 (the transposed product g_zf @ W_f^T) and 2 H^2 for
// K8 (the recomputed edge @ W_f as well).
// Design: pass 1 runs one block per (fragment, centre atom i), one thread per
// channel, and writes the centre-indexed g_edge and g_wt; K8 first holds the
// centre's edge rows in shared memory ([A][H], 40 KB at A = 40), the buffer
// that then holds g_zf.  g_wsrc is source-indexed: the TPU kernel
// accumulated it across its sequential grid (:868-870, :887-889); here pass 2
// runs one block per (fragment, source atom j) and sums
// g_df * adj * silu(zf) * wt_i over i in a fixed order.  K3's pass 2 rebuilds
// that per-edge factor from the stored zf; K8's pass 1 writes it to scratch,
// as there is no zf to rebuild it from.  No float atomics: bitwise
// repeatable.  Rows go in chunks of 8 so that a chunk's loads are in flight
// together.

#include "common.cuh"

using namespace ai2bmd;

template <bool RC>
__global__ void __launch_bounds__(256) edge_bwd_upd_centre(
    const float* __restrict__ zf, const float* __restrict__ edge,
    const float* __restrict__ wf, const float* __restrict__ bf,
    const float* __restrict__ adj, const float* __restrict__ wt,
    const float* __restrict__ wsrc, const float* __restrict__ wfT,
    const float* __restrict__ gdf, float* __restrict__ gedge, float* __restrict__ gwt,
    float* __restrict__ gs_e, int A, int H, int S) {
  extern __shared__ __align__(16) float smem[];
  float* sG = smem;  // [A][H] g_zf (K8: the edge rows of i first)
  const int t = threadIdx.x, i = blockIdx.x, b = blockIdx.y;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;

  float acc[1][MAXA];
  const int col[1] = {t};
  if constexpr (RC) {
    // zf = edge @ W_f (+ b_f below)
    const float4* E4 = reinterpret_cast<const float4*>(edge + bi * A * H);
    for (int x = t; x < A * H / 4; x += blockDim.x) reinterpret_cast<float4*>(sG)[x] = E4[x];
    __syncthreads();
    rows_times_cols<1>(sG, A, H, wf, H, col, acc);
    __syncthreads();  // every thread has read the edge rows
  }

  float wti[MAXS], gwti[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) {
    wti[c] = c < S ? wt[(bi * S + c) * H + t] : 0.0f;
    gwti[c] = 0.0f;
  }
  // one edge row r with its pre-activation z: g_zf into sG, the g_wt sums
  auto row = [&](int r, float z) {
    const size_t e = bi * A + r;
    float wsr[MAXS];
    float sdot = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      wsr[c] = c < S ? wsrc[((b0 + r) * S + c) * H + t] : 0.0f;
      sdot = fmaf(wti[c], wsr[c], sdot);
    }
    const float g = gdf[e * H + t] * adj[e];
    const float g_s = g * silu(z);
    if constexpr (RC) gs_e[e * H + t] = g_s;
#pragma unroll
    for (int c = 0; c < MAXS; ++c) gwti[c] = fmaf(g_s, wsr[c], gwti[c]);
    sG[r * H + t] = g * sdot * dsilu(z);
  };
  if constexpr (RC) {
    // acc is indexed by row, so the loop over chunks unrolls in full
    const float bft = bf[t];
#pragma unroll
    for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          row(r, acc[0][r] + bft);
        }
      }
    }
  } else {
    // a runtime loop over chunks, which the compiler pipelines
    for (int r0 = 0; r0 < A; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) row(r0 + rr, zf[(bi * A + r0 + rr) * H + t]);
    }
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gwt[(bi * S + c) * H + t] = gwti[c];
  __syncthreads();

  // g_edge = g_zf @ W_f^T
  rows_times_cols<1>(sG, A, H, wfT, H, col, acc);
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
}

// Pass 2: g_wsrc_j[c] = sum_i g_df_ij * adj_ij * silu(zf_ij) * wt_i[c], fixed order.
template <bool RC>
__global__ void __launch_bounds__(256) edge_bwd_upd_source(
    const float* __restrict__ adj, const float* __restrict__ wt, const float* __restrict__ zf,
    const float* __restrict__ gdf, const float* __restrict__ gs_e, float* __restrict__ gwsrc,
    int A, int H, int S) {
  const int t = threadIdx.x, j = blockIdx.x, b = blockIdx.y;
  const size_t b0 = (size_t)b * A;
  float sc[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) sc[c] = 0.0f;
#pragma unroll 8
  for (int i = 0; i < A; ++i) {
    const size_t e = (b0 + i) * A + j;
    float g_s;
    if constexpr (RC) {
      g_s = gs_e[e * H + t];
    } else {
      g_s = gdf[e * H + t] * adj[e] * silu(zf[e * H + t]);
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) sc[c] = fmaf(g_s, wt[((b0 + i) * S + c) * H + t], sc[c]);
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gwsrc[((b0 + j) * S + c) * H + t] = sc[c];
}

template <bool RC>
static int launch_upd(const float* zf, const float* edge, const float* wf, const float* bf,
                      const float* adj, const float* wt, const float* wsrc, const float* wfT,
                      const float* gdf, float* gedge, float* gwt, float* gwsrc, float* gs_e,
                      int B, int A, int H, int S, cudaStream_t stream) {
  if (A > MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_upd_centre<RC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_bwd_upd_centre<RC><<<dim3(A, B), H, smem, stream>>>(zf, edge, wf, bf, adj, wt, wsrc, wfT,
                                                           gdf, gedge, gwt, gs_e, A, H, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_upd_source<RC><<<dim3(A, B), H, 0, stream>>>(adj, wt, zf, gdf, gs_e, gwsrc, A, H, S);
  return (int)cudaGetLastError();
}

extern "C" int edge_bwd_upd_launch(const float* adj, const float* wt, const float* wsrc,
                                   const float* wfT, const float* zf, const float* gdf,
                                   float* gedge, float* gwt, float* gwsrc, int B, int A, int H,
                                   int S, cudaStream_t stream) {
  return launch_upd<false>(zf, nullptr, nullptr, nullptr, adj, wt, wsrc, wfT, gdf, gedge, gwt,
                           gwsrc, nullptr, B, A, H, S, stream);
}

extern "C" int edge_bwd_upd_rc_launch(const float* edge, const float* adj, const float* wt,
                                      const float* wsrc, const float* wf, const float* bf,
                                      const float* wfT, const float* gdf, float* gedge,
                                      float* gwt, float* gwsrc, float* gs_e, int B, int A, int H,
                                      int S, cudaStream_t stream) {
  return launch_upd<true>(nullptr, edge, wf, bf, adj, wt, wsrc, wfT, gdf, gedge, gwt, gwsrc,
                          gs_e, B, A, H, S, stream);
}
