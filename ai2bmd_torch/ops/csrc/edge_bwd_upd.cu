// K3 edge_bwd_upd: backward of the edge update
//   df_ij = silu(zf_ij) * sum_c wt_i[c] * wsrc_j[c] * adj_ij
// from the stored pre-activation zf.  Outputs g_edge, g_wt and g_wsrc.
//
// Replaces _bwd_upd_kernel_sa (ai2bmd_tpu/ops/pallas/vismp.py:852), launched
// by _bwd_upd_call_sa (:951).
//
// What bounds it on the H100: the transposed product g_zf @ W_f^T, H^2
// multiply-adds per edge cell, in float32 on the CUDA cores.
// Design: pass 1 runs one block per (fragment, centre atom i), one thread per
// channel, and writes the centre-indexed g_edge and g_wt.  g_wsrc is
// source-indexed: the TPU kernel accumulated it across its sequential grid
// (:868-870, :887-889); here pass 2 runs one block per (fragment, source
// atom j) and sums g_df * adj * silu(zf) * wt_i over i in a fixed order,
// recomputing the per-edge factor from the stored zf instead of writing it
// to scratch.  No float atomics: the kernel is bitwise repeatable.  Rows go
// in chunks of 8 so that a chunk's loads are in flight together.

#include "common.cuh"

using namespace ai2bmd;

__global__ void __launch_bounds__(256) edge_bwd_upd_centre(
    const float* __restrict__ adj, const float* __restrict__ wt,
    const float* __restrict__ wsrc, const float* __restrict__ wfT,
    const float* __restrict__ zf, const float* __restrict__ gdf, float* __restrict__ gedge,
    float* __restrict__ gwt, int A, int H, int S) {
  extern __shared__ __align__(16) float smem[];
  float* sG = smem;  // [A][H] g_zf
  const int t = threadIdx.x, i = blockIdx.x, b = blockIdx.y;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;

  float wti[MAXS], gwti[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) {
    wti[c] = c < S ? wt[(bi * S + c) * H + t] : 0.0f;
    gwti[c] = 0.0f;
  }
  for (int r0 = 0; r0 < A; r0 += RCHUNK) {
#pragma unroll
    for (int rr = 0; rr < RCHUNK; ++rr) {
      const int r = r0 + rr;
      const size_t e = bi * A + r;
      const float z = zf[e * H + t];
      float sdot = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) sdot = fmaf(wti[c], wsrc[((b0 + r) * S + c) * H + t], sdot);
      const float g = gdf[e * H + t] * adj[e];
      const float g_s = g * silu(z);
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) gwti[c] = fmaf(g_s, wsrc[((b0 + r) * S + c) * H + t], gwti[c]);
      sG[r * H + t] = g * sdot * dsilu(z);
    }
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gwt[(bi * S + c) * H + t] = gwti[c];
  __syncthreads();

  float acc[1][MAXA];
  const int col[1] = {t};
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
__global__ void __launch_bounds__(256) edge_bwd_upd_source(
    const float* __restrict__ adj, const float* __restrict__ wt, const float* __restrict__ zf,
    const float* __restrict__ gdf, float* __restrict__ gwsrc, int A, int H, int S) {
  const int t = threadIdx.x, j = blockIdx.x, b = blockIdx.y;
  const size_t b0 = (size_t)b * A;
  float sc[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) sc[c] = 0.0f;
#pragma unroll 8
  for (int i = 0; i < A; ++i) {
    const size_t e = (b0 + i) * A + j;
    const float g_s = gdf[e * H + t] * adj[e] * silu(zf[e * H + t]);
#pragma unroll
    for (int c = 0; c < MAXS; ++c)
      if (c < S) sc[c] = fmaf(g_s, wt[((b0 + i) * S + c) * H + t], sc[c]);
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gwsrc[((b0 + j) * S + c) * H + t] = sc[c];
}

extern "C" int edge_bwd_upd_launch(const float* adj, const float* wt, const float* wsrc,
                                   const float* wfT, const float* zf, const float* gdf,
                                   float* gedge, float* gwt, float* gwsrc, int B, int A, int H,
                                   int S, cudaStream_t stream) {
  if (A > MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)A * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_upd_centre,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_bwd_upd_centre<<<dim3(A, B), H, smem, stream>>>(adj, wt, wsrc, wfT, zf, gdf, gedge, gwt,
                                                       A, H, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_bwd_upd_source<<<dim3(A, B), H, 0, stream>>>(adj, wt, zf, gdf, gwsrc, A, H, S);
  return (int)cudaGetLastError();
}
