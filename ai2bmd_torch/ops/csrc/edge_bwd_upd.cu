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
// What bounds it on the H100: the edge products, per edge cell H^2
// multiply-adds for K3 (the transposed product g_zf @ W_f^T, float32 FMA on
// the CUDA cores) and 2 H^2 for K8 (the recomputed zf = edge @ W_f as
// well, on the tensor cores as 3xTF32, common.cuh).
// Design: pass 1 runs one block per (fragment, centre atom i), one thread per
// channel, and writes the centre-indexed g_edge and g_wt; K8 first holds the
// centre's edge rows in shared memory ([A][H + 4], 42 KB at A = 40), the
// buffer that then holds zf and, in its place, g_zf.  K8's zf is
// mma_rows_times_cols, the product K1 stores zf with, so K8's g_zf and
// results equal K3's on K1's stash bitwise.  g_wsrc is source-indexed: the
// TPU kernel accumulated it across its sequential grid (:868-870,
// :887-889); here pass 2 runs one block per (fragment, source atom j) and
// sums g_df * adj * silu(zf) * wt_i over i in a fixed order.  K3's pass 2
// rebuilds that per-edge factor from the stored zf; K8's pass 1 writes it
// to scratch, as there is no zf to rebuild it from.  No float atomics:
// bitwise repeatable.  Rows go in chunks of 8 so that a chunk's loads are
// in flight together.

#include "common.cuh"

using namespace ai2bmd;

// dynamic shared memory of one centre-pass block: sG
static size_t upd_smem(int A, int H) { return (size_t)A * mma_ld(H) * sizeof(float); }

template <bool RC>
__global__ void __launch_bounds__(256) edge_bwd_upd_centre(
    const float* __restrict__ zf, const float* __restrict__ edge,
    const float* __restrict__ wf, const float* __restrict__ bf,
    const float* __restrict__ adj, const float* __restrict__ wt,
    const float* __restrict__ wsrc, const float* __restrict__ wfT,
    const float* __restrict__ gdf, float* __restrict__ gedge, float* __restrict__ gwt,
    float* __restrict__ gs_e, int A, int H, int S) {
  extern __shared__ __align__(16) float smem[];
  const int ld = mma_ld(H);
  float* sG = smem;  // [A][ld] g_zf (K8: the edge rows of i, then zf, first)
  const int t = threadIdx.x, i = blockIdx.x, b = blockIdx.y;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;

  if constexpr (RC) {
    // zf = edge @ W_f (+ b_f below), over the edge rows
    load_rows(sG, ld, edge + bi * A * H, A, H);
    mma_rows_times_cols(sG, ld, A, H, wf, H, 0, sG, ld);
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
    sG[r * ld + t] = g * sdot * dsilu(z);
  };
  // a runtime loop over chunks, which the compiler pipelines
  const float bft = RC ? bf[t] : 0.0f;
  for (int r0 = 0; r0 < A; r0 += RCHUNK) {
#pragma unroll
    for (int rr = 0; rr < RCHUNK; ++rr) {
      const int r = r0 + rr;
      row(r, RC ? sG[r * ld + t] + bft : zf[(bi * A + r) * H + t]);
    }
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gwt[(bi * S + c) * H + t] = gwti[c];
  __syncthreads();

  // g_edge = g_zf @ W_f^T
  float acc[1][MAXA];
  const int col[1] = {t};
  rows_times_cols_ld<1>(sG, ld, A, H, wfT, H, col, acc);
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
  const size_t smem = upd_smem(A, H);
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

// shared memory, blocks per SM, registers and spill bytes of the centre
// pass, K3 (rc = 0) or K8 (rc = 1)
extern "C" int edge_bwd_upd_occupancy(int A, int H, int rc, int* out) {
  return rc ? occupancy(edge_bwd_upd_centre<true>, H, upd_smem(A, H), out)
            : occupancy(edge_bwd_upd_centre<false>, H, upd_smem(A, H), out);
}
