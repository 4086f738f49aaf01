// K1 edge_fwd: the ViS-MP edge core forward, with the edge update and the
// stored pre-activations as compile-time options.
//
// Replaces the four Pallas forward kernels of ai2bmd_tpu/ops/pallas/vismp.py:
//   _kernel_full_res (:153)  update on,  store on   (layers 1-8, forces)
//   _kernel_res      (:142)  update off, store on   (last layer, forces)
//   _kernel_full     (:100)  update on,  store off  (energy only)
//   _kernel          (:133)  update off, store off  (energy only)
// all of which run _edge_core (:182):
//   zdkv = edge @ W_dkv + b_dkv, dk|dv = silu(zdkv)
//   attn = silu(sum_head(q_i * k_j * dk)) * cutoff(r_ij) * adj_ij
//   v_ij = v_j * dv * attn
//   zs = v_ij @ W_s + b_s, s1|s2 = silu(zs) * adj_ij
//   x_agg_i = sum_j v_ij,  vec_agg_i[c] = sum_j s1 * vec_j[c] + sum_j s2 * d_sh_ij[c]
// and, with the update,  zf = edge @ W_f + b_f,
//   df_ij = silu(zf) * sum_c wt_i[c] * wsrc_j[c] * adj_ij.
//
// What bounds it on the H100: the three edge products, 5 H^2 multiply-adds
// per edge cell (0.66 MFLOP at H = 256), against a few KB of traffic per
// cell: it is bound by float32 arithmetic on the CUDA cores, not by memory.
// Design: one block per (fragment, centre atom i) with one thread per
// channel; the block keeps the centre's A edge rows and its v_ij rows in
// shared memory, so no edge intermediate other than the stored
// pre-activations goes to device memory (as the TPU kernel kept them in
// VMEM).  The products are plain float32 FMAs on the CUDA cores (no TF32,
// no tensor cores): each thread accumulates one output column for all A
// rows in registers while the block streams the weight rows from L2, one
// k-step ahead.  Rows go in chunks of 8 with one guard per chunk, so a
// chunk's loads and warp reductions are in flight together.  The head pool
// is a warp-shuffle sum, since one head (32 channels) is one warp.
// All sums run in a fixed order: the kernel is bitwise repeatable.
// The TPU's 8-row centre tile, the broadcast helpers and the 3-pass bf16
// split were Mosaic workarounds and have no counterpart here.

#include "common.cuh"

using namespace ai2bmd;

template <bool UPDATE, bool STORE>
__global__ void __launch_bounds__(256) edge_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ vec, const float* __restrict__ wt, const float* __restrict__ wsrc,
    const float* __restrict__ edge, const float* __restrict__ dsh,
    const float* __restrict__ dist, const float* __restrict__ adj,
    const float* __restrict__ wdkv, const float* __restrict__ bdkv,
    const float* __restrict__ ws, const float* __restrict__ bs,
    const float* __restrict__ wf, const float* __restrict__ bf,
    float* __restrict__ xagg, float* __restrict__ vecagg, float* __restrict__ df,
    float* __restrict__ zdkv, float* __restrict__ zs, float* __restrict__ zf,
    int A, int H, int S, float cutoff) {
  extern __shared__ __align__(16) float smem[];
  float* sE = smem;              // [A][H]  edge rows of centre i
  float* sV = sE + A * H;        // [A][H]  v_ij
  float* sDsh = sV + A * H;      // [A][S]
  float* sGate = sDsh + A * S;   // [A]     cutoff(r) * adj
  float* sAdj = sGate + A;       // [A]

  const int t = threadIdx.x;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;  // (fragment, centre) row
  const size_t b0 = (size_t)b * A;      // first atom of the fragment

  const float4* E4 = reinterpret_cast<const float4*>(edge + bi * A * H);
  for (int x = t; x < A * H / 4; x += blockDim.x) reinterpret_cast<float4*>(sE)[x] = E4[x];
  for (int x = t; x < A * S; x += blockDim.x) sDsh[x] = dsh[bi * A * S + x];
  for (int r = t; r < A; r += blockDim.x) {
    const float a = adj[bi * A + r];
    sAdj[r] = a;
    sGate[r] = cosine_cutoff(dist[bi * A + r], cutoff) * a;
  }
  __syncthreads();

  // One output column per product pass keeps a single row of accumulators
  // in registers, so two blocks fit on an SM.
  float acc[1][MAXA];
  const int col_lo[1] = {t}, col_hi[1] = {H + t};

  // zdkv = edge @ W_dkv + b_dkv.  dv = silu(zdkv[H + t]) waits in sV until
  // the attention loop overwrites it with v_ij; dk = silu(zdkv[t]) stays in
  // registers.
  rows_times_cols<1>(sE, A, H, wdkv, H2, col_hi, acc);
  const float bk = bdkv[t], bv = bdkv[H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float zv = acc[0][r] + bv;
        if (STORE) zdkv[(bi * A + r) * H2 + H + t] = zv;
        sV[r * H + t] = silu(zv);
      }
    }
  }
  rows_times_cols<1>(sE, A, H, wdkv, H2, col_lo, acc);
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float zk = acc[0][r] + bk;
        if (STORE) zdkv[(bi * A + r) * H2 + t] = zk;
        acc[0][r] = silu(zk);
      }
    }
  }

  // attention message; the head of channel t is the warp of thread t
  const float qi = q[bi * H + t];
  float xsum = 0.0f;
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float kr = k[(b0 + r) * H + t];
        const float vr = v[(b0 + r) * H + t];
        const float a = warp_sum(qi * kr * acc[0][r]);
        const float vij = vr * sV[r * H + t] * (silu(a) * sGate[r]);
        sV[r * H + t] = vij;
        xsum += vij;
      }
    }
  }
  xagg[bi * H + t] = xsum;
  __syncthreads();

  // zs = v_ij @ W_s + b_s; s1|s2 = silu(zs) * adj, one half at a time:
  // vec_agg[c] = sum_j s1 * vec_j[c] + sum_j s2 * d_sh_ij[c]
  float from_vec[MAXS], from_dsh[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) from_vec[c] = from_dsh[c] = 0.0f;
  rows_times_cols<1>(sV, A, H, ws, H2, col_hi, acc);
  const float b1 = bs[t], b2 = bs[H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float z2 = acc[0][r] + b2;
        if (STORE) zs[(bi * A + r) * H2 + H + t] = z2;
        const float s2 = silu(z2) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) from_dsh[c] = fmaf(s2, sDsh[r * S + c], from_dsh[c]);
      }
    }
  }
  rows_times_cols<1>(sV, A, H, ws, H2, col_lo, acc);
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float z1 = acc[0][r] + b1;
        if (STORE) zs[(bi * A + r) * H2 + t] = z1;
        const float s1 = silu(z1) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) from_vec[c] = fmaf(s1, vec[((b0 + r) * S + c) * H + t], from_vec[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) vecagg[(bi * S + c) * H + t] = from_vec[c] + from_dsh[c];

  if (UPDATE) {
    // df = silu(edge @ W_f + b_f) * <wt_i, wsrc_j>_c * adj
    float wti[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) wti[c] = c < S ? wt[(bi * S + c) * H + t] : 0.0f;
    rows_times_cols<1>(sE, A, H, wf, H, col_lo, acc);
    const float bft = bf[t];
#pragma unroll
    for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          const float z = acc[0][r] + bft;
          if (STORE) zf[(bi * A + r) * H + t] = z;
          float sdot = 0.0f;
#pragma unroll
          for (int c = 0; c < MAXS; ++c)
            if (c < S) sdot = fmaf(wti[c], wsrc[((b0 + r) * S + c) * H + t], sdot);
          df[(bi * A + r) * H + t] = silu(z) * sdot * sAdj[r];
        }
      }
    }
  }
}

template <bool UPDATE, bool STORE>
static int launch(const float* q, const float* k, const float* v, const float* vec,
                  const float* wt, const float* wsrc, const float* edge, const float* dsh,
                  const float* dist, const float* adj, const float* wdkv, const float* bdkv,
                  const float* ws, const float* bs, const float* wf, const float* bf,
                  float* xagg, float* vecagg, float* df, float* zdkv, float* zs, float* zf,
                  int B, int A, int H, int S, float cutoff, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * A * H + A * S + 2 * A) * sizeof(float);
  auto kern = edge_fwd_kernel<UPDATE, STORE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(A, B), H, smem, stream>>>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv,
                                        bdkv, ws, bs, wf, bf, xagg, vecagg, df, zdkv, zs, zf,
                                        A, H, S, cutoff);
  return (int)cudaGetLastError();
}

extern "C" int edge_fwd_launch(const float* q, const float* k, const float* v, const float* vec,
                               const float* wt, const float* wsrc, const float* edge,
                               const float* dsh, const float* dist, const float* adj,
                               const float* wdkv, const float* bdkv, const float* ws,
                               const float* bs, const float* wf, const float* bf, float* xagg,
                               float* vecagg, float* df, float* zdkv, float* zs, float* zf,
                               int B, int A, int H, int S, float cutoff, int update, int store,
                               cudaStream_t stream) {
  if (A > MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  if (update) {
    if (store)
      return launch<true, true>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws,
                                bs, wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff,
                                stream);
    return launch<true, false>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs,
                               wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff,
                               stream);
  }
  if (store)
    return launch<false, true>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs,
                               wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff,
                               stream);
  return launch<false, false>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs,
                              wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff, stream);
}

extern "C" const char* ai2bmd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
