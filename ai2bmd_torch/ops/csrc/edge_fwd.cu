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
// cell: arithmetic, not memory.  Since they run on the tensor cores as
// 3xTF32 (common.cuh), the bound is 165 TFLOP/s of float32 products; the
// weights (1.25 MB at H = 256) stream from L2 once per block, about 20
// FLOP per L2 byte at A = 40 and 8 at A = 16.  What holds it below the
// bound is feeding mma.sync (common.cuh), then the elementwise chains.
// Design: one block per (fragment, centre atom i), one thread per channel
// for the elementwise chains.  The block walks the centre's sources in
// chunks of at most ECHUNK = 48 rows (common.cuh), so a fragment (A <= 48)
// is one chunk and a whole molecule (A up to EDGE_MAXA) several.  Two
// [chunk][H + 4] buffers in shared memory (85 KB at A = 40, 102 KB for a
// chunk of 48, two blocks an SM): sE holds the chunk's edge rows and then
// v_ij, sP each product's output in turn.  The sums over sources (x_agg,
// vec_agg) are taken per chunk and added, chunk after chunk, to what the
// same thread wrote to the output for the chunks before: a fixed order, so
// the kernel stays bitwise repeatable without atomics, and at A <= 48 its
// arithmetic is the single-chunk kernel's, bit for bit.  No edge intermediate other than
// the stored pre-activations goes to device memory (as the TPU kernel kept
// them in VMEM).  Every product is mma_rows_times_cols (3xTF32 mma.sync,
// each warp owns 32 output channels, all warps share the rows in shared
// memory); the elementwise chains then read the product back one channel a
// thread, in order:  zf (update) -> df;  zk -> dk in sP;  zv written over
// the edge rows (the product syncs the block before it stores), then the
// attention message v_ij in its place;  z2 -> the d_sh half of vec_agg;
// z1 -> the vec half.  Rows go in runtime loops over chunks of 8 rows, the
// rows of a chunk unrolled, so a chunk's loads and warp reductions are in
// flight together while the code stays small (chains unrolled over all 48
// rows ran slower).  __launch_bounds__(256, 2) holds the
// kernel to 128 registers so two blocks share an SM.  The head pool is a
// shuffle sum over a head's lanes (head_sum<DH>, common.cuh), since a head
// of DH = 8, 16 or 32 channels is a quarter, half or all of a warp; a head
// of 64 channels adds its two warps' sums through shared memory between
// block barriers.  DH is a template parameter, chosen at launch from H / nh.
// All sums run in a fixed order: the kernel is bitwise repeatable, and K7
// and K8, which rebuild zdkv, zs and zf with the same product on the same
// rows, rebuild them bitwise.
// The TPU's 8-row centre tile and broadcast helpers were Mosaic
// workarounds and have no counterpart here; its 3-pass bf16 split becomes
// the 3-pass TF32 split, which keeps 3 more bits per pass.

#include "common.cuh"

using namespace ai2bmd;

// dynamic shared memory of one block: sE, sP, sDsh, sGate, sAdj for one
// chunk of min(A, ECHUNK) rows
static size_t fwd_smem(int A, int H, int S) {
  const int n = A < ECHUNK ? A : ECHUNK;
  return (size_t)(2 * n * mma_ld(H) + n * S + 2 * n) * sizeof(float);
}

template <bool UPDATE, bool STORE, int DH>
__global__ void __launch_bounds__(256, 2) edge_fwd_kernel(
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
  const int ld = mma_ld(H);
  const int CH = A < ECHUNK ? A : ECHUNK;  // rows of a chunk
  float* sE = smem;              // [CH][ld]  edge rows of the chunk, then zv, then v_ij
  float* sP = sE + CH * ld;      // [CH][ld]  zf, zk then dk, z2, z1
  float* sDsh = sP + CH * ld;    // [CH][S]
  float* sGate = sDsh + CH * S;  // [CH]     cutoff(r) * adj
  float* sAdj = sGate + CH;      // [CH]

  const int t = threadIdx.x;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;  // (fragment, centre) row

  // the sources in chunks of at most ECHUNK rows (one chunk at A <= 48);
  // each chunk's sums over j are added to the outputs' sums of the chunks
  // before it, which this thread wrote
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    const size_t e0 = bi * A + c0;         // the chunk's first edge row (b, i, c0)
    const size_t s0 = (size_t)b * A + c0;  // and its first source atom
    if (c0) __syncthreads();  // every thread is done with the last chunk's rows
    load_rows(sE, ld, edge + e0 * H, n, H);
    for (int x = t; x < n * S; x += blockDim.x) sDsh[x] = dsh[e0 * S + x];
    for (int r = t; r < n; r += blockDim.x) {
      const float a = adj[e0 + r];
      sAdj[r] = a;
      sGate[r] = cosine_cutoff(dist[e0 + r], cutoff) * a;
    }

    if (UPDATE) {
      // df = silu(edge @ W_f + b_f) * <wt_i, wsrc_j>_c * adj
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wf, H, 0, sP, ld);
      float wti[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) wti[c] = c < S ? wt[(bi * S + c) * H + t] : 0.0f;
      const float bft = bf[t];
      for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = r0 + rr;
          const float z = sP[r * ld + t] + bft;
          if (STORE) zf[(e0 + r) * H + t] = z;
          float sdot = 0.0f;
#pragma unroll
          for (int c = 0; c < MAXS; ++c)
            if (c < S) sdot = fmaf(wti[c], wsrc[((s0 + r) * S + c) * H + t], sdot);
          df[(e0 + r) * H + t] = silu(z) * sdot * sAdj[r];
        }
      }
    }

    // zdkv = edge @ W_dkv + b_dkv: dk = silu(zk) into sP, then zv over the
    // edge rows, which the attention loop overwrites with v_ij
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, 0, sP, ld);
    const float bk = bdkv[t], bv = bdkv[H + t];
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float zk = sP[r * ld + t] + bk;
        if (STORE) zdkv[(e0 + r) * H2 + t] = zk;
        sP[r * ld + t] = silu(zk);
      }
    }
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, H, sE, ld);

    // attention message; the head of channel t is t / DH, on the lanes of
    // thread t's warp that share it
    const float qi = q[bi * H + t];
    float xsum = 0.0f;
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float zv = sE[r * ld + t] + bv;
        if (STORE) zdkv[(e0 + r) * H2 + H + t] = zv;
        const float kr = k[(s0 + r) * H + t];
        const float vr = v[(s0 + r) * H + t];
        const float a = head_sum<DH>(qi * kr * sP[r * ld + t]);
        const float vij = vr * silu(zv) * (silu(a) * sGate[r]);
        sE[r * ld + t] = vij;
        xsum += vij;
      }
    }
    xagg[bi * H + t] = c0 ? xagg[bi * H + t] + xsum : xsum;

    // zs = v_ij @ W_s + b_s; s1|s2 = silu(zs) * adj, one half at a time:
    // vec_agg[c] = sum_j s1 * vec_j[c] + sum_j s2 * d_sh_ij[c]
    float from_vec[MAXS], from_dsh[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) from_vec[c] = from_dsh[c] = 0.0f;
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, H, sP, ld);
    const float b1 = bs[t], b2 = bs[H + t];
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float z2 = sP[r * ld + t] + b2;
        if (STORE) zs[(e0 + r) * H2 + H + t] = z2;
        const float s2 = silu(z2) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) from_dsh[c] = fmaf(s2, sDsh[r * S + c], from_dsh[c]);
      }
    }
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, 0, sP, ld);
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float z1 = sP[r * ld + t] + b1;
        if (STORE) zs[(e0 + r) * H2 + t] = z1;
        const float s1 = silu(z1) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) from_vec[c] = fmaf(s1, vec[((s0 + r) * S + c) * H + t], from_vec[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      if (c < S) {
        float* o = vecagg + (bi * S + c) * H + t;
        const float sum = from_vec[c] + from_dsh[c];
        *o = c0 ? *o + sum : sum;
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
                  int B, int A, int H, int S, float cutoff, int dh, cudaStream_t stream) {
  const size_t smem = fwd_smem(A, H, S);
  return with_head_width(dh, [&](auto d) {
    auto kern = edge_fwd_kernel<UPDATE, STORE, decltype(d)::value>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(A, B), H, smem, stream>>>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv,
                                          bdkv, ws, bs, wf, bf, xagg, vecagg, df, zdkv, zs, zf,
                                          A, H, S, cutoff);
    return (int)cudaGetLastError();
  });
}

extern "C" int edge_fwd_launch(const float* q, const float* k, const float* v, const float* vec,
                               const float* wt, const float* wsrc, const float* edge,
                               const float* dsh, const float* dist, const float* adj,
                               const float* wdkv, const float* bdkv, const float* ws,
                               const float* bs, const float* wf, const float* bf, float* xagg,
                               float* vecagg, float* df, float* zdkv, float* zs, float* zf,
                               int B, int A, int H, int S, float cutoff, int update, int store,
                               int dh, cudaStream_t stream) {
  if (A > EDGE_MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  if (update) {
    if (store)
      return launch<true, true>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws,
                                bs, wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff,
                                dh, stream);
    return launch<true, false>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs,
                               wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff,
                               dh, stream);
  }
  if (store)
    return launch<false, true>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs,
                               wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff,
                               dh, stream);
  return launch<false, false>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs,
                              wf, bf, xagg, vecagg, df, zdkv, zs, zf, B, A, H, S, cutoff, dh,
                              stream);
}

// shared memory, blocks per SM, registers and spill bytes of one flag pair
extern "C" int edge_fwd_occupancy(int A, int H, int S, int update, int store, int* out) {
  const size_t smem = fwd_smem(A, H, S);
  if (update)
    return store ? occupancy(edge_fwd_kernel<true, true, 32>, H, smem, out)
                 : occupancy(edge_fwd_kernel<true, false, 32>, H, smem, out);
  return store ? occupancy(edge_fwd_kernel<false, true, 32>, H, smem, out)
               : occupancy(edge_fwd_kernel<false, false, 32>, H, smem, out);
}

extern "C" const char* ai2bmd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
