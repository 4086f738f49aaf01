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
// is one chunk and a whole molecule (any A % 8 == 0) several.  Two
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
// Storage: float, or bfloat16 (this source compiled again with
// AI2BMD_STORE_BF16, common.cuh; edge_fwd_bf16_launch), the JAX kernels on
// bfloat16 refs (ops/vismp.py, edge_fwd_bf16_plain): every load widened,
// the arithmetic float but the cutoff chain, the outputs and the stash
// rounded at the store, the sums over the sources' chunks carried in float
// scratch.  The bytes halve; the products are the same passes.

#include "common.cuh"

using namespace ai2bmd;

// dynamic shared memory of one block: sE, sP, sDsh, sGate, sAdj for one
// chunk of min(A, ECHUNK) rows
static size_t fwd_smem(int A, int H, int S) {
  const int n = A < ECHUNK ? A : ECHUNK;
  return (size_t)(2 * n * mma_ld(H) + n * S + 2 * n) * sizeof(float);
}

// T is the storage type (common.cuh).  xacc, vacc hold the sums over the
// sources (x_agg, vec_agg) in float across the chunks: the outputs
// themselves for float, scratch for bfloat16, whose outputs xagg, vecagg
// each thread rounds from its own sums when its last chunk is done.
template <bool UPDATE, bool STORE, int DH, class T>
__global__ void __launch_bounds__(256, 2) edge_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ vec, const T* __restrict__ wt, const T* __restrict__ wsrc,
    const T* __restrict__ edge, const T* __restrict__ dsh,
    const T* __restrict__ dist, const T* __restrict__ adj,
    const T* __restrict__ wdkv, const T* __restrict__ bdkv,
    const T* __restrict__ ws, const T* __restrict__ bs,
    const T* __restrict__ wf, const T* __restrict__ bf,
    float* __restrict__ xacc, float* __restrict__ vacc, T* __restrict__ xagg,
    T* __restrict__ vecagg, T* __restrict__ df, T* __restrict__ zdkv, T* __restrict__ zs,
    T* __restrict__ zf, int A, int H, int S, float cutoff) {
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
    for (int x = t; x < n * S; x += blockDim.x) sDsh[x] = widen(dsh[e0 * S + x]);
    for (int r = t; r < n; r += blockDim.x) {
      const float a = widen(adj[e0 + r]);
      sAdj[r] = a;
      sGate[r] = cutoff_of<T>(widen(dist[e0 + r]), cutoff) * a;
    }

    if (UPDATE) {
      // df = silu(edge @ W_f + b_f) * <wt_i, wsrc_j>_c * adj
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wf, H, 0, sP, ld);
      float wti[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) wti[c] = c < S ? widen(wt[(bi * S + c) * H + t]) : 0.0f;
      const float bft = widen(bf[t]);
      for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = r0 + rr;
          const float z = sP[r * ld + t] + bft;
          if (STORE) zf[(e0 + r) * H + t] = st<T>(z);
          float sdot = 0.0f;
#pragma unroll
          for (int c = 0; c < MAXS; ++c)
            if (c < S) sdot = fmaf(wti[c], widen(wsrc[((s0 + r) * S + c) * H + t]), sdot);
          df[(e0 + r) * H + t] = st<T>(silu(z) * sdot * sAdj[r]);
        }
      }
    }

    // zdkv = edge @ W_dkv + b_dkv: dk = silu(zk) into sP, then zv over the
    // edge rows, which the attention loop overwrites with v_ij
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, 0, sP, ld);
    const float bk = widen(bdkv[t]), bv = widen(bdkv[H + t]);
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float zk = sP[r * ld + t] + bk;
        if (STORE) zdkv[(e0 + r) * H2 + t] = st<T>(zk);
        sP[r * ld + t] = silu(zk);
      }
    }
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, H, sE, ld);

    // attention message; the head of channel t is t / DH, on the lanes of
    // thread t's warp that share it
    const float qi = widen(q[bi * H + t]);
    float xsum = 0.0f;
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float zv = sE[r * ld + t] + bv;
        if (STORE) zdkv[(e0 + r) * H2 + H + t] = st<T>(zv);
        const float kr = widen(k[(s0 + r) * H + t]);
        const float vr = widen(v[(s0 + r) * H + t]);
        const float a = head_sum<DH>(qi * kr * sP[r * ld + t]);
        const float vij = vr * silu(zv) * (silu(a) * sGate[r]);
        sE[r * ld + t] = vij;
        xsum += vij;
      }
    }
    xacc[bi * H + t] = c0 ? xacc[bi * H + t] + xsum : xsum;

    // zs = v_ij @ W_s + b_s; s1|s2 = silu(zs) * adj, one half at a time:
    // vec_agg[c] = sum_j s1 * vec_j[c] + sum_j s2 * d_sh_ij[c]
    float from_vec[MAXS], from_dsh[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) from_vec[c] = from_dsh[c] = 0.0f;
    mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, H, sP, ld);
    const float b1 = widen(bs[t]), b2 = widen(bs[H + t]);
    for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = r0 + rr;
        const float z2 = sP[r * ld + t] + b2;
        if (STORE) zs[(e0 + r) * H2 + H + t] = st<T>(z2);
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
        if (STORE) zs[(e0 + r) * H2 + t] = st<T>(z1);
        const float s1 = silu(z1) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S)
            from_vec[c] = fmaf(s1, widen(vec[((s0 + r) * S + c) * H + t]), from_vec[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      if (c < S) {
        float* o = vacc + (bi * S + c) * H + t;
        const float sum = from_vec[c] + from_dsh[c];
        *o = c0 ? *o + sum : sum;
      }
    }
  }
  if constexpr (IS_BF16<T>) {
    xagg[bi * H + t] = st<T>(xacc[bi * H + t]);
    for (int c = 0; c < S; ++c) vecagg[(bi * S + c) * H + t] = st<T>(vacc[(bi * S + c) * H + t]);
  }
}

// The wide instantiation (common.cuh: every H and every head count that
// divides it): the same chains, a thread looping over its channels in each
// pass, each product (mma_tiles) over k-tiles of its rows staged in sX, the
// head sums from the same tiles (block_head_sums).  A chunk's rows live in
// the block's slot of the scratch `wrk` (wide_scratch kind 0): P [CH][Hp],
// each product's output (zf; zk, then the head terms; zv; z2; z1), E
// [CH][Hp], the messages v_ij (read as 0 past H), sA [CH][nh], a_ij.
// The sums over the sources go to the outputs chunk after chunk as in the
// narrow kernel; vec_agg takes the d_sh half and then the vec half.
template <bool UPDATE, bool STORE, class T>
__global__ void __launch_bounds__(256, 2) edge_fwd_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ vec, const T* __restrict__ wt, const T* __restrict__ wsrc,
    const T* __restrict__ edge, const T* __restrict__ dsh,
    const T* __restrict__ dist, const T* __restrict__ adj,
    const T* __restrict__ wdkv, const T* __restrict__ bdkv,
    const T* __restrict__ ws, const T* __restrict__ bs,
    const T* __restrict__ wf, const T* __restrict__ bf,
    float* __restrict__ xacc, float* __restrict__ vacc, T* __restrict__ xagg,
    T* __restrict__ vecagg, T* __restrict__ df, T* __restrict__ zdkv, T* __restrict__ zs,
    T* __restrict__ zf, float* wrk, int A, int H, int S, int nh, float cutoff) {
  __shared__ __align__(16) float sX[ECHUNK * XTILE_LD];  // a k-tile of a chunk's rows
  __shared__ float sDsh[ECHUNK * MAXS], sGate[ECHUNK], sAdj[ECHUNK];  // d_sh, cutoff(r) adj, adj
  const int Hp = wide_width(H), DH = H / nh, CH = A < ECHUNK ? A : ECHUNK;
  float* P = wrk + block_slot() * wide_scratch(0, A, H, nh);
  float* E = P + (size_t)CH * Hp;
  float* sA = E + (size_t)CH * Hp;

  const int t = threadIdx.x, TB = blockDim.x;
  const int i = blockIdx.x, b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;

  for (int c0 = 0; c0 < A; c0 += CH) {
    const int n = A - c0 < CH ? A - c0 : CH;
    const size_t e0 = bi * A + c0;
    const size_t s0 = (size_t)b * A + c0;
    const T* rows = edge + e0 * H;  // the chunk's edge rows
    if (c0) __syncthreads();  // every thread is done with the last chunk's rows
    for (int x = t; x < n * S; x += TB) sDsh[x] = widen(dsh[e0 * S + x]);
    for (int r = t; r < n; r += TB) {
      const float a = widen(adj[e0 + r]);
      sAdj[r] = a;
      sGate[r] = cutoff_of<T>(widen(dist[e0 + r]), cutoff) * a;
    }

    if (UPDATE) {
      // df = silu(edge @ W_f + b_f) * <wt_i, wsrc_j>_c * adj
      mma_tiles(sX, rows, H, H, n, Hp, wf, Hp, 0, Hp, P, Hp, Hp);
      for (int ch = t; ch < H; ch += TB) {
        float wti[MAXS];
#pragma unroll
        for (int c = 0; c < MAXS; ++c) wti[c] = c < S ? widen(wt[(bi * S + c) * H + ch]) : 0.0f;
        const float bft = widen(bf[ch]);
        for (int r = 0; r < n; ++r) {
          const float z = P[r * Hp + ch] + bft;
          if (STORE) zf[(e0 + r) * H + ch] = st<T>(z);
          float sdot = 0.0f;
#pragma unroll
          for (int c = 0; c < MAXS; ++c)
            if (c < S) sdot = fmaf(wti[c], widen(wsrc[((s0 + r) * S + c) * H + ch]), sdot);
          df[(e0 + r) * H + ch] = st<T>(silu(z) * sdot * sAdj[r]);
        }
      }
    }

    // zk = edge @ W_dkv[:, :H] + b_k into P, replaced by the head terms
    // q_i k_j dk, summed by head into sA
    mma_tiles(sX, rows, H, H, n, Hp, wdkv, 2 * Hp, 0, Hp, P, Hp, Hp);
    for (int ch = t; ch < H; ch += TB) {
      const float qi = widen(q[bi * H + ch]), bk = widen(bdkv[ch]);
      for (int r = 0; r < n; ++r) {
        const float zk = P[r * Hp + ch] + bk;
        if (STORE) zdkv[(e0 + r) * H2 + ch] = st<T>(zk);
        P[r * Hp + ch] = head_term(qi, widen(k[(s0 + r) * H + ch]), zk);
      }
    }
    block_head_sums(sX, P, Hp, n, H, nh, DH, sA);

    // zv = edge @ W_dkv[:, H:] + b_v into P; the message v_ij into E, x_agg
    // its sum
    mma_tiles(sX, rows, H, H, n, Hp, wdkv, 2 * Hp, Hp, Hp, P, Hp, Hp);
    for (int ch = t; ch < H; ch += TB) {
      const float bv = widen(bdkv[H + ch]);
      float xsum = 0.0f;
      for (int r = 0; r < n; ++r) {
        const float zv = P[r * Hp + ch] + bv;
        if (STORE) zdkv[(e0 + r) * H2 + H + ch] = st<T>(zv);
        const float vij = edge_message(widen(v[(s0 + r) * H + ch]), zv, sA[r * nh + ch / DH],
                                       sGate[r]);
        E[r * Hp + ch] = vij;
        xsum += vij;
      }
      xacc[bi * H + ch] = c0 ? xacc[bi * H + ch] + xsum : xsum;
    }

    // zs = v_ij @ W_s + b_s; s1|s2 = silu(zs) * adj, the d_sh half first:
    // vec_agg[c] += sum_j s2 * d_sh_ij[c], then += sum_j s1 * vec_j[c]
    mma_tiles(sX, E, Hp, H, n, Hp, ws, 2 * Hp, Hp, Hp, P, Hp, Hp);
    for (int ch = t; ch < H; ch += TB) {
      const float b2 = widen(bs[H + ch]);
      float sum[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) sum[c] = 0.0f;
      for (int r = 0; r < n; ++r) {
        const float z2 = P[r * Hp + ch] + b2;
        if (STORE) zs[(e0 + r) * H2 + H + ch] = st<T>(z2);
        const float s2 = silu(z2) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) sum[c] = fmaf(s2, sDsh[r * S + c], sum[c]);
      }
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          float* o = vacc + (bi * S + c) * H + ch;
          *o = c0 ? *o + sum[c] : sum[c];
        }
      }
    }
    mma_tiles(sX, E, Hp, H, n, Hp, ws, 2 * Hp, 0, Hp, P, Hp, Hp);
    for (int ch = t; ch < H; ch += TB) {
      const float b1 = widen(bs[ch]);
      float sum[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) sum[c] = 0.0f;
      for (int r = 0; r < n; ++r) {
        const float z1 = P[r * Hp + ch] + b1;
        if (STORE) zs[(e0 + r) * H2 + ch] = st<T>(z1);
        const float s1 = silu(z1) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) sum[c] = fmaf(s1, widen(vec[((s0 + r) * S + c) * H + ch]), sum[c]);
      }
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) vacc[(bi * S + c) * H + ch] += sum[c];
    }
  }
  if constexpr (IS_BF16<T>) {
    for (int ch = t; ch < H; ch += TB) {
      xagg[bi * H + ch] = st<T>(xacc[bi * H + ch]);
      for (int c = 0; c < S; ++c)
        vecagg[(bi * S + c) * H + ch] = st<T>(vacc[(bi * S + c) * H + ch]);
    }
  }
}

// The launchers take the library's storage type, EdgeT (common.cuh); xacc,
// vacc: the float sums over the sources (the outputs themselves for float).
template <bool UPDATE, bool STORE>
int launch(const EdgeT* q, const EdgeT* k, const EdgeT* v, const EdgeT* vec,
           const EdgeT* wt, const EdgeT* wsrc, const EdgeT* edge, const EdgeT* dsh,
           const EdgeT* dist, const EdgeT* adj, const EdgeT* wdkv, const EdgeT* bdkv,
           const EdgeT* ws, const EdgeT* bs, const EdgeT* wf, const EdgeT* bf,
           float* xacc, float* vacc, EdgeT* xagg, EdgeT* vecagg, EdgeT* df, EdgeT* zdkv,
           EdgeT* zs, EdgeT* zf, float* wrk, int B, int A, int H, int S, float cutoff,
           int dh, cudaStream_t stream) {
  if (!narrow_shapes(H, H / dh)) {
    if (wrk == nullptr) return (int)cudaErrorInvalidValue;
    edge_fwd_wide<UPDATE, STORE, EdgeT><<<dim3(A, B), wide_threads(H), 0, stream>>>(
        q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs, wf, bf, xacc, vacc,
        xagg, vecagg, df, zdkv, zs, zf, wrk, A, H, S, H / dh, cutoff);
    return (int)cudaGetLastError();
  }
  const size_t smem = fwd_smem(A, H, S);
  return with_head_width(dh, [&](auto d) {
    auto kern = edge_fwd_kernel<UPDATE, STORE, decltype(d)::value, EdgeT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(A, B), H, smem, stream>>>(q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv,
                                          bdkv, ws, bs, wf, bf, xacc, vacc, xagg, vecagg, df,
                                          zdkv, zs, zf, A, H, S, cutoff);
    return (int)cudaGetLastError();
  });
}

#ifndef AI2BMD_STORE_BF16
// shared memory, blocks per SM, registers and spill bytes of one flag
// pair's narrow kernel (heads of 32 channels, A slots) or wide one (H
// channels; its shared memory is static)
template <bool UPDATE>
int fwd_occupancy(bool wide, bool store, int A, int H, int S, int* out) {
  if (wide) {
    const int T = wide_threads(H);
    return store ? occupancy(edge_fwd_wide<UPDATE, true, float>, T, 0, out)
                 : occupancy(edge_fwd_wide<UPDATE, false, float>, T, 0, out);
  }
  const size_t smem = fwd_smem(A, H, S);
  return store ? occupancy(edge_fwd_kernel<UPDATE, true, 32, float>, H, smem, out)
               : occupancy(edge_fwd_kernel<UPDATE, false, 32, float>, H, smem, out);
}
#endif

// The narrow kernels take heads of 8, 16, 32 or 64 channels with H a
// multiple of 32 up to 256; the wide kernel every other H whose head count
// divides it, with its weights zero-padded to wide_width(H) a half (W_dkv
// [Hp][2 Hp], W_s [Hp][2 Hp], W_f [Hp][Hp]; the biases and every other
// tensor as they are) and the float scratch wrk of B A edge_wide_scratch(0,
// A, H, H / dh) floats (null for the narrow kernels).  edge_fwd_launch
// takes float, edge_fwd_bf16_launch bfloat16 and, after the outputs, the
// float scratch xacc [B][A][H] and vacc [B][A][S][H] for the sums over the
// sources.
extern "C" int AI2BMD_ENTRY(edge_fwd)(
    const EdgeT* q, const EdgeT* k, const EdgeT* v, const EdgeT* vec, const EdgeT* wt,
    const EdgeT* wsrc, const EdgeT* edge, const EdgeT* dsh, const EdgeT* dist, const EdgeT* adj,
    const EdgeT* wdkv, const EdgeT* bdkv, const EdgeT* ws, const EdgeT* bs, const EdgeT* wf,
    const EdgeT* bf, EdgeT* xagg, EdgeT* vecagg, EdgeT* df, EdgeT* zdkv, EdgeT* zs, EdgeT* zf,
#ifdef AI2BMD_STORE_BF16
    float* xacc, float* vacc,
#endif
    float* wrk, int B, int A, int H, int S, float cutoff, int update, int store, int dh,
    cudaStream_t stream) {
#ifndef AI2BMD_STORE_BF16
  float* xacc = xagg;  // float sums straight into the outputs
  float* vacc = vecagg;
  xagg = vecagg = nullptr;
#endif
  if (A <= 0 || A % RCHUNK || S > MAXS || H <= 0 || dh <= 0 || H % dh)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto u, auto s) {
    return launch<decltype(u)::value, decltype(s)::value>(
        q, k, v, vec, wt, wsrc, edge, dsh, dist, adj, wdkv, bdkv, ws, bs, wf, bf, xacc, vacc,
        xagg, vecagg, df, zdkv, zs, zf, wrk, B, A, H, S, cutoff, dh, stream);
  };
  using Y = std::true_type;
  using N = std::false_type;
  if (update) return store ? run(Y{}, Y{}) : run(Y{}, N{});
  return store ? run(N{}, Y{}) : run(N{}, N{});
}

#ifndef AI2BMD_STORE_BF16
// shared memory, blocks per SM, registers and spill bytes of one flag pair
extern "C" int edge_fwd_occupancy(int A, int H, int S, int update, int store, int* out) {
  return update ? fwd_occupancy<true>(false, store, A, H, S, out)
                : fwd_occupancy<false>(false, store, A, H, S, out);
}

// the same for the wide instantiation at H channels and nh heads (its shared
// memory is static: no H or nh changes it); out[4] receives the rows of its
// source chunk, out[5] the columns of its k-tiles
extern "C" int edge_fwd_wide_occupancy(int H, int S, int nh, int update, int store, int* out) {
  (void)nh;
  out[4] = ECHUNK;
  out[5] = XTILE;
  return update ? fwd_occupancy<true>(true, store, 0, H, S, out)
                : fwd_occupancy<false>(true, store, 0, H, S, out);
}

// Floats of scratch one block of a wide kernel takes: kind 0 K1, kind 1
// K2/K7 (wide_scratch, common.cuh); the wrappers allocate B A of them.
extern "C" long long edge_wide_scratch(int kind, int A, int H, int nh) {
  return (long long)wide_scratch(kind, A, H, nh);
}

extern "C" const char* ai2bmd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
