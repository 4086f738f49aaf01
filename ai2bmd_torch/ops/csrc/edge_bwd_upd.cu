// K3 edge_bwd_upd and K8 edge_bwd_upd_rc: backward of the edge update
//   df_ij = silu(zf_ij) * sum_c wt_i[c] * wsrc_j[c] * adj_ij,  zf = edge @ W_f + b_f.
// Outputs g_edge (added in place into the message path's g_edge, which K2 /
// K7 wrote: the buffer is read and updated, not replaced), g_wt and g_wsrc.
// One set of kernels, a template on RC:
//
//   RC = false, K3: from the pre-activation zf that K1 stores with `store`.
//     Replaces _bwd_upd_kernel_sa (ai2bmd_tpu/ops/pallas/vismp.py:852),
//     launched by _bwd_upd_call_sa (:951).
//   RC = true, K8: recompute mode, zf rebuilt from the edge rows inside the
//     kernel.  Replaces _bwd_upd_kernel (:714), launched by _bwd_upd_call's
//     pallas_call (:1086).
//
// What bounds it on the H100: per edge cell, H^2 multiply-adds for K3 (the
// transposed product g_zf @ W_f^T) and 2 H^2 for K8 (the recomputed
// zf = edge @ W_f as well), all on the tensor cores as 3xTF32 (common.cuh,
// 165 TFLOP/s in float32 products), against ~7 H floats moved per edge cell
// (zf or the edge row, g_df, and g_edge read and written).  At H = 256 the
// products take about half the time of the bytes, so the bound is bytes.
// What holds the kernels above it: the elementwise work of the centre and
// source passes, which read every source atom's wsrc / wt rows again for
// each edge cell (S H floats, from L2) and move the [B,A,A,H] tensors at
// about a third of the memory rate; and K8's zf product, which the helper
// takes at its own rate.
//
// Design.  Centre pass: it builds g_zf = g_df * adj * <wt_i, wsrc_j> *
// silu'(zf) for each centre's A edge rows, writes it to scratch and sums
// g_wt over the rows.  K3 runs 256 threads a block as 256 / width(H) centre
// atoms x width(H) channels (Group), so that a block's warps share each
// source atom's wsrc row in L1.  K8 runs one block per (fragment, centre
// atom i), a thread per channel: it holds the edge rows in shared memory
// ([chunk][H + 4], 42 KB at A = 40) and takes zf there with
// mma_rows_times_cols, the product K1 stores zf with.  Both walk the
// sources in chunks of at most ECHUNK = 48 rows (common.cuh; a fragment is
// one chunk, a whole molecule several) and add each chunk's g_wt sums to
// what the same thread wrote for the chunks before, so K8's g_zf and every
// result equal K3's on K1's stash bitwise, at any A.  The g_edge product
// g_zf @ W_f^T has no coupling between centres, so the row tile
// (`row_tile` in common.cuh, which K5 and K6 share) adds it into g_edge
// over the flattened edge rows, 128 rows x 64 output channels a block:
// W_f's k-slabs are copied to shared memory as stored
// with cp.async (double-buffered, with the g_zf slabs), split into hi / lo
// once per block, and read by all 8 warps with ldmatrix, so 128 rows share
// each split; the column blocks (4 at H = 256) keep small batches' grids
// from starving the card.  (Taking the product inside each centre block with
// mma_rows_times_cols, each block fetching and splitting every W fragment
// for its own <= 48 rows, was slower at every K3 shape on the H100.)
// g_wsrc is source-indexed: the TPU kernel accumulated it across its
// sequential grid (:868-870, :887-889); here the source pass runs one block
// per (fragment, source atom j) and sums g_df * adj * silu(zf) * wt_i over i
// in a fixed order.  K3's source pass rebuilds that per-edge factor from the
// stored zf; K8's centre pass writes it to scratch, as there is no zf to
// rebuild it from.  No float atomics: bitwise repeatable.
// Storage: float, or bfloat16 (this source compiled again with
// AI2BMD_STORE_BF16, common.cuh; the *_bf16_launch entry points), the JAX
// kernels on bfloat16 refs (ops/vismp.py, edge_bwd_upd_bf16_plain): K3
// rounds as they do on its bfloat16 zf, the g_edge product rounds before
// it is added into the bfloat16 g_edge, g_wsrc sums the centres in blocks
// of I_TILE; in bfloat16 K8 does not equal K3 on K1's stash.

#include "common.cuh"

using namespace ai2bmd;

// dynamic shared memory of one centre-pass block: K8's rows for zf, one
// chunk of min(A, ECHUNK)
static size_t upd_smem(int A, int H, bool rc) {
  const int n = A < ECHUNK ? A : ECHUNK;
  return rc ? (size_t)n * mma_ld(H) * sizeof(float) : 0;
}

// K3's centre pass, which has no block-wide product, runs 256 threads a
// block as 256 / width(H) centre atoms x width(H) channels, so that a
// block's warps can share each source atom's wsrc row in L1 (per edge cell
// S H floats, several times the bytes of g_df and zf).  On the H100 it ran
// 20-35% faster so than one centre a block; the source passes gained
// nothing from it.
__host__ __device__ constexpr int group_width(int H) { return H % 64 ? 32 : 64; }
struct Group {
  int atom, ch;  // this thread's atom of the fragment and channel
  __device__ Group(int H) {
    const int w = group_width(H), slices = H / w;
    atom = (blockIdx.x / slices) * (256 / w) + threadIdx.x / w;
    ch = (blockIdx.x % slices) * w + threadIdx.x % w;
  }
};
static dim3 group_grid(int A, int B, int H) { return dim3(A * H / 256, B); }

// T is the storage type (common.cuh).  K3 in bfloat16 reads a bfloat16
// zf: silu, silu' and the products of two bfloat16 values round as the JAX
// kernel's do (silu_st, dsilu_st, rnd_st; ops/vismp.py,
// edge_bwd_upd_bf16_plain); K8 recomputes zf in float32.  gwt_acc holds
// g_wt's float sums across the chunks (the output itself for float).
template <bool RC, class T>
__global__ void __launch_bounds__(256, 2) edge_bwd_upd_centre(
    const T* __restrict__ zf, const T* __restrict__ edge,
    const T* __restrict__ wf, const T* __restrict__ bf,
    const T* __restrict__ adj, const T* __restrict__ wt,
    const T* __restrict__ wsrc, const T* __restrict__ gdf, float* __restrict__ gwt_acc,
    T* __restrict__ gwt, float* __restrict__ gs_e, float* __restrict__ gz, int A, int H,
    int S) {
  constexpr bool B16 = IS_BF16<T> && !RC;
  extern __shared__ __align__(16) float smem[];
  const int ld = mma_ld(H);
  float* sG = smem;  // [chunk][ld]: K8's edge rows of the chunk, then zf
  // K3: centre atoms grouped (Group); K8: one block per centre atom, a
  // thread per channel
  const Group grp(H);
  const int t = RC ? threadIdx.x : grp.ch, i = RC ? blockIdx.x : grp.atom;
  const int b = blockIdx.y;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;
  // the centre's edge cells (b, i, r): channel t of row r at [r * H]
  const size_t cell = bi * A * H + t;
  const T* adj_i = adj + bi * A;
  const T* ws = wsrc + b0 * S * H + t;  // wsrc_r[c] at [(r S + c) H]

  // the sources in chunks of at most ECHUNK rows (one chunk at A <= 48),
  // in both kernels, so that K8's g_wt sums equal K3's: each chunk's sums
  // over j are added to what this thread wrote for the chunks before
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    if constexpr (RC) {
      // zf = edge @ W_f (+ b_f below), over the chunk's edge rows
      if (c0) __syncthreads();  // every thread is done with the last chunk's zf
      load_rows(sG, ld, edge + (bi * A + c0) * H, n, H);
      mma_rows_times_cols<ECHUNK>(sG, ld, n, H, wf, H, 0, sG, ld);
    }

    float wti[MAXS], gwti[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      wti[c] = c < S ? widen(wt[(bi * S + c) * H + t]) : 0.0f;
      gwti[c] = 0.0f;
    }
    // one edge row r with its pre-activation z: g_zf to scratch, the g_wt sums
    auto row = [&](int r, float z) {
      float wsr[MAXS];
      float sdot = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        wsr[c] = c < S ? widen(ws[(r * S + c) * H]) : 0.0f;
        sdot = fmaf(wti[c], wsr[c], sdot);
      }
      const float g = widen(gdf[cell + r * H]) * widen(adj_i[r]);
      const float g_s = rnd_st<B16>(g * silu_st<B16>(z));
      if constexpr (RC) gs_e[cell + r * H] = g_s;
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        gwti[c] = B16 ? gwti[c] + rnd_st<B16>(g_s * wsr[c]) : fmaf(g_s, wsr[c], gwti[c]);
      gz[cell + r * H] = g * sdot * dsilu_st<B16>(z);
    };
    // a runtime loop over chunks of 4 rows (8 would spill under the
    // two-blocks bound), which the compiler pipelines
    constexpr int RU = RCHUNK / 2;
    const float bft = RC ? widen(bf[t]) : 0.0f;
    for (int r0 = c0; r0 < c0 + n; r0 += RU) {
#pragma unroll
      for (int rr = 0; rr < RU; ++rr) {
        const int r = r0 + rr;
        row(r, RC ? sG[(r - c0) * ld + t] + bft : widen(zf[cell + r * H]));
      }
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      if (c < S) {
        float* o = gwt_acc + (bi * S + c) * H + t;
        *o = c0 ? *o + gwti[c] : gwti[c];
      }
    }
  }
  if constexpr (IS_BF16<T>)
    for (int c = 0; c < S; ++c) gwt[(bi * S + c) * H + t] = st<T>(gwt_acc[(bi * S + c) * H + t]);
}

// The wide centre pass (common.cuh: every H), K3 and K8 alike: one block
// per (fragment, centre atom i) of wide_threads(H) threads, each looping
// over its channels; the sources in chunks of ECHUNK rows.  g_zf goes to a
// scratch of Hp columns (zeros past H), which the row tile reads with W_f
// zero-padded to [Hp][Hp].  K8 takes zf = edge @ W_f with mma_tiles over
// k-tiles of the chunk's edge rows, the product K1's wide instantiation
// stores zf with, straight into that scratch, where each thread then reads
// its zf and writes its g_zf in its place.
template <bool RC, class T>
__global__ void __launch_bounds__(256, 2) edge_bwd_upd_wide(
    const T* __restrict__ zf, const T* __restrict__ edge,
    const T* __restrict__ wf, const T* __restrict__ bf,
    const T* __restrict__ adj, const T* __restrict__ wt,
    const T* __restrict__ wsrc, const T* __restrict__ gdf, float* __restrict__ gwt_acc,
    T* __restrict__ gwt, float* __restrict__ gs_e, float* __restrict__ gz, int A, int H,
    int S) {
  constexpr bool B16 = IS_BF16<T> && !RC;
  const int Hp = wide_width(H), CH = A < ECHUNK ? A : ECHUNK;
  const int t = threadIdx.x, TB = blockDim.x;
  const int i = blockIdx.x, b = blockIdx.y;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;
  const T* adj_i = adj + bi * A;

  for (int c0 = 0; c0 < A; c0 += CH) {
    const int n = A - c0 < CH ? A - c0 : CH;
    const size_t e0 = bi * A + c0;  // the chunk's first edge row (b, i, c0)
    if constexpr (RC) {
      __shared__ __align__(16) float sX[ECHUNK * XTILE_LD];  // a k-tile of the edge rows
      mma_tiles(sX, edge + e0 * H, H, H, n, Hp, wf, Hp, 0, Hp, gz + e0 * Hp, Hp, Hp);
    }
    for (int ch = t; ch < Hp; ch += TB) {
      if (ch >= H) {
        for (int r = 0; r < n; ++r) gz[(e0 + r) * Hp + ch] = 0.0f;
        continue;
      }
      float wti[MAXS], gwti[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        wti[c] = c < S ? widen(wt[(bi * S + c) * H + ch]) : 0.0f;
        gwti[c] = 0.0f;
      }
      const float bft = RC ? widen(bf[ch]) : 0.0f;
      for (int r = 0; r < n; ++r) {
        const size_t e = e0 + r;
        const float z = RC ? gz[e * Hp + ch] + bft : widen(zf[e * H + ch]);
        float wsr[MAXS];
        float sdot = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXS; ++c) {
          wsr[c] = c < S ? widen(wsrc[((b0 + c0 + r) * S + c) * H + ch]) : 0.0f;
          sdot = fmaf(wti[c], wsr[c], sdot);
        }
        const float g = widen(gdf[e * H + ch]) * widen(adj_i[c0 + r]);
        const float g_s = rnd_st<B16>(g * silu_st<B16>(z));
        if constexpr (RC) gs_e[e * H + ch] = g_s;
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          gwti[c] = B16 ? gwti[c] + rnd_st<B16>(g_s * wsr[c]) : fmaf(g_s, wsr[c], gwti[c]);
        gz[e * Hp + ch] = g * sdot * dsilu_st<B16>(z);
      }
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          float* o = gwt_acc + (bi * S + c) * H + ch;
          *o = c0 ? *o + gwti[c] : gwti[c];
        }
      }
    }
  }
  if constexpr (IS_BF16<T>)
    for (int ch = t; ch < H; ch += TB)
      for (int c = 0; c < S; ++c)
        gwt[(bi * S + c) * H + ch] = st<T>(gwt_acc[(bi * S + c) * H + ch]);
}

// The wide g_edge product's epilogue: gedge[r][n] += G[r][:] . W_f[n][:]
// for n < N (H), one element at a time.  In bfloat16 the product rounds
// before it is added, as JAX adds two bfloat16 edge gradients.
template <class T>
struct AddIntoCols {
  T* out;
  int ld, N;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    T* p = out + r * ld + n;
    if constexpr (IS_BF16<T>) {
      p[0] = st<T>(widen(p[0]) + rnd<T>(v0));
      if (n + 1 < N) p[1] = st<T>(widen(p[1]) + rnd<T>(v1));
    } else {
      p[0] += v0;
      if (n + 1 < N) p[1] += v1;
    }
  }
};

// The g_edge product's epilogue: gedge[r][n] += G[r][:] . W_f[n][:], read
// and written by the one thread that owns each element (in place).
template <class T>
struct AddInto {
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    if constexpr (IS_BF16<T>) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(out + r * ld + n);
      const float2 v = __bfloat1622float2(*p);
      *p = __floats2bfloat162_rn(v.x + rnd<T>(v0), v.y + rnd<T>(v1));
    } else {
      float2* p = reinterpret_cast<float2*>(out + r * ld + n);
      float2 v = *p;
      v.x += v0;
      v.y += v1;
      *p = v;
    }
  }
};

// Source pass: g_wsrc_j[c] = sum_i g_df_ij * adj_ij * silu(zf_ij) * wt_i[c], fixed order.
// The wide kernels' pass (WIDE) runs channel blocks of blockDim.x along the
// grid's z.  In bfloat16 the sum goes in blocks of I_TILE centres
// (common.cuh); K3's products round (two bfloat16 values).
template <bool RC, bool WIDE, class T>
__global__ void __launch_bounds__(256) edge_bwd_upd_source(
    const T* __restrict__ adj, const T* __restrict__ wt, const T* __restrict__ zf,
    const T* __restrict__ gdf, const float* __restrict__ gs_e, T* __restrict__ gwsrc,
    int A, int H, int S) {
  constexpr bool B16 = IS_BF16<T> && !RC;
  const int t = WIDE ? blockIdx.z * blockDim.x + threadIdx.x : threadIdx.x;
  const int j = blockIdx.x, b = blockIdx.y;
  if (WIDE && t >= H) return;
  const size_t b0 = (size_t)b * A;
  float sc[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) sc[c] = 0.0f;
  auto term = [&](int i) {
    const size_t e = (b0 + i) * A + j;
    float g_s;
    if constexpr (RC) {
      g_s = gs_e[e * H + t];
    } else {
      g_s = rnd_st<B16>(widen(gdf[e * H + t]) * widen(adj[e]) *
                        silu_st<B16>(widen(zf[e * H + t])));
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      if (c < S) {
        const float w = widen(wt[((b0 + i) * S + c) * H + t]);
        sc[c] = B16 ? sc[c] + rnd_st<B16>(g_s * w) : fmaf(g_s, w, sc[c]);
      }
    }
  };
  if constexpr (IS_BF16<T>) {
    float tc[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) tc[c] = 0.0f;
    for (int i0 = 0; i0 < A; i0 += I_TILE) {
#pragma unroll
      for (int i = i0; i < i0 + I_TILE; ++i) term(i);
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        tc[c] = rnd<T>(tc[c] + rnd<T>(sc[c]));
        sc[c] = 0.0f;
      }
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c) sc[c] = tc[c];
  } else {
#pragma unroll 8
    for (int i = 0; i < A; ++i) term(i);
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gwsrc[((b0 + j) * S + c) * H + t] = st<T>(sc[c]);
}

// The product copies 16-byte chunks of W_f and of the g_zf scratch, and
// adds float2 pairs into g_edge: W_f must be 16-byte aligned, g_edge 8.
// gwt_acc: g_wt's float sums over the source chunks (the output itself for
// float).
template <bool RC>
static int launch_upd(const EdgeT* zf, const EdgeT* edge, const EdgeT* wf, const EdgeT* bf,
                      const EdgeT* adj, const EdgeT* wt, const EdgeT* wsrc, const EdgeT* gdf,
                      EdgeT* gedge, float* gwt_acc, EdgeT* gwt, EdgeT* gwsrc, float* gs_e,
                      float* gz, int B, int A, int H, int S, cudaStream_t stream) {
  if (A <= 0 || A % RCHUNK || S > MAXS || H <= 0 || ((size_t)wf & 15) || ((size_t)gedge & 7))
    return (int)cudaErrorInvalidValue;
  if (!narrow_update(H)) {
    const int Hp = wide_width(H), T = wide_threads(H);
    edge_bwd_upd_wide<RC, EdgeT><<<dim3(A, B), T, 0, stream>>>(
        zf, edge, wf, bf, adj, wt, wsrc, gdf, gwt_acc, gwt, gs_e, gz, A, H, S);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = launch_row_tile<128, true>(gz, Hp, (size_t)B * A * A, Hp, H, wseg(wf, Hp),
                                     AddIntoCols<EdgeT>{gedge, H, H}, stream);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_upd_source<RC, true, EdgeT><<<dim3(A, B, (H + T - 1) / T), T, 0, stream>>>(
        adj, wt, zf, gdf, gs_e, gwsrc, A, H, S);
    return (int)cudaGetLastError();
  }
  const size_t smem = upd_smem(A, H, RC);
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_upd_centre<RC, EdgeT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_bwd_upd_centre<RC, EdgeT><<<RC ? dim3(A, B) : group_grid(A, B, H), RC ? H : 256, smem,
                                   stream>>>(zf, edge, wf, bf, adj, wt, wsrc, gdf, gwt_acc, gwt,
                                             gs_e, gz, A, H, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // gedge[E][H] += g_zf @ W_f^T: W_f's rows, as stored, are the MMA's B columns
  err = launch_row_tile<128, true>(gz, H, (size_t)B * A * A, H, H, wseg(wf, H),
                                   AddInto<EdgeT>{gedge, H}, stream);
  if (err != cudaSuccess) return (int)err;
  edge_bwd_upd_source<RC, false, EdgeT><<<dim3(A, B), H, 0, stream>>>(adj, wt, zf, gdf, gs_e,
                                                                      gwsrc, A, H, S);
  return (int)cudaGetLastError();
}

// gedge: the message path's g_edge, which the product adds into in place;
// gz: [B, A, A, H] scratch for g_zf.  The narrow kernels take H a multiple
// of 32 up to 256; the wide kernels every other H, with W_f
// zero-padded to [Hp][Hp] and gz of [B, A, A, Hp] (Hp = wide_width(H)).
// The _bf16 entry points take bfloat16 and, last, the float scratch
// gwt_acc [B][A][S][H] for g_wt's sums over the source chunks.
extern "C" int AI2BMD_ENTRY(edge_bwd_upd)(const EdgeT* adj, const EdgeT* wt, const EdgeT* wsrc,
                                          const EdgeT* wf, const EdgeT* zf, const EdgeT* gdf,
                                          EdgeT* gedge, EdgeT* gwt, EdgeT* gwsrc, float* gz,
#ifdef AI2BMD_STORE_BF16
                                          float* gwt_acc,
#endif
                                          int B, int A, int H, int S, cudaStream_t stream) {
#ifndef AI2BMD_STORE_BF16
  float* gwt_acc = gwt;
  gwt = nullptr;
#endif
  return launch_upd<false>(zf, nullptr, wf, nullptr, adj, wt, wsrc, gdf, gedge, gwt_acc, gwt,
                           gwsrc, nullptr, gz, B, A, H, S, stream);
}

// as K3's, and gs_e: [B, A, A, H] scratch for the source pass's factor
extern "C" int AI2BMD_ENTRY(edge_bwd_upd_rc)(const EdgeT* edge, const EdgeT* adj, const EdgeT* wt,
                                             const EdgeT* wsrc, const EdgeT* wf, const EdgeT* bf,
                                             const EdgeT* gdf, EdgeT* gedge, EdgeT* gwt,
                                             EdgeT* gwsrc, float* gs_e, float* gz,
#ifdef AI2BMD_STORE_BF16
                                             float* gwt_acc,
#endif
                                             int B, int A, int H, int S, cudaStream_t stream) {
#ifndef AI2BMD_STORE_BF16
  float* gwt_acc = gwt;
  gwt = nullptr;
#endif
  return launch_upd<true>(nullptr, edge, wf, bf, adj, wt, wsrc, gdf, gedge, gwt_acc, gwt, gwsrc,
                          gs_e, gz, B, A, H, S, stream);
}

#ifndef AI2BMD_STORE_BF16
// shared memory, blocks per SM, registers and spill bytes of one stage, K3
// (rc = 0) or K8 (rc = 1): the centre pass (stage 1) or the g_edge product
// (stage 2, shared by both)
extern "C" int edge_bwd_upd_occupancy(int A, int H, int rc, int stage, int* out) {
  if (stage == 2)
    return occupancy(row_tile<128, true, AddInto<float>>, 256, tile_smem<128>(), out);
  return rc ? occupancy(edge_bwd_upd_centre<true, float>, H, upd_smem(A, H, true), out)
            : occupancy(edge_bwd_upd_centre<false, float>, 256, 0, out);
}

// the same for the wide centre pass (stage 1) or its g_edge product (stage
// 2) at H channels (the shared memory is static); out[4] receives the rows
// of the centre pass's chunk, out[5] the columns of K8's k-tiles
extern "C" int edge_bwd_upd_wide_occupancy(int H, int rc, int stage, int* out) {
  out[4] = ECHUNK;
  out[5] = XTILE;
  if (stage == 2)
    return occupancy(row_tile<128, true, AddIntoCols<float>>, 256, tile_smem<128>(), out);
  return rc ? occupancy(edge_bwd_upd_wide<true, float>, wide_threads(H), 0, out)
            : occupancy(edge_bwd_upd_wide<false, float>, wide_threads(H), 0, out);
}
#endif
