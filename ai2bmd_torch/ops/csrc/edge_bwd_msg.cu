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
// What bounds it on the H100: the edge products, per edge cell 4 H^2
// multiply-adds for K2 (the transposed products g_s @ W_s^T and
// g_dkv @ W_dkv^T) and 8 H^2 for K7 (the recomputed edge @ W_dkv and
// v_ij @ W_s as well); the rest is elementwise.  They run on the tensor
// cores as 3xTF32 (common.cuh), so the bound is 165 TFLOP/s of float32
// products; each block streams the weights from L2 once per product (2 MB
// for K7 at H = 256).  K7 moves 5 H fewer floats per edge cell than K2 (no
// zdkv/zs read) for twice the arithmetic.  What holds them below that
// bound is feeding mma.sync: every warp splits its W fragments and the
// shared rows itself, about two other instructions per product (common.cuh).
// Design: pass 1 runs one block per (fragment, centre atom i), one thread per
// channel for the chains, and writes every centre-indexed output (g_q,
// g_edge, g_d_sh, g_dist).  The source-indexed outputs (g_k, g_v, g_vec) are
// sums over the centre atoms.  The TPU kernel accumulated them across its
// sequential grid (:804-808, :819-821, :829-831, :843-845); GPU blocks run
// in parallel and in no order, so pass 1 writes the per-edge terms of g_k
// and g_v to scratch, and pass 2 runs one block per (fragment, source atom
// j) and sums them over i in a fixed order.  g_vec's term, s1_ij *
// g_vec_agg_i, is rebuilt there from the stored zs (K2), or read from
// scratch (K7: pass 2 cannot rebuild s1 without the product).  No float
// atomics: bitwise repeatable.
// Every product of pass 1 is mma_rows_times_cols (3xTF32 mma.sync; each
// warp owns 32 output channels, the rows come from shared memory) and
// lands in shared memory, where the chains read it one channel a thread:
//   K7: edge rows in sE -> zv into sZv, zk through sW into registers (a
//       chunk's, 48 at most: zk lives from the recompute to the attention
//       chain, while sE holds v_ij and sW g_s); v_ij over the edge rows; z2
//       and z1 into sW, where g_s2 and g_s1 replace them in place.
//   both: g_vij = g_s @ W_s^T over g_s's first half (the product syncs the
//       block before it stores), then the attention chain writes g_dkv into
//       sW in place, and g_edge = g_dkv @ W_dkv^T goes straight to device
//       memory.
// Since K1 and K7 take the same product on the same rows, K7's zdkv and
// zs, and so its results, equal K2's on K1's stash bitwise.
// Pass 1 walks the centre's sources in chunks of at most ECHUNK = 48 rows
// (common.cuh): a fragment (A <= 48) is one chunk, a whole molecule (A up
// to EDGE_MAXA) several.  Every output of pass 1 but g_q is per edge row;
// g_q's sum over j is taken per chunk and added, chunk after chunk, to what
// the same thread wrote for the chunks before (a fixed order, no atomics;
// at A <= 48 the single-chunk kernel's arithmetic, bit for bit).  K2 and K7
// share the chunking, so K7 still equals K2 bitwise on K1's stash.
// Shared memory, for one chunk: sW [chunk][2H + 4], and for K7 sE and sZv
// [chunk][H + 4], beside the reduction buffers: 96 KB at A = 40 for K2 (115
// KB for a chunk of 48), which __launch_bounds__ holds to 128 registers so
// that two blocks share an SM; 180 KB for K7 (216 KB), one block an SM.  Rows go in chunks of 8 so that a chunk's loads and warp
// reductions are in flight together; the chunk loops are runtime loops
// (small code), except K7's v_ij and attention chains, which index zk.
// The cross-channel sums (g_d_sh, g_dist) reduce each warp with shuffles and
// then the warps in a fixed order through shared memory; the head sums (the
// attention pre-activation a_ij and its cotangent) reduce a head's DH lanes
// (head_sum<DH>, common.cuh; DH = H / nh, 8, 16, 32 or 64, a template
// parameter), and K7 keeps a_ij in sPre, one slot a head.
// The transposed products take W^T ([2H][H], row-major) as their W.

#include "common.cuh"

using namespace ai2bmd;

// dynamic shared memory of one centre-pass block (NW = H / 32 warps, H / dh
// heads) for one chunk of min(A, ECHUNK) rows
static size_t msg_smem(int A, int H, int S, bool rc, int dh) {
  const int NW = H / 32, n = A < ECHUNK ? A : ECHUNK;
  return (size_t)(n * mma_ld(2 * H) + (rc ? 2 * n * mma_ld(H) + n * (H / dh) : 0) + n * S +
                  3 * n + NW * n + NW * n * S) * sizeof(float);
}

template <bool RC, int DH>
__global__ void __launch_bounds__(256, RC ? 1 : 2) edge_bwd_msg_centre(
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
  const int ld = mma_ld(H), ldw = mma_ld(2 * H);
  const int CH = A < ECHUNK ? A : ECHUNK;  // rows of a chunk
  const int Ald = RC ? CH * ld : 0;
  float* sE = smem;                     // RC: [CH][ld] edge rows of the chunk, then v_ij
  float* sZv = sE + Ald;                // RC: [CH][ld] zdkv[:, H:]
  float* sW = sZv + Ald;                // [CH][ldw] (zk,) z2|z1 -> g_s, then g_vij|., then g_dkv
  float* sDsh = sW + CH * ldw;          // [CH][S]
  float* sAdj = sDsh + CH * S;          // [CH]
  float* sGate = sAdj + CH;             // [CH]  cutoff(r) * adj
  float* sDcut = sGate + CH;            // [CH]  d cutoff / d r
  float* sRedCut = sDcut + CH;          // [NW][CH]
  float* sRedDsh = sRedCut + NW * CH;   // [NW][CH][S]
  float* sPre = sRedDsh + NW * CH * S;  // RC: [CH][H / DH] head pre-activations a_ij

  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int NHD = blockDim.x / DH, hd = t / DH;  // heads, and the head of channel t
  const int i = blockIdx.x, b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;
  const float kpi = 3.14159265358979323846f / cutoff;

  // the sources in chunks of at most ECHUNK rows (one chunk at A <= 48);
  // each chunk's g_q sum over j is added to what this thread wrote for the
  // chunks before
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    const size_t e0 = bi * A + c0;         // the chunk's first edge row (b, i, c0)
    const size_t s0 = (size_t)b * A + c0;  // and its first source atom
    if (c0) __syncthreads();  // every thread is done with the last chunk's rows
    if constexpr (RC) load_rows(sE, ld, edge + e0 * H, n, H);
    for (int x = t; x < n * S; x += blockDim.x) sDsh[x] = dsh[e0 * S + x];
    for (int r = t; r < n; r += blockDim.x) {
      const float a = adj[e0 + r], d = dist[e0 + r];
      sAdj[r] = a;
      sGate[r] = cosine_cutoff(d, cutoff) * a;
      sDcut[r] = d < cutoff ? -0.5f * kpi * sinf(d * kpi) : 0.0f;
    }
    float gvai[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) gvai[c] = c < S ? gva[(bi * S + c) * H + t] : 0.0f;
    __syncthreads();

    const float qi = q[bi * H + t];
    float zk[RC ? ECHUNK : 1];
    if constexpr (RC) {
      // zdkv = edge @ W_dkv + b_dkv: zv to sZv, zk (through sW) to registers
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, H, sZv, ld);
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, 0, sW, ldw);
      const float bv = bdkv[H + t], bk = bdkv[t];
#pragma unroll
      for (int r = 0; r < ECHUNK; ++r) zk[r] = r < n ? sW[r * ldw + t] + bk : 0.0f;

      // v_ij = v_j * dv * silu(a) * gate with a = sum_head q_i k_j dk, over
      // the edge rows (every warp has read them: the product synced)
#pragma unroll
      for (int c8 = 0; c8 < ECHUNK / RCHUNK; ++c8) {
        if (c8 * RCHUNK < n) {
#pragma unroll
          for (int rr = 0; rr < RCHUNK; ++rr) {
            const int r = c8 * RCHUNK + rr;
            const float zv = sZv[r * ld + t] + bv;
            sZv[r * ld + t] = zv;
            const float kr = k[(s0 + r) * H + t], vr = v[(s0 + r) * H + t];
            const float a = head_sum<DH>(qi * kr * silu(zk[r]));
            if (t % DH == 0) sPre[r * NHD + hd] = a;
            sE[r * ld + t] = vr * silu(zv) * (silu(a) * sGate[r]);
          }
        }
      }
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
          if (lane == 0) sRedDsh[(w * CH + r) * S + c] = red;
        }
      }
      sW[r * ldw + H + t] = g2 * a * dsilu(z2);
    };
    auto g_s1 = [&](int r, float z1) {
      float g1 = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) g1 = fmaf(gvai[c], vec[((s0 + r) * S + c) * H + t], g1);
      sW[r * ldw + t] = g1 * sAdj[r] * dsilu(z1);
    };
    if constexpr (RC) {
      // zs = v_ij @ W_s + b_s, one half at a time into sW, where g_s takes
      // its place; s1 -> scratch for g_vec
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, H, sW + H, ldw);
      const float b2 = bs[H + t];
      for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = r0 + rr;
          g_s2(r, sW[r * ldw + H + t] + b2);
        }
      }
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, 0, sW, ldw);
      const float b1 = bs[t];
      for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = r0 + rr;
          const float z1 = sW[r * ldw + t] + b1;
          s1_e[(e0 + r) * H + t] = silu(z1) * sAdj[r];
          g_s1(r, z1);
        }
      }
    } else {
      for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = r0 + rr;
          const size_t e = e0 + r;
          g_s2(r, zs[e * H2 + H + t]);
          g_s1(r, zs[e * H2 + t]);
        }
      }
    }

    // g_vij = g_s @ W_s^T + g_x_agg_i: the product over g_s's first half
    mma_rows_times_cols<ECHUNK>(sW, ldw, n, H2, wsT, H, 0, sW, ldw);
    const float gxi = gx[bi * H + t];

    // the attention chain
    float gqi = 0.0f;
#pragma unroll (RC ? ECHUNK / RCHUNK : 1)
    for (int c8 = 0; c8 < ECHUNK / RCHUNK; ++c8) {
      if (c8 * RCHUNK < n) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          const size_t e = (e0 + r) * H + t;
          const float gvij = sW[r * ldw + t] + gxi;
          float zkr, zv;
          if constexpr (RC) {
            zkr = zk[r];
            zv = sZv[r * ld + t];
          } else {
            zkr = zdkv[(e0 + r) * H2 + t];
            zv = zdkv[(e0 + r) * H2 + H + t];
          }
          const float dk = silu(zkr), dv = silu(zv);
          const float kr = k[(s0 + r) * H + t], vr = v[(s0 + r) * H + t];
          float a;
          if constexpr (RC) {
            a = sPre[r * NHD + hd];
          } else {
            a = head_sum<DH>(qi * kr * dk);
          }
          const float att = silu(a), gate = sGate[r];
          const float g3 = att * gate;
          gv_e[e] = gvij * dv * g3;
          const float g_dv = gvij * vr * g3;
          const float g_g3 = gvij * vr * dv;
          const float red = warp_sum(g_g3 * att);
          if (lane == 0) sRedCut[w * CH + r] = red;
          const float g_a = head_sum<DH>(g_g3 * gate) * dsilu(a);
          gqi = fmaf(g_a * kr, dk, gqi);
          gk_e[e] = g_a * qi * dk;
          sW[r * ldw + t] = g_a * qi * kr * dsilu(zkr);
          sW[r * ldw + H + t] = g_dv * dsilu(zv);
        }
      }
    }
    gq[bi * H + t] = c0 ? gq[bi * H + t] + gqi : gqi;

    // g_edge = g_dkv @ W_dkv^T, straight to device memory; then the
    // cross-warp sums of g_dist and g_d_sh (the product synced the block)
    mma_rows_times_cols<ECHUNK>(sW, ldw, n, H2, wdkvT, H, 0, gedge + e0 * H, H);
    for (int r = t; r < n; r += blockDim.x) {
      float s = 0.0f;
      for (int ww = 0; ww < NW; ++ww) s += sRedCut[ww * CH + r];
      gdist[e0 + r] = s * sAdj[r] * sDcut[r];
    }
    for (int x = t; x < n * S; x += blockDim.x) {
      float s = 0.0f;
      for (int ww = 0; ww < NW; ++ww) s += sRedDsh[ww * CH * S + x];
      gdsh[e0 * S + x] = s;
    }
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
                  float* gv_e, float* s1_e, int B, int A, int H, int S, float cutoff, int dh,
                  cudaStream_t stream) {
  if (A > EDGE_MAXA || A % RCHUNK || S > MAXS || H % 32 != 0 || H > 256)
    return (int)cudaErrorInvalidValue;
  int rc = with_head_width(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    const size_t smem = msg_smem(A, H, S, RC, DH);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    auto kern = edge_bwd_msg_centre<RC, DH>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(A, B), H, smem, stream>>>(q, k, v, vec, zdkv, zs, edge, wdkv, bdkv, ws, bs, dsh,
                                          dist, adj, wdkvT, wsT, gx, gva, gq, gedge, gdsh, gdist,
                                          gk_e, gv_e, s1_e, A, H, S, cutoff);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
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
                                   float cutoff, int dh, cudaStream_t stream) {
  return launch_msg<false>(q, k, v, vec, zdkv, zs, nullptr, nullptr, nullptr, nullptr, nullptr, dsh,
                       dist, adj, wdkvT, wsT, gx, gva, gq, gk, gv, gvec, gedge, gdsh, gdist,
                       gk_e, gv_e, nullptr, B, A, H, S, cutoff, dh, stream);
}

extern "C" int edge_bwd_msg_rc_launch(
    const float* q, const float* k, const float* v, const float* vec, const float* edge,
    const float* dsh, const float* dist, const float* adj, const float* wdkv, const float* bdkv,
    const float* ws, const float* bs, const float* wdkvT, const float* wsT, const float* gx,
    const float* gva, float* gq, float* gk, float* gv, float* gvec, float* gedge, float* gdsh,
    float* gdist, float* gk_e, float* gv_e, float* s1_e, int B, int A, int H, int S,
    float cutoff, int dh, cudaStream_t stream) {
  return launch_msg<true>(q, k, v, vec, nullptr, nullptr, edge, wdkv, bdkv, ws, bs, dsh, dist, adj,
                      wdkvT, wsT, gx, gva, gq, gk, gv, gvec, gedge, gdsh, gdist, gk_e, gv_e, s1_e,
                      B, A, H, S, cutoff, dh, stream);
}

// shared memory, blocks per SM, registers and spill bytes of the centre
// pass, K2 (rc = 0) or K7 (rc = 1)
extern "C" int edge_bwd_msg_occupancy(int A, int H, int S, int rc, int* out) {
  return rc ? occupancy(edge_bwd_msg_centre<true, 32>, H, msg_smem(A, H, S, true, 32), out)
            : occupancy(edge_bwd_msg_centre<false, 32>, H, msg_smem(A, H, S, false, 32), out);
}
