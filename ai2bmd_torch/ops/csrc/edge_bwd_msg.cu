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
// (common.cuh): a fragment (A <= 48) is one chunk, a whole molecule (any
// A % 8 == 0) several.  Every output of pass 1 but g_q is per edge row;
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
// Storage: float, or bfloat16 (this source compiled again with
// AI2BMD_STORE_BF16, common.cuh; the *_bf16_launch entry points), the JAX
// kernels on bfloat16 refs (ops/vismp.py, edge_bwd_msg_bf16_plain): K2
// reads a bfloat16 stash and rounds as those kernels do (silu_st,
// dsilu_st, rnd_st), K7 recomputes float pre-activations, so in bfloat16
// K7 does not equal K2 on K1's stash; the source pass sums the centres in
// blocks of I_TILE with a bfloat16 running total, as the TPU grid did.

#include "common.cuh"

using namespace ai2bmd;

// dynamic shared memory of one centre-pass block (NW = H / 32 warps, H / dh
// heads) for one chunk of min(A, ECHUNK) rows
static size_t msg_smem(int A, int H, int S, bool rc, int dh) {
  const int NW = H / 32, n = A < ECHUNK ? A : ECHUNK;
  return (size_t)(n * mma_ld(2 * H) + (rc ? 2 * n * mma_ld(H) + n * (H / dh) : 0) + n * S +
                  3 * n + NW * n + NW * n * S) * sizeof(float);
}

// T is the storage type (common.cuh).  K2 in bfloat16 reads a bfloat16
// stash: silu, silu' and the products of two bfloat16 values round as the
// JAX kernel's do (silu_st, dsilu_st, rnd_st; ops/vismp.py,
// edge_bwd_msg_bf16_plain); K7 recomputes float32 pre-activations.  gq_acc
// holds g_q's float sums across the chunks (the output itself for float).
template <bool RC, int DH, class T>
__global__ void __launch_bounds__(256, RC ? 1 : 2) edge_bwd_msg_centre(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ vec, const T* __restrict__ zdkv,
    const T* __restrict__ zs, const T* __restrict__ edge,
    const T* __restrict__ wdkv, const T* __restrict__ bdkv,
    const T* __restrict__ ws, const T* __restrict__ bs,
    const T* __restrict__ dsh, const T* __restrict__ dist,
    const T* __restrict__ adj, const T* __restrict__ wdkvT,
    const T* __restrict__ wsT, const T* __restrict__ gx,
    const T* __restrict__ gva, float* __restrict__ gq_acc, T* __restrict__ gq,
    T* __restrict__ gedge, T* __restrict__ gdsh, T* __restrict__ gdist,
    float* __restrict__ gk_e, float* __restrict__ gv_e, float* __restrict__ s1_e, int A, int H,
    int S, float cutoff) {
  constexpr bool B16 = IS_BF16<T> && !RC;
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
    for (int x = t; x < n * S; x += blockDim.x) sDsh[x] = widen(dsh[e0 * S + x]);
    for (int r = t; r < n; r += blockDim.x) {
      const float a = widen(adj[e0 + r]), d = widen(dist[e0 + r]);
      sAdj[r] = a;
      sGate[r] = cutoff_of<T>(d, cutoff) * a;
      sDcut[r] = dcutoff_of<T>(d, cutoff, kpi);
    }
    float gvai[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) gvai[c] = c < S ? widen(gva[(bi * S + c) * H + t]) : 0.0f;
    __syncthreads();

    const float qi = widen(q[bi * H + t]);
    float zk[RC ? ECHUNK : 1];
    if constexpr (RC) {
      // zdkv = edge @ W_dkv + b_dkv: zv to sZv, zk (through sW) to registers
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, H, sZv, ld);
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, wdkv, H2, 0, sW, ldw);
      const float bv = widen(bdkv[H + t]), bk = widen(bdkv[t]);
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
            const float kr = widen(k[(s0 + r) * H + t]), vr = widen(v[(s0 + r) * H + t]);
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
      const float s2 = silu_st<B16>(z2) * a;
      float g2 = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          g2 = fmaf(gvai[c], sDsh[r * S + c], g2);
          const float red = warp_sum(rnd_st<B16>(gvai[c] * s2));
          if (lane == 0) sRedDsh[(w * CH + r) * S + c] = red;
        }
      }
      sW[r * ldw + H + t] = g2 * a * dsilu_st<B16>(z2);
    };
    auto g_s1 = [&](int r, float z1) {
      float g1 = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c)
        if (c < S) g1 = fmaf(gvai[c], widen(vec[((s0 + r) * S + c) * H + t]), g1);
      sW[r * ldw + t] = g1 * sAdj[r] * dsilu_st<B16>(z1);
    };
    if constexpr (RC) {
      // zs = v_ij @ W_s + b_s, one half at a time into sW, where g_s takes
      // its place; s1 -> scratch for g_vec
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, H, sW + H, ldw);
      const float b2 = widen(bs[H + t]);
      for (int r0 = 0; r0 < n; r0 += RCHUNK) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = r0 + rr;
          g_s2(r, sW[r * ldw + H + t] + b2);
        }
      }
      mma_rows_times_cols<ECHUNK>(sE, ld, n, H, ws, H2, 0, sW, ldw);
      const float b1 = widen(bs[t]);
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
          g_s2(r, widen(zs[e * H2 + H + t]));
          g_s1(r, widen(zs[e * H2 + t]));
        }
      }
    }

    // g_vij = g_s @ W_s^T + g_x_agg_i: the product over g_s's first half
    mma_rows_times_cols<ECHUNK>(sW, ldw, n, H2, wsT, H, 0, sW, ldw);
    const float gxi = widen(gx[bi * H + t]);

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
            zkr = widen(zdkv[(e0 + r) * H2 + t]);
            zv = widen(zdkv[(e0 + r) * H2 + H + t]);
          }
          const float dk = silu_st<B16>(zkr), dv = silu_st<B16>(zv);
          const float kr = widen(k[(s0 + r) * H + t]), vr = widen(v[(s0 + r) * H + t]);
          float a;
          if constexpr (RC) {
            a = sPre[r * NHD + hd];
          } else {
            a = head_sum<DH>(rnd_st<B16>(qi * kr) * dk);
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
          sW[r * ldw + t] = g_a * qi * kr * dsilu_st<B16>(zkr);
          sW[r * ldw + H + t] = g_dv * dsilu_st<B16>(zv);
        }
      }
    }
    gq_acc[bi * H + t] = c0 ? gq_acc[bi * H + t] + gqi : gqi;

    // g_edge = g_dkv @ W_dkv^T, straight to device memory; then the
    // cross-warp sums of g_dist and g_d_sh (the product synced the block)
    mma_rows_times_cols<ECHUNK>(sW, ldw, n, H2, wdkvT, H, 0, gedge + e0 * H, H);
    for (int r = t; r < n; r += blockDim.x) {
      float s = 0.0f;
      for (int ww = 0; ww < NW; ++ww) s += sRedCut[ww * CH + r];
      gdist[e0 + r] = st<T>(s * sAdj[r] * sDcut[r]);
    }
    for (int x = t; x < n * S; x += blockDim.x) {
      float s = 0.0f;
      for (int ww = 0; ww < NW; ++ww) s += sRedDsh[ww * CH * S + x];
      gdsh[e0 * S + x] = st<T>(s);
    }
  }
  if constexpr (IS_BF16<T>) gq[bi * H + t] = st<T>(gq_acc[bi * H + t]);
}

// The wide instantiation (common.cuh: every H and every head count that
// divides it), one block per (fragment, centre atom i) of wide_threads(H)
// threads, each looping over its channels in every pass; each product
// (mma_tiles) over k-tiles of its rows staged in sX, the head sums from the
// same tiles (block_head_sums).  A chunk's rows live in the block's slot of
// the scratch `wrk` (wide_scratch kind 1): W [CH][2 Hp], E [CH][Hp], sA and
// sG [CH][nh].  K7 passes zk and zv from its recompute to the attention
// chain through the g_k and g_v scratch, which the chain then overwrites
// element by element (the same thread reads and writes each).  Per chunk:
//   head terms q_i k_j dk -> W's first half (K7: from zdkv = edge @ W_dkv
//     + b_dkv, computed into W), summed by head into sA;
//   K7: v_ij into E (read as 0 past H), zs = v_ij @ W_s + b_s into W;
//   g_s in W in place (from W, or K2's stash), g_d_sh's per-warp sums;
//   g_vij = g_s @ W_s^T into E;
//   the attention chain in two passes around the head sums of g_g3 * gate
//     (W's first half -> sG): g_v's terms, g_dist's sums and g_dv, then
//     g_a, g_q, g_k's terms and g_dk, g_dkv in W;
//   g_edge = g_dkv @ W_dkv^T to device memory.
// The padded columns of W stay 0 (zeroed when the kernel starts, or a
// product of zero-padded weights), since g_vij and g_edge read them.
template <bool RC, class T>
__global__ void __launch_bounds__(256, 2) edge_bwd_msg_wide(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ vec, const T* __restrict__ zdkv,
    const T* __restrict__ zs, const T* __restrict__ edge,
    const T* __restrict__ wdkv, const T* __restrict__ bdkv,
    const T* __restrict__ ws, const T* __restrict__ bs,
    const T* __restrict__ dsh, const T* __restrict__ dist,
    const T* __restrict__ adj, const T* __restrict__ wdkvT,
    const T* __restrict__ wsT, const T* __restrict__ gx,
    const T* __restrict__ gva, float* __restrict__ gq_acc, T* __restrict__ gq,
    T* __restrict__ gedge, T* __restrict__ gdsh, T* __restrict__ gdist,
    float* __restrict__ gk_e, float* __restrict__ gv_e, float* __restrict__ s1_e, float* wrk,
    int A, int H, int S, int nh, float cutoff) {
  constexpr bool B16 = IS_BF16<T> && !RC;
  __shared__ __align__(16) float sX[ECHUNK * XTILE_LD];  // a k-tile of a chunk's rows
  __shared__ float sDsh[ECHUNK * MAXS], sAdj[ECHUNK], sGate[ECHUNK], sDcut[ECHUNK];
  __shared__ float sRedCut[8 * ECHUNK], sRedDsh[8 * ECHUNK * MAXS];  // [NW][CH] (x S)
  const int NW = blockDim.x / 32, Hp = wide_width(H), DH = H / nh, CH = A < ECHUNK ? A : ECHUNK;
  const int ldw = 2 * Hp;
  float* W = wrk + block_slot() * wide_scratch(1, A, H, nh);
  float* E = W + (size_t)CH * ldw;
  float* sA = E + (size_t)CH * Hp;
  float* sG = sA + (size_t)CH * nh;

  const int t = threadIdx.x, TB = blockDim.x, w = t / 32, lane = t % 32;
  const int i = blockIdx.x, b = blockIdx.y;
  const int H2 = 2 * H;
  const size_t bi = (size_t)b * A + i;
  const float kpi = 3.14159265358979323846f / cutoff;

  for (int x = t; x < CH * 2 * Hp; x += TB) {
    const int r = x / (2 * Hp), c = x - r * 2 * Hp;
    if (c % Hp >= H) W[r * ldw + c] = 0.0f;
  }

  for (int c0 = 0; c0 < A; c0 += CH) {
    const int n = A - c0 < CH ? A - c0 : CH;
    const size_t e0 = bi * A + c0;         // the chunk's first edge row (b, i, c0)
    const size_t s0 = (size_t)b * A + c0;  // and its first source atom
    __syncthreads();  // W is zeroed / every thread is done with the last chunk's rows
    for (int x = t; x < n * S; x += TB) sDsh[x] = widen(dsh[e0 * S + x]);
    for (int r = t; r < n; r += TB) {
      const float a = widen(adj[e0 + r]), d = widen(dist[e0 + r]);
      sAdj[r] = a;
      sGate[r] = cutoff_of<T>(d, cutoff) * a;
      sDcut[r] = dcutoff_of<T>(d, cutoff, kpi);
    }

    // the head terms into W's first half; K7 keeps zv in its second half
    if constexpr (RC) {
      mma_tiles(sX, edge + e0 * H, H, H, n, Hp, wdkv, 2 * Hp, 0, 2 * Hp, W, ldw, 2 * Hp);
      for (int ch = t; ch < H; ch += TB) {
        const float qi = widen(q[bi * H + ch]), bk = widen(bdkv[ch]), bv = widen(bdkv[H + ch]);
        for (int r = 0; r < n; ++r) {
          const size_t e = (e0 + r) * H + ch;
          const float zk = W[r * ldw + ch] + bk, zv = W[r * ldw + Hp + ch] + bv;
          gk_e[e] = zk;
          gv_e[e] = zv;
          W[r * ldw + ch] = head_term(qi, widen(k[(s0 + r) * H + ch]), zk);
          W[r * ldw + Hp + ch] = zv;
        }
      }
    } else {
      for (int ch = t; ch < H; ch += TB) {
        const float qi = widen(q[bi * H + ch]);
        for (int r = 0; r < n; ++r) {
          const float kr = widen(k[(s0 + r) * H + ch]), zk = widen(zdkv[(e0 + r) * H2 + ch]);
          W[r * ldw + ch] = B16 ? rnd_st<B16>(qi * kr) * silu_st<B16>(zk) : head_term(qi, kr, zk);
        }
      }
    }
    block_head_sums(sX, W, ldw, n, H, nh, DH, sA);
    if constexpr (RC) {
      for (int ch = t; ch < H; ch += TB)
        for (int r = 0; r < n; ++r)
          E[r * Hp + ch] = edge_message(widen(v[(s0 + r) * H + ch]), W[r * ldw + Hp + ch],
                                        sA[r * nh + ch / DH], sGate[r]);
      // zs = v_ij @ W_s (+ b_s below) over both halves
      mma_tiles(sX, E, Hp, H, n, Hp, ws, 2 * Hp, 0, 2 * Hp, W, ldw, 2 * Hp);
    }

    // g_s = [sum_c g_vec_agg_i[c] vec_j[c], sum_c g_vec_agg_i[c] d_sh_ij[c]] * adj *
    // silu'(zs) in W; g_d_sh_ij[c] = sum_h g_vec_agg_i[c] * s2 per warp; K7's s1 to scratch
    for (int r = 0; r < n; ++r) {
      const size_t e = e0 + r;
      const float a = sAdj[r];
      float red[MAXS];
#pragma unroll
      for (int c = 0; c < MAXS; ++c) red[c] = 0.0f;
      for (int ch = t; ch < H; ch += TB) {
        float z1, z2;
        if constexpr (RC) {
          z1 = W[r * ldw + ch] + widen(bs[ch]);
          z2 = W[r * ldw + Hp + ch] + widen(bs[H + ch]);
          s1_e[e * H + ch] = silu(z1) * a;
        } else {
          z1 = widen(zs[e * H2 + ch]);
          z2 = widen(zs[e * H2 + H + ch]);
        }
        const float s2 = silu_st<B16>(z2) * a;
        float g1 = 0.0f, g2 = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXS; ++c) {
          if (c < S) {
            const float gv = widen(gva[(bi * S + c) * H + ch]);
            g1 = fmaf(gv, widen(vec[((s0 + r) * S + c) * H + ch]), g1);
            g2 = fmaf(gv, sDsh[r * S + c], g2);
            red[c] = B16 ? red[c] + rnd_st<B16>(gv * s2) : fmaf(gv, s2, red[c]);
          }
        }
        W[r * ldw + ch] = g1 * a * dsilu_st<B16>(z1);
        W[r * ldw + Hp + ch] = g2 * a * dsilu_st<B16>(z2);
      }
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          const float s = warp_sum(red[c]);
          if (lane == 0) sRedDsh[(w * CH + r) * S + c] = s;
        }
      }
    }

    // g_vij = g_s @ W_s^T (+ g_x_agg_i below) into E
    mma_tiles(sX, W, ldw, 2 * Hp, n, 2 * Hp, wsT, Hp, 0, Hp, E, Hp, Hp);

    // the attention chain, first pass: g_v's terms, g_dist's sums, g_dv;
    // g_g3 * gate into W's first half for the head sums
    for (int r = 0; r < n; ++r) {
      float red = 0.0f;
      for (int ch = t; ch < H; ch += TB) {
        const size_t e = (e0 + r) * H + ch;
        const float gvij = E[r * Hp + ch] + widen(gx[bi * H + ch]);
        const float zv = RC ? gv_e[e] : widen(zdkv[(e0 + r) * H2 + H + ch]);
        const float dv = silu_st<B16>(zv), vr = widen(v[(s0 + r) * H + ch]);
        const float att = silu(sA[r * nh + ch / DH]), gate = sGate[r];
        const float g3 = att * gate;
        gv_e[e] = gvij * dv * g3;
        const float g_g3 = gvij * vr * dv;
        red = fmaf(g_g3, att, red);
        W[r * ldw + ch] = g_g3 * gate;
        W[r * ldw + Hp + ch] = gvij * vr * g3 * dsilu_st<B16>(zv);
      }
      red = warp_sum(red);
      if (lane == 0) sRedCut[w * CH + r] = red;
    }
    block_head_sums(sX, W, ldw, n, H, nh, DH, sG);
    // second pass: g_a = sum_head(g_g3 * gate) silu'(a), g_q, g_k's terms, g_dk
    for (int ch = t; ch < H; ch += TB) {
      const float qi = widen(q[bi * H + ch]);
      float gqi = 0.0f;
      for (int r = 0; r < n; ++r) {
        const size_t e = (e0 + r) * H + ch;
        const float zk = RC ? gk_e[e] : widen(zdkv[(e0 + r) * H2 + ch]);
        const float dk = silu_st<B16>(zk), kr = widen(k[(s0 + r) * H + ch]);
        const int x = r * nh + ch / DH;
        const float g_a = sG[x] * dsilu(sA[x]);
        gqi = fmaf(g_a * kr, dk, gqi);
        gk_e[e] = g_a * qi * dk;
        W[r * ldw + ch] = g_a * qi * kr * dsilu_st<B16>(zk);
      }
      gq_acc[bi * H + ch] = c0 ? gq_acc[bi * H + ch] + gqi : gqi;
    }

    // g_edge = g_dkv @ W_dkv^T, straight to device memory; then the
    // cross-warp sums of g_dist and g_d_sh (the product synced the block)
    mma_tiles(sX, W, ldw, 2 * Hp, n, 2 * Hp, wdkvT, Hp, 0, Hp, gedge + e0 * H, H, H);
    for (int r = t; r < n; r += TB) {
      float s = 0.0f;
      for (int ww = 0; ww < NW; ++ww) s += sRedCut[ww * CH + r];
      gdist[e0 + r] = st<T>(s * sAdj[r] * sDcut[r]);
    }
    for (int x = t; x < n * S; x += TB) {
      float s = 0.0f;
      for (int ww = 0; ww < NW; ++ww) s += sRedDsh[ww * CH * S + x];
      gdsh[e0 * S + x] = st<T>(s);
    }
  }
  if constexpr (IS_BF16<T>)
    for (int ch = t; ch < H; ch += TB) gq[bi * H + ch] = st<T>(gq_acc[bi * H + ch]);
}

// Pass 2: one block per (fragment, source atom j); fixed-order sums over i.
// The wide kernels' pass (WIDE) runs channel blocks of blockDim.x along the
// grid's z.  In bfloat16 the sums go in blocks of I_TILE centres
// (common.cuh); K2's s1 g_vec_agg products round (a product of two bfloat16
// values).

template <bool RC, bool WIDE, class T>
__global__ void __launch_bounds__(256) edge_bwd_msg_source(
    const T* __restrict__ zs, const T* __restrict__ adj,
    const float* __restrict__ s1_e, const T* __restrict__ gva,
    const float* __restrict__ gk_e, const float* __restrict__ gv_e, T* __restrict__ gk,
    T* __restrict__ gv, T* __restrict__ gvec, int A, int H, int S) {
  constexpr bool B16 = IS_BF16<T> && !RC;
  const int t = WIDE ? blockIdx.z * blockDim.x + threadIdx.x : threadIdx.x;
  const int j = blockIdx.x, b = blockIdx.y;
  if (WIDE && t >= H) return;
  const size_t b0 = (size_t)b * A;
  float sk = 0.0f, sv = 0.0f;
  float sc[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) sc[c] = 0.0f;
  auto term = [&](int i) {
    const size_t e = (b0 + i) * A + j;
    sk += gk_e[e * H + t];
    sv += gv_e[e * H + t];
    float s1;
    if constexpr (RC) {
      s1 = s1_e[e * H + t];
    } else {
      s1 = silu_st<B16>(widen(zs[e * 2 * H + t])) * widen(adj[e]);
    }
#pragma unroll
    for (int c = 0; c < MAXS; ++c) {
      if (c < S) {
        const float g = widen(gva[((b0 + i) * S + c) * H + t]);
        sc[c] = B16 ? sc[c] + rnd_st<B16>(s1 * g) : fmaf(s1, g, sc[c]);
      }
    }
  };
  if constexpr (IS_BF16<T>) {
    float tk = 0.0f, tv = 0.0f, tc[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) tc[c] = 0.0f;
    for (int i0 = 0; i0 < A; i0 += I_TILE) {
#pragma unroll
      for (int i = i0; i < i0 + I_TILE; ++i) term(i);
      tk = rnd<T>(tk + rnd<T>(sk));
      tv = rnd<T>(tv + rnd<T>(sv));
      sk = sv = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        tc[c] = rnd<T>(tc[c] + rnd<T>(sc[c]));
        sc[c] = 0.0f;
      }
    }
    sk = tk, sv = tv;
#pragma unroll
    for (int c = 0; c < MAXS; ++c) sc[c] = tc[c];
  } else {
#pragma unroll 8
    for (int i = 0; i < A; ++i) term(i);
  }
  gk[(b0 + j) * H + t] = st<T>(sk);
  gv[(b0 + j) * H + t] = st<T>(sv);
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) gvec[((b0 + j) * S + c) * H + t] = st<T>(sc[c]);
}

// gq_acc: g_q's float sums over the source chunks (the output itself for
// float); the rest as the kernels'.
template <bool RC>
int launch_msg(const EdgeT* q, const EdgeT* k, const EdgeT* v, const EdgeT* vec,
               const EdgeT* zdkv, const EdgeT* zs, const EdgeT* edge, const EdgeT* wdkv,
               const EdgeT* bdkv, const EdgeT* ws, const EdgeT* bs, const EdgeT* dsh,
               const EdgeT* dist, const EdgeT* adj, const EdgeT* wdkvT, const EdgeT* wsT,
               const EdgeT* gx, const EdgeT* gva, float* gq_acc, EdgeT* gq, EdgeT* gk,
               EdgeT* gv, EdgeT* gvec, EdgeT* gedge, EdgeT* gdsh, EdgeT* gdist,
               float* gk_e, float* gv_e, float* s1_e, float* wrk, int B, int A, int H,
               int S, float cutoff, int dh, cudaStream_t stream) {
  if (A <= 0 || A % RCHUNK || S > MAXS || H <= 0 || dh <= 0 || H % dh)
    return (int)cudaErrorInvalidValue;
  if (!narrow_shapes(H, H / dh)) {
    if (wrk == nullptr) return (int)cudaErrorInvalidValue;
    const int T = wide_threads(H);
    edge_bwd_msg_wide<RC, EdgeT><<<dim3(A, B), T, 0, stream>>>(
        q, k, v, vec, zdkv, zs, edge, wdkv, bdkv, ws, bs, dsh, dist, adj, wdkvT, wsT, gx, gva,
        gq_acc, gq, gedge, gdsh, gdist, gk_e, gv_e, s1_e, wrk, A, H, S, H / dh, cutoff);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    edge_bwd_msg_source<RC, true, EdgeT><<<dim3(A, B, (H + T - 1) / T), T, 0, stream>>>(
        zs, adj, s1_e, gva, gk_e, gv_e, gk, gv, gvec, A, H, S);
    return (int)cudaGetLastError();
  }
  int rc = with_head_width(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    const size_t smem = msg_smem(A, H, S, RC, DH);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    auto kern = edge_bwd_msg_centre<RC, DH, EdgeT>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(A, B), H, smem, stream>>>(q, k, v, vec, zdkv, zs, edge, wdkv, bdkv, ws, bs, dsh,
                                          dist, adj, wdkvT, wsT, gx, gva, gq_acc, gq, gedge, gdsh,
                                          gdist, gk_e, gv_e, s1_e, A, H, S, cutoff);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
  edge_bwd_msg_source<RC, false, EdgeT><<<dim3(A, B), H, 0, stream>>>(
      zs, adj, s1_e, gva, gk_e, gv_e, gk, gv, gvec, A, H, S);
  return (int)cudaGetLastError();
}

#ifndef AI2BMD_STORE_BF16
// shared memory, blocks per SM, registers and spill bytes of the centre
// pass of K2 (RC false) or K7 (RC true): the narrow one (heads of 32
// channels, A slots) or the wide one (H channels; static shared memory)
template <bool RC>
int msg_occupancy(bool wide, int A, int H, int S, int* out) {
  if (wide) return occupancy(edge_bwd_msg_wide<RC, float>, wide_threads(H), 0, out);
  return occupancy(edge_bwd_msg_centre<RC, 32, float>, H, msg_smem(A, H, S, RC, 32), out);
}
#endif

// The narrow kernels take heads of 8, 16, 32 or 64 channels with H a
// multiple of 32 up to 256; the wide kernel every other H whose head count
// divides it, with W_dkv^T and W_s^T (and K7's W_dkv, W_s) zero-padded to
// wide_width(H) a half, [2 Hp][Hp] ([Hp][2 Hp]), and the float scratch wrk
// of B A edge_wide_scratch(1, A, H, H / dh) floats (null for the narrow
// kernels).  The _bf16 entry points take bfloat16 and, before wrk, the
// float scratch gq_acc [B][A][H] for g_q's sums over the source chunks.
extern "C" int AI2BMD_ENTRY(edge_bwd_msg)(
    const EdgeT* q, const EdgeT* k, const EdgeT* v, const EdgeT* vec, const EdgeT* zdkv,
    const EdgeT* zs, const EdgeT* dsh, const EdgeT* dist, const EdgeT* adj, const EdgeT* wdkvT,
    const EdgeT* wsT, const EdgeT* gx, const EdgeT* gva, EdgeT* gq, EdgeT* gk, EdgeT* gv,
    EdgeT* gvec, EdgeT* gedge, EdgeT* gdsh, EdgeT* gdist, float* gk_e, float* gv_e,
#ifdef AI2BMD_STORE_BF16
    float* gq_acc,
#endif
    float* wrk, int B, int A, int H, int S, float cutoff, int dh, cudaStream_t stream) {
#ifndef AI2BMD_STORE_BF16
  float* gq_acc = gq;
  gq = nullptr;
#endif
  return launch_msg<false>(q, k, v, vec, zdkv, zs, nullptr, nullptr, nullptr, nullptr, nullptr,
                           dsh, dist, adj, wdkvT, wsT, gx, gva, gq_acc, gq, gk, gv, gvec, gedge,
                           gdsh, gdist, gk_e, gv_e, nullptr, wrk, B, A, H, S, cutoff, dh, stream);
}

extern "C" int AI2BMD_ENTRY(edge_bwd_msg_rc)(
    const EdgeT* q, const EdgeT* k, const EdgeT* v, const EdgeT* vec, const EdgeT* edge,
    const EdgeT* dsh, const EdgeT* dist, const EdgeT* adj, const EdgeT* wdkv, const EdgeT* bdkv,
    const EdgeT* ws, const EdgeT* bs, const EdgeT* wdkvT, const EdgeT* wsT, const EdgeT* gx,
    const EdgeT* gva, EdgeT* gq, EdgeT* gk, EdgeT* gv, EdgeT* gvec, EdgeT* gedge, EdgeT* gdsh,
    EdgeT* gdist, float* gk_e, float* gv_e, float* s1_e,
#ifdef AI2BMD_STORE_BF16
    float* gq_acc,
#endif
    float* wrk, int B, int A, int H, int S, float cutoff, int dh, cudaStream_t stream) {
#ifndef AI2BMD_STORE_BF16
  float* gq_acc = gq;
  gq = nullptr;
#endif
  return launch_msg<true>(q, k, v, vec, nullptr, nullptr, edge, wdkv, bdkv, ws, bs, dsh, dist,
                          adj, wdkvT, wsT, gx, gva, gq_acc, gq, gk, gv, gvec, gedge, gdsh, gdist,
                          gk_e, gv_e, s1_e, wrk, B, A, H, S, cutoff, dh, stream);
}

#ifndef AI2BMD_STORE_BF16
// shared memory, blocks per SM, registers and spill bytes of the centre
// pass, K2 (rc = 0) or K7 (rc = 1)
extern "C" int edge_bwd_msg_occupancy(int A, int H, int S, int rc, int* out) {
  return rc ? msg_occupancy<true>(false, A, H, S, out) : msg_occupancy<false>(false, A, H, S, out);
}

// the same for the wide instantiation at H channels and nh heads (its shared
// memory is static); out[4] receives the rows of its source chunk, out[5]
// the columns of its k-tiles
extern "C" int edge_bwd_msg_wide_occupancy(int H, int S, int nh, int rc, int* out) {
  (void)nh;
  out[4] = ECHUNK;
  out[5] = XTILE;
  return rc ? msg_occupancy<true>(true, 0, H, S, out) : msg_occupancy<false>(true, 0, H, S, out);
}
#endif
