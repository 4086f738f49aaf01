// K5 vislayer_fwd: one complete ViS-MP layer forward.
//
// Replaces _fwd_kernel (ai2bmd_tpu/ops/pallas/vislayer.py:86), launched by
// _fwd_call's pallas_call (:457):
//   xn = LayerNorm(x);  vecn = vec * w_vln
//   q|k|v = xn @ W_qkv + b;  vec1|vec2|vec3 = vecn @ W_vp;  vdot = sum_c vec1 * vec2
//   wt, ws = vecn @ W_t, vecn @ W_src                 (not the last layer)
//   edge core (K1's): x_agg, vec_agg;  df = silu(edge @ W_f + b_f) * <wt_i, ws_j>_c * adj
//   o1|o2|o3 = x_agg @ W_o + b_o
//   x' = x + vdot * o2 + o3;  vec' = vec + vec3 * o1 + vec_agg;  edge' = edge + df
// (edge' = edge for the last layer, whose zero W_t/W_f are not multiplied).
//
// What bounds it on the H100: float32 arithmetic on the CUDA cores.  The
// edge stage does 5 H^2 multiply-adds per edge cell (edge @ W_dkv, v_ij @
// W_s, edge @ W_f), the node stages 46 H^2 per atom; the traffic is a few KB
// per cell.
// Design: the TPU kernel ran a sequential grid over 8-row centre tiles and
// kept the node prologue's results in VMEM scratch across it.  GPU blocks
// run in no order, so the launcher issues the stages in order on the stream
// and the node results go through small scratch tensors ([B*A][3H] and
// [B*S*A][5H], a few MB, L2-resident):
//   (a) node prologue, one block per 16 node rows and column group
//       (vislayer.cuh): qkv, and vec1|vec2|vec3|wt|wsrc;
//   (b) edge stage, one block per (fragment, centre atom i), one thread per
//       channel: K1's edge core with nothing stored, plus edge' written from
//       the edge rows already in shared memory;
//   (c) node update, one block per 16 atoms, three output columns per thread
//       (o1, o2, o3 of one channel), so the residual adds need no exchange.
// All products are plain float32 FMAs summed in a fixed order: the kernel
// is bitwise repeatable.  The TPU's b3 bf16 split, _rowbc, its VMEM budget
// and its 8-row centre tile were Mosaic workarounds and are not carried over.

#include <cstddef>
#include <cstring>

#include "vislayer.cuh"

using namespace ai2bmd;

namespace {

template <bool LAST>
__global__ void __launch_bounds__(256) vislayer_fwd_edge(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  const int A = p.A, H = p.H, S = p.S;
  float* sE = smem;              // [A][H]  edge rows of centre i
  float* sV = sE + A * H;        // [A][H]  dv, then v_ij
  float* sDsh = sV + A * H;      // [S][A]  d_sh[c][i][:]
  float* sGate = sDsh + S * A;   // [A]     cutoff(r) * adj
  float* sAdj = sGate + A;       // [A]

  const int t = threadIdx.x, i = blockIdx.x, b = blockIdx.y;
  const int H2 = 2 * H, H3 = 3 * H, ldp = p.NP * H;
  const size_t bi = (size_t)b * A + i;
  const size_t b0 = (size_t)b * A;

  const float4* E4 = reinterpret_cast<const float4*>(p.edge + bi * A * H);
  for (int e = t; e < A * H / 4; e += blockDim.x) reinterpret_cast<float4*>(sE)[e] = E4[e];
  for (int e = t; e < S * A; e += blockDim.x) {
    const int c = e / A, r = e % A;
    sDsh[e] = p.dsh[(((size_t)b * S + c) * A + i) * A + r];
  }
  for (int r = t; r < A; r += blockDim.x) {
    const float a = p.adj[bi * A + r];
    sAdj[r] = a;
    sGate[r] = cosine_cutoff(p.dist[bi * A + r], p.cutoff) * a;
  }
  __syncthreads();

  float acc[1][MAXA];
  const int col_lo[1] = {t}, col_hi[1] = {H + t};

  // dv = silu(edge @ W_dkv[:, H:] + b) waits in sV; dk stays in acc
  rows_times_cols<1>(sE, A, H, p.w_dkv, H2, col_hi, acc);
  const float bk = p.b_dkv[t], bv = p.b_dkv[H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        sV[r * H + t] = silu(acc[0][r] + bv);
      }
    }
  }
  rows_times_cols<1>(sE, A, H, p.w_dkv, H2, col_lo, acc);
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        acc[0][r] = silu(acc[0][r] + bk);
      }
    }
  }

  // attention message; the head of channel t is the warp of thread t
  const float qi = p.qkv[bi * H3 + t];
  float xsum = 0.0f;
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float kr = p.qkv[(b0 + r) * H3 + H + t];
        const float vr = p.qkv[(b0 + r) * H3 + H2 + t];
        const float a = warp_sum(qi * kr * acc[0][r]);
        const float vij = vr * sV[r * H + t] * (silu(a) * sGate[r]);
        sV[r * H + t] = vij;
        xsum += vij;
      }
    }
  }
  p.xagg[bi * H + t] = xsum;
  __syncthreads();

  // s1|s2 = silu(v_ij @ W_s + b_s) * adj, one half at a time:
  // vec_agg[c] = sum_j s1 * vecn_j[c] + sum_j s2 * d_sh_ij[c]
  float from_vec[MAXS], from_dsh[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) from_vec[c] = from_dsh[c] = 0.0f;
  rows_times_cols<1>(sV, A, H, p.w_s, H2, col_hi, acc);
  const float b1 = p.b_s[t], b2 = p.b_s[H + t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float s2 = silu(acc[0][r] + b2) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S) from_dsh[c] = fmaf(s2, sDsh[c * A + r], from_dsh[c]);
      }
    }
  }
  rows_times_cols<1>(sV, A, H, p.w_s, H2, col_lo, acc);
  const float wv = p.vln_w[t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        const float s1 = silu(acc[0][r] + b1) * sAdj[r];
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S)
            from_vec[c] = fmaf(s1, p.vec[(((size_t)b * S + c) * A + r) * H + t] * wv, from_vec[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    if (c < S) p.vecagg[(((size_t)b * S + c) * A + i) * H + t] = from_vec[c] + from_dsh[c];

  float* out = p.edge2 + bi * A * H;
  if (LAST) {
    // edge' = edge
    for (int e = t; e < A * H / 4; e += blockDim.x)
      reinterpret_cast<float4*>(out)[e] = reinterpret_cast<const float4*>(sE)[e];
    return;
  }
  // edge' = edge + silu(edge @ W_f + b_f) * <wt_i, ws_j>_c * adj
  float wti[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c)
    wti[c] = c < S ? p.proj[(((size_t)b * S + c) * A + i) * ldp + 3 * H + t] : 0.0f;
  rows_times_cols<1>(sE, A, H, p.w_f, H, col_lo, acc);
  const float bft = p.b_f[t];
#pragma unroll
  for (int c8 = 0; c8 < MAXA / RCHUNK; ++c8) {
    if (c8 * RCHUNK < A) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c8 * RCHUNK + rr;
        float sdot = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXS; ++c)
          if (c < S)
            sdot = fmaf(wti[c], p.proj[(((size_t)b * S + c) * A + r) * ldp + 4 * H + t], sdot);
        out[r * H + t] = sE[r * H + t] + silu(acc[0][r] + bft) * sdot * sAdj[r];
      }
    }
  }
}

// x' = x + vdot * o2 + o3;  vec' = vec + vec3 * o1 + vec_agg, with
// o1|o2|o3 = x_agg @ W_o + b_o; thread t owns channel t of o1, o2 and o3.
__global__ void __launch_bounds__(256) vislayer_fwd_update(const Layer p) {
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;  // [NODE_ROWS][H] x_agg rows
  const int t = threadIdx.x, H = p.H, A = p.A, S = p.S, ldp = p.NP * H;
  const int M = p.B * A;
  const int r0 = blockIdx.x * NODE_ROWS, n = min(NODE_ROWS, M - r0);
  for (int e = t; e < n * H; e += blockDim.x) sX[e] = p.xagg[(size_t)r0 * H + e];
  __syncthreads();
  const int col[3] = {t, H + t, 2 * H + t};
  float acc[3][NODE_ROWS];
  rows_times_cols<3, NODE_ROWS>(sX, n, H, p.w_o, 3 * H, col, acc);
  const float bo1 = p.b_o[t], bo2 = p.b_o[H + t], bo3 = p.b_o[2 * H + t];
#pragma unroll
  for (int r = 0; r < NODE_ROWS; ++r) {
    if (r < n) {
      const int row = r0 + r, b = row / A, a = row % A;
      const float o1 = acc[0][r] + bo1, o2 = acc[1][r] + bo2, o3 = acc[2][r] + bo3;
      float vdot = 0.0f;
      for (int c = 0; c < S; ++c) {
        const float* pr = p.proj + (((size_t)b * S + c) * A + a) * ldp;
        vdot = fmaf(pr[t], pr[H + t], vdot);
      }
      p.x2[(size_t)row * H + t] = p.x[(size_t)row * H + t] + vdot * o2 + o3;
      for (int c = 0; c < S; ++c) {
        const size_t v = ((size_t)b * S + c) * A + a;
        p.vec2[v * H + t] = p.vec[v * H + t] + p.proj[v * ldp + 2 * H + t] * o1 + p.vecagg[v * H + t];
      }
    }
  }
}

template <bool LAST>
cudaError_t launch_fwd(const Layer& p, cudaStream_t stream) {
  cudaError_t err = launch_node_prologue(p, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(2 * p.A * p.H + p.S * p.A + 2 * p.A) * sizeof(float);
  err = allow_smem(vislayer_fwd_edge<LAST>, smem);
  if (err != cudaSuccess) return err;
  vislayer_fwd_edge<LAST><<<dim3(p.A, p.B), p.H, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vislayer_fwd_update<<<node_tiles(p.B * p.A), p.H, (size_t)NODE_ROWS * p.H * sizeof(float),
                        stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the LAYER_PTRS pointers of Layer in field order (ops/vislayer.py,
// PTR_FIELDS); the forward reads x..b_f and writes qkv, proj, vecagg, x2,
// vec2, edge2 and xagg.
extern "C" int vislayer_fwd_launch(const void* const* ptrs, int n_ptrs, int B, int A, int H,
                                   int S, float cutoff, int last, cudaStream_t stream) {
  static_assert(offsetof(Layer, B) == LAYER_PTRS * sizeof(void*), "Layer: pointers first");
  if (n_ptrs != LAYER_PTRS || !layer_shapes_ok(A, H, S)) return (int)cudaErrorInvalidValue;
  Layer p;
  std::memcpy(&p, ptrs, LAYER_PTRS * sizeof(void*));
  p.B = B, p.A = A, p.H = H, p.S = S, p.NP = last ? 3 : 5, p.cutoff = cutoff;
  return (int)(last ? launch_fwd<true>(p, stream) : launch_fwd<false>(p, stream));
}
