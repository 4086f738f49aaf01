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
// What bounds it on the H100: the products, 5 H^2 multiply-adds per edge
// cell (edge @ W_dkv, v_ij @ W_s, edge @ W_f) and 46 H^2 per atom on the
// node side, on the tensor cores as 3xTF32 (165 TFLOP/s in float32
// products); the bytes (edge in, edge' out, ~2 H floats per cell) take
// about half the products' time at H = 256.
// Design: every product is a row_tile (common.cuh) over rows with no
// coupling between them, with its row-local work in the epilogue; what
// couples rows (head sums, sums over j) runs in per-centre passes between
// the products, one block per (fragment, centre atom i), a thread per
// channel.  Stages, in stream order, and the [E, .] rows each moves (E =
// B A A edge rows, in floats per row):
//   (a) node prologue (vislayer.cuh): xn, vecn; qkv; proj.
//   (b) edge @ [W_dkv | W_f] (N = 3H, or 2H for the last layer): the
//       epilogue writes z = silu(zdkv + b) and edge' = edge + silu(zf +
//       b_f) * <wt_i, ws_j> * adj (reads H, writes 3H, reads edge again
//       in the epilogue, H);
//   (c) centre pass 1: a_ij, v_ij -> v_e, x_agg (reads 2H, writes H);
//   (d) v_e @ W_s: the epilogue writes s = silu(zs + b_s) * adj (reads H,
//       writes 2H);
//   (e) o = x_agg @ W_o + b_o;
//   (f) centre pass 2: vec_agg_i = sum_j s1 vecn_j + s2 d_sh_ij, then
//       vec' and x' (reads 2H).
// About 13 H floats move per edge cell, all in L2-sized pieces at fragment
// shapes (z is 13 MB at B = 4, A = 40; 1.2 GB for a whole molecule of 752
// slots, where the scratch z, v_e, s_e is 5 H floats an edge row).  The
// centre passes walk the sources in chunks of ECHUNK = 48 rows
// (common.cuh), staging a chunk's gates or d_sh in shared memory; each of
// their sums is one register chain over the rows in order, so they take any
// A % 8 == 0 (no cap), and at A <= 48 (one chunk) give the
// single-chunk kernel's bits.  For the last layer edge' = edge is a device
// copy.  Every sum runs in a fixed order: the kernel is bitwise
// repeatable.  The TPU's b3 bf16 split, _rowbc, its VMEM budget and its
// 8-row centre tile were Mosaic workarounds and are not carried over.

#include <cstddef>
#include <cstring>

#include "vislayer.cuh"

using namespace ai2bmd;

namespace {

// (b): n < 2H: z[r][n] = silu(acc + b_dkv[n]); n >= 2H: edge'.
struct EdgeEpi {
  Layer p;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const int H = p.H;
    if (n < 2 * H) {
      *reinterpret_cast<float2*>(p.z + r * 2 * H + n) =
          make_float2(silu(v0 + p.b_dkv[n]), silu(v1 + p.b_dkv[n + 1]));
      return;
    }
    const int ch = n - 2 * H, A = p.A, S = p.S, ldp = p.NP * H;
    const EdgeRow e(r, A);
    float2 sdot = make_float2(0.0f, 0.0f);
    for (int c = 0; c < S; ++c) {
      const size_t v = (size_t)e.b * S + c;
      const float2 wt = *reinterpret_cast<const float2*>(p.proj + (v * A + e.i) * ldp + 3 * H + ch);
      const float2 ws = *reinterpret_cast<const float2*>(p.proj + (v * A + e.j) * ldp + 4 * H + ch);
      sdot.x = fmaf(wt.x, ws.x, sdot.x);
      sdot.y = fmaf(wt.y, ws.y, sdot.y);
    }
    const float a = p.adj[r];
    const float2 ed = *reinterpret_cast<const float2*>(p.edge + r * H + ch);
    *reinterpret_cast<float2*>(p.edge2 + r * H + ch) =
        make_float2(ed.x + silu(v0 + p.b_f[ch]) * sdot.x * a,
                    ed.y + silu(v1 + p.b_f[ch + 1]) * sdot.y * a);
  }
};

// (d): s[r][n] = silu(acc + b_s[n]) * adj[r].
struct SEpi {
  Layer p;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const float a = p.adj[r];
    *reinterpret_cast<float2*>(p.s_e + r * 2 * p.H + n) =
        make_float2(silu(v0 + p.b_s[n]) * a, silu(v1 + p.b_s[n + 1]) * a);
  }
};

// (c): v_ij = v_j * dv * silu(a) * gate -> v_e;  x_agg_i = sum_j v_ij, one
// register chain over the rows in order, whatever the chunks.
template <int DH>
__global__ void __launch_bounds__(256) vislayer_fwd_centre1(const Layer p) {
  __shared__ float sGate[ECHUNK];
  const int t = threadIdx.x, A = p.A, H = p.H, H3 = 3 * H;
  const size_t bi = (size_t)blockIdx.y * p.A + blockIdx.x, b0 = bi - blockIdx.x;
  const float qi = p.qkv[bi * H3 + t];
  float xsum = 0.0f;
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    if (c0) __syncthreads();  // every thread is done with the last chunk's gates
    load_gate(p.dist, p.adj, n, p.cutoff, bi * A + c0, sGate);
    __syncthreads();
    for (int c8 = 0; c8 < n; c8 += RCHUNK) {
#pragma unroll
      for (int rr = 0; rr < RCHUNK; ++rr) {
        const int r = c0 + c8 + rr;
        const size_t e = bi * A + r;
        const float kr = p.qkv[(b0 + r) * H3 + H + t];
        const float vr = p.qkv[(b0 + r) * H3 + 2 * H + t];
        const float a = head_pre<DH>(qi, kr, p.z[e * 2 * H + t]);
        const float vij = vr * p.z[e * 2 * H + H + t] * (silu(a) * sGate[c8 + rr]);
        p.v_e[e * H + t] = vij;
        xsum += vij;
      }
    }
  }
  p.xagg[bi * H + t] = xsum;
}

// (f): vec_agg_i[c] = sum_j s1 * vecn_j[c] + sum_j s2 * d_sh_ij[c], then
// x' = x + vdot * o2 + o3 and vec' = vec + vec3 * o1 + vec_agg.  d_sh is
// staged a chunk of sources at a time; each thread's sums run over the rows
// in order across the chunks.
__global__ void __launch_bounds__(256) vislayer_fwd_centre2(const Layer p) {
  __shared__ float sDsh[MAXS * ECHUNK];
  const int t = threadIdx.x, A = p.A, H = p.H, S = p.S, ldp = p.NP * H;
  const size_t bi = (size_t)blockIdx.y * p.A + blockIdx.x, b = blockIdx.y, i = blockIdx.x;
  float from_vec[MAXS], from_dsh[MAXS];
#pragma unroll
  for (int c = 0; c < MAXS; ++c) from_vec[c] = from_dsh[c] = 0.0f;
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    if (c0) __syncthreads();  // every thread is done with the last chunk's d_sh
    for (int e = t; e < S * n; e += blockDim.x) {
      const int c = e / n, r = e % n;
      sDsh[e] = p.dsh[((b * S + c) * A + i) * A + c0 + r];
    }
    __syncthreads();
    // a runtime loop over the rows, four at a time (n % 8 == 0), the four
    // unrolled so that their loads are in flight together (eight held 177
    // registers, one block an SM; a loop the compiler was left to unroll
    // over a chunk's n rows ran 2.3x slower at the fragment shapes)
    for (int r4 = 0; r4 < n; r4 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = r4 + u, r = c0 + rr;
        const size_t e = bi * A + r;
        const float s1 = p.s_e[e * 2 * H + t], s2 = p.s_e[e * 2 * H + H + t];
#pragma unroll
        for (int c = 0; c < MAXS; ++c) {
          if (c < S) {
            from_vec[c] = fmaf(s1, p.vecn[((b * S + c) * A + r) * H + t], from_vec[c]);
            from_dsh[c] = fmaf(s2, sDsh[c * n + rr], from_dsh[c]);
          }
        }
      }
    }
  }
  const float o1 = p.o[bi * 3 * H + t], o2 = p.o[bi * 3 * H + H + t],
              o3 = p.o[bi * 3 * H + 2 * H + t];
  float vdot = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXS; ++c) {
    if (c < S) {
      const size_t v = (b * S + c) * A + i;
      const float* pr = p.proj + v * ldp;
      vdot = fmaf(pr[t], pr[H + t], vdot);
      p.vec2[v * H + t] = p.vec[v * H + t] + pr[2 * H + t] * o1 + (from_vec[c] + from_dsh[c]);
    }
  }
  p.x2[bi * H + t] = p.x[bi * H + t] + vdot * o2 + o3;
}

template <int DH>
cudaError_t launch_fwd(const Layer& p, cudaStream_t stream) {
  const int H = p.H;
  const bool last = p.NP == 3;
  const size_t M = (size_t)p.B * p.A, E = M * p.A;
  const dim3 centres(p.A, p.B);
  cudaError_t err = launch_node_prologue(p, stream);
  if (err != cudaSuccess) return err;
  if (last) {
    err = cudaMemcpyAsync(p.edge2, p.edge, E * H * sizeof(float), cudaMemcpyDeviceToDevice,
                          stream);
    if (err != cudaSuccess) return err;
  }
  err = launch_row_tile<EDGE_TM, false>(p.edge, H, E, H, last ? 2 * H : 3 * H,
                                        wseg(p.w_dkv, 2 * H, 2 * H, p.w_f, H), EdgeEpi{p},
                                        stream);
  if (err != cudaSuccess) return err;
  vislayer_fwd_centre1<DH><<<centres, H, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM, false>(p.v_e, H, E, H, 2 * H, wseg(p.w_s, 2 * H), SEpi{p},
                                        stream);
  if (err != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, false>(p.xagg, H, M, H, 3 * H, wseg(p.w_o, 3 * H),
                                        BiasStore{p.o, 3 * H, p.b_o}, stream);
  if (err != cudaSuccess) return err;
  vislayer_fwd_centre2<<<centres, H, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wide instantiation (vislayer.cuh): the same stages at Hp, with
// centre passes that loop a thread over its channels and sum heads through
// shared memory.
// ---------------------------------------------------------------------------

// (b), wide: n < 2 Hp: z[r][n] = silu(acc + b_dkv[n]) (0 on padded
// channels); n >= 2 Hp: edge' at H, a channel at a time.
struct EdgeEpiWide {
  Layer p;
  int Hp;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    if (n < 2 * Hp) {
      *reinterpret_cast<float2*>(p.z + r * 2 * Hp + n) =
          make_float2(silu(v0 + p.b_dkv[n]), silu(v1 + p.b_dkv[n + 1]));
      return;
    }
    const int ch = n - 2 * Hp, H = p.H, A = p.A, S = p.S, ldp = p.NP * Hp;
    if (ch >= H) return;
    const EdgeRow e(r, A);
    float2 sdot = make_float2(0.0f, 0.0f);
    for (int c = 0; c < S; ++c) {
      const size_t v = (size_t)e.b * S + c;
      const float2 wt = *reinterpret_cast<const float2*>(p.proj + (v * A + e.i) * ldp + 3 * Hp + ch);
      const float2 ws = *reinterpret_cast<const float2*>(p.proj + (v * A + e.j) * ldp + 4 * Hp + ch);
      sdot.x = fmaf(wt.x, ws.x, sdot.x);
      sdot.y = fmaf(wt.y, ws.y, sdot.y);
    }
    const float a = p.adj[r];
    p.edge2[r * H + ch] = p.edge[r * H + ch] + silu(v0 + p.b_f[ch]) * sdot.x * a;
    if (ch + 1 < H)
      p.edge2[r * H + ch + 1] = p.edge[r * H + ch + 1] + silu(v1 + p.b_f[ch + 1]) * sdot.y * a;
  }
};

// (d), wide: s[r][n] = silu(acc + b_s[n]) * adj[r] at 2 Hp.
struct SEpiWide {
  Layer p;
  int Hp;
  __device__ __forceinline__ void operator()(size_t r, int n, float v0, float v1) const {
    const float a = p.adj[r];
    *reinterpret_cast<float2*>(p.s_e + r * 2 * Hp + n) =
        make_float2(silu(v0 + p.b_s[n]) * a, silu(v1 + p.b_s[n + 1]) * a);
  }
};

// (c), wide: per chunk of ECHUNK sources, the head terms q_i k_j dk of the
// H channels into the chunk's v_e rows, their head sums a_ij into its s_e
// rows (block_head_sums over k-tiles staged in sX; s_e is free until (d)
// fills it), then a thread a channel at a time: v_ij -> v_e over the terms
// (0 past H), x_agg_i = sum_j v_ij (at Hp), one chain a channel over the
// rows in order, carried from chunk to chunk in x_agg itself.
__global__ void __launch_bounds__(256) vislayer_fwd_centre1_wide(const Layer p, int Hp, int nh) {
  __shared__ __align__(16) float sX[ECHUNK * XTILE_LD];
  __shared__ float sGate[ECHUNK];
  const int t = threadIdx.x, T = blockDim.x, A = p.A, H = p.H, dh = H / nh, ldq = 3 * Hp;
  const size_t bi = (size_t)blockIdx.y * A + blockIdx.x, b0 = bi - blockIdx.x;
  for (int c0 = 0; c0 < A; c0 += ECHUNK) {
    const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
    const size_t e0 = bi * A + c0, s0 = b0 + c0;
    float* terms = p.v_e + e0 * Hp;   // [n][Hp]
    float* sA = p.s_e + e0 * 2 * Hp;  // [n][nh] a_ij
    if (c0) __syncthreads();  // every thread is done with the last chunk's gates
    load_gate(p.dist, p.adj, n, p.cutoff, e0, sGate);
    for (int ch = t; ch < H; ch += T) {
      const float qi = p.qkv[bi * ldq + ch];
      for (int r = 0; r < n; ++r)
        terms[r * Hp + ch] = layer_term(qi, p.qkv[(s0 + r) * ldq + Hp + ch],
                                        p.z[(e0 + r) * 2 * Hp + ch]);
    }
    block_head_sums(sX, terms, Hp, n, H, nh, dh, sA);
    for (int ch = t; ch < Hp; ch += T) {
      float xsum = c0 ? p.xagg[bi * Hp + ch] : 0.0f;
      for (int r = 0; r < n; ++r) {
        const size_t e = e0 + r;
        const float vij = ch < H ? p.qkv[(s0 + r) * ldq + 2 * Hp + ch] *
                                       p.z[e * 2 * Hp + Hp + ch] *
                                       (silu(sA[r * nh + ch / dh]) * sGate[r])
                                 : 0.0f;
        p.v_e[e * Hp + ch] = vij;
        xsum += vij;
      }
      p.xagg[bi * Hp + ch] = xsum;
    }
  }
}

// (f), wide: as vislayer_fwd_centre2, the channels in turns of T threads
// (d_sh staged again for each turn), x' and vec' written at H.
__global__ void __launch_bounds__(256) vislayer_fwd_centre2_wide(const Layer p, int Hp) {
  __shared__ float sDsh[MAXS * ECHUNK];
  const int t = threadIdx.x, T = blockDim.x, A = p.A, H = p.H, S = p.S, ldp = p.NP * Hp;
  const size_t bi = (size_t)blockIdx.y * p.A + blockIdx.x, b = blockIdx.y, i = blockIdx.x;
  for (int ch0 = 0; ch0 < Hp; ch0 += T) {
    const int ch = ch0 + t;
    float from_vec[MAXS], from_dsh[MAXS];
#pragma unroll
    for (int c = 0; c < MAXS; ++c) from_vec[c] = from_dsh[c] = 0.0f;
    for (int c0 = 0; c0 < A; c0 += ECHUNK) {
      const int n = A - c0 < ECHUNK ? A - c0 : ECHUNK;
      if (c0 || ch0) __syncthreads();  // every thread is done with the last d_sh
      for (int e = t; e < S * n; e += T) {
        const int c = e / n, r = e % n;
        sDsh[e] = p.dsh[((b * S + c) * A + i) * A + c0 + r];
      }
      __syncthreads();
      if (ch < H) {
        for (int rr = 0; rr < n; ++rr) {
          const int r = c0 + rr;
          const size_t e = bi * A + r;
          const float s1 = p.s_e[e * 2 * Hp + ch], s2 = p.s_e[e * 2 * Hp + Hp + ch];
#pragma unroll
          for (int c = 0; c < MAXS; ++c) {
            if (c < S) {
              from_vec[c] = fmaf(s1, p.vecn[((b * S + c) * A + r) * Hp + ch], from_vec[c]);
              from_dsh[c] = fmaf(s2, sDsh[c * n + rr], from_dsh[c]);
            }
          }
        }
      }
    }
    if (ch < H) {
      const float o1 = p.o[bi * 3 * Hp + ch], o2 = p.o[bi * 3 * Hp + Hp + ch],
                  o3 = p.o[bi * 3 * Hp + 2 * Hp + ch];
      float vdot = 0.0f;
#pragma unroll
      for (int c = 0; c < MAXS; ++c) {
        if (c < S) {
          const size_t v = (b * S + c) * A + i;
          const float* pr = p.proj + v * ldp;
          vdot = fmaf(pr[ch], pr[Hp + ch], vdot);
          p.vec2[v * H + ch] =
              p.vec[v * H + ch] + pr[2 * Hp + ch] * o1 + (from_vec[c] + from_dsh[c]);
        }
      }
      p.x2[bi * H + ch] = p.x[bi * H + ch] + vdot * o2 + o3;
    }
  }
}

cudaError_t launch_fwd_wide(const Layer& p, int nh, cudaStream_t stream) {
  const int H = p.H, Hp = wide_width(H), T = wide_threads(H);
  const bool last = p.NP == 3;
  const size_t M = (size_t)p.B * p.A, E = M * p.A;
  const dim3 centres(p.A, p.B);
  cudaError_t err = launch_node_prologue_wide(p, Hp, stream);
  if (err != cudaSuccess) return err;
  if (last) {
    err = cudaMemcpyAsync(p.edge2, p.edge, E * H * sizeof(float), cudaMemcpyDeviceToDevice,
                          stream);
    if (err != cudaSuccess) return err;
  }
  const float* X;
  if ((err = padded_edge_rows(p, Hp, p.v_e, &X, stream)) != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM_WIDE, false, true>(X, Hp, E, Hp, last ? 2 * Hp : 3 * Hp,
                                        wseg(p.w_dkv, 2 * Hp, 2 * Hp, p.w_f, Hp),
                                        EdgeEpiWide{p, Hp}, stream);
  if (err != cudaSuccess) return err;
  vislayer_fwd_centre1_wide<<<centres, T, 0, stream>>>(p, Hp, nh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_row_tile<EDGE_TM_WIDE, false, true>(p.v_e, Hp, E, Hp, 2 * Hp, wseg(p.w_s, 2 * Hp),
                                        SEpiWide{p, Hp}, stream);
  if (err != cudaSuccess) return err;
  err = launch_row_tile<NODE_TM, false, true>(p.xagg, Hp, M, Hp, 3 * Hp, wseg(p.w_o, 3 * Hp),
                                        BiasStore{p.o, 3 * Hp, p.b_o}, stream);
  if (err != cudaSuccess) return err;
  vislayer_fwd_centre2_wide<<<centres, T, 0, stream>>>(p, Hp);
  return cudaGetLastError();
}

}  // namespace

// ptrs: the LAYER_PTRS pointers of Layer in field order (ops/vislayer.py,
// PTR_FIELDS); the forward reads x..b_f, uses the scratch xn, vecn, qkv,
// proj, o, z ([E][2H]), v_e ([E][H]) and s_e ([E][2H]), and writes x2,
// vec2, edge2 and xagg (a_e unused).  dh = H / nh, the channels of a head.  The wide
// instantiation (every shape but narrow_shapes(H, nh)) takes its scratch,
// x_agg and every weight at Hp = wide_width(H) a segment (vislayer.cuh).
extern "C" int vislayer_fwd_launch(const void* const* ptrs, int n_ptrs, int B, int A, int H,
                                   int S, float cutoff, int last, int dh, cudaStream_t stream) {
  static_assert(offsetof(Layer, B) == LAYER_PTRS * sizeof(void*), "Layer: pointers first");
  if (n_ptrs != LAYER_PTRS || !layer_shapes_ok(A, H, S, dh)) return (int)cudaErrorInvalidValue;
  Layer p;
  std::memcpy(&p, ptrs, LAYER_PTRS * sizeof(void*));
  p.B = B, p.A = A, p.H = H, p.S = S, p.NP = last ? 3 : 5, p.cutoff = cutoff;
  if (!narrow_shapes(H, H / dh)) return (int)launch_fwd_wide(p, H / dh, stream);
  return with_head_width(dh, [&](auto d) {
    return (int)launch_fwd<decltype(d)::value>(p, stream);
  });
}

// shared memory, blocks per SM, registers and spill bytes of one stage:
// 0 qkv (node rows), 1 proj (vector rows), 2 edge @ [W_dkv | W_f],
// 3 centre pass 1, 4 v_e @ W_s, 5 centre pass 2
extern "C" int vislayer_fwd_occupancy(int A, int H, int S, int stage, int* out) {
  (void)A, (void)S;
  switch (stage) {
    case 0: return occupancy(row_tile<NODE_TM, false, BiasStore>, 256, tile_smem<NODE_TM>(), out);
    case 1: return occupancy(row_tile<VEC_TM, false, BiasStore>, 256, tile_smem<VEC_TM>(), out);
    case 2: return occupancy(row_tile<EDGE_TM, false, EdgeEpi>, 256, tile_smem<EDGE_TM>(), out);
    case 3: return occupancy(vislayer_fwd_centre1<32>, H, 0, out);
    case 4: return occupancy(row_tile<EDGE_TM, false, SEpi>, 256, tile_smem<EDGE_TM>(), out);
    case 5: return occupancy(vislayer_fwd_centre2, H, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the same for the wide instantiation at H channels and nh heads: 0 edge
// @ [W_dkv | W_f], 1 centre pass 1, 2 v_e @ W_s, 3 centre pass 2, 4 the
// node rows (xn, vecn), 5 the edge rows' padding; out[4] receives the rows
// of centre pass 1's source chunk, out[5] the columns of its k-tiles (its
// shared memory is static: no H or nh changes it)
extern "C" int vislayer_fwd_wide_occupancy(int H, int S, int nh, int stage, int* out) {
  (void)S, (void)nh;
  const int T = wide_threads(H);
  out[4] = ECHUNK;
  out[5] = XTILE;
  switch (stage) {
    case 0: return occupancy(row_tile<EDGE_TM_WIDE, false, EdgeEpiWide, float, true>, 256,
                                    tile_smem<EDGE_TM_WIDE>(), out);
    case 1: return occupancy(vislayer_fwd_centre1_wide, T, 0, out);
    case 2: return occupancy(row_tile<EDGE_TM_WIDE, false, SEpiWide, float, true>, 256,
                                    tile_smem<EDGE_TM_WIDE>(), out);
    case 3: return occupancy(vislayer_fwd_centre2_wide, T, 0, out);
    case 4: return occupancy(node_prep_wide, 256, 0, out);
    case 5: return occupancy(pad_rows, 256, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
