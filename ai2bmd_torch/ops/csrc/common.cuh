// Shared device helpers for the ai2bmd_torch kernels (float32 throughout).
//
// The products take one of three modes, a compile-time constant of the
// library (AI2BMD_MM_MODE; ops/_build.py builds one library per mode, and
// ops/vismp.py picks it from AI2BMD_KERNEL_MM_PRECISION, the variable of the
// JAX package's kernels, ai2bmd_tpu/ops/pallas/vismp.py:43-70):
// - MM_B3 (the production mode, the default): the 3xTF32 split below;
// - MM_HIGHEST: full float32, each output a chain of float32 FMAs over k in
//   order (the order of a plain float32 dot product), on the CUDA cores: the
//   operands keep mma.sync's fragment layout and reach the lanes that own
//   each accumulator through warp shuffles (`gather_rows` / `gather_cols`,
//   `fma_tile`).  Chosen over a six-pass three-way TF32 split (the
//   counterpart of the TPU's six-pass HIGHEST) because the tensor cores'
//   own float32 accumulation, which a split cannot remove, is not IEEE
//   rounding: the FMA chain's error is a float32 product's by construction.
//   Bound: 67 TFLOP/s of float32 FMA;
// - MM_DEFAULT: one pass on operands rounded to bfloat16 (cvt.rn.bf16.f32,
//   round to nearest even, widened back), the TPU's single bf16 pass.  A
//   bfloat16 value is exact in TF32, so the m16n8k8 TF32 mma.sync carries
//   it: one pass in place of three, and no lo halves.  Bound: 495 TF32
//   TFLOP/s.
// In MM_B3, every product of every kernel runs on the tensor cores with a
// 3xTF32 split: each float32 operand x is cut into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna, 10 explicit mantissa bits each), and each
// product is lo*hi + hi*lo + hi*hi, three m16n8k8 mma.sync products in that
// order into one float32 accumulator.  What it drops against a float32
// product: lo_x*lo_w (|.| <= 2^-22 |x w|) and the rounding of lo
// (<= 2^-22 |x|), so each term carries at most ~2^-21 of |x w| beside the
// float32 sum's own rounding; over K terms that stays within a few float32
// roundings, where one TF32 pass alone would carry 2^-11
// (tests/test_torch_tf32x3.py holds the split's error to <= 10x a float32
// product's at K = 256 and 512).  The bound is the tensor cores' 495 TF32
// TFLOP/s over the three passes, 165 TFLOP/s in float32 products.
//
// Two forms of the product:
// - `mma_rows_times_cols` (K1, K2, K7, K8's zf): one chunk of a centre's
//   edge rows (<= 48) in shared memory, inside a block that also does the centre's
//   elementwise work.  Every warp loads and splits its own W fragments from
//   L2 and splits the shared rows again, about two other instructions per
//   product, with two or four warps a scheduler to hide the latency: it
//   reaches ~20% of mma.sync's rate (chip_smoke.py phase 3 prints both).
// - `row_tile` (K3/K8's g_edge, every product of K5 and K6): a kernel of
//   its own over rows with no coupling between them, TM rows x 64 output
//   columns a block of 8 warps.  X and W k-slabs are copied to shared
//   memory with cp.async (double-buffered), the W slab is split into hi /
//   lo once per block and read by all warps with ldmatrix, so TM rows share
//   each split; the 64-column blocks give small row counts a grid that
//   fills the card.  W is read as it is stored in both forms (X @ W and
//   X @ W^T), from up to three weight tensors side by side, so no kernel
//   copies or transposes a weight; a row-local epilogue (a functor) takes
//   the accumulators, so bias, activations, gates and residual sums make no
//   extra pass over the rows.
// wgmma (64-row warpgroup tiles, swizzled shared-memory operands) is left
// to a later change.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace ai2bmd {

// ---------------------------------------------------------------------------
// Storage types
// ---------------------------------------------------------------------------
//
// The edge kernels (K1-K3, K7, K8) store their streams, weights and outputs
// as float or as bfloat16 (`bf16`, the mixed-precision mode of
// ops/vismp.py).  Each source compiles one storage type, `EdgeT`
// (AI2BMD_STORE_BF16 selects bfloat16; ops/_build.py compiles the edge
// sources once each way, in parallel).  A load widens to float (exact), a
// store rounds to nearest even; everything between runs in float, and
// `rnd<T>` rounds a float as T would store it where the JAX kernels round a
// bfloat16 intermediate (ops/vismp.py lists where).  For T = float every
// helper is the identity, so the float32 kernels compile as before.
using bf16 = __nv_bfloat16;
#ifdef AI2BMD_STORE_BF16
using EdgeT = bf16;
#define AI2BMD_ENTRY(name) name##_bf16_launch
#else
using EdgeT = float;
#define AI2BMD_ENTRY(name) name##_launch
#endif
template <class T>
constexpr bool IS_BF16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
// __ldg of a float or a bfloat16, widened
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) { return __bfloat162float(__ldg(p)); }

template <class T>
__device__ __forceinline__ T st(float x) {
  if constexpr (IS_BF16<T>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// x as T stores it, back in float
template <class T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (IS_BF16<T>) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

#ifndef AI2BMD_MM_MODE
#define AI2BMD_MM_MODE 0
#endif
constexpr int MM_B3 = 0, MM_HIGHEST = 1, MM_DEFAULT = 2;
constexpr int MM_MODE = AI2BMD_MM_MODE;
static_assert(MM_MODE == MM_B3 || MM_MODE == MM_HIGHEST || MM_MODE == MM_DEFAULT,
              "AI2BMD_MM_MODE is 0 (b3), 1 (highest) or 2 (default)");

// Largest slot count of a fragment: the dipeptide rows of every bundled
// protein are at most 40 slots wide, ACE-NME units 16.  Only the product
// helper's default row bound (mma_rows_times_cols) and its lone test
// launcher (tf32x3_mm.cu) still use it.
constexpr int MAXA = 48;
// Every centre pass (K1-K3, K7, K8, and K5/K6's centre passes) walks a
// centre's sources in chunks of at most ECHUNK rows: shared memory and
// per-row registers are sized by the chunk, not by A, so they take any
// A % 8 == 0, as the TPU's dense kernels do (vislayer.py:440, :495): a
// fragment (A <= 48, one chunk) or a whole molecule of any size.  No slot
// count is capped.  Every index into an edge tensor ([B A A][up to 5 Hp],
// past 2^31 elements at A = 1112 and H = 512) or a per-atom tensor is a
// size_t, the block's row and chunk offsets included; only shared-memory
// and per-chunk indices are int.  The card's memory bounds A.
constexpr int ECHUNK = 48;
// Rows go in chunks of RCHUNK, and a slot count is a multiple of it (the
// fragment indexer rounds slots to 8): a guard per chunk instead of per row
// lets the compiler batch a chunk's loads and warp reductions.
constexpr int RCHUNK = 8;
// Largest number of spherical-harmonic components, (lmax + 1)^2 - 1 at lmax 2.
constexpr int MAXS = 8;
// The source-indexed sums of the bfloat16 backward kernels (g_k, g_v,
// g_vec, g_wsrc) go as the JAX kernels accumulate them across their grid:
// each block of I_TILE centres summed in float and rounded, the blocks added
// in order to a bfloat16 total (ops/vismp.py: _source_sum_bf16).
constexpr int I_TILE = 8;

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ float silu(float z) { return z * sigmoid(z); }

// d silu / dz
__device__ __forceinline__ float dsilu(float z) {
  const float s = sigmoid(z);
  return s * (1.0f + z * (1.0f - s));
}

// sigmoid, silu and silu' of a bfloat16 stash value as the JAX kernels
// compute them on bfloat16 (ops/vismp.py: _sigmoid_bf16, _dsilu_bf16):
// 1 / (1 + exp(-z)) with each step rounded, silu z sigmoid(z) rounded,
// silu' sg (1 + z (1 - sg)) rounded at every step but the last.
__device__ __forceinline__ float sigmoid_bf16(float z) {
  return rnd<bf16>(1.0f / rnd<bf16>(1.0f + rnd<bf16>(expf(-z))));
}
__device__ __forceinline__ float silu_bf16(float z) { return rnd<bf16>(z * sigmoid_bf16(z)); }
__device__ __forceinline__ float dsilu_bf16(float z) {
  const float s = sigmoid_bf16(z);
  return s * rnd<bf16>(1.0f + rnd<bf16>(z * rnd<bf16>(1.0f - s)));
}

// silu, silu' and the product of two values read from a stash: in
// bfloat16 (B16: K2 and K3 from a bfloat16 stash) as the JAX kernels
// compute them there, else in float.
template <bool B16>
__device__ __forceinline__ float silu_st(float z) {
  if constexpr (B16) {
    return silu_bf16(z);
  } else {
    return silu(z);
  }
}
template <bool B16>
__device__ __forceinline__ float dsilu_st(float z) {
  if constexpr (B16) {
    return dsilu_bf16(z);
  } else {
    return dsilu(z);
  }
}
template <bool B16>
__device__ __forceinline__ float rnd_st(float x) {
  return B16 ? rnd<bf16>(x) : x;
}

// Sum over the DH lanes of one attention head: a head is DH consecutive
// channels, one a thread.  Up to DH = 32 a warp holds 32 / DH heads side by
// side and the butterfly over offsets DH/2 .. 1 stays inside each.  A head
// of 64 channels spans the warp pair (2h, 2h + 1): each warp's butterfly
// sum goes through shared memory and the pair adds them in warp order,
// between two block barriers, so every thread of the block must call it
// together (every caller's row loops are uniform over the block).  Every
// lane gets its own head's sum.  The order is fixed, so the result is
// bitwise repeatable; at DH = 32 it is warp_sum, offset for offset.
template <int DH>
__device__ __forceinline__ float head_sum(float x) {
  static_assert(DH == 8 || DH == 16 || DH == 32 || DH == 64,
                "heads of 8, 16, 32 or 64 channels");
  constexpr int LANES = DH < 32 ? DH : 32;
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if constexpr (DH == 64) {
    __shared__ float part[32];  // one a warp (blockDim.x <= 1024)
    const int w = threadIdx.x / 32;
    __syncthreads();  // every warp has read the last call's partials
    if (threadIdx.x % 32 == 0) part[w] = x;
    __syncthreads();
    x = part[w & ~1] + part[w | 1];
  }
  return x;
}

// Sum over the 32 lanes of a warp; every lane gets the total.  The sums
// over all channels (LayerNorm statistics, g_dist, g_d_sh) take one a warp
// and then add the warps in a fixed order.
__device__ __forceinline__ float warp_sum(float x) { return head_sum<32>(x); }

// Call f(std::integral_constant<int, DH>{}) for the head width dh (H / nh)
// that the kernels are instantiated for; any other dh is refused.
template <class F>
static int with_head_width(int dh, F&& f) {
  switch (dh) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float cosine_cutoff(float d, float cutoff) {
  return d < cutoff ? 0.5f * (cosf(d * (3.14159265358979323846f / cutoff)) + 1.0f) : 0.0f;
}

// The cutoff of a distance stored as T: for bfloat16, as the JAX kernels
// compute it on a bfloat16 distance, pi / cutoff rounded first and every
// step rounded (ops/vismp.py: cosine_cutoff on a bfloat16 distance).
template <class T>
__device__ __forceinline__ float cutoff_of(float d, float cutoff) {
  if constexpr (IS_BF16<T>) {
    const float kb = rnd<bf16>(3.14159265358979323846f / cutoff);
    return d < cutoff ? 0.5f * rnd<bf16>(rnd<bf16>(cosf(rnd<bf16>(d * kb))) + 1.0f) : 0.0f;
  } else {
    return cosine_cutoff(d, cutoff);
  }
}

// d cutoff / d r of a distance stored as T (for bfloat16 every step rounded
// but the last product, ops/vismp.py: _dcut_bf16); kpi = pi / cutoff.
template <class T>
__device__ __forceinline__ float dcutoff_of(float d, float cutoff, float kpi) {
  if constexpr (IS_BF16<T>) {
    const float kb = rnd<bf16>(kpi), kd = rnd<bf16>(-0.5f * kpi);
    return d < cutoff ? kd * rnd<bf16>(sinf(rnd<bf16>(d * kb))) : 0.0f;
  } else {
    return d < cutoff ? -0.5f * kpi * sinf(d * kpi) : 0.0f;
  }
}

// Copy A rows of H floats (device memory, dense) into shared memory at row
// stride ld (ld % 4 == 0), float4 a thread; bfloat16 rows widen, four
// values (8 bytes) a thread.
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src, int A, int H) {
  const int H4 = H / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int x = threadIdx.x; x < A * H4; x += blockDim.x) {
    const int r = x / H4;
    reinterpret_cast<float4*>(dst + r * ld)[x - r * H4] = s4[x];
  }
}
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int ld,
                                          const bf16* __restrict__ src, int A, int H) {
  const int H4 = H / 4;
  const uint2* s4 = reinterpret_cast<const uint2*>(src);
  for (int x = threadIdx.x; x < A * H4; x += blockDim.x) {
    const int r = x / H4;
    const uint2 u = s4[x];
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    reinterpret_cast<float4*>(dst + r * ld)[x - r * H4] = make_float4(a.x, a.y, b.x, b.y);
  }
}

// The shared-memory row stride for rows of n floats that
// mma_rows_times_cols reads or writes: n + 4, so that the 8 rows x 4
// columns a warp reads for one B fragment, and the 4 row pairs x 8 columns
// it stores, fall in 32 different banks (n % 32 == 0).
__host__ __device__ constexpr int mma_ld(int n) { return n + 4; }

// cvt.rna.tf32.f32: the nearest TF32 value, ties away from zero, as a
// float32 bit pattern whose low 13 bits are 0.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// cvt.rn.bf16.f32 widened back: the nearest bfloat16 value, ties to even,
// as a float32 bit pattern whose low 16 bits are 0 (exact in TF32).
__device__ __forceinline__ unsigned to_bf16(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return (unsigned)h << 16;
}

// An operand as the one-pass modes take it: rounded to bfloat16 (MM_DEFAULT)
// or as it is (MM_HIGHEST).
__device__ __forceinline__ unsigned mm_operand(float x) {
  if constexpr (MM_MODE == MM_DEFAULT) {
    return to_bf16(x);
  } else {
    return __float_as_uint(x);
  }
}

// MM_HIGHEST: the float32 values of an m16n8k8 A fragment (lane 4 g + q
// holds A[g][q], A[g + 8][q], A[g][q + 4], A[g + 8][q + 4]) gathered so that
// each lane holds the whole rows of its accumulators: r[0][k] = A[g][k],
// r[1][k] = A[g + 8][k].
__device__ __forceinline__ void gather_rows(float (&r)[2][8], const unsigned (&a)[4]) {
  const int base = threadIdx.x & 28;  // 4 g
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    r[0][k] = __uint_as_float(__shfl_sync(0xffffffffu, a[k < 4 ? 0 : 2], base + (k & 3)));
    r[1][k] = __uint_as_float(__shfl_sync(0xffffffffu, a[k < 4 ? 1 : 3], base + (k & 3)));
  }
}

// MM_HIGHEST: a B fragment (lane 4 g + q holds B[q][g], B[q + 4][g])
// gathered to the columns of each lane's accumulators: c[j][k] = B[k][2 q + j].
__device__ __forceinline__ void gather_cols(float (&c)[2][8], const unsigned (&b)[2]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[0][k] = __uint_as_float(__shfl_sync(0xffffffffu, b[k >> 2], 8 * q + (k & 3)));
    c[1][k] = __uint_as_float(__shfl_sync(0xffffffffu, b[k >> 2], 8 * q + 4 + (k & 3)));
  }
}

// MM_HIGHEST: d += A B for one 16 x 8 x 8 tile in mma.sync's accumulator
// layout (d: rows g, g + 8 x columns 2 q, 2 q + 1), a float32 FMA a term in
// k order.
__device__ __forceinline__ void fma_tile(float (&d)[4], const float (&r)[2][8],
                                         const float (&c)[2][8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    d[0] = fmaf(r[0][k], c[0][k], d[0]);
    d[1] = fmaf(r[0][k], c[1][k], d[1]);
    d[2] = fmaf(r[1][k], c[0][k], d[2]);
    d[3] = fmaf(r[1][k], c[1][k], d[3]);
  }
}

// d += a b for one 16 x 8 x 8 tile: TF32 operands, float32 accumulation.
// Not volatile: the compiler may interleave independent tiles' products,
// while each accumulator's own products keep their order.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step's W fragments of a warp's two m16 tiles, from p = &W[k0 + q][n + g]:
// f[mt] = W[k0 + q (+4)][n + 16 mt + g (+8)].
// W is float or bfloat16 (widened on load).
template <class TW>
__device__ __forceinline__ void load_w_frags(float (&f)[2][4], const TW* __restrict__ p,
                                             int ldw) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    f[mt][0] = ldg(p + 16 * mt);
    f[mt][1] = ldg(p + 16 * mt + 8);
    f[mt][2] = ldg(p + 4 * (size_t)ldw + 16 * mt);
    f[mt][3] = ldg(p + 4 * (size_t)ldw + 16 * mt + 8);
  }
}

// One k-step of 8 of mma_rows_times_cols: split this step's W fragments f,
// refill f with the step two ahead, then for each row tile split its B
// fragment and run the three passes over the warp's two m16 tiles (the
// compiler overlaps one tile's loads and splits with the last one's
// products; a split B fragment is held for one tile only, which keeps the
// helper near 90 registers).  MM_DEFAULT rounds each fragment to bfloat16
// and runs one pass; MM_HIGHEST gathers the W fragments' rows once a step
// and each row tile's columns, then runs the FMA chain.  Xk is X's column
// k0 (row stride ldx), Wq W's row q (the k-step reads rows k0 + q (+4)).
template <int MAXR, class TW>
__device__ __forceinline__ void mma_k_step(float (&acc)[2][MAXR / RCHUNK][4], float (&f)[2][4],
                                           const float* Xk, int ldx, int A, int k0, int K,
                                           const TW* __restrict__ Wq, int ldw, int g, int q) {
  constexpr int NT = MAXR / RCHUNK;
  if constexpr (MM_MODE != MM_B3) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[mt][j] = mm_operand(f[mt][j]);
    if (k0 + 16 < K) load_w_frags(f, Wq + (size_t)(k0 + 16) * ldw, ldw);
    float r[2][2][8];
    if constexpr (MM_MODE == MM_HIGHEST) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) gather_rows(r[mt], a[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * RCHUNK < A) {
        const float* x = Xk + (nt * RCHUNK + g) * ldx + q;
        const unsigned b[2] = {mm_operand(x[0]), mm_operand(x[4])};
        if constexpr (MM_MODE == MM_DEFAULT) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], a[mt], b);
        } else {
          float c[2][8];
          gather_cols(c, b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) fma_tile(acc[mt][nt], r[mt], c);
        }
      }
    }
  } else {
    unsigned ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(f[mt][j], ahi[mt][j], alo[mt][j]);
    if (k0 + 16 < K) load_w_frags(f, Wq + (size_t)(k0 + 16) * ldw, ldw);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt * RCHUNK < A) {
        const float* x = Xk + (nt * RCHUNK + g) * ldx + q;
        unsigned bhi[2], blo[2];
        split_tf32(x[0], bhi[0], blo[0]);
        split_tf32(x[4], bhi[1], blo[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], alo[mt], bhi);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], ahi[mt], blo);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_tf32(acc[mt][nt], ahi[mt], bhi);
      }
    }
  }
}

// out[r][n] = sum_k X[r][k] * W[k][col0 + n] for r < A and
// n < 32 * (blockDim.x / 32), on the tensor cores with the 3xTF32 split.
// X: [A][ldx] in shared memory (ldx = mma_ld(.) for conflict-free reads,
// A % RCHUNK == 0, A <= MAXR); W: [K][ldw] row-major in device memory
// (K % 16 == 0), float or bfloat16; out: [A][ldo] in shared or device memory,
// float or bfloat16 (rounded at the store), and may alias X.
// Every thread of the block calls it: it synchronises the block when it
// starts (X is written), before it stores (every warp has read X) and when
// it ends (out is written).
// Layout: the transposed product out^T = W^T X^T, with the output channels
// on the MMA's M side and the edge rows on its N side, so A needs no
// padding.  Warp w owns the 32 columns n = 32 w.. (two m16 tiles) for all
// rows (MAXR / 8 n8 tiles): it loads its own W fragments from L2, two
// k-steps ahead in registers, and splits them once per k-step; the B
// fragments (the rows of X) are read from shared memory by every warp.
// A thread holds, per k-step, W[k0 + q (+4)][col0 + n + g (+8)]
// (g = lane / 4, q = lane % 4) and X[r0 + g][k0 + q (+4)]; its
// accumulators out[r0 + 2q (+1)][n + g (+8)].  Every sum runs in a fixed
// order: bitwise repeatable, and equal between any two kernels that call it
// on equal X and W.
template <int MAXR = MAXA, class TW, class TO>
__device__ __forceinline__ void mma_rows_times_cols(const float* X, int ldx, int A, int K,
                                                    const TW* __restrict__ W, int ldw,
                                                    int col0, TO* out, int ldo) {
  constexpr int NT = MAXR / RCHUNK;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int n0 = 32 * (threadIdx.x >> 5);
  const TW* Wq = W + (size_t)q * ldw + col0 + n0 + g;
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;
  float fa[2][4], fb[2][4];
  load_w_frags(fa, Wq, ldw);
  load_w_frags(fb, Wq + 8 * (size_t)ldw, ldw);
  __syncthreads();  // X is written
  for (int k0 = 0; k0 < K; k0 += 16) {
    mma_k_step<MAXR>(acc, fa, X + k0, ldx, A, k0, K, Wq, ldw, g, q);
    mma_k_step<MAXR>(acc, fb, X + k0 + 8, ldx, A, k0 + 8, K, Wq, ldw, g, q);
  }
  __syncthreads();  // every warp has read X
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * RCHUNK < A) {
      TO* o = out + (nt * RCHUNK + 2 * q) * ldo + n0 + g;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        o[16 * mt] = st<TO>(acc[mt][nt][0]);
        o[ldo + 16 * mt] = st<TO>(acc[mt][nt][1]);
        o[16 * mt + 8] = st<TO>(acc[mt][nt][2]);
        o[ldo + 16 * mt + 8] = st<TO>(acc[mt][nt][3]);
      }
    }
  }
  __syncthreads();  // out is written
}

// ---------------------------------------------------------------------------
// The wide instantiations of the edge kernels
// ---------------------------------------------------------------------------
//
// K1-K3, K7 and K8 have two instantiations each.  The narrow one (above:
// one thread a channel, head_sum<DH> on a warp's lanes, sources in chunks
// of ECHUNK) takes heads of 8, 16, 32 or 64 channels with H a multiple of
// 32 up to 256.  The wide one takes every other H and every head count that
// divides it; no constant bounds H, and no shared memory grows with it:
// - channels are padded to Hp, the next multiple of 32: the wrappers
//   (ops/vismp.py) hand the kernels their weights zero-padded to Hp (per
//   half), a product's rows read zeros past H, so a padded channel adds
//   nothing to a product and no kernel writes one out;
// - at most 256 threads a block, each owning the channels t, t + 256, ...
//   (a loop over channels inside each pass, so per-channel registers live
//   for one channel at a time);
// - a chunk's rows of Hp (or 2 Hp) channels live in device memory, in the
//   block's own slot of a scratch the wrappers allocate (`wide_scratch`:
//   the products' outputs, the messages, the cotangent rows, the head
//   sums), where they stay in L2 while the chunk is worked on;
// - the products are `mma_tiles`: mma_rows_times_cols's k-steps, each warp
//   looping over its 32-column tiles, over rows staged in shared memory a
//   k-tile of XTILE columns at a time (sX, [ECHUNK][XTILE + 4]), each
//   KSLAB-deep slab of k summed apart and added to the running sums in
//   float32;
// - a head sums its DH channels in order, one (row, head) a thread, from
//   the same k-tiles (`block_head_sums`): a head wider than a tile carries
//   its partial sum from one tile to the next;
// - the sources go in chunks of ECHUNK rows, as in the narrow kernels: the
//   shared memory of a wide block is fixed (static, under 48 KB).
// Every sum runs in a fixed order: bitwise repeatable, and K7/K8's
// recomputed pre-activations equal K1's stash, as in the narrow kernels
// (K1, K7 and K8 take the same products over the same k-tiles).
// the most shared memory one block may take (227 KB)
constexpr size_t SMEM_MAX = 232448;
// the columns of a k-tile of a wide kernel's rows in shared memory
constexpr int XTILE = 128;
constexpr int XTILE_LD = mma_ld(XTILE);
// the k-terms mma_tiles sums apart before it adds them to its running sums
// in float32: the widest narrow K (256), so that the narrow and wide
// products agree bitwise wherever both run
constexpr int KSLAB = 2 * XTILE;

// Which instantiation a launcher takes, one predicate a kernel family
// (``narrow_shapes`` / ``narrow_update`` in ops/vismp.py): K1, K2 and K7
// sum heads, so their narrow instantiations take nh heads of 8, 16, 32 or
// 64 channels with H a multiple of 32 up to 256; K3 and K8 sum no head, so
// theirs take every H a multiple of 32 up to 256.
inline bool narrow_update(int H) { return H % 32 == 0 && H <= 256; }

inline bool narrow_shapes(int H, int nh) {
  if (nh <= 0 || H % nh) return false;
  const int dh = H / nh;
  return narrow_update(H) && (dh == 8 || dh == 16 || dh == 32 || dh == 64);
}

// H rounded up to a multiple of 32: the wide kernels' padded width.
__host__ __device__ __forceinline__ int wide_width(int H) { return (H + 31) / 32 * 32; }

// The threads of a wide block: one a channel of Hp, at most 256.
inline int wide_threads(int H) { return wide_width(H) < 256 ? wide_width(H) : 256; }

// Floats of device scratch one block of a wide kernel takes (its slot of the
// wrappers' scratch, B A slots; ops/vismp.py): for a chunk of min(A,
// ECHUNK) rows, K1 (kind 0) a product's output rows and the messages
// ([CH][Hp] each) and a_ij ([CH][nh]); K2/K7 (kind 1) the [CH][2 Hp] rows
// of the head terms, g_s and g_dkv, the [CH][Hp] rows of v_ij and g_vij,
// a_ij and the head sums of g_g3 gate ([CH][nh] each).
__host__ __device__ inline size_t wide_scratch(int kind, int A, int H, int nh) {
  const size_t CH = A < ECHUNK ? A : ECHUNK, Hp = wide_width(H);
  return kind == 0 ? CH * (2 * Hp + nh) : CH * (3 * Hp + 2 * (size_t)nh);
}

// This block's slot of a wide kernel's scratch (grid (A, B): b A + i).
__device__ __forceinline__ size_t block_slot() {
  return (size_t)blockIdx.y * gridDim.x + blockIdx.x;
}

// sX[r][c] = X[r][k0 + c] for r < n, c < kw, 0 where k0 + c >= kv: a
// k-tile of n rows (device memory, row stride ldx, float or bfloat16,
// widened) staged in shared memory at stride XTILE_LD.  X may be written
// by this block (its scratch): it is read through the coherent path.
template <class TX>
__device__ __forceinline__ void stage_tile(float* __restrict__ sX, const TX* X, size_t ldx,
                                           int kv, int n, int k0, int kw) {
  for (int x = threadIdx.x; x < n * kw; x += blockDim.x) {
    const int r = x / kw, c = x - r * kw;
    sX[r * XTILE_LD + c] = k0 + c < kv ? widen(X[r * ldx + k0 + c]) : 0.0f;
  }
}

// out[r][n] = sum_k X[r][k] * W[k][col0 + n] for r < A and n < N (N % 32 ==
// 0), stored for n < nout only.  X: A rows of K floats (K % 16 == 0) in
// device memory at row stride ldx, read as 0 at k >= kv; they go through
// sX ([ECHUNK][XTILE_LD], shared) a k-tile at a time.  The k-steps are
// mma_rows_times_cols's, in the same order whatever the tiles, so equal X
// and W give equal bits.  Each KSLAB-deep slab of k sums into
// accumulators of its own, added to the running sums by float32 adds after
// the slab (as row_tile's PROMOTE): the tensor cores' un-rounded float32
// accumulation then errs as a sum of KSLAB terms at any K, not of K terms.
// At K <= KSLAB the sum is mma_rows_times_cols's bit for bit, so a narrow
// K8 (H <= 256) rebuilds a wide K1's z_f stash exactly.
// Warp w takes the 32-column tiles w, w + warps,
// ... in turn (the block's warps together, so that all meet at each tile's
// barriers), each over all k-tiles; out must not alias X.  Every thread of
// the block calls it: it synchronises the block before each k-tile (X is
// written; every warp is done with the last tile) and when it ends (out is
// written).
template <int MAXR = ECHUNK, class TX, class TW, class TO>
__device__ __forceinline__ void mma_tiles(float* __restrict__ sX, const TX* X, size_t ldx,
                                          int kv, int A, int K, const TW* __restrict__ W,
                                          int ldw, int col0, int N, TO* out, size_t ldo,
                                          int nout) {
  constexpr int NT = MAXR / RCHUNK;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int step = 32 * (blockDim.x >> 5);
  for (int nb = 0; nb < N; nb += step) {
    const int n0 = nb + 32 * (threadIdx.x >> 5);
    const bool on = n0 < N;  // this warp has a column tile in this turn
    const TW* Wq = W + (size_t)q * ldw + col0 + (on ? n0 : 0) + g;
    float acc[2][NT][4], part[2][NT][4];  // the running sums; this k-tile's
    float fa[2][4], fb[2][4];
    if (on) {
      load_w_frags(fa, Wq, ldw);
      load_w_frags(fb, Wq + 8 * (size_t)ldw, ldw);
    }
    for (int kt = 0; kt < K; kt += XTILE) {
      const int kw = K - kt < XTILE ? K - kt : XTILE;
      __syncthreads();  // X is written; every warp is done with the last tile
      stage_tile(sX, X, ldx, kv, A, kt, kw);
      __syncthreads();
      if (on) {
        if (kt % KSLAB == 0) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) part[mt][nt][j] = 0.0f;
        }
        for (int k0 = kt; k0 < kt + kw; k0 += 16) {
          mma_k_step<MAXR>(part, fa, sX + (k0 - kt), XTILE_LD, A, k0, K, Wq, ldw, g, q);
          mma_k_step<MAXR>(part, fb, sX + (k0 + 8 - kt), XTILE_LD, A, k0 + 8, K, Wq, ldw, g, q);
        }
        if ((kt + kw) % KSLAB == 0 || kt + kw == K) {  // the slab's end
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[mt][nt][j] = kt < KSLAB ? part[mt][nt][j] : acc[mt][nt][j] + part[mt][nt][j];
        }
      }
    }
    if (on) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt * RCHUNK < A) {
          TO* o = out + (size_t)(nt * RCHUNK + 2 * q) * ldo;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int c = n0 + g + 16 * mt + 8 * half;
              if (c < nout) {
                o[c] = st<TO>(acc[mt][nt][2 * half]);
                o[ldo + c] = st<TO>(acc[mt][nt][2 * half + 1]);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();  // out is written
}

// out[r][h] = sum_j p[r][h dh + j] over j = 0 .. dh - 1 in order, for r < n
// and h < nh: the attention head sums of the wide kernels, one (row, head)
// a thread.  p: n rows of the H channels' terms in device memory at stride
// ldp, staged in sX a k-tile of XTILE channels at a time; a head that
// spans tiles carries its partial sum in out (device or shared memory)
// from one tile to the next, so every sum runs over its channels in order
// from 0, as one loop over whole rows would.  Every thread of the block
// calls it: it synchronises the block before each tile (p is written;
// every thread is done with the last tile and its partial sums) and when
// it ends (out is written).
__device__ __forceinline__ void block_head_sums(float* __restrict__ sX, const float* p,
                                                size_t ldp, int n, int H, int nh, int dh,
                                                float* out) {
  for (int kt = 0; kt < H; kt += XTILE) {
    const int kw = H - kt < XTILE ? H - kt : XTILE;
    __syncthreads();
    stage_tile(sX, p, ldp, H, n, kt, kw);
    __syncthreads();
    const int h0 = kt / dh, heads = (kt + kw - 1) / dh - h0 + 1;  // the tile's heads
    for (int x = threadIdx.x; x < n * heads; x += blockDim.x) {
      const int r = x / heads, h = h0 + x - r * heads;
      const int lo = h * dh > kt ? h * dh : kt;
      const int hi = (h + 1) * dh < kt + kw ? (h + 1) * dh : kt + kw;
      const float* pr = sX + r * XTILE_LD;
      float s = lo == h * dh ? 0.0f : out[r * nh + h];
      for (int j = lo; j < hi; ++j) s += pr[j - kt];
      out[r * nh + h] = s;
    }
  }
  __syncthreads();
}

// The terms of the attention pre-activation a_ij = sum_head q_i k_j dk,
// dk = silu(zk), and the message v_ij = v_j dv silu(a) gate, dv = silu(zv):
// one expression each for K1 and K2/K7's wide instantiations, so that K2
// and K7 rebuild K1's values bitwise.
__device__ __forceinline__ float head_term(float qi, float kr, float zk) {
  return qi * kr * silu(zk);
}
__device__ __forceinline__ float edge_message(float vr, float zv, float a, float gate) {
  return vr * silu(zv) * (silu(a) * gate);
}

// ---------------------------------------------------------------------------
// The row tile
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes device -> shared, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Four (x4) or two (x2) 8 x 4 matrices of 32-bit values from shared memory
// (ldmatrix counts them as 8 x 8 of 16 bits): lane l gives the address of
// row l % 8 of matrix l / 8, and gets element (lane / 4, lane % 4) of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// a if P, else b (a compile-time choice between two arrays of one type)
template <bool P, class T>
__device__ __forceinline__ T& pick(T& a, T& b) {
  if constexpr (P) {
    return a;
  } else {
    return b;
  }
}

// TILE_N output columns a block, k-slabs of TILE_K, shared-memory rows at
// stride TILE_LD (16 bytes apart in the banks, so ldmatrix's 8 row reads
// of one 8 x 4 matrix are conflict-free); an X @ W slab of W, [TILE_K]
// [TILE_N] as stored, at stride TILE_WLD.
constexpr int TILE_N = 64, TILE_K = 32, TILE_LD = TILE_K + 4, TILE_WLD = TILE_N + 4;
constexpr int TILE_WBUF = TILE_N * TILE_LD;
static_assert(TILE_K * TILE_WLD <= TILE_WBUF, "a W slab buffer holds either form");

// Warps of a TM-row tile: 4 x 2 warps of 32 x 32 at TM = 128, 4 x 2 of
// 16 x 32 at TM = 64, 2 x 4 of 16 x 16 at TM = 32, 1 x 8 of 16 x 8 at TM = 16.
template <int TM>
struct TileShape {
  static constexpr int WARPS_M = TM / 16 < 4 ? TM / 16 : 4;
  static constexpr int WM = TM / WARPS_M, WN = TILE_N / (8 / WARPS_M);
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(TM % 16 == 0 && TM <= 128 && NT >= 1, "tile rows");
};

// The one-pass modes keep no lo half of the W slab.
template <int TM>
__host__ __device__ constexpr size_t tile_smem() {
  return (size_t)(2 * TM * TILE_LD + 2 * TILE_WBUF + (MM_MODE == MM_B3 ? 2 : 1) * TILE_N * TILE_LD) *
         sizeof(float);
}

// Up to three weight tensors side by side, each row-major with its own
// leading dimension.  For X @ W (WT = false) segment s holds the output
// columns [end[s-1], end[s]) as W_s[k][n - end[s-1]]; for X @ W^T (WT =
// true) it holds the k range [end[s-1], end[s]) as W_s[n][k - end[s-1]],
// so W's rows, as stored, are the MMA's B columns.  Segment bounds are
// multiples of 4 (X @ W) or of TILE_K (X @ W^T).
template <class TW>
struct WSegT {
  const TW* w[3];
  int ld[3];
  int end[3];
};
using WSeg = WSegT<float>;
constexpr int SEG_END = 1 << 30;
template <class TW>
inline WSegT<TW> wseg(const TW* w0, int ld0) {
  return {{w0, w0, w0}, {ld0, ld0, ld0}, {SEG_END, SEG_END, SEG_END}};
}
inline WSeg wseg(const float* w0, int ld0, int end0, const float* w1, int ld1,
                 int end1 = SEG_END, const float* w2 = nullptr, int ld2 = 0) {
  return {{w0, w1, w2 ? w2 : w1}, {ld0, ld1, w2 ? ld2 : ld1}, {end0, end1, SEG_END}};
}
// The segment that holds x: its weights, leading dimension and first x.
// Constant indices only: a runtime index into the kernel argument would
// copy it to local memory.
template <class TW>
__device__ __forceinline__ void seg_at(const WSegT<TW>& W, int x, const TW*& w, int& ld,
                                       int& base) {
  if (x < W.end[0]) {
    w = W.w[0], ld = W.ld[0], base = 0;
  } else if (x < W.end[1]) {
    w = W.w[1], ld = W.ld[1], base = W.end[0];
  } else {
    w = W.w[2], ld = W.ld[2], base = W.end[1];
  }
}

// Four values device -> shared: 16 bytes of float asynchronously, or four
// bfloat16 widened by a plain load and store (visible after the block's
// next barrier, as a finished copy is).
__device__ __forceinline__ void copy4(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void copy4(float* dst, const bf16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}

// out[r][n] = sum_k X[r][k] * W[k][n]  (WT = false)  or  X[r][k] * W[n][k]
// (WT = true), for r < M, n < N, handed to epi(r, n, out[r][n],
// out[r][n + 1]) (n even) and stored nowhere else.  X: [M][ldx] row-major
// (ldx % 4 == 0, 16-byte aligned), K % TILE_K == 0, N % 8 == 0; the
// weights 16-byte aligned (float) or 8-byte aligned (bfloat16, widened
// into the slab as it is copied).  Block (x, y): rows TM x.., columns TILE_N y..;
// per k-slab: wait for its copy, start the next one's, split the W slab
// into hi / lo in shared memory ([TILE_N][TILE_LD], column n, k along it;
// an X @ W slab is transposed on the way), then four k8 steps of lo*hi,
// hi*lo, hi*hi with the X fragments read by ldmatrix and split in
// registers.  MM_DEFAULT stores the W slab rounded to bfloat16 as hi, rounds
// the X fragments likewise and runs one pass; MM_HIGHEST stores the slab as
// it is and runs fma_tile's chains on gathered fragments.  Rows past M read
// row M - 1 and columns past N read column N - 1 (or W's row N - 1);
// neither is handed to epi.  Each sum runs over
// k in order: bitwise repeatable, and equal between any two kernels that
// call it on equal X and W.  epi owns each (r, n) pair: an epilogue may
// read and write its outputs in place.
// PROMOTE: each k-slab's products go into accumulators of their own, added
// to the running sums by float32 adds after the slab.  The tensor cores
// add into their float32 accumulators without IEEE rounding, and that
// error, carried over every product into a sum of K terms, grows with K:
// the wide K5/K6 (K up to 3 Hp) promote, so their error stays that of
// 32-term slabs at any H (the wide edge kernels' mma_tiles promote per
// KSLAB terms likewise); the narrow instantiations do not (their bits are
// unchanged).
template <int TM, bool WT, class Epi, class TW = float, bool PROMOTE = false>
static __global__ void __launch_bounds__(256, 2)
    row_tile(const float* __restrict__ X, int ldx, size_t M, int K, int N, const WSegT<TW> W,
             const Epi epi) {
  using S = TileShape<TM>;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                     // [2][TM][TILE_LD] X slabs
  float* sW = sX + 2 * TM * TILE_LD;    // [2][TILE_WBUF] W slabs as copied
  float* sHi = sW + 2 * TILE_WBUF;      // [TILE_N][TILE_LD] this slab's hi
  float* sLo = sHi + TILE_N * TILE_LD;  // and lo (MM_B3 only)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = S::WM * (warp % S::WARPS_M), wn = S::WN * (warp / S::WARPS_M);
  const size_t r0 = (size_t)blockIdx.x * TM;
  const int n0 = blockIdx.y * TILE_N;
  constexpr int C4 = TILE_K / 4, N4 = TILE_N / 4;  // 16-byte chunks a slab row

  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int it = 0; it < (TM * C4 + 255) / 256; ++it) {
      const int x = t + 256 * it, r = x / C4, c = 4 * (x % C4);
      if (TM * C4 % 256 == 0 || x < TM * C4) {
        const size_t src = r0 + r < M ? r0 + r : M - 1;
        cp_async16(sX + (buf * TM + r) * TILE_LD + c, X + src * ldx + k0 + c);
      }
    }
    float* w = sW + buf * TILE_WBUF;
    if constexpr (WT) {
      const TW* ws;
      int ld, base;
      seg_at(W, k0, ws, ld, base);
#pragma unroll
      for (int it = 0; it < TILE_N * C4 / 256; ++it) {
        const int x = t + 256 * it, n = x / C4, c = 4 * (x % C4);
        const int nw = n0 + n < N ? n0 + n : N - 1;
        copy4(w + n * TILE_LD + c, ws + (size_t)nw * ld + k0 - base + c);
      }
    } else {
#pragma unroll
      for (int it = 0; it < TILE_K * N4 / 256; ++it) {
        const int x = t + 256 * it, k = x / N4, c = 4 * (x % N4);
        const int n = n0 + c < N ? n0 + c : N - 4;
        const TW* ws;
        int ld, base;
        seg_at(W, n, ws, ld, base);
        copy4(w + k * TILE_WLD + c, ws + (size_t)(k0 + k) * ld + n - base);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.0f;

  // the slab's accumulators: acc itself, or (PROMOTE) a set of their own
  float part[S::MT][S::NT][4];
  float (&d)[S::MT][S::NT][4] = pick<PROMOTE>(part, acc);

  const int nslab = K / TILE_K;
  load(0, 0);
  for (int s = 0; s < nslab; ++s) {
    const int buf = s & 1;
    if constexpr (PROMOTE) {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mt][nt][j] = 0.0f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // slab s is in; every warp is done with slab s - 1
    if (s + 1 < nslab) load(buf ^ 1, (s + 1) * TILE_K);
    const float* w = sW + buf * TILE_WBUF;
    if constexpr (WT) {
#pragma unroll
      for (int it = 0; it < TILE_N * C4 / 256; ++it) {
        const int x = t + 256 * it, n = x / C4, c = 4 * (x % C4);
        const float4 v = *reinterpret_cast<const float4*>(w + n * TILE_LD + c);
        if constexpr (MM_MODE == MM_B3) {
          uint4 hi, lo;
          split_tf32(v.x, hi.x, lo.x);
          split_tf32(v.y, hi.y, lo.y);
          split_tf32(v.z, hi.z, lo.z);
          split_tf32(v.w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(sHi + n * TILE_LD + c) = hi;
          *reinterpret_cast<uint4*>(sLo + n * TILE_LD + c) = lo;
        } else {
          *reinterpret_cast<uint4*>(sHi + n * TILE_LD + c) =
              make_uint4(mm_operand(v.x), mm_operand(v.y),
                         mm_operand(v.z), mm_operand(v.w));
        }
      }
    } else {
      // a warp reads one 16-byte column chunk of 32 k rows and writes 32
      // consecutive k of each of its 4 columns: both conflict-free
#pragma unroll
      for (int it = 0; it < TILE_K * N4 / 256; ++it) {
        const int x = t + 256 * it, k = x % TILE_K, c = 4 * (x / TILE_K);
        const float4 v = *reinterpret_cast<const float4*>(w + k * TILE_WLD + c);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MM_MODE == MM_B3) {
            unsigned hi, lo;
            split_tf32(e[j], hi, lo);
            reinterpret_cast<unsigned*>(sHi)[(c + j) * TILE_LD + k] = hi;
            reinterpret_cast<unsigned*>(sLo)[(c + j) * TILE_LD + k] = lo;
          } else {
            reinterpret_cast<unsigned*>(sHi)[(c + j) * TILE_LD + k] = mm_operand(e[j]);
          }
        }
      }
    }
    __syncthreads();  // the split slab is written
    const float* xs = sX + buf * TM * TILE_LD;
    if constexpr (MM_MODE != MM_B3) {
#pragma unroll
      for (int kk = 0; kk < TILE_K; kk += 8) {
        // as MM_B3's fragments below, without the split: the X fragments
        // rounded (MM_DEFAULT) or as they are, W's from the one stored half
        unsigned a[S::MT][4];
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) {
          ldsm_x4(a[mt], xs + (wm + 16 * mt + (lane & 15)) * TILE_LD + kk + 4 * (lane >> 4));
#pragma unroll
          for (int j = 0; j < 4; ++j) a[mt][j] = mm_operand(__uint_as_float(a[mt][j]));
        }
        unsigned b[S::NT][2];
        if constexpr (S::NT == 1) {
          ldsm_x2(b[0], sHi + (wn + (lane & 7)) * TILE_LD + kk + 4 * ((lane >> 3) & 1));
        } else {
#pragma unroll
          for (int np = 0; np < S::NT / 2; ++np) {
            unsigned h[4];
            ldsm_x4(h, sHi + (wn + 16 * np + (lane & 7) + 8 * (lane >> 4)) * TILE_LD + kk +
                           4 * ((lane >> 3) & 1));
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              b[2 * np][j] = h[j];
              b[2 * np + 1][j] = h[2 + j];
            }
          }
        }
        if constexpr (MM_MODE == MM_DEFAULT) {
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < S::NT; ++nt) mma_tf32(d[mt][nt], a[mt], b[nt]);
        } else {
          float r[S::MT][2][8];
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt) gather_rows(r[mt], a[mt]);
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt) {
            float c[2][8];
            gather_cols(c, b[nt]);
#pragma unroll
            for (int mt = 0; mt < S::MT; ++mt) fma_tile(d[mt][nt], r[mt], c);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < TILE_K; kk += 8) {
        // A: X rows wm + 16 mt + (lane % 16), k kk + 4 (lane / 16)
        unsigned ahi[S::MT][4], alo[S::MT][4];
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) {
          unsigned a[4];
          ldsm_x4(a, xs + (wm + 16 * mt + (lane & 15)) * TILE_LD + kk + 4 * (lane >> 4));
#pragma unroll
          for (int j = 0; j < 4; ++j) split_tf32(__uint_as_float(a[j]), ahi[mt][j], alo[mt][j]);
        }
        // B: columns wn + 16 np + (lane % 8) + 8 (lane / 16), k kk + 4 ((lane / 8) % 2)
        unsigned bhi[S::NT][2], blo[S::NT][2];
        if constexpr (S::NT == 1) {
          const int off = (wn + (lane & 7)) * TILE_LD + kk + 4 * ((lane >> 3) & 1);
          ldsm_x2(bhi[0], sHi + off);
          ldsm_x2(blo[0], sLo + off);
        } else {
#pragma unroll
          for (int np = 0; np < S::NT / 2; ++np) {
            const int off = (wn + 16 * np + (lane & 7) + 8 * (lane >> 4)) * TILE_LD + kk +
                            4 * ((lane >> 3) & 1);
            unsigned h[4], l[4];
            ldsm_x4(h, sHi + off);
            ldsm_x4(l, sLo + off);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              bhi[2 * np][j] = h[j];
              bhi[2 * np + 1][j] = h[2 + j];
              blo[2 * np][j] = l[j];
              blo[2 * np + 1][j] = l[2 + j];
            }
          }
        }
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt) mma_tf32(d[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt) mma_tf32(d[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < S::NT; ++nt) mma_tf32(d[mt][nt], ahi[mt], bhi[nt]);
      }
    }
    if constexpr (PROMOTE) {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];
    }
  }
  // accumulators: (row g, columns 2q, 2q + 1) and row g + 8 of each tile.
  // A warp whose columns all lie below N (all but a ragged last block) hands
  // them over with no guard per column: with a guard around each epilogue
  // call, K3's product took 0.0887 ms over its four lone shapes on the
  // H100 instead of 0.0706 (chip_smoke.py).
  if (n0 + wn + S::WN <= N) {
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const size_t r = r0 + wm + 16 * mt + g + 8 * half;
        if (r >= M) continue;
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
          epi(r, n0 + wn + 8 * nt + 2 * q, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  } else if (n0 + wn < N) {
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const size_t r = r0 + wm + 16 * mt + g + 8 * half;
        if (r >= M) continue;
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) {
          const int n = n0 + wn + 8 * nt + 2 * q;
          if (n < N) epi(r, n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    }
  }
}

// Launch row_tile over M x N; the grid is (row tiles, 64-column blocks).
template <int TM, bool WT, bool PROMOTE = false, class Epi, class TW>
static cudaError_t launch_row_tile(const float* X, int ldx, size_t M, int K, int N,
                                   const WSegT<TW>& W, const Epi& epi, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  constexpr size_t smem = tile_smem<TM>();
  auto kern = row_tile<TM, WT, Epi, TW, PROMOTE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((unsigned)((M + TM - 1) / TM), (N + TILE_N - 1) / TILE_N), 256, smem, stream>>>(
      X, ldx, M, K, N, W, epi);
  return cudaGetLastError();
}

// What a launch of `kern` with `threads` threads and `smem` bytes of dynamic
// shared memory gets: out = {shared memory bytes (dynamic and static),
// blocks per SM, registers
// a thread, local (spill) bytes a thread}.  For reports, not for launches.
template <class Kern>
static int occupancy(Kern kern, int threads, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)(smem + fa.sharedSizeBytes);
  out[1] = blocks;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace ai2bmd
