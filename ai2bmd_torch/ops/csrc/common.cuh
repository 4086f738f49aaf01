// Shared device helpers for the ai2bmd_torch kernels (float32 throughout).
//
// Two row-block products.  `rows_times_cols` (K5, K6) is plain float32 FMA
// on the CUDA cores, one output column per thread.
// `mma_rows_times_cols` (K1, K2, K7, K8's zf) runs on the tensor cores with
// a 3xTF32 split: each float32 operand x is cut into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna, 10 explicit mantissa bits each), and each
// product is lo*hi + hi*lo + hi*hi, three m16n8k8 mma.sync products in that
// order into one float32 accumulator.  What it drops against a float32
// product: lo_x*lo_w (|.| <= 2^-22 |x w|) and the rounding of lo
// (<= 2^-22 |x|), so each term carries at most ~2^-21 of |x w| beside the
// float32 sum's own rounding; over K terms that stays within a few float32
// roundings, where one TF32 pass alone would carry 2^-11
// (tests/test_torch_tf32x3.py holds the split's error to <= 10x a float32
// product's at K = 256 and 512).  The bound is the tensor cores' 495 TF32
// TFLOP/s over the three passes, 165 TFLOP/s in float32 products, against
// 67 TFLOP/s of FMA; the weights stream from L2 once per block either way.
// mma.sync reaches only part of that peak, and the helper a fraction of
// mma.sync's own rate (chip_smoke.py phase 3 prints both): at one centre's
// rows a block, every warp loads and splits its W fragments and splits the
// shared rows again, about two other instructions per product, with two or
// four warps a scheduler to hide the latency.  K3/K8's g_edge product,
// which has no coupling between centres, has its own row-tile kernel with
// the same split in edge_bwd_upd.cu: 128 flattened edge rows a block share
// each W slab, staged in shared memory and split once per block.
// wgmma (64-row warpgroup tiles, swizzled shared-memory operands) does not
// fit a block of one centre's A <= 48 edge rows; it needs blocks of several
// centres, which would also share the W splits, and is left to a later
// change.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ai2bmd {

// Largest slot count a block takes: the dipeptide rows of every bundled
// protein are at most 40 slots wide, ACE-NME units 16.  Per-row values are
// kept in registers indexed by fully unrolled loops over this bound.
constexpr int MAXA = 48;
// Rows go in chunks of RCHUNK, and a slot count is a multiple of it (the
// fragment indexer rounds slots to 8): a guard per chunk instead of per row
// lets the compiler batch a chunk's loads and warp reductions.
constexpr int RCHUNK = 8;
// Largest number of spherical-harmonic components, (lmax + 1)^2 - 1 at lmax 2.
constexpr int MAXS = 8;

__device__ __forceinline__ float sigmoid(float z) { return 1.0f / (1.0f + expf(-z)); }

__device__ __forceinline__ float silu(float z) { return z * sigmoid(z); }

// d silu / dz
__device__ __forceinline__ float dsilu(float z) {
  const float s = sigmoid(z);
  return s * (1.0f + z * (1.0f - s));
}

// Sum over the 32 lanes of a warp; every lane gets the total.  The butterfly
// order is fixed, so the result is bitwise repeatable.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float cosine_cutoff(float d, float cutoff) {
  return d < cutoff ? 0.5f * (cosf(d * (3.14159265358979323846f / cutoff)) + 1.0f) : 0.0f;
}

// acc_j[r] = sum_k X[r][k] * W[k][col_j], j < NC, for the rows r < A of a
// row block X ([A][ldx], row-major, in shared memory, K % 4 == 0, ldx % 4
// == 0, A % RCHUNK == 0, A <= MAXR) and NC columns of a row-major W
// ([K][ldw], device memory).  Each thread owns its columns, so a warp reads
// 32 neighbouring floats of a W row, and every thread reads the same X
// element (a shared-memory broadcast).  The next k-step's W values are
// loaded while this one's are used, to hide the L2 latency.  Each sum runs
// over k in order with fused multiply-adds: bitwise repeatable.
template <int NC, int MAXR = MAXA>
__device__ __forceinline__ void rows_times_cols_ld(const float* __restrict__ X, int ldx, int A,
                                                   int K, const float* __restrict__ W, int ldw,
                                                   const int (&col)[NC],
                                                   float (&acc)[NC][MAXR]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[j][r] = 0.0f;
  float nxt[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) nxt[j][q] = __ldg(W + (size_t)q * ldw + col[j]);
  for (int k = 0; k < K; k += 4) {
    float w[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[j][q] = nxt[j][q];
    if (k + 4 < K) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) nxt[j][q] = __ldg(W + (size_t)(k + 4 + q) * ldw + col[j]);
    }
#pragma unroll
    for (int c8 = 0; c8 < MAXR / RCHUNK; ++c8) {
      if (c8 * RCHUNK < A) {
#pragma unroll
        for (int rr = 0; rr < RCHUNK; ++rr) {
          const int r = c8 * RCHUNK + rr;
          const float4 x = *reinterpret_cast<const float4*>(X + r * ldx + k);
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            float a = acc[j][r];
            a = fmaf(x.x, w[j][0], a);
            a = fmaf(x.y, w[j][1], a);
            a = fmaf(x.z, w[j][2], a);
            a = fmaf(x.w, w[j][3], a);
            acc[j][r] = a;
          }
        }
      }
    }
  }
}

// rows_times_cols_ld for a dense row block (row stride K).
template <int NC, int MAXR = MAXA>
__device__ __forceinline__ void rows_times_cols(const float* __restrict__ X, int A, int K,
                                                const float* __restrict__ W, int ldw,
                                                const int (&col)[NC], float (&acc)[NC][MAXR]) {
  rows_times_cols_ld<NC, MAXR>(X, K, A, K, W, ldw, col, acc);
}

// Copy A rows of H floats (device memory, dense) into shared memory at row
// stride ld (ld % 4 == 0), float4 a thread.
__device__ __forceinline__ void load_rows(float* __restrict__ dst, int ld,
                                          const float* __restrict__ src, int A, int H) {
  const int H4 = H / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int x = threadIdx.x; x < A * H4; x += blockDim.x) {
    const int r = x / H4;
    reinterpret_cast<float4*>(dst + r * ld)[x - r * H4] = s4[x];
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
__device__ __forceinline__ void load_w_frags(float (&f)[2][4], const float* __restrict__ p,
                                             int ldw) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    f[mt][0] = __ldg(p + 16 * mt);
    f[mt][1] = __ldg(p + 16 * mt + 8);
    f[mt][2] = __ldg(p + 4 * (size_t)ldw + 16 * mt);
    f[mt][3] = __ldg(p + 4 * (size_t)ldw + 16 * mt + 8);
  }
}

// One k-step of 8 of mma_rows_times_cols: split this step's W fragments f,
// refill f with the step two ahead, then for each row tile split its B
// fragment and run the three passes over the warp's two m16 tiles (the
// compiler overlaps one tile's loads and splits with the last one's
// products; a split B fragment is held for one tile only, which keeps the
// helper near 90 registers).
template <int MAXR>
__device__ __forceinline__ void mma_k_step(float (&acc)[2][MAXR / RCHUNK][4], float (&f)[2][4],
                                           const float* X, int ldx, int A, int k0, int K,
                                           const float* __restrict__ Wq, int ldw, int g, int q) {
  constexpr int NT = MAXR / RCHUNK;
  unsigned ahi[2][4], alo[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(f[mt][j], ahi[mt][j], alo[mt][j]);
  if (k0 + 16 < K) load_w_frags(f, Wq + (size_t)(k0 + 16) * ldw, ldw);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * RCHUNK < A) {
      const float* x = X + (nt * RCHUNK + g) * ldx + k0 + q;
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

// out[r][n] = sum_k X[r][k] * W[k][col0 + n] for r < A and
// n < 32 * (blockDim.x / 32), on the tensor cores with the 3xTF32 split.
// X: [A][ldx] in shared memory (ldx = mma_ld(.) for conflict-free reads,
// A % RCHUNK == 0, A <= MAXR); W: [K][ldw] row-major in device memory
// (K % 16 == 0); out: [A][ldo] in shared or device memory, and may alias X.
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
template <int MAXR = MAXA>
__device__ __forceinline__ void mma_rows_times_cols(const float* X, int ldx, int A, int K,
                                                    const float* __restrict__ W, int ldw,
                                                    int col0, float* out, int ldo) {
  constexpr int NT = MAXR / RCHUNK;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int n0 = 32 * (threadIdx.x >> 5);
  const float* Wq = W + (size_t)q * ldw + col0 + n0 + g;
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
    mma_k_step<MAXR>(acc, fa, X, ldx, A, k0, K, Wq, ldw, g, q);
    mma_k_step<MAXR>(acc, fb, X, ldx, A, k0 + 8, K, Wq, ldw, g, q);
  }
  __syncthreads();  // every warp has read X
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt * RCHUNK < A) {
      float* o = out + (nt * RCHUNK + 2 * q) * ldo + n0 + g;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        o[16 * mt] = acc[mt][nt][0];
        o[ldo + 16 * mt] = acc[mt][nt][1];
        o[16 * mt + 8] = acc[mt][nt][2];
        o[ldo + 16 * mt + 8] = acc[mt][nt][3];
      }
    }
  }
  __syncthreads();  // out is written
}

// What a launch of `kern` with `threads` threads and `smem` bytes of dynamic
// shared memory gets: out = {shared memory bytes, blocks per SM, registers
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
  out[0] = (int)smem;
  out[1] = blocks;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace ai2bmd
