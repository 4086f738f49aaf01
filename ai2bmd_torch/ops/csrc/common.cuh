// Shared device helpers for the ai2bmd_torch kernels (float32 throughout).
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

}  // namespace ai2bmd
