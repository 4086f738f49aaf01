// tf32x3_mm: out = X @ W through mma_rows_times_cols (common.cuh) alone, a
// check of the tensor-core product that K1, K2, K7 and K8 share, in the
// library's mode (3xTF32 in the b3 library, the FMA chain in the highest
// one, one bf16 pass in the default one); and tf32_mma_rate, the rate of
// the mma.sync instruction the helper is built on, with nothing else in
// the loop.  No TPU kernel: chip_smoke.py holds the product against its
// mode's plain model (ops/tf32x3.py plain_mm) and a float64 product, and
// prints both rates.  Nothing on the model's path launches them.
// Design: one block per (A rows, 32 x warps columns), the rows copied to
// shared memory at the helper's padded stride, the product stored
// straight to device memory.

#include "common.cuh"

using namespace ai2bmd;

__global__ void __launch_bounds__(256) tf32x3_mm_kernel(const float* __restrict__ X,
                                                        const float* __restrict__ W,
                                                        float* __restrict__ out, int A, int K,
                                                        int N) {
  extern __shared__ __align__(16) float sX[];  // [A][K + 4]
  const size_t r0 = (size_t)blockIdx.x * A;
  const int col0 = blockIdx.y * blockDim.x;
  load_rows(sX, mma_ld(K), X + r0 * K, A, K);
  mma_rows_times_cols(sX, mma_ld(K), A, K, W, N, col0, out + r0 * N + col0, N);
}

extern "C" int tf32x3_mm_launch(const float* X, const float* W, float* out, int M, int K, int N,
                                int A, cudaStream_t stream) {
  const int threads = N < 256 ? N : 256;
  const size_t smem = (size_t)A * mma_ld(K) * sizeof(float);
  if (A > MAXA || A % RCHUNK || M % A || K % 32 || N % threads || threads % 32 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tf32x3_mm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tf32x3_mm_kernel<<<dim3(M / A, N / threads), threads, smem, stream>>>(X, W, out, A, K, N);
  return (int)cudaGetLastError();
}

// Each warp runs iters x 8 independent m16n8k8 TF32 products on register
// operands (no loads, no splits); out keeps the sums live.
__global__ void __launch_bounds__(256) tf32_mma_rate_kernel(float* __restrict__ out, int iters) {
  float acc[8][4] = {};
  const unsigned a[4] = {threadIdx.x, threadIdx.x + 1u, 3u, 4u}, b[2] = {5u, threadIdx.x};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, b);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int tf32_mma_rate_launch(float* out, int blocks, int iters, cudaStream_t stream) {
  tf32_mma_rate_kernel<<<blocks, 256, 0, stream>>>(out, iters);
  return (int)cudaGetLastError();
}
