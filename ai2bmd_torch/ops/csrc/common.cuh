// Shared device helpers for the ai2bmd_torch kernels (float32 throughout).
//
// Every product of every kernel runs on the tensor cores with a 3xTF32
// split: each float32 operand x is cut into hi = tf32(x) and
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

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace ai2bmd {

// Largest slot count of a fragment: the dipeptide rows of every bundled
// protein are at most 40 slots wide, ACE-NME units 16.  Only the product
// helper's default row bound (mma_rows_times_cols) and its lone test
// launcher (tf32x3_mm.cu) still use it.
constexpr int MAXA = 48;
// Every centre pass (K1-K3, K7, K8, and K5/K6's centre passes) walks a
// centre's sources in chunks of at most ECHUNK rows: shared memory and
// per-row registers are sized by the chunk, not by A, so they take any
// A % 8 == 0 up to EDGE_MAXA.  Every fragment shape (A <= 48) is one chunk.
constexpr int ECHUNK = 48;
// Largest slot count the edge and full-layer kernels take: a whole molecule
// (abd, the largest bundled protein, is 752 slots).  Every index that can
// pass 2^31 at B A^2 3H elements is a size_t.
constexpr int EDGE_MAXA = 1024;
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

template <int TM>
__host__ __device__ constexpr size_t tile_smem() {
  return (size_t)(2 * TM * TILE_LD + 2 * TILE_WBUF + 2 * TILE_N * TILE_LD) * sizeof(float);
}

// Up to three weight tensors side by side, each row-major with its own
// leading dimension.  For X @ W (WT = false) segment s holds the output
// columns [end[s-1], end[s]) as W_s[k][n - end[s-1]]; for X @ W^T (WT =
// true) it holds the k range [end[s-1], end[s]) as W_s[n][k - end[s-1]],
// so W's rows, as stored, are the MMA's B columns.  Segment bounds are
// multiples of 4 (X @ W) or of TILE_K (X @ W^T).
struct WSeg {
  const float* w[3];
  int ld[3];
  int end[3];
};
constexpr int SEG_END = 1 << 30;
inline WSeg wseg(const float* w0, int ld0) {
  return {{w0, w0, w0}, {ld0, ld0, ld0}, {SEG_END, SEG_END, SEG_END}};
}
inline WSeg wseg(const float* w0, int ld0, int end0, const float* w1, int ld1,
                 int end1 = SEG_END, const float* w2 = nullptr, int ld2 = 0) {
  return {{w0, w1, w2 ? w2 : w1}, {ld0, ld1, w2 ? ld2 : ld1}, {end0, end1, SEG_END}};
}
// The segment that holds x: its weights, leading dimension and first x.
// Constant indices only: a runtime index into the kernel argument would
// copy it to local memory.
__device__ __forceinline__ void seg_at(const WSeg& W, int x, const float*& w, int& ld,
                                       int& base) {
  if (x < W.end[0]) {
    w = W.w[0], ld = W.ld[0], base = 0;
  } else if (x < W.end[1]) {
    w = W.w[1], ld = W.ld[1], base = W.end[0];
  } else {
    w = W.w[2], ld = W.ld[2], base = W.end[1];
  }
}

// out[r][n] = sum_k X[r][k] * W[k][n]  (WT = false)  or  X[r][k] * W[n][k]
// (WT = true), for r < M, n < N, handed to epi(r, n, out[r][n],
// out[r][n + 1]) (n even) and stored nowhere else.  X: [M][ldx] row-major
// (ldx % 4 == 0, 16-byte aligned), K % TILE_K == 0, N % 8 == 0; the
// weights 16-byte aligned.  Block (x, y): rows TM x.., columns TILE_N y..;
// per k-slab: wait for its copy, start the next one's, split the W slab
// into hi / lo in shared memory ([TILE_N][TILE_LD], column n, k along it;
// an X @ W slab is transposed on the way), then four k8 steps of lo*hi,
// hi*lo, hi*hi with the X fragments read by ldmatrix and split in
// registers.  Rows past M read row M - 1 and columns past N read column
// N - 1 (or W's row N - 1); neither is handed to epi.  Each sum runs over
// k in order: bitwise repeatable, and equal between any two kernels that
// call it on equal X and W.  epi owns each (r, n) pair: an epilogue may
// read and write its outputs in place.
template <int TM, bool WT, class Epi>
static __global__ void __launch_bounds__(256, 2)
    row_tile(const float* __restrict__ X, int ldx, size_t M, int K, int N, const WSeg W,
             const Epi epi) {
  using S = TileShape<TM>;
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                     // [2][TM][TILE_LD] X slabs
  float* sW = sX + 2 * TM * TILE_LD;    // [2][TILE_WBUF] W slabs as copied
  float* sHi = sW + 2 * TILE_WBUF;      // [TILE_N][TILE_LD] this slab's hi
  float* sLo = sHi + TILE_N * TILE_LD;  // and lo
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
      const float* ws;
      int ld, base;
      seg_at(W, k0, ws, ld, base);
#pragma unroll
      for (int it = 0; it < TILE_N * C4 / 256; ++it) {
        const int x = t + 256 * it, n = x / C4, c = 4 * (x % C4);
        const int nw = n0 + n < N ? n0 + n : N - 1;
        cp_async16(w + n * TILE_LD + c, ws + (size_t)nw * ld + k0 - base + c);
      }
    } else {
#pragma unroll
      for (int it = 0; it < TILE_K * N4 / 256; ++it) {
        const int x = t + 256 * it, k = x / N4, c = 4 * (x % N4);
        const int n = n0 + c < N ? n0 + c : N - 4;
        const float* ws;
        int ld, base;
        seg_at(W, n, ws, ld, base);
        cp_async16(w + k * TILE_WLD + c, ws + (size_t)(k0 + k) * ld + n - base);
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

  const int nslab = K / TILE_K;
  load(0, 0);
  for (int s = 0; s < nslab; ++s) {
    const int buf = s & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // slab s is in; every warp is done with slab s - 1
    if (s + 1 < nslab) load(buf ^ 1, (s + 1) * TILE_K);
    const float* w = sW + buf * TILE_WBUF;
    if constexpr (WT) {
#pragma unroll
      for (int it = 0; it < TILE_N * C4 / 256; ++it) {
        const int x = t + 256 * it, n = x / C4, c = 4 * (x % C4);
        const float4 v = *reinterpret_cast<const float4*>(w + n * TILE_LD + c);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(sHi + n * TILE_LD + c) = hi;
        *reinterpret_cast<uint4*>(sLo + n * TILE_LD + c) = lo;
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
          unsigned hi, lo;
          split_tf32(e[j], hi, lo);
          reinterpret_cast<unsigned*>(sHi)[(c + j) * TILE_LD + k] = hi;
          reinterpret_cast<unsigned*>(sLo)[(c + j) * TILE_LD + k] = lo;
        }
      }
    }
    __syncthreads();  // the split slab is written
    const float* xs = sX + buf * TM * TILE_LD;
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
        for (int nt = 0; nt < S::NT; ++nt) mma_tf32(acc[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) mma_tf32(acc[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) mma_tf32(acc[mt][nt], ahi[mt], bhi[nt]);
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
template <int TM, bool WT, class Epi>
static cudaError_t launch_row_tile(const float* X, int ldx, size_t M, int K, int N,
                                   const WSeg& W, const Epi& epi, cudaStream_t stream) {
  if (M == 0) return cudaSuccess;
  constexpr size_t smem = tile_smem<TM>();
  cudaError_t err = cudaFuncSetAttribute(row_tile<TM, WT, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  row_tile<TM, WT, Epi><<<dim3((unsigned)((M + TM - 1) / TM), (N + TILE_N - 1) / TILE_N), 256,
                          smem, stream>>>(X, ldx, M, K, N, W, epi);
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
