// K4 cap_grad: analytic dE/dpos of each dipeptide row's AMBER cap energy
//   bonds      0.5 k (r - r0)^2
//   angles     0.5 k (theta - theta0)^2,  theta = atan2(|u x v|, u . v)
//   dihedrals  0.5 k (1 + cos(n phi - phase))
//   nonbonded  A / r^12 - B / r^6 + Q / r   (A, B pre-divided by scnb, Q by scee)
// the energy of ai2bmd_tpu/frag/hydrogen.py:103-151 (amber_row_energy).
//
// Replaces _kernel (ai2bmd_tpu/ops/pallas/caps.py:165), launched by
// fused_cap_grad (:308) through amber_grad_rows (:340).  Forward only: every
// caller stops the gradient at the optimized cap positions.
//
// What bounds it on the H100: a few thousand scalar terms per MD step, so
// the launch itself and the latency of its three short stages; its bytes
// (~0.15 MB a call) would take 0.04 us at 3.35 TB/s, far below one launch.
// Design: one block per row, three stages.  (1) The row's positions and its
// per-atom slot lists go to shared memory.  (2) One thread per term writes
// each (term, endpoint) slot's force to shared memory.  The TPU kernel
// expressed the endpoint gathers and the force scatter as one-hot matmuls
// and evaluated atan2 and n*phi by polynomial and Chebyshev recurrence,
// because Mosaic has no dynamic indexing and no inverse trigonometry; here
// the endpoints are index gathers from the topology tables and the angles
// use atan2f / sinf.  (3) One thread per atom coordinate sums the slots of
// its own atom's list (slot_ptr / slot_idx, built once on the host by
// ops/caps.py: a CSR list per row of the slots that name each atom, in
// ascending slot order), so the result is bitwise repeatable without
// atomics, and is the same sequence of float32 additions as a scan over
// every slot that tests the slot's atom.  The lists skip the slots that
// always carry +-0.0, whose addition to a sum that starts at +0.0 changes
// nothing: those of masked-out pairs, and those of terms whose endpoints
// are all one atom (the tables' padding; their geometry guards below give
// zero force).  Without them no Chignolin atom has more than 43 slots
// (20 on average), where the scan walked all 1,304 slots of the row per
// thread; the padding atom 0 alone would otherwise hold up to 957.  A term
// whose geometry is degenerate (a zero-length bond, cross product or axis)
// gives zero force, as the safe-norm guards of hydrogen.py give zero
// gradient.

#include "common.cuh"

namespace {

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

constexpr float EPS = 1e-12f;

}  // namespace

__global__ void cap_grad_kernel(const float* __restrict__ pos, const int* __restrict__ bond_ij,
                                const float* __restrict__ bond_k, const float* __restrict__ bond_r0,
                                const int* __restrict__ angle_ijk, const float* __restrict__ angle_k,
                                const float* __restrict__ angle_t0, const int* __restrict__ dih_ijkl,
                                const float* __restrict__ dih_k, const float* __restrict__ dih_n,
                                const float* __restrict__ dih_phase, const int* __restrict__ nb_ij,
                                const float* __restrict__ nb_a, const float* __restrict__ nb_b,
                                const float* __restrict__ nb_q, const float* __restrict__ nb_mask,
                                const int* __restrict__ slot_ptr, const int* __restrict__ slot_idx,
                                float* __restrict__ grad, int RT, int S, int NB, int NA, int ND,
                                int NP) {
  extern __shared__ __align__(16) float smem[];
  const int NE = 2 * NB + 3 * NA + 4 * ND + 2 * NP;  // (term, endpoint) slots
  float* sPos = smem;                                  // [S][3]
  float* sF = sPos + 3 * S;                            // [NE][3]
  int* sPtr = reinterpret_cast<int*>(sF + 3 * NE);     // [S+1] list bounds of each atom
  int* sIdx = sPtr + S + 1;                            // [<= NE] slots, atom by atom

  // pos row p takes the tables of row p % RT: one launch covers the rows of
  // several replicas, stacked replica-major
  const int prow = blockIdx.x, row = prow % RT, t = threadIdx.x, nt = blockDim.x;
  const int* ptr = slot_ptr + (size_t)row * (S + 1);
  const int* idx = slot_idx + (size_t)row * NE;
  const int n_live = ptr[S];
  for (int x = t; x < 3 * S; x += nt) sPos[x] = pos[(size_t)prow * S * 3 + x];
  for (int x = t; x <= S; x += nt) sPtr[x] = ptr[x];
  for (int x = t; x < n_live; x += nt) sIdx[x] = idx[x];
  __syncthreads();

  auto P = [&](int a) { return V3{sPos[3 * a], sPos[3 * a + 1], sPos[3 * a + 2]}; };
  auto put = [&](int slot, V3 f) {
    sF[3 * slot] = f.x;
    sF[3 * slot + 1] = f.y;
    sF[3 * slot + 2] = f.z;
  };
  const V3 zero{0.0f, 0.0f, 0.0f};

  // bonds
  for (int m = t; m < NB; m += nt) {
    const int* ij = bond_ij + ((size_t)row * NB + m) * 2;
    const V3 d = sub(P(ij[0]), P(ij[1]));
    const float r2 = dot(d, d);
    V3 f = zero;
    if (r2 > EPS) {
      const float r = sqrtf(r2);
      f = scale(d, bond_k[row * NB + m] * (r - bond_r0[row * NB + m]) / r);
    }
    put(2 * m, f);
    put(2 * m + 1, scale(f, -1.0f));
  }

  // angles: dtheta/du = (dt (v x w^) - c v) / (c^2 + dt^2), likewise for v
  const int a0 = 2 * NB;
  for (int m = t; m < NA; m += nt) {
    const int* ijk = angle_ijk + ((size_t)row * NA + m) * 3;
    const V3 pj = P(ijk[1]);
    const V3 u = sub(P(ijk[0]), pj), v = sub(P(ijk[2]), pj);
    const V3 w = cross(u, v);
    const float c2 = dot(w, w), dt = dot(u, v);
    V3 fi = zero, fk = zero;
    if (c2 > EPS) {
      const float c = sqrtf(c2);
      const float theta = atan2f(c, dt);
      const float g = angle_k[row * NA + m] * (theta - angle_t0[row * NA + m]) / (c2 + dt * dt);
      const V3 wh = scale(w, 1.0f / c);
      fi = scale(sub(scale(cross(v, wh), dt), scale(v, c)), g);
      fk = scale(sub(scale(cross(wh, u), dt), scale(u, c)), g);
    }
    put(a0 + 3 * m, fi);
    put(a0 + 3 * m + 1, scale(add(fi, fk), -1.0f));
    put(a0 + 3 * m + 2, fk);
  }

  // proper dihedrals.  With b1 = p1-p0, b2 = p2-p1, b3 = p3-p2, m = b1 x b2,
  // n = b2 x b3, hydrogen.py's phi is atan2(-(m x b2).n, (m.n)|b2|) and
  //   dphi/dp0 = -|b2|/|m|^2 m,  dphi/dp3 = |b2|/|n|^2 n,
  //   dphi/dp1 = -(1+s1) dphi/dp0 + s2 dphi/dp3,
  //   dphi/dp2 = s1 dphi/dp0 - (1+s2) dphi/dp3,
  // s1 = b1.b2/|b2|^2, s2 = b3.b2/|b2|^2.
  const int d0 = a0 + 3 * NA;
  for (int m = t; m < ND; m += nt) {
    const int* ijkl = dih_ijkl + ((size_t)row * ND + m) * 4;
    const V3 p0 = P(ijkl[0]), p1 = P(ijkl[1]), p2 = P(ijkl[2]), p3 = P(ijkl[3]);
    const V3 b1 = sub(p1, p0), b2 = sub(p2, p1), b3 = sub(p3, p2);
    const V3 mm = cross(b1, b2), nn = cross(b2, b3);
    const float m2 = dot(mm, mm), n2 = dot(nn, nn), bb = dot(b2, b2);
    V3 f0 = zero, f1 = zero, f2 = zero, f3 = zero;
    if (m2 > EPS && n2 > EPS && bb > EPS) {
      const float bl = sqrtf(bb);
      const float phi = atan2f(-dot(cross(mm, b2), nn), dot(mm, nn) * bl);
      const float nd = dih_n[row * ND + m];
      const float dE = -0.5f * dih_k[row * ND + m] * nd * sinf(nd * phi - dih_phase[row * ND + m]);
      const V3 A0 = scale(mm, -bl / m2), A3 = scale(nn, bl / n2);
      const float s1 = dot(b1, b2) / bb, s2 = dot(b3, b2) / bb;
      f0 = scale(A0, dE);
      f3 = scale(A3, dE);
      f1 = scale(add(scale(A0, -1.0f - s1), scale(A3, s2)), dE);
      f2 = scale(add(scale(A0, s1), scale(A3, -1.0f - s2)), dE);
    }
    put(d0 + 4 * m, f0);
    put(d0 + 4 * m + 1, f1);
    put(d0 + 4 * m + 2, f2);
    put(d0 + 4 * m + 3, f3);
  }

  // nonbonded over the exclusion complement: dE/dr / r = -12A/r^14 + 6B/r^8 - Q/r^3
  const int n0 = d0 + 4 * ND;
  for (int m = t; m < NP; m += nt) {
    const int* ij = nb_ij + ((size_t)row * NP + m) * 2;
    const V3 d = sub(P(ij[0]), P(ij[1]));
    const float r2 = dot(d, d);
    V3 f = zero;
    if (nb_mask[row * NP + m] > 0.0f && r2 > EPS) {
      const float inv2 = 1.0f / r2, inv6 = inv2 * inv2 * inv2;
      const float s = (-12.0f * nb_a[row * NP + m] * inv6 + 6.0f * nb_b[row * NP + m]) * inv6 * inv2 -
                      nb_q[row * NP + m] * inv2 / sqrtf(r2);
      f = scale(d, s);
    }
    put(n0 + 2 * m, f);
    put(n0 + 2 * m + 1, scale(f, -1.0f));
  }
  __syncthreads();

  // deterministic scatter: one thread per (atom, coordinate), its atom's
  // slots in ascending order
  for (int x = t; x < 3 * S; x += nt) {
    const int atom = x / 3, c = x % 3;
    float s = 0.0f;
    for (int e = sPtr[atom]; e < sPtr[atom + 1]; ++e) s += sF[3 * sIdx[e] + c];
    grad[(size_t)prow * S * 3 + x] = s;
  }
}

extern "C" int cap_grad_launch(const float* pos, const int* bond_ij, const float* bond_k,
                               const float* bond_r0, const int* angle_ijk, const float* angle_k,
                               const float* angle_t0, const int* dih_ijkl, const float* dih_k,
                               const float* dih_n, const float* dih_phase, const int* nb_ij,
                               const float* nb_a, const float* nb_b, const float* nb_q,
                               const float* nb_mask, const int* slot_ptr, const int* slot_idx,
                               float* grad, int R, int RT, int S, int NB, int NA, int ND, int NP,
                               cudaStream_t stream) {
  if (RT <= 0 || R % RT) return (int)cudaErrorInvalidValue;
  const int NE = 2 * NB + 3 * NA + 4 * ND + 2 * NP;
  const size_t smem =
      (size_t)(3 * S + 3 * NE) * sizeof(float) + (size_t)(S + 1 + NE) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(cap_grad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cap_grad_kernel<<<R, 128, smem, stream>>>(pos, bond_ij, bond_k, bond_r0, angle_ijk, angle_k,
                                            angle_t0, dih_ijkl, dih_k, dih_n, dih_phase, nb_ij,
                                            nb_a, nb_b, nb_q, nb_mask, slot_ptr, slot_idx, grad,
                                            RT, S, NB, NA, ND, NP);
  return (int)cudaGetLastError();
}
