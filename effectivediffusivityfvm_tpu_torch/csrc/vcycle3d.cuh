// K6: the 7-point voxel V(nu, nu) cycle z = M r over the padded-even 3D
// hierarchy.  This header holds what K6 shares with K7 (cgstep3d.cu, which
// runs K6's cycle on levels[1:] as its coarse tail): the level descriptor,
// the resident rule and the cycle's entry point (run_cycle3, defined in
// vcycle3d.cu for float and double).
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/vcycle3d.py
// (v_cycle3d_pallas / _cycle3d_value, and v_cycle3d_tiled's _t1_kernel3,
// _t2_kernel3 and coarse_tail3).  On the TPU the whole pyramid of a small
// volume sat in VMEM, and a large one streamed in z-slabs.  A Hopper SM has
// 227 KB of shared memory and one 128^3 fp32 level is 8 MiB, so vcycle3d.cu
// rebuilds that residency in two regimes, as K2 (vcycle.cu) does in 2D: two
// z-marching tile passes a level above the bottom (levelpass3d.cuh), and one
// launch for the bottom of the pyramid, which lives in one CTA's shared
// memory per volume.  The banded cycle's T1 and T2 are the same two passes
// on level 0.
//
// Arithmetic follows the plain versions (ops/kernels/vcycle3d.py) operation
// for operation, in the same order: the neighbour sum
// aw x[w] + (aw x)[e] + an x[n] + (an x)[s] + au x[u] + (au x)[d], the sweep
// (1 - w) x + (w (rhs + nbsum)) dinv, the diagonal 1/dinv, the restriction
// z pairs, then y pairs, then x pairs.  The build turns FMA contraction
// off, so each product and sum is rounded as the plain version rounds it.
//
// Per-volume gating: every kernel takes an optional int flag per volume
// (nullptr = all volumes); a block whose volume flag is 0 returns at once.
#pragma once

#include "vcycle.cuh"

namespace deff {

// Host-side count of the 3D V-cycles this library ran (each run_cycle3
// call, whoever made it: the whole-cycle entry, the banded cycle's tail, or
// K7's tail).
extern long long g_cycles3;

// The sweeps a leg the level passes take (their halos are nu cells).
constexpr int MAX_NU3 = 3;

struct Dims3 {
  int nz, ny, nx;
  __host__ __device__ int plane() const { return ny * nx; }
  __host__ __device__ int cells() const { return nz * ny * nx; }
};

// Stored coefficient volumes of one level, all volumes: a_w, a_n, a_u and
// diag_inv at global index g (volume offset included).
template <typename T>
struct Stored3 {
  const T* aw;
  const T* an;
  const T* au;
  const T* dinv;
};

template <typename T>
struct Level3 {
  Stored3<T> co;
  Dims3 dm;
};

// Guarded product-form harmonic mean (2a) b / (a + b), 0 where a + b <= 0.
template <typename T>
__device__ __forceinline__ T hmean3(T a, T b) {
  const T s = a + b;
  return s > T(0) ? ((T(2) * a) * b) / s : T(0);
}

// Scratch the whole cycle needs per volume: level 0's pre-smoothed e, and
// on every level below it the right-hand side, e and the correction.
inline long long cycle3_scratch_elems(int L, const int* nz, const int* ny,
                                      const int* nx) {
  long long s = 0;
  for (int l = 0; l < L; ++l)
    s += (l == 0 ? 1LL : 3LL) * nz[l] * ny[l] * nx[l];
  return s;
}

// The resident bottom: the shared memory its volumes may take in one CTA
// (the H100's opt-in 227 KB a block less 1 KB for the kernel's level
// table), and the levels it may hold.
constexpr long long RESIDENT3_SMEM = 231424;
constexpr int RESIDENT3_LEVELS = 16;

// The resident rule: the first level l from which the rest of the pyramid
// (levels l..L-1: a_w, a_n, a_u, diag_inv, right-hand side and correction
// of each, plus one ping-pong volume of level l's size) fits RESIDENT3_SMEM
// bytes in at most RESIDENT3_LEVELS levels; L when even the coarsest level
// does not fit (it then runs its sweeps from global memory).  Shape and
// element size alone decide it; the Python twin is
// ops/kernels/vcycle3d.py::cycle3_resident_from.
inline int cycle3_resident_from(int L, const int* nz, const int* ny,
                                const int* nx, int itemsize) {
  long long cells = 0;
  for (int l = L - 1; l >= 0; --l) {
    const long long n = (long long)nz[l] * ny[l] * nx[l];
    cells += 6 * n;
    if ((cells + n) * itemsize > RESIDENT3_SMEM || L - l > RESIDENT3_LEVELS)
      return l + 1;
  }
  return 0;
}

// Launch one whole V(nu, nu) cycle z = M r (1 <= nu <= MAX_NU3) for B
// volumes on `st`: two tile passes a level above the resident bottom, one
// launch for the bottom.  `scratch` holds B * cycle3_scratch_elems(...)
// elements; z must not alias r or the scratch.  Defined in vcycle3d.cu.
template <typename T>
cudaError_t run_cycle3(int B, int L, const Level3<T>* lv, const T* r, T* z,
                       T* scratch, const double* ws, int nu, int coarse_iters,
                       double over, const int* flag, cudaStream_t st);

template <typename T>
int fill_levels3(int L, const int* nz, const int* ny, const int* nx,
                 const void* const* aw, const void* const* an,
                 const void* const* au, const void* const* dinv,
                 Level3<T>* lv) {
  if (L < 1 || L > MAX_LEVELS) return 0;
  for (int l = 0; l < L; ++l) {
    lv[l].co.aw = static_cast<const T*>(aw[l]);
    lv[l].co.an = static_cast<const T*>(an[l]);
    lv[l].co.au = static_cast<const T*>(au[l]);
    lv[l].co.dinv = static_cast<const T*>(dinv[l]);
    lv[l].dm = Dims3{nz[l], ny[l], nx[l]};
    if (l < L - 1 && (nz[l] % 2 || ny[l] % 2 || nx[l] % 2)) return 0;
    if (l > 0 && (nz[l] < nz[l - 1] / 2 || ny[l] < ny[l - 1] / 2 ||
                  nx[l] < nx[l - 1] / 2))
      return 0;
  }
  return 1;
}

}  // namespace deff
