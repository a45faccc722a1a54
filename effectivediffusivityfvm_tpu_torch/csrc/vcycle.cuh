// K2: one whole V(nu, nu) multigrid cycle z = M r over the padded-even
// hierarchy.  This header holds what the other kernels share with K2: the
// level descriptor, the stencil, staging and launch helpers, the launch
// counters, three batch-wide level kernels that K1 runs at its level 0 when
// nu > 2, and the cycle's entry points (cycle_from, run_cycle), which
// vcycle.cu defines.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/vcycle_vmem.py
// (v_cycle_pallas / _cycle_value).  On the TPU one grid step held an
// image's whole pyramid in VMEM.  A Hopper SM has 227 KB of shared memory
// and one 512^2 fp32 plane is 1 MiB, so vcycle.cu rebuilds that residency
// in two regimes (see there): two shared-memory tile passes a level above
// the bottom, and one launch for the bottom of the pyramid, which lives in
// one CTA's shared memory per image.
//
// Arithmetic follows the plain version (ops/kernels/vcycle.py) operation
// for operation, in the same order; the build turns FMA contraction off, so
// each product and sum is rounded as the plain version's elementwise ops
// round it.  Neighbour reads are bounded (zero outside the grid).
//
// Per-image gating: every kernel takes an optional int flag per image
// (nullptr = all images); a block whose image flag is 0 returns at once,
// so a frozen or finished image costs no memory traffic.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace deff {

constexpr int THREADS = 256;            // threads per block
constexpr int CPT = 4;                  // cells per thread
constexpr int TILE = THREADS * CPT;     // cells per block
constexpr int MAX_LEVELS = 32;

// Host-side counts of kernel launches made by this library, and of the
// V-cycles it ran (each cycle_from call, whoever made it).
extern long long g_launches;
extern long long g_cycles;

#define DEFF_LAUNCH(...)                                   \
  do {                                                     \
    __VA_ARGS__;                                           \
    ++::deff::g_launches;                                  \
    cudaError_t _e = cudaGetLastError();                   \
    if (_e != cudaSuccess) return _e;                      \
  } while (0)

template <typename T>
struct Level {
  const T* aw;
  const T* an;
  const T* dinv;
  int ny, nx;
};

inline int blocks_for(long long n) { return (int)((n + TILE - 1) / TILE); }

__device__ __forceinline__ bool gated_off(const int* flag) {
  return flag != nullptr && flag[blockIdx.y] == 0;
}

// Symmetric-stencil neighbour sum from the west/north planes only:
// aw[c] v(w) + aw[c+1] v(e) + an[c] v(n) + an[c+nx] v(s), in that order.
template <typename T, typename V>
__device__ __forceinline__ T nbsum(const T* aw, const T* an, V v, int c,
                                   int i, int j, int ny, int nx) {
  T s = (j > 0) ? aw[c] * v(c - 1) : T(0);
  if (j + 1 < nx) s = s + aw[c + 1] * v(c + 1);
  if (i > 0) s = s + an[c] * v(c - nx);
  if (i + 1 < ny) s = s + an[c + nx] * v(c + nx);
  return s;
}

template <typename T>
__device__ __forceinline__ T diag_of(T di) {
  return di > T(0) ? T(1) / di : T(0);
}

// cp.async copy of one element into shared memory; ok == false zero-fills
// (0 bytes read).  cp_async_wait waits for the thread's copies and
// synchronises the block.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool ok) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sa),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Allow a kernel `bytes` of dynamic shared memory, once per device; `done`
// is the caller's per-kernel device mask.  Set even below 48 KB: the
// default limit counts the kernel's static shared memory too.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes, unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (*done >> dev & 1u)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 32) *done |= 1u << dev;
  return e;
}

// One damped-Jacobi sweep: out = (1-w) x + (rhs + nbsum(x)) (w dinv).
template <typename T>
__global__ void smooth_kernel(Level<T> lv, const T* __restrict__ x,
                              const T* __restrict__ rhs, T* __restrict__ out,
                              T w, T omw, const int* flag) {
  if (gated_off(flag)) return;
  const int n = lv.ny * lv.nx;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* xb = x + off;
  auto v = [&](int cc) { return xb[cc]; };
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    const int i = c / lv.nx, j = c - i * lv.nx;
    const T nb = nbsum(aw, an, v, c, i, j, lv.ny, lv.nx);
    out[off + c] = omw * xb[c] + (rhs[off + c] + nb) * (w * di[c]);
  }
}

// res = r - (diag e - nbsum(e)) with diag = 1/dinv, summed over each 2x2
// block (row pairs, then column pairs); one thread per coarse cell.  A
// coarse cell past the fine grid (padding) receives 0.
template <typename T>
__global__ void resid_restrict_kernel(Level<T> lv, const T* __restrict__ r,
                                      const T* __restrict__ e,
                                      T* __restrict__ rc, int nyc, int nxc,
                                      const int* flag) {
  if (gated_off(flag)) return;
  const int n = lv.ny * lv.nx, nc = nyc * nxc;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* rb = r + off;
  const T* eb = e + off;
  auto v = [&](int cc) { return eb[cc]; };
  auto res = [&](int i, int j) {
    const int c = i * lv.nx + j;
    return rb[c] - (diag_of(di[c]) * eb[c] - nbsum(aw, an, v, c, i, j, lv.ny, lv.nx));
  };
  for (int k = 0; k < CPT; ++k) {
    const int cc = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (cc >= nc) break;
    const int I = cc / nxc, J = cc - I * nxc;
    T out = T(0);
    if (2 * I < lv.ny && 2 * J < lv.nx) {
      const int i = 2 * I, j = 2 * J;
      out = (res(i, j) + res(i + 1, j)) + (res(i, j + 1) + res(i + 1, j + 1));
    }
    rc[(size_t)blockIdx.y * nc + cc] = out;
  }
}

// Post-smoothing's first sweep fused with the prolongation:
// src = es + over * e_c[i/2, j/2] is recomputed at the 5 stencil points.
template <typename T>
__global__ void post_first_kernel(Level<T> lv, const T* __restrict__ es,
                                  const T* __restrict__ ec, int nyc, int nxc,
                                  T over, const T* __restrict__ rhs,
                                  T* __restrict__ out, T w, T omw,
                                  const int* flag) {
  if (gated_off(flag)) return;
  const int n = lv.ny * lv.nx;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* eb = es + off;
  const T* cb = ec + (size_t)blockIdx.y * nyc * nxc;
  const int nx = lv.nx;
  auto v = [&](int cc) {
    const int i = cc / nx, j = cc - i * nx;
    return eb[cc] + over * cb[(i >> 1) * nxc + (j >> 1)];
  };
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    const int i = c / nx, j = c - i * nx;
    const T nb = nbsum(aw, an, v, c, i, j, lv.ny, nx);
    out[off + c] = omw * v(c) + (rhs[off + c] + nb) * (w * di[c]);
  }
}

// Scratch the cycle needs per image: e and a ping-pong plane on every
// level, plus the restricted residual on every level below the finest.
inline long long cycle_scratch_elems(int L, const int* ny, const int* nx) {
  long long s = 0;
  for (int l = 0; l < L; ++l) s += (l == 0 ? 2LL : 3LL) * ny[l] * nx[l];
  return s;
}

// The resident bottom: the shared memory its planes may take in one CTA
// (the H100's opt-in 227 KB a block less 1 KB for the kernel's level and
// weight tables), and the levels it may hold.
constexpr long long RESIDENT_SMEM = 231424;
constexpr int RESIDENT_LEVELS = 16;

// The resident rule: the first level l from which the rest of the pyramid
// (levels l..L-1: a_w, a_n, diag_inv, right-hand side and correction of
// each, plus one ping-pong plane of level l's size) fits RESIDENT_SMEM
// bytes in at most RESIDENT_LEVELS levels; L when even the coarsest level
// does not fit (it then runs its sweeps from global memory).  Shape and
// element size alone decide it; the Python twin is
// ops/kernels/vcycle.py::cycle_resident_from.
inline int cycle_resident_from(int L, const int* ny, const int* nx,
                               int itemsize) {
  long long cells = 0;
  for (int l = L - 1; l >= 0; --l) {
    const long long n = (long long)ny[l] * nx[l];
    cells += 5 * n;
    if ((cells + n) * itemsize > RESIDENT_SMEM || L - l > RESIDENT_LEVELS)
      return l + 1;
  }
  return 0;
}

// One V(nu, nu) cycle (1 <= nu <= 8) from level l0 down to the coarsest and
// back, for B images on `st`: `r` is level l0's right-hand side and `z`
// receives level l0's correction (z must not alias r or the scratch).
// `scratch` holds B * cycle_scratch_elems(L, ny, nx) elements laid out for
// the whole hierarchy (level 0: e and a spare plane; level l >= 1: its
// right-hand side, e and its correction); the planes of the levels above l0
// are not touched.  l0 = 0 is K2's whole cycle; K1 runs its level 0 in its
// own passes and calls this with l0 = 1, its pass X having written level
// 1's right-hand side into the scratch.  Defined in vcycle.cu for float and
// double.
template <typename T>
cudaError_t cycle_from(int B, int L, const Level<T>* lv, int l0, const T* r,
                       T* z, T* scratch, const double* ws, int nu,
                       int coarse_iters, double over, const int* flag,
                       cudaStream_t st);

// cycle_from with l0 = 0: K2's whole cycle.
template <typename T>
cudaError_t run_cycle(int B, int L, const Level<T>* lv, const T* r, T* z,
                      T* scratch, const double* ws, int nu, int coarse_iters,
                      double over, const int* flag, cudaStream_t st) {
  return cycle_from<T>(B, L, lv, 0, r, z, scratch, ws, nu, coarse_iters,
                       over, flag, st);
}

template <typename T>
int fill_levels(int L, const int* ny, const int* nx, const void* const* aw,
                const void* const* an, const void* const* dinv, Level<T>* lv) {
  if (L < 1 || L > MAX_LEVELS) return 0;
  for (int l = 0; l < L; ++l) {
    lv[l].aw = static_cast<const T*>(aw[l]);
    lv[l].an = static_cast<const T*>(an[l]);
    lv[l].dinv = static_cast<const T*>(dinv[l]);
    lv[l].ny = ny[l];
    lv[l].nx = nx[l];
  }
  return 1;
}

}  // namespace deff
