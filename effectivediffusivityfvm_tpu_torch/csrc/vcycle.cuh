// K2: one whole V(nu, nu) multigrid cycle z = M r over the padded-even
// hierarchy, as a sequence of batch-wide level kernels.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/vcycle_vmem.py
// (v_cycle_pallas / _cycle_value).  On the TPU one grid step held an
// image's whole pyramid in VMEM; a Hopper SM has 227 KB of shared memory
// and one 512^2 fp32 plane is 1 MiB, so here every pass streams its planes
// through L2/HBM with blockIdx = (tile of cells, image).
//
// What bounds it on an H100: memory bandwidth.  A pass does a handful of
// flops per cell and moves 16-24 B/cell (fp32): smooth reads x, rhs, a_w,
// a_n, diag_inv and writes x' (24 B/cell); residual+restrict reads r, e,
// a_w, a_n, diag_inv (20 B/cell) and writes a quarter plane.  The design
// cuts passes by fusing: the first pre-smooth e0 = w0 dinv r is recomputed
// at the 5 stencil points inside the second sweep (never stored), the
// residual is computed inside the restriction (one thread per coarse
// cell), and the prolongation e + over P e_c is recomputed at the stencil
// points inside the first post-smooth.  A V(2,2) level costs 4 passes; the
// coarsest level runs all its sweeps in one block per image.  Neighbour
// reads are bounded (zero outside the grid): no wrap-around.
//
// Arithmetic follows the plain version (ops/kernels/vcycle.py) operation
// for operation, in the same order; the build turns FMA contraction off, so
// each product and sum is rounded as the plain version's elementwise ops
// round it.
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
// V-cycles it ran (each run_cycle call, whoever made it).
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

// Pre-smoothing: e = w0 dinv r, then (two == 1) one damped-Jacobi sweep at
// w1 whose neighbour values of e are recomputed from r.
template <typename T>
__global__ void pre_first_kernel(Level<T> lv, const T* __restrict__ r,
                                 T* __restrict__ e, T w0, T w1, T omw1,
                                 int two, const int* flag) {
  if (gated_off(flag)) return;
  const int n = lv.ny * lv.nx;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* rb = r + off;
  T* eb = e + off;
  auto e0 = [&](int cc) { return (w0 * di[cc]) * rb[cc]; };
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    if (!two) {
      eb[c] = e0(c);
    } else {
      const int i = c / lv.nx, j = c - i * lv.nx;
      const T nb = nbsum(aw, an, e0, c, i, j, lv.ny, lv.nx);
      eb[c] = omw1 * e0(c) + (rb[c] + nb) * (w1 * di[c]);
    }
  }
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

// Coarsest level: `iters` damped-Jacobi sweeps at w from e = 0, one block
// per image (blockIdx.y), ping-ponging between `other` and `out` so that
// the last sweep lands in `out`.
template <typename T>
__global__ void coarse_solve_kernel(Level<T> lv, const T* __restrict__ rhs,
                                    T* out, T* other, T w, T omw, int iters,
                                    const int* flag) {
  if (gated_off(flag)) return;
  const int n = lv.ny * lv.nx;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* rb = rhs + off;
  T* bufs[2] = {out + off, other + off};
  // sweep s writes bufs[(iters - 1 - s) & 1]; its source is the other one
  T* src = bufs[iters & 1];
  for (int c = threadIdx.x; c < n; c += blockDim.x) src[c] = T(0);
  __syncthreads();
  for (int s = 0; s < iters; ++s) {
    T* dst = bufs[(iters - 1 - s) & 1];
    const T* sv = src;
    auto v = [&](int cc) { return sv[cc]; };
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int i = c / lv.nx, j = c - i * lv.nx;
      const T nb = nbsum(aw, an, v, c, i, j, lv.ny, lv.nx);
      dst[c] = omw * sv[c] + (rb[c] + nb) * (w * di[c]);
    }
    __syncthreads();
    src = dst;
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

// One V(nu, nu) cycle from level l0 down to the coarsest and back, for B
// images on `st`: `r` is level l0's right-hand side and `z` receives level
// l0's correction (z must not alias r or the scratch).  `scratch` holds B *
// cycle_scratch_elems(L, ny, nx) elements laid out for the whole hierarchy;
// the planes of the levels above l0 are not touched.  l0 = 0 is K2's whole
// cycle; K1 runs its level 0 in its own passes and calls this with l0 = 1.
template <typename T>
cudaError_t cycle_from(int B, int L, const Level<T>* lv, int l0, const T* r,
                       T* z, T* scratch, const double* ws, int nu,
                       int coarse_iters, double over, const int* flag,
                       cudaStream_t st) {
  if (L < 1 || L > MAX_LEVELS || l0 < 0 || l0 >= L || nu < 1 ||
      coarse_iters < 0 || B < 1)
    return cudaErrorInvalidValue;
  ++g_cycles;
  T* R[MAX_LEVELS];
  T* E[MAX_LEVELS];
  T* P[MAX_LEVELS];
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    const long long n = (long long)B * lv[l].ny * lv[l].nx;
    R[l] = nullptr;
    if (l > 0) { R[l] = scratch + off; off += n; }
    E[l] = scratch + off; off += n;
    P[l] = scratch + off; off += n;
  }
  const T tover = (T)over;
  const dim3 blk(THREADS);
  auto grid = [&](long long n) { return dim3(blocks_for(n), B); };

  // way down: pre-smooth, then residual + restriction
  T* es[MAX_LEVELS];
  T* spare[MAX_LEVELS];
  for (int l = l0; l < L - 1; ++l) {
    const Level<T> v = lv[l];
    const T* rl = (l == l0) ? r : R[l];
    const long long n = (long long)v.ny * v.nx;
    const double w1 = nu > 1 ? ws[1] : 0.0;
    DEFF_LAUNCH(pre_first_kernel<T><<<grid(n), blk, 0, st>>>(
        v, rl, E[l], (T)ws[0], (T)w1, (T)(1.0 - w1), nu > 1 ? 1 : 0, flag));
    T* cur = E[l];
    T* oth = P[l];
    for (int s = 2; s < nu; ++s) {
      DEFF_LAUNCH(smooth_kernel<T><<<grid(n), blk, 0, st>>>(
          v, cur, rl, oth, (T)ws[s], (T)(1.0 - ws[s]), flag));
      T* t = cur; cur = oth; oth = t;
    }
    es[l] = cur;
    spare[l] = oth;
    const long long nc = (long long)lv[l + 1].ny * lv[l + 1].nx;
    DEFF_LAUNCH(resid_restrict_kernel<T><<<grid(nc), blk, 0, st>>>(
        v, rl, cur, R[l + 1], lv[l + 1].ny, lv[l + 1].nx, flag));
  }

  // coarsest level: coarse_iters sweeps at the last weight, from zero
  const int lc = L - 1;
  const double wc = ws[nu - 1];
  T* ec = (lc == l0) ? z : E[lc];
  DEFF_LAUNCH(coarse_solve_kernel<T><<<dim3(1, B), blk, 0, st>>>(
      lv[lc], lc == l0 ? r : R[lc], ec, P[lc], (T)wc, (T)(1.0 - wc),
      coarse_iters, flag));

  // way up: prolongation fused into the first post-smooth, weights reversed
  for (int l = L - 2; l >= l0; --l) {
    const Level<T> v = lv[l];
    const T* rl = (l == l0) ? r : R[l];
    const long long n = (long long)v.ny * v.nx;
    T* bufs[2] = {spare[l], es[l]};
    T* dst = (l == l0 && nu == 1) ? z : bufs[0];
    const double w0 = ws[nu - 1];
    DEFF_LAUNCH(post_first_kernel<T><<<grid(n), blk, 0, st>>>(
        v, es[l], ec, lv[l + 1].ny, lv[l + 1].nx, tover, rl, dst, (T)w0,
        (T)(1.0 - w0), flag));
    for (int s = 1; s < nu; ++s) {
      T* src = dst;
      dst = (l == l0 && s == nu - 1) ? z : bufs[s & 1];
      const double w = ws[nu - 1 - s];
      DEFF_LAUNCH(smooth_kernel<T><<<grid(n), blk, 0, st>>>(
          v, src, rl, dst, (T)w, (T)(1.0 - w), flag));
    }
    ec = dst;
  }
  return cudaSuccess;
}

// Launch one whole V(nu, nu) cycle z = M r (K2) for B images on `st`.
// `scratch` holds B * cycle_scratch_elems(L, ny, nx) elements; z must not
// alias r.
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
