// K6: the 7-point voxel V(nu, nu) cycle z = M r over the padded-even 3D
// hierarchy, as a sequence of batch-wide level kernels; also T1 and T2 of
// the banded cycle.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/vcycle3d.py
// (v_cycle3d_pallas / _cycle3d_value, and v_cycle3d_tiled's _t1_kernel3,
// _t2_kernel3 and coarse_tail3).  On the TPU the whole pyramid of a small
// volume sat in VMEM, and a large one streamed in z-slabs of `band` slices
// with HALO_Z = 4 halo slices.  A Hopper SM has 227 KB of shared memory:
// a 3D window with a halo of nu + 2 on all six faces holds six fields of
// ~60 KB each at nu = 2 (fp32, an 8x16x32 tile), past that budget.  So this
// first form makes one pass over device memory per sweep, with
// blockIdx = (run of cells, image): each pass reads only the previous
// pass's values, which makes it exact, and the neighbours a stencil reads
// mostly come from L1/L2.
//
// What bounds it on an H100: memory bandwidth.  A sweep does ~20 flops per
// cell and moves 24 B/cell in fp32 (x, rhs, a_w, a_n, a_u, diag_inv in;
// x' out).  Fusion by recompute cuts passes as in K2 (vcycle.cuh): the first
// pre-smooth e0 = (w0 dinv) r is recomputed at the 7 stencil points inside
// the second sweep, the residual is computed inside the restriction (one
// thread per coarse cell, 8 fine residuals), and the prolongation e + over
// P e_c is recomputed at the stencil points inside the first post-smooth.
// A V(nu, nu) level costs 2 nu passes; the coarsest level runs all its
// sweeps in one block per image.  Neighbour reads are bounded (0 outside
// the volume).
//
// Arithmetic follows the plain versions (ops/kernels/vcycle3d.py) operation
// for operation, in the same order: the neighbour sum
// aw x[w] + (aw x)[e] + an x[n] + (an x)[s] + au x[u] + (au x)[d], the sweep
// (1 - w) x + (w (rhs + nbsum)) dinv, the diagonal 1/dinv, the restriction
// z pairs, then y pairs, then x pairs.  The build turns FMA contraction
// off, so each product and sum is rounded as the plain version rounds it.
//
// Per-image gating: every kernel takes an optional int flag per image
// (nullptr = all images); a block whose image flag is 0 returns at once.
#pragma once

#include "vcycle.cuh"

namespace deff {

// Host-side count of the 3D V-cycles this library ran (each run_cycle3
// call, whoever made it: the whole-cycle entry, the banded cycle's tail, or
// K7's tail).
extern long long g_cycles3;

struct Dims3 {
  int nz, ny, nx;
  __host__ __device__ int plane() const { return ny * nx; }
  __host__ __device__ int cells() const { return nz * ny * nx; }
};

// A cell of an image: its index in the image and its coordinates.
struct Cell {
  int c, k, i, j;
};

__device__ __forceinline__ Cell cell_of(int c, const Dims3& d) {
  Cell out;
  out.c = c;
  out.k = c / d.plane();
  const int rem = c - out.k * d.plane();
  out.i = rem / d.nx;
  out.j = rem - out.i * d.nx;
  return out;
}

// Stored coefficient volumes of one level, all images: w(g) = a_w, n(g) =
// a_n, u(g) = a_u, di(g) = diag_inv at global index g (image offset
// included).
template <typename T>
struct Stored3 {
  const T* aw;
  const T* an;
  const T* au;
  const T* dinv;
  __device__ __forceinline__ T w(size_t g, const Cell&) const { return aw[g]; }
  __device__ __forceinline__ T n(size_t g, const Cell&) const { return an[g]; }
  __device__ __forceinline__ T u(size_t g, const Cell&) const { return au[g]; }
  __device__ __forceinline__ T di(size_t g, const Cell&, const Dims3&) const {
    return dinv[g];
  }
};

// Guarded product-form harmonic mean (2a) b / (a + b), 0 where a + b <= 0.
template <typename T>
__device__ __forceinline__ T hmean3(T a, T b) {
  const T s = a + b;
  return s > T(0) ? ((T(2) * a) * b) / s : T(0);
}

// The symmetric 7-point neighbour sum at cell q (global index g) of the
// values v(global index), in the plain version's order.
template <typename T, typename C, typename V>
__device__ __forceinline__ T nbsum3(const C& co, V v, size_t g, const Cell& q,
                                    const Dims3& dm) {
  const size_t pl = (size_t)dm.plane();
  T s = q.j > 0 ? co.w(g, q) * v(g - 1) : T(0);
  if (q.j + 1 < dm.nx) {
    const Cell e{q.c + 1, q.k, q.i, q.j + 1};
    s = s + co.w(g + 1, e) * v(g + 1);
  }
  if (q.i > 0) s = s + co.n(g, q) * v(g - dm.nx);
  if (q.i + 1 < dm.ny) {
    const Cell so{q.c + dm.nx, q.k, q.i + 1, q.j};
    s = s + co.n(g + dm.nx, so) * v(g + dm.nx);
  }
  if (q.k > 0) s = s + co.u(g, q) * v(g - pl);
  if (q.k + 1 < dm.nz) {
    const Cell dn{q.c + dm.plane(), q.k + 1, q.i, q.j};
    s = s + co.u(g + pl, dn) * v(g + pl);
  }
  return s;
}

// Pre-smoothing: e = (w0 dinv) r, then (two == 1) one sweep at w1 whose
// neighbour values of e are recomputed from r.
template <typename T, typename C>
__global__ void pre_first3_kernel(C co, Dims3 dm, const T* __restrict__ r,
                                  T* __restrict__ e, T w0, T w1, T omw1,
                                  int two, const int* flag) {
  if (gated_off(flag)) return;
  const int n = dm.cells();
  const size_t off = (size_t)blockIdx.y * n;
  auto e0 = [&](size_t g) {
    const Cell q = cell_of((int)(g - off), dm);
    return (w0 * co.di(g, q, dm)) * r[g];
  };
  for (int kk = 0; kk < CPT; ++kk) {
    const int c = blockIdx.x * TILE + kk * THREADS + threadIdx.x;
    if (c >= n) break;
    const size_t g = off + c;
    const Cell q = cell_of(c, dm);
    const T di = co.di(g, q, dm);
    const T ec = (w0 * di) * r[g];
    if (!two) {
      e[g] = ec;
    } else {
      const T nb = nbsum3<T>(co, e0, g, q, dm);
      e[g] = omw1 * ec + (w1 * (r[g] + nb)) * di;
    }
  }
}

// One damped-Jacobi sweep out = (1 - w) x + (w (rhs + nbsum(x))) dinv.
template <typename T, typename C>
__global__ void smooth3_kernel(C co, Dims3 dm, const T* __restrict__ x,
                               const T* __restrict__ rhs, T* __restrict__ out,
                               T w, T omw, const int* flag) {
  if (gated_off(flag)) return;
  const int n = dm.cells();
  const size_t off = (size_t)blockIdx.y * n;
  auto v = [&](size_t g) { return x[g]; };
  for (int kk = 0; kk < CPT; ++kk) {
    const int c = blockIdx.x * TILE + kk * THREADS + threadIdx.x;
    if (c >= n) break;
    const size_t g = off + c;
    const Cell q = cell_of(c, dm);
    const T nb = nbsum3<T>(co, v, g, q, dm);
    out[g] = omw * x[g] + (w * (rhs[g] + nb)) * co.di(g, q, dm);
  }
}

// res = r - (diag e - nbsum(e)) with diag = 1/dinv, summed over each
// 2x2x2 block (z pairs, then y pairs, then x pairs); one thread per coarse
// cell.  A coarse cell past the fine volume (padding) receives 0.
template <typename T, typename C>
__global__ void resid_restrict3_kernel(C co, Dims3 dm, const T* __restrict__ r,
                                       const T* __restrict__ e,
                                       T* __restrict__ rc, Dims3 dc,
                                       const int* flag) {
  if (gated_off(flag)) return;
  const int n = dm.cells(), nc = dc.cells();
  const size_t off = (size_t)blockIdx.y * n;
  auto v = [&](size_t g) { return e[g]; };
  auto res = [&](int k, int i, int j) {
    const int c = (k * dm.ny + i) * dm.nx + j;
    const size_t g = off + c;
    const Cell q{c, k, i, j};
    return r[g] - (diag_of(co.di(g, q, dm)) * e[g] - nbsum3<T>(co, v, g, q, dm));
  };
  auto zs = [&](int K, int i, int j) {
    return res(2 * K, i, j) + res(2 * K + 1, i, j);
  };
  for (int kk = 0; kk < CPT; ++kk) {
    const int cc = blockIdx.x * TILE + kk * THREADS + threadIdx.x;
    if (cc >= nc) break;
    const Cell Q = cell_of(cc, dc);
    T out = T(0);
    if (2 * Q.k < dm.nz && 2 * Q.i < dm.ny && 2 * Q.j < dm.nx) {
      const int i = 2 * Q.i, j = 2 * Q.j;
      out = (zs(Q.k, i, j) + zs(Q.k, i + 1, j)) +
            (zs(Q.k, i, j + 1) + zs(Q.k, i + 1, j + 1));
    }
    rc[(size_t)blockIdx.y * nc + cc] = out;
  }
}

// Coarsest level: `iters` sweeps at w from e = 0, one block per image
// (blockIdx.y), ping-ponging between `other` and `out` so that the last
// sweep lands in `out`.
template <typename T>
__global__ void coarse_solve3_kernel(Stored3<T> co, Dims3 dm,
                                     const T* __restrict__ rhs, T* out,
                                     T* other, T w, T omw, int iters,
                                     const int* flag) {
  if (gated_off(flag)) return;
  const int n = dm.cells();
  const size_t off = (size_t)blockIdx.y * n;
  T* bufs[2] = {out + off, other + off};
  // sweep s writes bufs[(iters - 1 - s) & 1]; its source is the other one
  T* src = bufs[iters & 1];
  for (int c = threadIdx.x; c < n; c += blockDim.x) src[c] = T(0);
  __syncthreads();
  for (int s = 0; s < iters; ++s) {
    T* dst = bufs[(iters - 1 - s) & 1];
    const T* sv = src - off;            // indexed by global index
    auto v = [&](size_t g) { return sv[g]; };
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const size_t g = off + c;
      const Cell q = cell_of(c, dm);
      const T nb = nbsum3<T>(co, v, g, q, dm);
      dst[c] = omw * sv[g] + (w * (rhs[g] + nb)) * co.di(g, q, dm);
    }
    __syncthreads();
    src = dst;
  }
}

// Post-smoothing's first sweep fused with the prolongation: the source
// es + over * e_c[k/2, i/2, j/2] is recomputed at the 7 stencil points.
template <typename T, typename C>
__global__ void post_first3_kernel(C co, Dims3 dm, const T* __restrict__ es,
                                   const T* __restrict__ ec, Dims3 dc, T over,
                                   const T* __restrict__ rhs,
                                   T* __restrict__ out, T w, T omw,
                                   const int* flag) {
  if (gated_off(flag)) return;
  const int n = dm.cells();
  const size_t off = (size_t)blockIdx.y * n;
  const T* cb = ec + (size_t)blockIdx.y * dc.cells();
  auto v = [&](size_t g) {
    const Cell q = cell_of((int)(g - off), dm);
    return es[g] +
           over * cb[((q.k >> 1) * dc.ny + (q.i >> 1)) * dc.nx + (q.j >> 1)];
  };
  for (int kk = 0; kk < CPT; ++kk) {
    const int c = blockIdx.x * TILE + kk * THREADS + threadIdx.x;
    if (c >= n) break;
    const size_t g = off + c;
    const Cell q = cell_of(c, dm);
    const T nb = nbsum3<T>(co, v, g, q, dm);
    out[g] = omw * v(g) + (w * (rhs[g] + nb)) * co.di(g, q, dm);
  }
}

template <typename T>
struct Level3 {
  Stored3<T> co;
  Dims3 dm;
};

inline dim3 grid3(long long n, int B) { return dim3(blocks_for(n), B); }

// The down leg on one level (T1): pre-smoothing into `e` (the sweeps
// ping-pong through `spare` and end in `e`), then the residual restricted
// onto the coarse shape `dc` into `rc`.
template <typename T, typename C>
cudaError_t down3(int B, const C& co, Dims3 dm, const T* r, T* e, T* spare,
                  T* rc, Dims3 dc, const double* ws, int nu, const int* flag,
                  cudaStream_t st) {
  const dim3 blk(THREADS);
  const int extra = nu > 2 ? nu - 2 : 0;     // sweeps after the fused two
  T* cur = (extra % 2 == 0) ? e : spare;
  T* oth = (extra % 2 == 0) ? spare : e;
  const double w1 = nu > 1 ? ws[1] : 0.0;
  DEFF_LAUNCH(pre_first3_kernel<T, C><<<grid3(dm.cells(), B), blk, 0, st>>>(
      co, dm, r, cur, (T)ws[0], (T)w1, (T)(1.0 - w1), nu > 1 ? 1 : 0, flag));
  for (int s = 2; s < nu; ++s) {
    DEFF_LAUNCH(smooth3_kernel<T, C><<<grid3(dm.cells(), B), blk, 0, st>>>(
        co, dm, cur, r, oth, (T)ws[s], (T)(1.0 - ws[s]), flag));
    T* t = cur; cur = oth; oth = t;
  }
  DEFF_LAUNCH(resid_restrict3_kernel<T, C><<<grid3(dc.cells(), B), blk, 0,
                                             st>>>(co, dm, r, e, rc, dc,
                                                   flag));
  return cudaSuccess;
}

// The up leg on one level (T2): e + over P e_c, then the sweeps in reverse
// order of ws.  `e` is clobbered after the first sweep; the result goes to
// `out` if it is not null, else it lands in `spare` or `e` and *landed`
// says where.
template <typename T, typename C>
cudaError_t up3(int B, const C& co, Dims3 dm, T* e, const T* ec, Dims3 dc,
                T over, const T* r, T* out, T* spare, const double* ws,
                int nu, const int* flag, cudaStream_t st,
                T** landed) {
  const dim3 blk(THREADS);
  T* bufs[2] = {spare, e};
  T* dst = (nu == 1 && out != nullptr) ? out : bufs[0];
  const double w0 = ws[nu - 1];
  DEFF_LAUNCH(post_first3_kernel<T, C><<<grid3(dm.cells(), B), blk, 0, st>>>(
      co, dm, e, ec, dc, over, r, dst, (T)w0, (T)(1.0 - w0), flag));
  for (int s = 1; s < nu; ++s) {
    T* src = dst;
    const bool last = s == nu - 1;
    dst = (last && out != nullptr) ? out : bufs[s & 1];
    const double w = ws[nu - 1 - s];
    DEFF_LAUNCH(smooth3_kernel<T, C><<<grid3(dm.cells(), B), blk, 0, st>>>(
        co, dm, src, r, dst, (T)w, (T)(1.0 - w), flag));
  }
  if (landed != nullptr) *landed = dst;
  return cudaSuccess;
}

// Scratch the whole cycle needs per image: e and a ping-pong volume on
// every level, plus the restricted residual on every level below the
// finest.
inline long long cycle3_scratch_elems(int L, const int* nz, const int* ny,
                                      const int* nx) {
  long long s = 0;
  for (int l = 0; l < L; ++l)
    s += (l == 0 ? 2LL : 3LL) * nz[l] * ny[l] * nx[l];
  return s;
}

// Launch one whole V(nu, nu) cycle z = M r for B images on `st`.
// `scratch` holds B * cycle3_scratch_elems(...) elements; z must not alias
// r.
template <typename T>
cudaError_t run_cycle3(int B, int L, const Level3<T>* lv, const T* r, T* z,
                       T* scratch, const double* ws, int nu, int coarse_iters,
                       double over, const int* flag, cudaStream_t st) {
  if (L < 1 || L > MAX_LEVELS || nu < 1 || coarse_iters < 0 || B < 1)
    return cudaErrorInvalidValue;
  ++g_cycles3;
  T* R[MAX_LEVELS];
  T* E[MAX_LEVELS];
  T* P[MAX_LEVELS];
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    const long long n = (long long)B * lv[l].dm.cells();
    R[l] = nullptr;
    if (l > 0) { R[l] = scratch + off; off += n; }
    E[l] = scratch + off; off += n;
    P[l] = scratch + off; off += n;
  }
  cudaError_t err;
  for (int l = 0; l < L - 1; ++l) {
    err = down3<T>(B, lv[l].co, lv[l].dm, l == 0 ? r : R[l], E[l], P[l],
                   R[l + 1], lv[l + 1].dm, ws, nu, flag, st);
    if (err != cudaSuccess) return err;
  }
  const int lc = L - 1;
  const double wc = ws[nu - 1];
  T* ec = (L == 1) ? z : E[lc];
  DEFF_LAUNCH(coarse_solve3_kernel<T><<<dim3(1, B), THREADS, 0, st>>>(
      lv[lc].co, lv[lc].dm, L == 1 ? r : R[lc], ec, P[lc], (T)wc,
      (T)(1.0 - wc), coarse_iters, flag));
  for (int l = L - 2; l >= 0; --l) {
    T* landed = nullptr;
    err = up3<T>(B, lv[l].co, lv[l].dm, E[l], ec, lv[l + 1].dm, (T)over,
                 l == 0 ? r : R[l], l == 0 ? z : nullptr, P[l], ws, nu,
                 flag, st, &landed);
    if (err != cudaSuccess) return err;
    ec = landed;
  }
  return cudaSuccess;
}

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
