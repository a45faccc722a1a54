// K6's cycle (declared in vcycle3d.cuh) and its C entry points, loaded with
// ctypes by effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle3d.py: the
// whole cycle, and T1 / T2 of the banded cycle on level 0 (the wrapper runs
// the whole cycle on levels[1:] between them).  Every entry launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of its launches.
//
// The TPU kernel (v_cycle3d_pallas) held a volume's whole pyramid in VMEM
// for one cycle, and its banded form streamed level 0 in z-slabs.  On an
// H100 the upper levels are far too large for an SM, and the cycle is
// bound by memory bandwidth there and by latency (launches, barriers) at
// the bottom.  So the residency comes back in two regimes, as in K2:
//
//   DOWN (each level l above the bottom, and T1 at level 0): one z-marching
//     tile pass (levelpass3d.cuh) that stages r and the four coefficient
//     volumes slice by slice, keeps e0 = (w0 dinv) r and the nu - 1 sweeps
//     in rings of slices, and writes e and the restricted residual: ~6.1
//     volumes of traffic (5 read, e and an eighth written).
//   UP (the same levels in reverse, and T2): e, r, the coefficients and the
//     coarse correction under the window staged; e + over P e_c, then the
//     nu post-sweeps, the last on the tile; writes the correction: ~7.1.
//   BOTTOM (the levels from cycle3_resident_from down): one CTA per volume
//     loads a_w, a_n, a_u, diag_inv of every level and the first level's
//     right-hand side into shared memory, runs the down legs, the coarse
//     sweeps and the up legs there with a barrier between sweeps, and
//     writes the first level's correction: one launch for the rest of the
//     cycle.
//
// A level above the bottom costs 2 launches and ~13.3 volumes of traffic
// (one global pass a sweep would cost 2 nu + 2 launches and ~26.3 at nu =
// 2).  At B=1 x 256^3 float32 the cycle on levels[1:] runs 128^3, 64^3 and
// 32^3 in passes and the rest (16^3 down, ~129 KB) in one CTA: 7 launches.
// The passes are bound by their z-steps' work, not by bytes: on the small
// levels by the steps' latency, hence segments of 2 slices there
// (march3d.cuh).  When even the coarsest level does not fit one CTA, it
// runs its sweeps from global memory in one block per volume
// (coarse_solve3_kernel).
#include <type_traits>

#include "levelpass3d.cuh"

namespace deff {

long long g_cycles3 = 0;

namespace {

using march::Vol0;
using march::W3;

constexpr int BOT3_THREADS = 1024;      // the resident bottom's CTA

#define DEFF_TRY3(...)                         \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

// A cell of a volume: its index and its coordinates.
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

// The symmetric 7-point neighbour sum at cell q (index g into co's
// volumes) of the values v(index), in the plain version's order, 0 outside
// the volume.
template <typename T, typename V>
__device__ __forceinline__ T nbsum3(const Stored3<T>& co, V v, size_t g,
                                    const Cell& q, const Dims3& dm) {
  const size_t pl = (size_t)dm.plane();
  T s = q.j > 0 ? co.aw[g] * v(g - 1) : T(0);
  if (q.j + 1 < dm.nx) s = s + co.aw[g + 1] * v(g + 1);
  if (q.i > 0) s = s + co.an[g] * v(g - dm.nx);
  if (q.i + 1 < dm.ny) s = s + co.an[g + dm.nx] * v(g + dm.nx);
  if (q.k > 0) s = s + co.au[g] * v(g - pl);
  if (q.k + 1 < dm.nz) s = s + co.au[g + pl] * v(g + pl);
  return s;
}

// ---- the level passes: K6's DOWN and UP bodies without the CG update
template <typename T, int NU>
__global__ void __launch_bounds__(march::NT)
zdown3_kernel(Vol0<T> v, const T* r, T* e, T* rc, Dims3 dc, const int* flag,
              W3 ws, int seglen) {
  // without the CG update the body only reads r
  march::down3_body<T, NU, false, false>(
      v, nullptr, nullptr, nullptr, const_cast<T*>(r), nullptr, nullptr, e,
      rc, dc, flag, CgState<T>{}, ws, seglen);
}

template <typename T, int NU>
__global__ void __launch_bounds__(march::NT)
zup3_kernel(Vol0<T> v, const T* e, const T* ec, Dims3 dc, T over,
            const T* r, T* out, const int* flag, W3 ws, int seglen) {
  march::up3_body<T, NU, false, false>(v, r, nullptr, e, ec, dc, over, out,
                                       flag, CgState<T>{}, ws, seglen);
}

// ---- BOTTOM: the rest of the cycle from its first level, one CTA per
// volume (blockIdx.y) with the pyramid in shared memory.
template <typename T>
struct Pyramid3 {
  Level3<T> lv[RESIDENT3_LEVELS];
  int n;
};

// One damped-Jacobi sweep over a whole level in shared memory.
template <typename T>
__device__ __forceinline__ void sweep_vol(const Stored3<T>& co, const T* rhs,
                                          const T* src, T* dst,
                                          const Dims3& dm, T w, T omw) {
  auto v = [&](size_t g) { return src[g]; };
  const int n = dm.cells();
  for (int c = threadIdx.x; c < n; c += BOT3_THREADS) {
    const Cell q = cell_of(c, dm);
    const T nb = nbsum3<T>(co, v, (size_t)c, q, dm);
    dst[c] = omw * src[c] + (w * (rhs[c] + nb)) * co.dinv[c];
  }
  __syncthreads();
}

// Shared memory: per level k, a_w, a_n, a_u, diag_inv, right-hand side and
// e (6 volumes of level k), then one ping-pong volume of level 0's size.
template <typename T>
__global__ void __launch_bounds__(BOT3_THREADS, 1)
bottom3_kernel(Pyramid3<T> py, const T* __restrict__ r, T* __restrict__ z,
               W3 ws, int nu, T over, int iters, const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Level3<T> slv[RESIDENT3_LEVELS];
  __shared__ int base[RESIDENT3_LEVELS + 1];
  if (gated_off(flag)) return;
  const int b = blockIdx.y;
  const int n = py.n;
#pragma unroll
  for (int k = 0; k < RESIDENT3_LEVELS; ++k)
    if (threadIdx.x == k && k < n) slv[k] = py.lv[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0;
    for (int k = 0; k < n; ++k) {
      base[k] = o;
      o += 6 * slv[k].dm.cells();
    }
    base[n] = o;
  }
  __syncthreads();
  T* S = reinterpret_cast<T*>(smem_raw);
  T* tmp = S + base[n];
  // volumes: 0 a_w, 1 a_n, 2 a_u, 3 diag_inv, 4 right-hand side, 5 e
  auto vol = [&](int k, int p) { return S + base[k] + p * slv[k].dm.cells(); };
  auto coefs = [&](int k) {
    return Stored3<T>{vol(k, 0), vol(k, 1), vol(k, 2), vol(k, 3)};
  };
  for (int k = 0; k < n; ++k) {
    const Level3<T> L = slv[k];
    const int nk = L.dm.cells();
    const size_t off = (size_t)b * nk;
    T* aw = vol(k, 0);
    T* an = vol(k, 1);
    T* au = vol(k, 2);
    T* di = vol(k, 3);
    T* rh = vol(k, 4);
    for (int c = threadIdx.x; c < nk; c += BOT3_THREADS) {
      aw[c] = L.co.aw[off + c];
      an[c] = L.co.an[off + c];
      au[c] = L.co.au[off + c];
      di[c] = L.co.dinv[off + c];
      if (k == 0) rh[c] = r[off + c];
    }
  }
  __syncthreads();

  // way down: the pre-sweeps end in e (e0 starts in tmp when nu - 1 sweeps
  // follow it and nu - 1 is odd), then the residual restricted into the
  // next level's right-hand side (0 on its padding)
  for (int k = 0; k + 1 < n; ++k) {
    const Dims3 dm = slv[k].dm, dc = slv[k + 1].dm;
    const Stored3<T> co = coefs(k);
    const T* rh = vol(k, 4);
    T* e = vol(k, 5);
    T* cur = ((nu - 1) & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    const T w0 = (T)ws.w[0];
    for (int c = threadIdx.x; c < dm.cells(); c += BOT3_THREADS)
      cur[c] = (w0 * co.dinv[c]) * rh[c];
    __syncthreads();
    for (int s = 1; s < nu; ++s) {
      sweep_vol(co, rh, cur, oth, dm, (T)ws.w[s], (T)(1.0 - ws.w[s]));
      T* t = cur; cur = oth; oth = t;
    }
    T* rc = vol(k + 1, 4);
    auto ev = [&](size_t g) { return e[g]; };
    auto res = [&](int kk, int i, int j) {
      const int c = (kk * dm.ny + i) * dm.nx + j;
      const Cell q{c, kk, i, j};
      return rh[c] - (diag_of(co.dinv[c]) * e[c] -
                      nbsum3<T>(co, ev, (size_t)c, q, dm));
    };
    auto zs = [&](int K, int i, int j) {
      return res(2 * K, i, j) + res(2 * K + 1, i, j);
    };
    for (int cc = threadIdx.x; cc < dc.cells(); cc += BOT3_THREADS) {
      const Cell Q = cell_of(cc, dc);
      T out = T(0);
      if (2 * Q.k < dm.nz && 2 * Q.i < dm.ny && 2 * Q.j < dm.nx) {
        const int i = 2 * Q.i, j = 2 * Q.j;
        out = (zs(Q.k, i, j) + zs(Q.k, i + 1, j)) +
              (zs(Q.k, i, j + 1) + zs(Q.k, i + 1, j + 1));
      }
      rc[cc] = out;
    }
    __syncthreads();
  }

  // coarsest level: iters sweeps at the last weight from zero, ending in e
  {
    const int k = n - 1;
    const Dims3 dm = slv[k].dm;
    T* e = vol(k, 5);
    T* cur = (iters & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    for (int c = threadIdx.x; c < dm.cells(); c += BOT3_THREADS) cur[c] = T(0);
    __syncthreads();
    const T wc = (T)ws.w[nu - 1], omwc = (T)(1.0 - ws.w[nu - 1]);
    for (int s = 0; s < iters; ++s) {
      sweep_vol(coefs(k), vol(k, 4), cur, oth, dm, wc, omwc);
      T* t = cur; cur = oth; oth = t;
    }
  }

  // way up: src = e + over P e_c (in tmp when nu is odd), the post-sweeps
  // in reverse weight order, ending in e
  for (int k = n - 2; k >= 0; --k) {
    const Dims3 dm = slv[k].dm, dc = slv[k + 1].dm;
    T* e = vol(k, 5);
    const T* ec = vol(k + 1, 5);
    T* cur = (nu & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    for (int c = threadIdx.x; c < dm.cells(); c += BOT3_THREADS) {
      const Cell q = cell_of(c, dm);
      cur[c] = e[c] + over * ec[((q.k >> 1) * dc.ny + (q.i >> 1)) * dc.nx +
                                (q.j >> 1)];
    }
    __syncthreads();
    for (int s = 1; s <= nu; ++s) {
      sweep_vol(coefs(k), vol(k, 4), cur, oth, dm, (T)ws.w[nu - s],
                (T)(1.0 - ws.w[nu - s]));
      T* t = cur; cur = oth; oth = t;
    }
  }

  const T* e0 = vol(0, 5);
  const int n0 = slv[0].dm.cells();
  for (int c = threadIdx.x; c < n0; c += BOT3_THREADS)
    z[(size_t)b * n0 + c] = e0[c];
}

// Coarsest level from global memory (when it does not fit one CTA): `iters`
// sweeps at w from e = 0, one block per volume (blockIdx.y), ping-ponging
// between `other` and `out` so that the last sweep lands in `out`.
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
      dst[c] = omw * sv[g] + (w * (rhs[g] + nb)) * co.dinv[g];
    }
    __syncthreads();
    src = dst;
  }
}

// ---- launches

// Call f(std::integral_constant<int, nu>) for nu in 1..MAX_NU3.
template <int NU = 1, typename F>
cudaError_t with_nu3(int nu, F&& f) {
  if constexpr (NU > MAX_NU3) {
    return cudaErrorInvalidValue;
  } else {
    if (nu == NU) return f(std::integral_constant<int, NU>{});
    return with_nu3<NU + 1>(nu, f);
  }
}

template <typename T>
Vol0<T> vol_of(const Level3<T>& lv) {
  Vol0<T> v{};
  v.aw = lv.co.aw;
  v.an = lv.co.an;
  v.au = lv.co.au;
  v.dinv = lv.co.dinv;
  v.dm = lv.dm;
  return v;
}

template <typename T, int NU>
cudaError_t launch_down3(int B, const Level3<T>& lv, const T* r, T* e, T* rc,
                         Dims3 dc, const W3& ws, const int* flag,
                         cudaStream_t st) {
  static unsigned done = 0;
  const Dims3 d = lv.dm;
  const size_t sm = march::smem_bytes(3, sizeof(T), NU, false);
  auto kern = zdown3_kernel<T, NU>;
  DEFF_TRY3(allow_smem(kern, sm, &done));
  const int seglen =
      march::seg_len(d.nz, d.ny, d.nx, sizeof(T), march::LEVEL_MIN_SEG);
  const int ncta =
      march::ctas(d.nz, d.ny, d.nx, sizeof(T), march::LEVEL_MIN_SEG);
  DEFF_LAUNCH(kern<<<dim3(ncta, B), march::NT, sm, st>>>(
      vol_of(lv), r, e, rc, dc, flag, ws, seglen));
  return cudaSuccess;
}

template <typename T, int NU>
cudaError_t launch_up3(int B, const Level3<T>& lv, const T* e, const T* ec,
                       Dims3 dc, T over, const T* r, T* out, const W3& ws,
                       const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  const Dims3 d = lv.dm;
  const size_t sm = march::smem_bytes(4, sizeof(T), NU, false);
  auto kern = zup3_kernel<T, NU>;
  DEFF_TRY3(allow_smem(kern, sm, &done));
  const int seglen =
      march::seg_len(d.nz, d.ny, d.nx, sizeof(T), march::LEVEL_MIN_SEG);
  const int ncta =
      march::ctas(d.nz, d.ny, d.nx, sizeof(T), march::LEVEL_MIN_SEG);
  DEFF_LAUNCH(kern<<<dim3(ncta, B), march::NT, sm, st>>>(
      vol_of(lv), e, ec, dc, over, r, out, flag, ws, seglen));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bottom3(int B, int n, const Level3<T>* lv, const T* r,
                           T* z, const W3& ws, int nu, T over, int iters,
                           const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  if (n < 1 || n > RESIDENT3_LEVELS) return cudaErrorInvalidValue;
  Pyramid3<T> p{};
  p.n = n;
  long long cells = lv[0].dm.cells();
  for (int k = 0; k < n; ++k) {
    p.lv[k] = lv[k];
    cells += 6LL * lv[k].dm.cells();
  }
  const size_t sm = sizeof(T) * cells;
  if ((long long)sm > RESIDENT3_SMEM) return cudaErrorInvalidValue;
  auto kern = bottom3_kernel<T>;
  DEFF_TRY3(allow_smem(kern, (size_t)RESIDENT3_SMEM, &done));
  DEFF_LAUNCH(kern<<<dim3(1, B), BOT3_THREADS, sm, st>>>(p, r, z, ws, nu,
                                                         over, iters, flag));
  return cudaSuccess;
}

}  // namespace

template <typename T>
cudaError_t run_cycle3(int B, int L, const Level3<T>* lv, const T* r, T* z,
                       T* scratch, const double* ws, int nu, int coarse_iters,
                       double over, const int* flag, cudaStream_t st) {
  if (L < 1 || L > MAX_LEVELS || nu < 1 || nu > MAX_NU3 ||
      coarse_iters < 0 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  ++g_cycles3;
  T* R[MAX_LEVELS];
  T* E[MAX_LEVELS];
  T* P[MAX_LEVELS];
  int nz[MAX_LEVELS], ny[MAX_LEVELS], nx[MAX_LEVELS];
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    nz[l] = lv[l].dm.nz;
    ny[l] = lv[l].dm.ny;
    nx[l] = lv[l].dm.nx;
    const long long n = (long long)B * lv[l].dm.cells();
    R[l] = P[l] = nullptr;
    if (l > 0) { R[l] = scratch + off; off += n; }
    E[l] = scratch + off; off += n;
    if (l > 0) { P[l] = scratch + off; off += n; }
  }
  const int lb = cycle3_resident_from(L, nz, ny, nx, (int)sizeof(T));
  const W3 w3 = march::make_w3(ws, nu);
  const T tover = (T)over;
  // level l's right-hand side and the volume that receives its correction
  auto rhs = [&](int l) -> const T* { return l == 0 ? r : R[l]; };
  auto cor = [&](int l) -> T* { return l == 0 ? z : P[l]; };

  const int top = lb < L ? lb : L - 1;   // the first level not in passes
  for (int l = 0; l < top; ++l)
    DEFF_TRY3(with_nu3(nu, [&](auto k) {
      return launch_down3<T, decltype(k)::value>(
          B, lv[l], rhs(l), E[l], R[l + 1], lv[l + 1].dm, w3, flag, st);
    }));
  if (lb < L) {
    DEFF_TRY3(launch_bottom3<T>(B, L - lb, lv + lb, rhs(lb), cor(lb), w3, nu,
                                tover, coarse_iters, flag, st));
  } else {
    const int lc = L - 1;
    const double wc = ws[nu - 1];
    DEFF_LAUNCH(coarse_solve3_kernel<T><<<dim3(1, B), THREADS, 0, st>>>(
        lv[lc].co, lv[lc].dm, rhs(lc), cor(lc), E[lc], (T)wc, (T)(1.0 - wc),
        coarse_iters, flag));
  }
  for (int l = top - 1; l >= 0; --l)
    DEFF_TRY3(with_nu3(nu, [&](auto k) {
      return launch_up3<T, decltype(k)::value>(
          B, lv[l], E[l], cor(l + 1), lv[l + 1].dm, tover, rhs(l), cor(l),
          w3, flag, st);
    }));
  return cudaSuccess;
}

template cudaError_t run_cycle3<float>(int, int, const Level3<float>*,
                                       const float*, float*, float*,
                                       const double*, int, int, double,
                                       const int*, cudaStream_t);
template cudaError_t run_cycle3<double>(int, int, const Level3<double>*,
                                        const double*, double*, double*,
                                        const double*, int, int, double,
                                        const int*, cudaStream_t);

}  // namespace deff

namespace {

template <typename T>
int v_cycle3d_entry(int B, int L, const int* nz, const int* ny, const int* nx,
                    const void* const* aw, const void* const* an,
                    const void* const* au, const void* const* dinv,
                    const void* r, void* z, void* scratch, const double* ws,
                    int nu, int coarse_iters, double over, void* stream) {
  deff::Level3<T> lv[deff::MAX_LEVELS];
  if (!deff::fill_levels3<T>(L, nz, ny, nx, aw, an, au, dinv, lv))
    return cudaErrorInvalidValue;
  return deff::run_cycle3<T>(B, L, lv, static_cast<const T*>(r),
                             static_cast<T*>(z), static_cast<T*>(scratch), ws,
                             nu, coarse_iters, over, nullptr,
                             static_cast<cudaStream_t>(stream));
}

template <typename T>
deff::Level3<T> level0(int nz, int ny, int nx, const void* aw,
                       const void* an, const void* au, const void* dinv) {
  deff::Level3<T> lv{};
  lv.co = deff::Stored3<T>{static_cast<const T*>(aw),
                           static_cast<const T*>(an),
                           static_cast<const T*>(au),
                           static_cast<const T*>(dinv)};
  lv.dm = deff::Dims3{nz, ny, nx};
  return lv;
}

bool bad_dims(int B, deff::Dims3 d0, deff::Dims3 d1, int nu) {
  return B < 1 || B > 65535 || nu < 1 || nu > deff::MAX_NU3 || d0.nz < 2 ||
         d0.ny < 2 || d0.nx < 2 || d0.nz % 2 || d0.ny % 2 || d0.nx % 2 ||
         d1.nz < d0.nz / 2 || d1.ny < d0.ny / 2 || d1.nx < d0.nx / 2;
}

template <typename T>
int t1_entry(int B, int nz, int ny, int nx, int nz1, int ny1, int nx1,
             const void* aw, const void* an, const void* au, const void* dinv,
             const void* r, void* e, void* rc, const double* ws, int nu,
             void* stream) {
  const deff::Dims3 d1{nz1, ny1, nx1};
  const deff::Level3<T> lv = level0<T>(nz, ny, nx, aw, an, au, dinv);
  if (bad_dims(B, lv.dm, d1, nu)) return cudaErrorInvalidValue;
  const deff::march::W3 w3 = deff::march::make_w3(ws, nu);
  return deff::with_nu3(nu, [&](auto k) {
    return deff::launch_down3<T, decltype(k)::value>(
        B, lv, static_cast<const T*>(r), static_cast<T*>(e),
        static_cast<T*>(rc), d1, w3, nullptr,
        static_cast<cudaStream_t>(stream));
  });
}

template <typename T>
int t2_entry(int B, int nz, int ny, int nx, int nz1, int ny1, int nx1,
             const void* aw, const void* an, const void* au, const void* dinv,
             const void* e, const void* ec, const void* r, void* z,
             const double* ws, int nu, double over, void* stream) {
  const deff::Dims3 d1{nz1, ny1, nx1};
  const deff::Level3<T> lv = level0<T>(nz, ny, nx, aw, an, au, dinv);
  if (bad_dims(B, lv.dm, d1, nu)) return cudaErrorInvalidValue;
  const deff::march::W3 w3 = deff::march::make_w3(ws, nu);
  return deff::with_nu3(nu, [&](auto k) {
    return deff::launch_up3<T, decltype(k)::value>(
        B, lv, static_cast<const T*>(e), static_cast<const T*>(ec), d1,
        (T)over, static_cast<const T*>(r), static_cast<T*>(z), w3, nullptr,
        static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

extern "C" {

long long deff_cycle3_count() { return deff::g_cycles3; }

long long deff_cycle3_scratch_elems(int L, const int* nz, const int* ny,
                                    const int* nx) {
  return deff::cycle3_scratch_elems(L, nz, ny, nx);
}

int deff_cycle3_resident_from(int L, const int* nz, const int* ny,
                              const int* nx, int itemsize) {
  if (L < 1 || L > deff::MAX_LEVELS) return -1;
  return deff::cycle3_resident_from(L, nz, ny, nx, itemsize);
}

#define DEFF_V_CYCLE3D_ENTRIES(SUF, T)                                        \
  int deff_v_cycle3d_##SUF(int B, int L, const int* nz, const int* ny,        \
                           const int* nx, const void* const* aw,              \
                           const void* const* an, const void* const* au,      \
                           const void* const* dinv, const void* r, void* z,   \
                           void* scratch, const double* ws, int nu,           \
                           int coarse_iters, double over, void* stream) {     \
    return v_cycle3d_entry<T>(B, L, nz, ny, nx, aw, an, au, dinv, r, z,       \
                              scratch, ws, nu, coarse_iters, over, stream);   \
  }                                                                           \
  int deff_t1_3d_##SUF(int B, int nz, int ny, int nx, int nz1, int ny1,       \
                       int nx1, const void* aw, const void* an,               \
                       const void* au, const void* dinv, const void* r,       \
                       void* e, void* rc, const double* ws, int nu,           \
                       void* stream) {                                        \
    return t1_entry<T>(B, nz, ny, nx, nz1, ny1, nx1, aw, an, au, dinv, r, e,  \
                       rc, ws, nu, stream);                                   \
  }                                                                           \
  int deff_t2_3d_##SUF(int B, int nz, int ny, int nx, int nz1, int ny1,       \
                       int nx1, const void* aw, const void* an,               \
                       const void* au, const void* dinv, const void* e,       \
                       const void* ec, const void* r, void* z,                \
                       const double* ws, int nu, double over, void* stream) { \
    return t2_entry<T>(B, nz, ny, nx, nz1, ny1, nx1, aw, an, au, dinv, e, ec, \
                       r, z, ws, nu, over, stream);                           \
  }

DEFF_V_CYCLE3D_ENTRIES(f32, float)
DEFF_V_CYCLE3D_ENTRIES(f64, double)

}  // extern "C"
