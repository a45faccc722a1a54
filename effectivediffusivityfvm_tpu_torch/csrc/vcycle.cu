// K2's cycle (declared in vcycle.cuh) and its C entry points, loaded with
// ctypes by effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle.py.  Every
// entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launches.
//
// The TPU kernel (vcycle_vmem.py, v_cycle_pallas) held an image's whole
// pyramid in VMEM for one cycle.  On an H100 the upper levels are too large
// for an SM, and the cycle is bound by memory bandwidth there and by
// latency (launches, barriers) at the bottom.  So the residency comes back
// in two regimes:
//
//   DOWN and UP (each level l above the bottom): the level passes of
//     levelpass2d.cuh in K2's sweep form, a tile and its halo in shared
//     memory and 2x2 blocks in registers; DOWN writes e and the quarter
//     plane (~21 B a cell in fp32: 16 read, 4 + 1 written), UP the
//     correction (~25 B a cell).
//   BOTTOM (the levels from cycle_resident_from down): one CTA per image
//     loads a_w, a_n, diag_inv of every level and the first level's right-
//     hand side into shared memory, runs the down legs, the coarse sweeps
//     and the up legs there with a barrier between sweeps, and writes the
//     first level's correction: one launch for the rest of the cycle.
//
// A level above the bottom costs 2 launches and ~46 B a cell (the per-sweep
// kernels this replaces: nu + 2 launches and ~90 B a cell at nu = 2).  When
// even the coarsest level does not fit one CTA, it runs its sweeps from
// global memory in one block per image (coarse_solve_kernel).
#include "levelpass2d.cuh"
#include "window.cuh"

namespace deff {

long long g_launches = 0;
long long g_cycles = 0;
long long g_window_iters = 0;

namespace {

// Per image, the cycles whose image was not gated, counted on the device
// (a replayed CUDA graph advances it; the host counts above only count
// launches made from the host).
__device__ unsigned long long g_image_cycles = 0;

using namespace lp;

constexpr int BOT_THREADS = 1024;       // the resident bottom's CTA

#define DEFF_TRY(...)                          \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

// ---- BOTTOM: the rest of the cycle from its first level, one CTA per image
// (blockIdx.y) with the pyramid in shared memory.
template <typename T>
struct Pyramid {
  Level<T> lv[RESIDENT_LEVELS];
  int n;
};

// One damped-Jacobi sweep over a whole level in shared memory.
template <typename T>
__device__ __forceinline__ void sweep_plane(const T* aw, const T* an,
                                            const T* di, const T* rhs,
                                            const T* src, T* dst, int ny,
                                            int nx, T w, T omw) {
  auto v = [&](int k) { return src[k]; };
  const int n = ny * nx;
  for (int c = threadIdx.x; c < n; c += BOT_THREADS) {
    const int i = c / nx, j = c - i * nx;
    const T nb = nbsum(aw, an, v, c, i, j, ny, nx);
    dst[c] = omw * src[c] + (rhs[c] + nb) * (w * di[c]);
  }
  __syncthreads();
}

// Shared memory: per level k, a_w, a_n, diag_inv, right-hand side and e
// (5 planes of level k), then one ping-pong plane of level 0's size.
template <typename T>
__global__ void __launch_bounds__(BOT_THREADS, 1)
bottom_kernel(Pyramid<T> py, const T* __restrict__ r, T* __restrict__ z,
              Sweeps<T> ws, T over, int iters, const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Level<T> slv[RESIDENT_LEVELS];
  __shared__ int base[RESIDENT_LEVELS + 1];
  __shared__ T sw[MAX_NU], somw[MAX_NU];
  if (gated_off(flag)) return;
  if (threadIdx.x == 0) atomicAdd(&g_image_cycles, 1ULL);
  const int b = blockIdx.y;
  const int n = py.n, nu = ws.nu;
#pragma unroll
  for (int k = 0; k < RESIDENT_LEVELS; ++k)
    if (threadIdx.x == k && k < n) slv[k] = py.lv[k];
#pragma unroll
  for (int k = 0; k < MAX_NU; ++k)
    if (threadIdx.x == 32 + k) {
      sw[k] = ws.w[k];
      somw[k] = ws.omw[k];
    }
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0;
    for (int k = 0; k < n; ++k) {
      base[k] = o;
      o += 5 * slv[k].ny * slv[k].nx;
    }
    base[n] = o;
  }
  __syncthreads();
  T* S = reinterpret_cast<T*>(smem_raw);
  T* tmp = S + base[n];
  auto plane = [&](int k, int p) {
    return S + base[k] + p * slv[k].ny * slv[k].nx;
  };
  // planes: 0 a_w, 1 a_n, 2 diag_inv, 3 right-hand side, 4 e
  for (int k = 0; k < n; ++k) {
    const Level<T> L = slv[k];
    const int nk = L.ny * L.nx;
    const size_t off = (size_t)b * nk;
    T* aw = plane(k, 0);
    T* an = plane(k, 1);
    T* di = plane(k, 2);
    T* rh = plane(k, 3);
    for (int c = threadIdx.x; c < nk; c += BOT_THREADS) {
      aw[c] = L.aw[off + c];
      an[c] = L.an[off + c];
      di[c] = L.dinv[off + c];
      if (k == 0) rh[c] = r[off + c];
    }
  }
  __syncthreads();

  // way down: the pre-sweeps end in e (e0 starts in tmp when nu - 1 sweeps
  // follow it and nu - 1 is odd), then the residual restricted into the
  // next level's right-hand side
  for (int k = 0; k + 1 < n; ++k) {
    const int ny = slv[k].ny, nx = slv[k].nx;
    const T* aw = plane(k, 0);
    const T* an = plane(k, 1);
    const T* di = plane(k, 2);
    const T* rh = plane(k, 3);
    T* e = plane(k, 4);
    T* cur = ((nu - 1) & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    const T w0 = sw[0];
    for (int c = threadIdx.x; c < ny * nx; c += BOT_THREADS)
      cur[c] = (w0 * di[c]) * rh[c];
    __syncthreads();
    for (int s = 1; s < nu; ++s) {
      sweep_plane(aw, an, di, rh, cur, oth, ny, nx, sw[s], somw[s]);
      T* t = cur; cur = oth; oth = t;
    }
    const int nyc = slv[k + 1].ny, nxc = slv[k + 1].nx;
    T* rc = plane(k + 1, 3);
    auto ev = [&](int cc) { return e[cc]; };
    auto res = [&](int i, int j) {
      const int c = i * nx + j;
      return rh[c] - (diag_of(di[c]) * e[c] - nbsum(aw, an, ev, c, i, j, ny,
                                                     nx));
    };
    for (int cc = threadIdx.x; cc < nyc * nxc; cc += BOT_THREADS) {
      const int I = cc / nxc, J = cc - I * nxc;
      T out = T(0);
      if (2 * I < ny && 2 * J < nx) {
        const int i = 2 * I, j = 2 * J;
        out = (res(i, j) + res(i + 1, j)) +
              (res(i, j + 1) + res(i + 1, j + 1));
      }
      rc[cc] = out;
    }
    __syncthreads();
  }

  // coarsest level: iters sweeps at the last weight from zero, ending in e
  {
    const int k = n - 1;
    const int ny = slv[k].ny, nx = slv[k].nx;
    T* e = plane(k, 4);
    T* cur = (iters & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    for (int c = threadIdx.x; c < ny * nx; c += BOT_THREADS) cur[c] = T(0);
    __syncthreads();
    for (int s = 0; s < iters; ++s) {
      sweep_plane(plane(k, 0), plane(k, 1), plane(k, 2), plane(k, 3), cur,
                  oth, ny, nx, sw[nu - 1], somw[nu - 1]);
      T* t = cur; cur = oth; oth = t;
    }
  }

  // way up: src = e + over P e_c (in tmp when nu is odd), the post-sweeps
  // in reverse weight order, ending in e
  for (int k = n - 2; k >= 0; --k) {
    const int ny = slv[k].ny, nx = slv[k].nx, nxc = slv[k + 1].nx;
    T* e = plane(k, 4);
    const T* ec = plane(k + 1, 4);
    T* cur = (nu & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    for (int c = threadIdx.x; c < ny * nx; c += BOT_THREADS) {
      const int i = c / nx, j = c - i * nx;
      cur[c] = e[c] + over * ec[(i >> 1) * nxc + (j >> 1)];
    }
    __syncthreads();
    for (int s = 1; s <= nu; ++s) {
      sweep_plane(plane(k, 0), plane(k, 1), plane(k, 2), plane(k, 3), cur,
                  oth, ny, nx, sw[nu - s], somw[nu - s]);
      T* t = cur; cur = oth; oth = t;
    }
  }

  const T* e0 = plane(0, 4);
  const int n0 = slv[0].ny * slv[0].nx;
  for (int c = threadIdx.x; c < n0; c += BOT_THREADS)
    z[(size_t)b * n0 + c] = e0[c];
}

// Coarsest level from global memory (when it does not fit one CTA): `iters`
// damped-Jacobi sweeps at w from e = 0, one block per image (blockIdx.y),
// ping-ponging between `other` and `out` so that the last sweep lands in
// `out`.
template <typename T>
__global__ void coarse_solve_kernel(Level<T> lv, const T* __restrict__ rhs,
                                    T* out, T* other, T w, T omw, int iters,
                                    const int* flag) {
  if (gated_off(flag)) return;
  if (threadIdx.x == 0) atomicAdd(&g_image_cycles, 1ULL);
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

// ---- launches

template <typename T>
cudaError_t launch_bottom(int B, int n, const Level<T>* lv, const T* r, T* z,
                          const Sweeps<T>& sw, T over, int iters,
                          const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  if (n < 1 || n > RESIDENT_LEVELS) return cudaErrorInvalidValue;
  Pyramid<T> p{};
  p.n = n;
  long long cells = (long long)lv[0].ny * lv[0].nx;
  for (int k = 0; k < n; ++k) {
    p.lv[k] = lv[k];
    cells += 5LL * lv[k].ny * lv[k].nx;
  }
  const size_t sm = sizeof(T) * cells;
  if ((long long)sm > RESIDENT_SMEM) return cudaErrorInvalidValue;
  auto kern = bottom_kernel<T>;
  DEFF_TRY(allow_smem(kern, (size_t)RESIDENT_SMEM, &done));
  DEFF_LAUNCH(kern<<<dim3(1, B), BOT_THREADS, sm, st>>>(p, r, z, sw, over,
                                                        iters, flag));
  return cudaSuccess;
}

}  // namespace

template <typename T>
cudaError_t cycle_from(int B, int L, const Level<T>* lv, int l0, const T* r,
                       T* z, T* scratch, const double* ws, int nu,
                       int coarse_iters, double over, const int* flag,
                       cudaStream_t st) {
  if (L < 1 || L > MAX_LEVELS || l0 < 0 || l0 >= L || nu < 1 ||
      nu > MAX_NU || coarse_iters < 0 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  ++g_cycles;
  T* R[MAX_LEVELS];
  T* E[MAX_LEVELS];
  T* P[MAX_LEVELS];
  int ny[MAX_LEVELS], nx[MAX_LEVELS];
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    ny[l] = lv[l].ny;
    nx[l] = lv[l].nx;
    const long long n = (long long)B * ny[l] * nx[l];
    R[l] = nullptr;
    if (l > 0) { R[l] = scratch + off; off += n; }
    E[l] = scratch + off; off += n;
    P[l] = scratch + off; off += n;
  }
  int lb = cycle_resident_from(L, ny, nx, (int)sizeof(T));
  if (lb < l0) lb = l0;
  const Sweeps<T> sw = make_sweeps<T>(ws, nu);
  const T tover = (T)over;
  // level l's right-hand side and the plane that receives its correction
  auto rhs = [&](int l) -> const T* { return l == l0 ? r : R[l]; };
  auto cor = [&](int l) -> T* { return l == l0 ? z : P[l]; };

  const int top = lb < L ? lb : L - 1;   // the first level not in passes
  for (int l = l0; l < top; ++l)
    DEFF_TRY(with_nu(nu, [&](auto k) {
      return launch_down<T, decltype(k)::value, K2Level>(
          B, lv[l], rhs(l), E[l], R[l + 1], ny[l + 1], nx[l + 1], sw, flag,
          st);
    }));
  if (lb < L) {
    DEFF_TRY(launch_bottom<T>(B, L - lb, lv + lb, rhs(lb), cor(lb), sw, tover,
                              coarse_iters, flag, st));
  } else {
    const int lc = L - 1;
    DEFF_LAUNCH(coarse_solve_kernel<T><<<dim3(1, B), THREADS, 0, st>>>(
        lv[lc], rhs(lc), cor(lc), E[lc], sw.w[nu - 1], sw.omw[nu - 1],
        coarse_iters, flag));
  }
  for (int l = top - 1; l >= l0; --l)
    DEFF_TRY(with_nu(nu, [&](auto k) {
      return launch_up<T, decltype(k)::value, K2Level>(
          B, lv[l], E[l], cor(l + 1), ny[l + 1], nx[l + 1], tover, rhs(l),
          cor(l), sw, flag, st);
    }));
  return cudaSuccess;
}

template cudaError_t cycle_from<float>(int, int, const Level<float>*, int,
                                       const float*, float*, float*,
                                       const double*, int, int, double,
                                       const int*, cudaStream_t);
template cudaError_t cycle_from<double>(int, int, const Level<double>*, int,
                                        const double*, double*, double*,
                                        const double*, int, int, double,
                                        const int*, cudaStream_t);

}  // namespace deff

namespace {

template <typename T>
int v_cycle_entry(int B, int L, const int* ny, const int* nx,
                  const void* const* aw, const void* const* an,
                  const void* const* dinv, const void* r, void* z,
                  void* scratch, const double* ws, int nu, int coarse_iters,
                  double over, const int* flag, void* stream) {
  deff::Level<T> lv[deff::MAX_LEVELS];
  if (!deff::fill_levels<T>(L, ny, nx, aw, an, dinv, lv))
    return cudaErrorInvalidValue;
  return deff::run_cycle<T>(B, L, lv, static_cast<const T*>(r),
                            static_cast<T*>(z), static_cast<T*>(scratch), ws,
                            nu, coarse_iters, over, flag,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

long long deff_cycle_scratch_elems(int L, const int* ny, const int* nx) {
  return deff::cycle_scratch_elems(L, ny, nx);
}

int deff_cycle_resident_from(int L, const int* ny, const int* nx,
                             int itemsize) {
  if (L < 1 || L > deff::MAX_LEVELS) return -1;
  return deff::cycle_resident_from(L, ny, nx, itemsize);
}

long long deff_launch_count() { return deff::g_launches; }

long long deff_cycle_count() { return deff::g_cycles; }

// Iterations launched by the K1, K5 and K7 windows (window.cuh).
long long deff_window_iter_count() { return deff::g_window_iters; }

// The device count of image cycles (see g_image_cycles) on the current
// device; synchronises with it.  -1 if the read fails.
long long deff_image_cycle_count() {
  unsigned long long v = 0;
  if (cudaMemcpyFromSymbol(&v, deff::g_image_cycles, sizeof(v)) !=
      cudaSuccess)
    return -1;
  return (long long)v;
}

int deff_v_cycle_f32(int B, int L, const int* ny, const int* nx,
                     const void* const* aw, const void* const* an,
                     const void* const* dinv, const void* r, void* z,
                     void* scratch, const double* ws, int nu,
                     int coarse_iters, double over, const int* flag,
                     void* stream) {
  return v_cycle_entry<float>(B, L, ny, nx, aw, an, dinv, r, z, scratch, ws,
                              nu, coarse_iters, over, flag, stream);
}

int deff_v_cycle_f64(int B, int L, const int* ny, const int* nx,
                     const void* const* aw, const void* const* an,
                     const void* const* dinv, const void* r, void* z,
                     void* scratch, const double* ws, int nu,
                     int coarse_iters, double over, const int* flag,
                     void* stream) {
  return v_cycle_entry<double>(B, L, ny, nx, aw, an, dinv, r, z, scratch, ws,
                               nu, coarse_iters, over, flag, stream);
}

}  // extern "C"
