// K1: up to k multigrid-preconditioned CG iterations per image, then the
// true-residual refresh and restart, as one host loop of batch-wide
// launches on one stream (no host synchronisation inside the window).
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/cgstep_vmem.py
// (cg_steps_pallas(refresh=True) / _kernel).  The TPU kernel kept one
// image's CG state and pyramid resident in VMEM for a whole window; on
// Hopper an image's state (~14 MiB at 512^2 fp32) does not fit an SM, so
// each CG step is a batch-wide pass with blockIdx = (tile of cells, image).
//
// What bounds it on an H100: memory bandwidth.  Per iteration, outside the
// V-cycle (vcycle.cuh): q = A p reads p, a_w, a_n, diag_inv and writes q
// (20 B/cell fp32); the x/r update reads x, r, p, q and writes x, r
// (24 B/cell); <r,z> and sum|r| read r, z (8 B/cell); p = z + beta p
// (12 B/cell).  The reductions ride inside those passes: every block writes
// one partial per image, and a one-block-per-image finalize kernel sums the
// partials in a fixed order (no float atomics, so iteration counts do not
// change from run to run) and computes alpha, beta, rz and the image's
// live flag on the device.  Products are formed in T, but dot products and
// sum|r| accumulate in double and are rounded to T once: over 262k cells an
// fp32 sum carries ~1e-5 relative error whose order-dependence CG amplifies
// from iteration to iteration, while the double sum rounds to the same T
// value as any other accurate summation (the plain version sums in double
// too).  The cost is register and shared-memory width only; the passes stay
// bandwidth-bound.
//
// Per-image control: `live` is i < k && stop < sum|r| < hi, recomputed on
// the device after every iteration; every pass of an image whose flag is 0
// returns at once, so an image that exited early, or a frozen one
// (active <= 0), moves no data.  The p update is gated on the flag as it
// was at the start of the iteration (`pflag`), since the finalize kernel
// that computes beta also retires the image.
#include "vcycle.cuh"

namespace deff {
namespace {

__device__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

// Fixed-order sum of one image's per-block partials.
__device__ double sum_parts(const double* part, int nblk, double* sh) {
  double acc = 0.0;
  for (int j = threadIdx.x; j < nblk; j += THREADS) acc += part[j];
  return block_sum(acc, sh);
}

template <typename T>
__global__ void set_act_kernel(const T* active, int* act, int* it, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  act[b] = active[b] > T(0) ? 1 : 0;
  it[b] = 0;
}

// q = A p (diag rebuilt as 1/diag_inv) and per-block partials of <p, q>.
template <typename T>
__global__ void matvec_dot_kernel(Level<T> lv, const T* __restrict__ p,
                                  T* __restrict__ q, double* part, int nblk,
                                  const int* flag) {
  __shared__ double sh[THREADS];
  if (gated_off(flag)) return;
  const int n = lv.ny * lv.nx;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* pb = p + off;
  auto v = [&](int cc) { return pb[cc]; };
  double acc = 0.0;
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    const int i = c / lv.nx, j = c - i * lv.nx;
    const T qc = diag_of(di[c]) * pb[c] - nbsum(aw, an, v, c, i, j, lv.ny, lv.nx);
    q[off + c] = qc;
    const T prod = pb[c] * qc;
    acc += (double)prod;
  }
  const double s = block_sum(acc, sh);
  if (threadIdx.x == 0) part[(size_t)blockIdx.y * nblk + blockIdx.x] = s;
}

// r = b - A x.
template <typename T>
__global__ void resid_kernel(Level<T> lv, const T* __restrict__ rhs,
                             const T* __restrict__ x, T* __restrict__ r,
                             const int* flag) {
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
    r[off + c] = rhs[off + c] -
        (diag_of(di[c]) * xb[c] - nbsum(aw, an, v, c, i, j, lv.ny, lv.nx));
  }
}

// x += alpha p, r -= alpha q.
template <typename T>
__global__ void axpy_kernel(T* __restrict__ x, T* __restrict__ r,
                            const T* __restrict__ p, const T* __restrict__ q,
                            const T* alpha, int n, const int* flag) {
  if (gated_off(flag)) return;
  const size_t off = (size_t)blockIdx.y * n;
  const T a = alpha[blockIdx.y];
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    x[off + c] = x[off + c] + a * p[off + c];
    r[off + c] = r[off + c] - a * q[off + c];
  }
}

// Per-block partials of <r, z> (skipped when z is null) and sum|r|.
template <typename T>
__global__ void dots_kernel(const T* __restrict__ r, const T* __restrict__ z,
                            double* part_rz, double* part_abs, int n,
                            int nblk, const int* flag) {
  __shared__ double sh[THREADS];
  if (gated_off(flag)) return;
  const size_t off = (size_t)blockIdx.y * n;
  double arz = 0.0, aab = 0.0;
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    const T rc = r[off + c];
    if (z != nullptr) {
      const T prod = rc * z[off + c];
      arz += (double)prod;
    }
    aab += (double)(rc < T(0) ? -rc : rc);
  }
  const size_t slot = (size_t)blockIdx.y * nblk + blockIdx.x;
  if (z != nullptr) {
    const double s = block_sum(arz, sh);
    if (threadIdx.x == 0) part_rz[slot] = s;
  }
  const double s = block_sum(aab, sh);
  if (threadIdx.x == 0) part_abs[slot] = s;
}

// p = z + beta p.
template <typename T>
__global__ void pupdate_kernel(T* __restrict__ p, const T* __restrict__ z,
                               const T* beta, int n, const int* flag) {
  if (gated_off(flag)) return;
  const size_t off = (size_t)blockIdx.y * n;
  const T bt = beta[blockIdx.y];
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    p[off + c] = z[off + c] + bt * p[off + c];
  }
}

// ---- per-image finalize kernels: grid (1, B), one block per image ----

template <typename T>
__global__ void fin_init_kernel(const double* part_abs, int nblk,
                                const int* act, int* live, const T* stop,
                                const T* hi, int k) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!act[b]) {
    if (threadIdx.x == 0) live[b] = 0;
    return;
  }
  const T sr = (T)sum_parts(part_abs + (size_t)b * nblk, nblk, sh);
  if (threadIdx.x == 0) live[b] = (0 < k && sr > stop[b] && sr < hi[b]);
}

template <typename T>
__global__ void fin_alpha_kernel(const double* part, int nblk, const T* rz,
                                 T* alpha, const int* live) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!live[b]) return;
  const T pap = (T)sum_parts(part + (size_t)b * nblk, nblk, sh);
  if (threadIdx.x == 0) alpha[b] = pap > T(0) ? rz[b] / pap : T(0);
}

template <typename T>
__global__ void fin_beta_kernel(const double* part_rz, const double* part_abs,
                                int nblk, T* rz, T* beta, int* it, int* live,
                                int* pflag, const T* stop, const T* hi,
                                int k) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!live[b]) {
    if (threadIdx.x == 0) pflag[b] = 0;
    return;
  }
  const T rzn = (T)sum_parts(part_rz + (size_t)b * nblk, nblk, sh);
  const T sr = (T)sum_parts(part_abs + (size_t)b * nblk, nblk, sh);
  if (threadIdx.x == 0) {
    const T rzo = rz[b];
    beta[b] = rzo > T(0) ? rzn / rzo : T(0);
    rz[b] = rzn;
    const int i = it[b] + 1;
    it[b] = i;
    live[b] = (i < k && sr > stop[b] && sr < hi[b]);
    pflag[b] = 1;
  }
}

template <typename T>
__global__ void fin_refresh_kernel(const double* part_rz,
                                   const double* part_abs, int nblk,
                                   const int* act, const int* it, T* rz,
                                   T* sr_true, int* k_done) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!act[b]) {
    if (threadIdx.x == 0) { sr_true[b] = T(0); k_done[b] = 0; }
    return;
  }
  const T rzv = (T)sum_parts(part_rz + (size_t)b * nblk, nblk, sh);
  const T sr = (T)sum_parts(part_abs + (size_t)b * nblk, nblk, sh);
  if (threadIdx.x == 0) {
    rz[b] = rzv;
    sr_true[b] = sr;
    k_done[b] = it[b];
  }
}

// Scratch per image in elements of `elem_bytes` (4 or 8): the double
// partials of <.,.> and sum|r| first (8-byte aligned at the start), then
// q, z, the cycle's scratch, alpha and beta.
long long cg_scratch_elems(int L, const int* ny, const int* nx,
                           int elem_bytes) {
  const long long n0 = (long long)ny[0] * nx[0];
  return 2LL * blocks_for(n0) * (8 / elem_bytes) + 2 * n0 +
         cycle_scratch_elems(L, ny, nx) + 2;
}

template <typename T>
int cg_steps_entry(int B, int L, const int* ny, const int* nx,
                   const void* const* aw, const void* const* an,
                   const void* const* dinv, const void* b_, void* x_,
                   void* r_, void* p_, void* rz_, const void* active_,
                   const void* stop_, const void* hi_, int k, void* k_done_,
                   void* sr_true_, const double* ws, int nu, int coarse_iters,
                   double over, void* scratch_, void* iscratch_,
                   void* stream) {
  Level<T> lv[MAX_LEVELS];
  if (!fill_levels<T>(L, ny, nx, aw, an, dinv, lv) || B < 1 || k < 0)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* rhs = static_cast<const T*>(b_);
  T* x = static_cast<T*>(x_);
  T* r = static_cast<T*>(r_);
  T* p = static_cast<T*>(p_);
  T* rz = static_cast<T*>(rz_);
  const T* active = static_cast<const T*>(active_);
  const T* stop = static_cast<const T*>(stop_);
  const T* hi = static_cast<const T*>(hi_);

  const int n0 = ny[0] * nx[0];
  const int nblk = blocks_for(n0);
  double* part_rz = static_cast<double*>(scratch_);
  double* part_abs = part_rz + (size_t)B * nblk;
  T* q = reinterpret_cast<T*>(part_abs + (size_t)B * nblk);
  T* z = q + (size_t)B * n0;
  T* cyc = z + (size_t)B * n0;
  T* alpha = cyc + (size_t)B * cycle_scratch_elems(L, ny, nx);
  T* beta = alpha + B;
  int* act = static_cast<int*>(iscratch_);
  int* live = act + B;
  int* pflag = live + B;
  int* it = pflag + B;

  const dim3 blk(THREADS), cells(nblk, B), per_image(1, B);
  DEFF_LAUNCH(set_act_kernel<T><<<(B + THREADS - 1) / THREADS, blk, 0, st>>>(
      active, act, it, B));
  DEFF_LAUNCH(dots_kernel<T><<<cells, blk, 0, st>>>(
      r, nullptr, part_rz, part_abs, n0, nblk, act));
  DEFF_LAUNCH(fin_init_kernel<T><<<per_image, blk, 0, st>>>(
      part_abs, nblk, act, live, stop, hi, k));

  for (int i = 0; i < k; ++i) {
    DEFF_LAUNCH(matvec_dot_kernel<T><<<cells, blk, 0, st>>>(
        lv[0], p, q, part_rz, nblk, live));
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, blk, 0, st>>>(
        part_rz, nblk, rz, alpha, live));
    DEFF_LAUNCH(axpy_kernel<T><<<cells, blk, 0, st>>>(
        x, r, p, q, alpha, n0, live));
    cudaError_t e = run_cycle<T>(B, L, lv, r, z, cyc, ws, nu, coarse_iters,
                                 over, live, st);
    if (e != cudaSuccess) return e;
    DEFF_LAUNCH(dots_kernel<T><<<cells, blk, 0, st>>>(
        r, z, part_rz, part_abs, n0, nblk, live));
    DEFF_LAUNCH(fin_beta_kernel<T><<<per_image, blk, 0, st>>>(
        part_rz, part_abs, nblk, rz, beta, it, live, pflag, stop, hi, k));
    DEFF_LAUNCH(pupdate_kernel<T><<<cells, blk, 0, st>>>(
        p, z, beta, n0, pflag));
  }

  // refresh + restart for every active image: r = b - A x, p = z = M r
  DEFF_LAUNCH(resid_kernel<T><<<cells, blk, 0, st>>>(lv[0], rhs, x, r, act));
  cudaError_t e = run_cycle<T>(B, L, lv, r, p, cyc, ws, nu, coarse_iters,
                               over, act, st);
  if (e != cudaSuccess) return e;
  DEFF_LAUNCH(dots_kernel<T><<<cells, blk, 0, st>>>(
      r, p, part_rz, part_abs, n0, nblk, act));
  DEFF_LAUNCH(fin_refresh_kernel<T><<<per_image, blk, 0, st>>>(
      part_rz, part_abs, nblk, act, it, rz, static_cast<T*>(sr_true_),
      static_cast<int*>(k_done_)));
  return cudaSuccess;
}

}  // namespace
}  // namespace deff

extern "C" {

long long deff_cg_scratch_elems(int L, const int* ny, const int* nx,
                                int elem_bytes) {
  return deff::cg_scratch_elems(L, ny, nx, elem_bytes);
}

#define DEFF_CG_ENTRY(NAME, T)                                               \
  int NAME(int B, int L, const int* ny, const int* nx, const void* const* aw, \
           const void* const* an, const void* const* dinv, const void* b,     \
           void* x, void* r, void* p, void* rz, const void* active,           \
           const void* stop, const void* hi, int k, void* k_done,             \
           void* sr_true, const double* ws, int nu, int coarse_iters,         \
           double over, void* scratch, void* iscratch, void* stream) {        \
    return deff::cg_steps_entry<T>(B, L, ny, nx, aw, an, dinv, b, x, r, p,   \
                                   rz, active, stop, hi, k, k_done, sr_true,  \
                                   ws, nu, coarse_iters, over, scratch,       \
                                   iscratch, stream);                         \
  }

DEFF_CG_ENTRY(deff_cg_steps_f32, float)
DEFF_CG_ENTRY(deff_cg_steps_f64, double)

}  // extern "C"
