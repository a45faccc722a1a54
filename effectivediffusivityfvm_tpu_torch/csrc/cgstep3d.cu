// K7: up to k multigrid-preconditioned CG iterations per volume on the
// banded 3D engine, each iteration three passes over level 0 with the
// per-volume scalars computed on the device between them, as one host loop
// of batch-wide launches on one stream (no host synchronisation inside the
// window).  No refresh: the solver refreshes through K6 between windows.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/cgstep3d.py
// (cg_steps3d_tiled: _pass_a3, _pass_b3, _pass_c3).  Per iteration, for
// every live volume:
//   A  beta = rz/rz_prev (0 on the first iteration or if rz_prev <= 0);
//      p = z + beta p_old (recomputed at the 7 stencil points), q = A p,
//      partials of <p, q>;
//   .  alpha = rz/<p,q> (0 unless <p,q> > 0);
//   B  x += alpha p; r -= alpha q with q recomputed from p, partials of
//      sum|r|; then T1 (vcycle3d.cuh's down leg) on the new r;
//   .  the coarse tail: K6's whole cycle on levels[1:];
//   C  T2 (the up leg) gives z, pinned to 0 where D == 0 when matrix-free,
//      with the partials of <r, z> in its last sweep;
//   .  rz_prev = rz, rz = <r, z>, k_done += 1, live &= stop < sum|r| < hi.
// On entry z = p, live = active > 0 & stop < sum|r_in| < hi; when
// matrix-free, x, r and p are first multiplied by (D > 0), as the TPU
// kernel does for every volume.  Level 0's coefficients are the stored
// volumes or, matrix-free, rebuilt from D at every use (vcycle3d.cuh's
// FromD3), term for term as the TPU kernel's _coeffs_from_dwin.
//
// On the TPU the passes read p_old and wrote p slab by slab in order; here
// blocks run in parallel and read their neighbours, so p alternates
// between the caller's volume and a scratch volume, volume by volume
// (`par`), and goes back to the caller's volume at the end.  x and r are
// read only at their own cell by the pass that writes them, so they are
// updated in place.  A frozen or retired volume's blocks return at once,
// which also keeps its z.  Reductions: per-block partials in double, summed
// in a fixed order by one block per volume (cgscalars.cuh, shared with K5).
//
// Bounds on an H100: memory bandwidth.  Stored level 0, fp32, per
// iteration at nu = 2 the passes move about 42 volumes (A: z, p_old and four
// coefficient volumes in, p out; the x/r update: x, p, r and the
// coefficients in, x and r out; T1: two sweeps' worth and the restriction;
// T2: two sweeps), plus the coarse tail on levels[1:] (~1/7 of a cycle).
// Matrix-free, the four coefficient volumes of every pass become one D
// volume, at the cost of rebuilding them (divisions) at every stencil
// point.
#include "cgscalars.cuh"
#include "vcycle3d.cuh"

namespace deff {
namespace {

// Per-block partials of sum|r| over the volume.
template <typename T>
__global__ void abs_parts3_kernel(const T* __restrict__ r, int n,
                                  double* part, int nblk) {
  __shared__ double sh[THREADS];
  const size_t off = (size_t)blockIdx.y * n;
  double acc = 0.0;
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    const T v = r[off + c];
    acc += (double)(v < T(0) ? -v : v);
  }
  const double s = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) part[(size_t)blockIdx.y * nblk + blockIdx.x] = s;
}

// Pass A: p = z + beta p_old, q = A p, partials of <p, q>.
template <typename T, typename C>
__global__ void pass_a3_kernel(C co, Dims3 dm, T* p0, T* p1, const T* zbuf,
                               int first, CgState<T> s) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const int n = dm.cells();
  const size_t off = (size_t)b * n;
  const int par = s.par[b];
  const T* pold = par ? p1 : p0;
  T* pnew = par ? p0 : p1;
  const T* z = first ? pold : zbuf;
  const T rzp = s.rz_prev[b], rzc = s.rz[b];
  const T beta = (!first && rzp > T(0)) ? rzc / rzp : T(0);
  auto pv = [&](size_t g) { return z[g] + beta * pold[g]; };
  double acc = 0.0;
  for (int kk = 0; kk < CPT; ++kk) {
    const int c = blockIdx.x * TILE + kk * THREADS + threadIdx.x;
    if (c >= n) break;
    const size_t g = off + c;
    const Cell q = cell_of(c, dm);
    const T pc = pv(g);
    const T qv = diag_of(co.di(g, q, dm)) * pc - nbsum3<T>(co, pv, g, q, dm);
    pnew[g] = pc;
    const T prod = pc * qv;
    acc += (double)prod;
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_a[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// Pass B's update: x += alpha p, r -= alpha q (in place), partials of
// sum|r|.
template <typename T, typename C>
__global__ void update_xr3_kernel(C co, Dims3 dm, T* __restrict__ x,
                                  const T* p0, const T* p1, T* __restrict__ r,
                                  CgState<T> s) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const int n = dm.cells();
  const size_t off = (size_t)b * n;
  const T* p = s.par[b] ? p0 : p1;
  const T alpha = s.alpha[b];
  auto pv = [&](size_t g) { return p[g]; };
  double acc = 0.0;
  for (int kk = 0; kk < CPT; ++kk) {
    const int c = blockIdx.x * TILE + kk * THREADS + threadIdx.x;
    if (c >= n) break;
    const size_t g = off + c;
    const Cell q = cell_of(c, dm);
    const T qv = diag_of(co.di(g, q, dm)) * p[g] - nbsum3<T>(co, pv, g, q, dm);
    x[g] = x[g] + alpha * p[g];
    const T rv = r[g] - alpha * qv;
    r[g] = rv;
    acc += (double)(rv < T(0) ? -rv : rv);
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_b[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// Scratch per volume, in elements of `elem_bytes` (4 or 8): the three
// double partial arrays first (8-byte aligned at the start), then z, the
// second p, e, a spare volume, the coarse residual, e_c, the coarse tail's
// scratch, and three scalars (rz_prev, alpha, spare).
long long cg3d_scratch_elems(int L, const int* nz, const int* ny,
                             const int* nx, int elem_bytes) {
  if (L < 2) return 0;
  const long long n0 = (long long)nz[0] * ny[0] * nx[0];
  const long long n1 = (long long)nz[1] * ny[1] * nx[1];
  return 3LL * blocks_for(n0) * (8 / elem_bytes) + 4 * n0 + 2 * n1 +
         cycle3_scratch_elems(L - 1, nz + 1, ny + 1, nx + 1) + 3;
}

// The k-iteration window for level-0 coefficients `co` (Stored3 or FromD3).
template <typename T, typename C>
cudaError_t run_window(int B, int L, const Level3<T>* lv, const C& co,
                       const T* d, T* x, T* r0, T* p0, CgState<T> s,
                       T* zbuf, T* p1, T* e, T* spare, T* rc, T* ec, T* cyc,
                       const T* active, int k, const double* ws, int nu,
                       int coarse_iters, double over, cudaStream_t st) {
  const Dims3 d0 = lv[0].dm, d1 = lv[1].dm;
  const int n0 = d0.cells();
  const dim3 blocks(blocks_for(n0), B), per_image(1, B);
  if (d != nullptr) {
    const long long n = (long long)B * n0;
    const int nb = (int)((n + THREADS - 1) / THREADS < 65536
                             ? (n + THREADS - 1) / THREADS : 65536);
    DEFF_LAUNCH(pin_kernel<T><<<nb, THREADS, 0, st>>>(d, x, r0, p0, n));
  }
  DEFF_LAUNCH(abs_parts3_kernel<T><<<blocks, THREADS, 0, st>>>(
      r0, n0, s.part_b, s.ntiles));
  DEFF_LAUNCH(fin_init_kernel<T><<<per_image, THREADS, 0, st>>>(s, active));
  const DotOut<T> dot{d, s.part_c, s.ntiles};
  cudaError_t err;
  for (int i = 0; i < k; ++i) {
    DEFF_LAUNCH(pass_a3_kernel<T, C><<<blocks, THREADS, 0, st>>>(
        co, d0, p0, p1, zbuf, i == 0 ? 1 : 0, s));
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, THREADS, 0, st>>>(s));
    DEFF_LAUNCH(update_xr3_kernel<T, C><<<blocks, THREADS, 0, st>>>(
        co, d0, x, p0, p1, r0, s));
    err = down3<T>(B, co, d0, r0, e, spare, rc, d1, ws, nu, s.live, st);
    if (err != cudaSuccess) return err;
    err = run_cycle3<T>(B, L - 1, lv + 1, rc, ec, cyc, ws, nu, coarse_iters,
                        over, s.live, st);
    if (err != cudaSuccess) return err;
    err = up3<T>(B, co, d0, e, ec, d1, (T)over, r0, zbuf, spare, ws, nu, dot,
                 s.live, st, nullptr);
    if (err != cudaSuccess) return err;
    DEFF_LAUNCH(fin_live_kernel<T><<<per_image, THREADS, 0, st>>>(s));
  }
  DEFF_LAUNCH(copy_back_kernel<T><<<blocks, THREADS, 0, st>>>(
      nullptr, nullptr, p0, p1, n0, s.par));
  return cudaSuccess;
}

template <typename T>
int cg3d_entry(int B, int L, const int* nz, const int* ny, const int* nx,
               const void* const* aw, const void* const* an,
               const void* const* au, const void* const* dinv, const void* d_,
               double fx, double fy, double fz, double bcf, int nxr, void* x_,
               void* r_, void* p_, void* rz_, const void* active_,
               const void* stop_, const void* hi_, int k, void* k_done_,
               const double* ws, int nu, int coarse_iters, double over,
               void* scratch_, void* iscratch_, void* stream) {
  Level3<T> lv[MAX_LEVELS];
  if (!fill_levels3<T>(L, nz, ny, nx, aw, an, au, dinv, lv) || L < 2 ||
      B < 1 || k < 0 || nu < 1 || nu > 3)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n0 = lv[0].dm.cells(), n1 = lv[1].dm.cells();
  const int nt = blocks_for(n0);
  CgState<T> s{};
  s.part_a = static_cast<double*>(scratch_);
  s.part_b = s.part_a + (size_t)B * nt;
  s.part_c = s.part_b + (size_t)B * nt;
  T* zbuf = reinterpret_cast<T*>(s.part_c + (size_t)B * nt);
  T* p1 = zbuf + (size_t)B * n0;
  T* e = p1 + (size_t)B * n0;
  T* spare = e + (size_t)B * n0;
  T* rc = spare + (size_t)B * n0;
  T* ec = rc + (size_t)B * n1;
  T* cyc = ec + (size_t)B * n1;
  s.rz_prev = cyc + (size_t)B * cycle3_scratch_elems(L - 1, nz + 1, ny + 1,
                                                     nx + 1);
  s.alpha = s.rz_prev + B;
  s.rz = static_cast<T*>(rz_);
  s.stop = static_cast<const T*>(stop_);
  s.hi = static_cast<const T*>(hi_);
  s.live = static_cast<int*>(iscratch_);
  s.par = s.live + B;
  s.k_done = static_cast<int*>(k_done_);
  s.ntiles = nt;
  const T* d = static_cast<const T*>(d_);
  T* x = static_cast<T*>(x_);
  T* r = static_cast<T*>(r_);
  T* p = static_cast<T*>(p_);
  const T* active = static_cast<const T*>(active_);
  if (d == nullptr)
    return run_window<T>(B, L, lv, lv[0].co, d, x, r, p, s, zbuf, p1, e,
                         spare, rc, ec, cyc, active, k, ws, nu, coarse_iters,
                         over, st);
  const FromD3<T> co{d, (T)fx, (T)fy, (T)fz, (T)bcf, nxr, lv[0].dm.nx,
                     lv[0].dm.plane()};
  return run_window<T>(B, L, lv, co, d, x, r, p, s, zbuf, p1, e, spare, rc,
                       ec, cyc, active, k, ws, nu, coarse_iters, over, st);
}

}  // namespace
}  // namespace deff

extern "C" {

long long deff_cg3d_scratch_elems(int L, const int* nz, const int* ny,
                                  const int* nx, int elem_bytes) {
  return deff::cg3d_scratch_elems(L, nz, ny, nx, elem_bytes);
}

#define DEFF_CG3D_ENTRY(NAME, T)                                              \
  int NAME(int B, int L, const int* nz, const int* ny, const int* nx,         \
           const void* const* aw, const void* const* an,                      \
           const void* const* au, const void* const* dinv, const void* d,     \
           double fx, double fy, double fz, double bcf, int nxr, void* x,     \
           void* r, void* p, void* rz, const void* active, const void* stop,  \
           const void* hi, int k, void* k_done, const double* ws, int nu,     \
           int coarse_iters, double over, void* scratch, void* iscratch,      \
           void* stream) {                                                    \
    return deff::cg3d_entry<T>(B, L, nz, ny, nx, aw, an, au, dinv, d, fx, fy, \
                               fz, bcf, nxr, x, r, p, rz, active, stop, hi,   \
                               k, k_done, ws, nu, coarse_iters, over,         \
                               scratch, iscratch, stream);                    \
  }

DEFF_CG3D_ENTRY(deff_cg_steps3d_f32, float)
DEFF_CG3D_ENTRY(deff_cg_steps3d_f64, double)

}  // extern "C"
