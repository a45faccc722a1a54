// K5: up to k multigrid-preconditioned CG iterations per image for fine
// grids past the whole-cycle engine's size, each iteration three tiled
// passes over level 0 with per-image scalars computed on the device between
// them, as one host loop of batch-wide launches on one stream (no host
// synchronisation inside the window).  No refresh: the solver refreshes
// through K4 between windows.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/cgstep_tiled.py
// (cg_steps_tiled: _pass_a, _pass_b, _pass_c, _coeffs_from_dwin2).  Per
// iteration, for every live image:
//   A  beta = rz/rz_prev (0 on the first iteration or if rz_prev <= 0);
//      p = z + beta p_old on the window, q = A p, partials of <p, q>;
//   .  alpha = rz/<p,q> (0 unless <p,q> > 0);
//   B  x += alpha p; r -= alpha q with q recomputed from p on the window;
//      T1 (tiled.cuh) on the new r; partials of sum|r|;
//   .  the coarse tail: K2's level kernels on levels[1:] (vcycle.cuh);
//   C  T2 gives z (pinned to 0 where D == 0 when matrix-free); partials of
//      <r, z>;
//   .  rz_prev = rz, rz = <r, z>, k_done += 1, live &= stop < sum|r| < hi.
// On entry z = p, live = active > 0 & stop < sum|r_in| < hi; when
// matrix-free, x, r and p are first multiplied by (D > 0), as the TPU
// kernel does for every image.
//
// The TPU passes read p_old, r_old and wrote p, r over the same arrays
// band by band in order; blocks here run in parallel and read their
// neighbours' halos, so p and r alternate between the caller's plane and a
// scratch plane, image by image (`par`), and the last copies go back to the
// caller's planes at the end.  A frozen or retired image's blocks return at
// once.  Reductions: per-tile partials in double, summed in a fixed order by
// one block per image, rounded to T once -- iteration counts do not change
// from run to run.
//
// Bounds on an H100: memory bandwidth.  Stored level 0, fp32, per iteration
// and cell: A reads z, p_old and 3 coefficient planes and writes p (24 B);
// B reads x, p, r and the coefficients and writes x, r, e and a quarter
// plane (37 B); C reads e, r, the coefficients and a quarter plane and
// writes z (29 B).  Matrix-free, the three coefficient planes become one D
// plane (and C reads D once more for the pin).  Halos add up to ~56% of the
// reads at nu = 2, mostly from L2.
#include "cgscalars.cuh"
#include "tiled.cuh"

namespace deff {
namespace {

// The partials' block sums (cgscalars.cuh) assume one thread per cell of a
// THREADS-wide block.
static_assert(TILE_THREADS == THREADS, "tile blocks are THREADS wide");

// Per-tile partials of sum|r| over the padded plane.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
abs_parts_kernel(const T* __restrict__ r, int py, int px, double* part,
                 int nt) {
  __shared__ double sh[TILE_THREADS];
  const Tile t = make_tile(py, px, 0);
  const T* rb = r + (size_t)blockIdx.y * py * px;
  double acc = 0.0;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int gi = t.ty0 + c / TX, gj = t.tx0 + c % TX;
    if (gi < py && gj < px) {
      const T v = rb[(size_t)gi * px + gj];
      acc += (double)(v < T(0) ? -v : v);
    }
  }
  const double s = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) part[(size_t)blockIdx.y * nt + blockIdx.x] = s;
}

// Pass A: p = z + beta p_old, q = A p, partials of <p, q>.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
pass_a_kernel(Fine<T> f, T* p0, T* p1, const T* zbuf, int first,
              CgState<T> s, int h) {
  __shared__ double sh[TILE_THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  T* S = reinterpret_cast<T*>(smem_raw);
  const Tile t = make_tile(f.py, f.px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *P = S + 3 * n, *Dw = S + 4 * n;
  const size_t off = (size_t)b * f.py * f.px;
  const int par = s.par[b];
  const T* pold = (par ? p1 : p0) + off;
  T* pnew = (par ? p0 : p1) + off;
  const T* z = first ? pold : zbuf + off;
  const T rzp = s.rz_prev[b], rzc = s.rz[b];
  const T beta = (!first && rzp > T(0)) ? rzc / rzp : T(0);
  coeff_windows(f, off, t, AW, AN, DI, Dw);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int wi = c / t.wx, wj = c - wi * t.wx;
    const int gi = t.i0 + wi, gj = t.j0 + wj;
    if (gi >= 0 && gi < t.py && gj >= 0 && gj < t.px) {
      const size_t g = (size_t)gi * t.px + gj;
      P[c] = z[g] + beta * pold[g];
    } else {
      P[c] = T(0);
    }
  }
  __syncthreads();
  double acc = 0.0;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi >= t.py || gj >= t.px) continue;
    const int wi = ti + h, wj = tj + h, wc = wi * t.wx + wj;
    const T pc = P[wc];
    const T q = diag_of(DI[wc]) * pc -
                wnbsum(AW, AN, P, wc, wi, wj, t.wy, t.wx);
    pnew[(size_t)gi * t.px + gj] = pc;
    const T prod = pc * q;
    acc += (double)prod;
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_a[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// Pass B: x += alpha p, r -= alpha q, partials of sum|r|, then T1 on r.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
pass_b_kernel(Fine<T> f, T* __restrict__ x, const T* p0, const T* p1,
              T* r0, T* r1, T* __restrict__ e, T* __restrict__ rc,
              CgState<T> s, Weights ws, int h) {
  __shared__ double sh[TILE_THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  T* S = reinterpret_cast<T*>(smem_raw);
  const Tile t = make_tile(f.py, f.px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *P = S + 3 * n, *R = S + 4 * n;
  T *E0 = S + 5 * n, *E1 = S + 6 * n, *Dw = S + 7 * n;
  const size_t off = (size_t)b * f.py * f.px;
  const int par = s.par[b];
  const T* pnew = (par ? p0 : p1) + off;
  const T* rold = (par ? r1 : r0) + off;
  T* rnew = (par ? r0 : r1) + off;
  const T alpha = s.alpha[b];
  coeff_windows(f, off, t, AW, AN, DI, Dw);
  load_window(P, pnew, t, 0);
  load_window(R, rold, t, 0);
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int wi = c / t.wx, wj = c - wi * t.wx;
    const T q = diag_of(DI[c]) * P[c] -
                wnbsum(AW, AN, P, c, wi, wj, t.wy, t.wx);
    R[c] = R[c] - alpha * q;
  }
  __syncthreads();
  double acc = 0.0;
  T* xb = x + off;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi >= t.py || gj >= t.px) continue;
    const int wc = (ti + h) * t.wx + tj + h;
    const size_t g = (size_t)gi * t.px + gj;
    xb[g] = xb[g] + alpha * P[wc];
    const T rv = R[wc];
    rnew[g] = rv;
    acc += (double)(rv < T(0) ? -rv : rv);
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_b[(size_t)b * s.ntiles + blockIdx.x] = sum;
  const T* E = pre_smooth(AW, AN, DI, R, E0, E1, ws, t);
  store_interior(e + off, E, t);
  restrict_tile(AW, AN, DI, R, E, t,
                rc + (size_t)b * (f.py / 2) * (f.px / 2));
}

// Pass C: T2 gives z, partials of <r, z>.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
pass_c_kernel(Fine<T> f, const T* r0, const T* r1, const T* __restrict__ e,
              const T* __restrict__ ec, T* __restrict__ z, T over,
              CgState<T> s, Weights ws, int h) {
  __shared__ double sh[TILE_THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  T* S = reinterpret_cast<T*>(smem_raw);
  const Tile t = make_tile(f.py, f.px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *R = S + 3 * n;
  T *E0 = S + 4 * n, *E1 = S + 5 * n, *Dw = S + 6 * n;
  const size_t off = (size_t)b * f.py * f.px;
  const T* rnew = (s.par[b] ? r0 : r1) + off;
  coeff_windows(f, off, t, AW, AN, DI, Dw);
  load_window(R, rnew, t, 0);
  const T* Z = post_smooth(AW, AN, DI, R, E0, E1, e + off,
                           ec + (size_t)b * (f.py / 2) * (f.px / 2), over,
                           ws, t);
  double acc = 0.0;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi >= t.py || gj >= t.px) continue;
    const int wc = (ti + h) * t.wx + tj + h;
    const size_t g = (size_t)gi * t.px + gj;
    T zv = Z[wc];
    if (f.d != nullptr && !(f.d[off + g] > T(0))) zv = T(0);
    z[off + g] = zv;
    const T prod = R[wc] * zv;
    acc += (double)prod;
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_c[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// Scratch per image, in elements of `elem_bytes` (4 or 8): the three double
// partial arrays first (8-byte aligned at the start), then z, the second p
// and r, e, the coarse residual, e_c, the coarse tail's scratch, and three
// scalars (rz_prev, alpha, spare).
long long cg_tiled_scratch_elems(int L, const int* ny, const int* nx,
                                 int elem_bytes) {
  if (L < 2) return 0;
  const long long n0 = (long long)ny[0] * nx[0];
  const long long n1 = (long long)ny[1] * nx[1];
  return 3LL * tiles_for(ny[0], nx[0]) * (8 / elem_bytes) + 4 * n0 + n1 +
         n1 + cycle_scratch_elems(L - 1, ny + 1, nx + 1) + 3;
}

template <typename K>
cudaError_t smem_for(K kernel, int planes, int h, bool mf, size_t item,
                     size_t* bytes) {
  *bytes = tile_smem(planes, h, mf, item);
  return allow_smem(kernel, *bytes);
}

template <typename T>
int cg_tiled_entry(int B, int L, const int* ny, const int* nx,
                   const void* const* aw, const void* const* an,
                   const void* const* dinv, const void* d, double fx,
                   double fy, double bcf, int nxr, void* x_, void* r_,
                   void* p_, void* rz_, const void* active_,
                   const void* stop_, const void* hi_, int k, void* k_done_,
                   const double* ws, int nu, int coarse_iters, double over,
                   void* scratch_, void* iscratch_, void* stream) {
  Level<T> lv[MAX_LEVELS];
  if (!fill_levels<T>(L, ny, nx, aw, an, dinv, lv) || L < 2 || B < 1 ||
      k < 0 || nu < 1 || nu > MAX_NU - 2)
    return cudaErrorInvalidValue;
  const int py = ny[0], px = nx[0];
  if (py % 2 || px % 2 || ny[1] != py / 2 || nx[1] != px / 2)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool mf = d != nullptr;
  Fine<T> f{};
  f.aw = lv[0].aw;
  f.an = lv[0].an;
  f.dinv = lv[0].dinv;
  f.d = static_cast<const T*>(d);
  f.fx = (T)fx;
  f.fy = (T)fy;
  f.bcf = (T)bcf;
  f.nxr = nxr;
  f.py = py;
  f.px = px;
  const int h = nu + 2;
  const Weights wts = make_weights(ws, nu);

  const int n0 = py * px, n1 = ny[1] * nx[1];
  const int nt = tiles_for(py, px);
  T* x = static_cast<T*>(x_);
  T* r0 = static_cast<T*>(r_);
  T* p0 = static_cast<T*>(p_);
  CgState<T> s{};
  s.part_a = static_cast<double*>(scratch_);
  s.part_b = s.part_a + (size_t)B * nt;
  s.part_c = s.part_b + (size_t)B * nt;
  T* zbuf = reinterpret_cast<T*>(s.part_c + (size_t)B * nt);
  T* p1 = zbuf + (size_t)B * n0;
  T* r1 = p1 + (size_t)B * n0;
  T* e = r1 + (size_t)B * n0;
  T* rc = e + (size_t)B * n0;
  T* ec = rc + (size_t)B * n1;
  T* cyc = ec + (size_t)B * n1;
  s.rz_prev = cyc + (size_t)B * cycle_scratch_elems(L - 1, ny + 1, nx + 1);
  s.alpha = s.rz_prev + B;
  s.rz = static_cast<T*>(rz_);
  s.stop = static_cast<const T*>(stop_);
  s.hi = static_cast<const T*>(hi_);
  s.live = static_cast<int*>(iscratch_);
  s.par = s.live + B;
  s.k_done = static_cast<int*>(k_done_);
  s.ntiles = nt;

  size_t smem_a, smem_b, smem_c;
  cudaError_t err = smem_for(pass_a_kernel<T>, 4, h, mf, sizeof(T), &smem_a);
  if (err == cudaSuccess)
    err = smem_for(pass_b_kernel<T>, 7, h, mf, sizeof(T), &smem_b);
  if (err == cudaSuccess)
    err = smem_for(pass_c_kernel<T>, 6, h, mf, sizeof(T), &smem_c);
  if (err != cudaSuccess) return err;

  const dim3 tiles(nt, B), per_image(1, B);
  if (mf) {
    const long long n = (long long)B * n0;
    const int blocks = (int)((n + THREADS - 1) / THREADS < 65536
                                 ? (n + THREADS - 1) / THREADS : 65536);
    DEFF_LAUNCH(pin_kernel<T><<<blocks, THREADS, 0, st>>>(f.d, x, r0, p0, n));
  }
  DEFF_LAUNCH(abs_parts_kernel<T><<<tiles, TILE_THREADS, 0, st>>>(
      r0, py, px, s.part_b, nt));
  DEFF_LAUNCH(fin_init_kernel<T><<<per_image, TILE_THREADS, 0, st>>>(
      s, static_cast<const T*>(active_)));

  for (int i = 0; i < k; ++i) {
    DEFF_LAUNCH(pass_a_kernel<T><<<tiles, TILE_THREADS, smem_a, st>>>(
        f, p0, p1, zbuf, i == 0 ? 1 : 0, s, h));
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, TILE_THREADS, 0, st>>>(s));
    DEFF_LAUNCH(pass_b_kernel<T><<<tiles, TILE_THREADS, smem_b, st>>>(
        f, x, p0, p1, r0, r1, e, rc, s, wts, h));
    err = run_cycle<T>(B, L - 1, lv + 1, rc, ec, cyc, ws, nu, coarse_iters,
                       over, s.live, st);
    if (err != cudaSuccess) return err;
    DEFF_LAUNCH(pass_c_kernel<T><<<tiles, TILE_THREADS, smem_c, st>>>(
        f, r0, r1, e, ec, zbuf, (T)over, s, wts, h));
    DEFF_LAUNCH(fin_live_kernel<T><<<per_image, TILE_THREADS, 0, st>>>(s));
  }
  DEFF_LAUNCH(copy_back_kernel<T><<<dim3(blocks_for(n0), B), THREADS, 0,
                                    st>>>(r0, r1, p0, p1, n0, s.par));
  return cudaSuccess;
}

}  // namespace
}  // namespace deff

extern "C" {

long long deff_cg_tiled_scratch_elems(int L, const int* ny, const int* nx,
                                      int elem_bytes) {
  return deff::cg_tiled_scratch_elems(L, ny, nx, elem_bytes);
}

#define DEFF_CG_TILED_ENTRY(NAME, T)                                          \
  int NAME(int B, int L, const int* ny, const int* nx, const void* const* aw, \
           const void* const* an, const void* const* dinv, const void* d,     \
           double fx, double fy, double bcf, int nxr, void* x, void* r,       \
           void* p, void* rz, const void* active, const void* stop,           \
           const void* hi, int k, void* k_done, const double* ws, int nu,     \
           int coarse_iters, double over, void* scratch, void* iscratch,      \
           void* stream) {                                                    \
    return deff::cg_tiled_entry<T>(B, L, ny, nx, aw, an, dinv, d, fx, fy,    \
                                   bcf, nxr, x, r, p, rz, active, stop, hi,   \
                                   k, k_done, ws, nu, coarse_iters, over,     \
                                   scratch, iscratch, stream);                \
  }

DEFF_CG_TILED_ENTRY(deff_cg_steps_tiled_f32, float)
DEFF_CG_TILED_ENTRY(deff_cg_steps_tiled_f64, double)

}  // extern "C"
