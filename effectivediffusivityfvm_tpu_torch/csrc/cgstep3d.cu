// K7: up to k multigrid-preconditioned CG iterations per volume on the
// banded 3D engine, each iteration three z-marching passes over level 0
// with the per-volume scalars computed on the device between them, as one
// host loop of batch-wide launches on one stream (no host synchronisation
// inside the window).  No refresh: the solver refreshes through K6 between
// windows.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/cgstep3d.py
// (cg_steps3d_tiled: _pass_a3, _pass_b3, _pass_c3).  Per iteration, for
// every live volume:
//   P  beta = rz/rz_prev (0 on the first iteration or if rz_prev <= 0);
//      p = z + beta p_old, q = A p, both written; partials of <p, q>;
//   .  alpha = rz/<p,q> (0 unless <p,q> > 0);
//   X  x += alpha p; r_new = r - alpha q; partials of sum|r_new|; then T1
//      on r_new: e0 = (w0 dinv) r_new, the nu - 1 further pre-sweeps, the
//      residual r_new - A e and its 2x2x2 restriction.  Writes x, r_new, e
//      and the coarse residual;
//   .  the coarse tail: K6's whole cycle on levels[1:] (vcycle3d.cuh),
//      gated by the live flags;
//   Z  e + over P e_c on the window, then the nu post-sweeps: z, pinned to
//      0 where D <= 0 when matrix-free, with partials of <r_new, z>;
//   .  rz_prev = rz, rz = <r, z>, k_done += 1, live &= stop < sum|r| < hi.
// On entry z = p, live = active > 0 & stop < sum|r_in| < hi; when
// matrix-free, x, r and p are first multiplied by (D > 0), as the TPU
// kernel does for every volume.
//
// Each pass marches along z through (y, x) tiles (march3d.cuh): a CTA holds
// rings of z-slices of each intermediate field in shared memory, stage s
// running s slices behind stage s - 1, so a pass reads each input slice
// from HBM once.  Halos: P 1 (q = A p), X nu (nu - 1 sweeps and the
// residual), Z nu (nu sweeps).  X and Z are K6's DOWN and UP passes with
// the CG update (one body each, levelpass3d.cuh), and K6's cycle runs the
// same passes on levels[1:] above its resident bottom.  Every operand a
// stage reads comes from shared memory, staged one step ahead by cp.async:
// the windows, and the tile's x and p (X) and the coarse window of e_c and
// the pin's D (Z); e0 = (w0 dinv) r_new is kept in a ring rather than
// recomputed at the stencil points.  Matrix-free, the passes rebuild a_w,
// a_n, a_u and diag_inv from D once a pass (march3d.cuh's Coefs), term for
// term as ops/kernels/vcycle3d.py's coeffs_from_d3.
//
// The TPU passes read p_old and r and wrote p and r slab by slab in order;
// here CTAs run in parallel and read their neighbours' halos, so p and r
// alternate between the caller's volume and a scratch volume, volume by
// volume (`par`), and go back to the caller's volumes at the end.  x is
// read only at its own cell and is updated in place.  A frozen or retired
// volume's CTAs return at once, which also keeps its z.  Reductions:
// per-CTA partials in double, summed in a fixed order by one block per
// volume (cgscalars.cuh, shared with K5).
//
// Bounds on an H100: memory bandwidth.  Stored level 0, fp32, reckoned per
// iteration and cell: P reads z, p_old and four coefficient volumes and
// writes p and q (32 B); X reads r, q, x, p and the coefficients and writes
// x, r, e and an eighth volume (44.5 B); Z reads e, r, the coefficients and
// an eighth volume and writes z (28.5 B): ~105 B/cell, against ~168 for the
// eight launches this replaces, plus K6's tail on levels[1:].
// Matrix-free the four coefficient volumes become one D volume in each
// pass: ~69 B/cell, at 4 divisions a cell a pass (plus the halo) for the
// rebuild.
#include "levelpass3d.cuh"

namespace deff {
namespace {

using march::Coefs;
using march::Geo;
using march::NT;
using march::TX;
using march::Tile3;
using march::Tri;
using march::Vol0;
using march::W3;
using march::for_win;
using march::nb7;
using march::prologue;
using march::tri;

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

// ---- pass P: p = z + beta p_old on the window, q = A p on the tile;
// writes p and q, partials of <p, q>.
template <typename T, bool MF>
__global__ void __launch_bounds__(NT)
march_p3_kernel(Vol0<T> v, T* p0, T* p1, const T* zbuf, T* qbuf, int first,
                CgState<T> s, int seglen) {
  constexpr int H = 1, NC = march::coef_slots(0, 1);
  using G = Geo<T, H>;
  __shared__ double sh[THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const Dims3 dm = v.dm;
  const Tile3 tl = march::tile3<G::TY>(dm, seglen);
  const size_t off = (size_t)b * dm.cells();
  const int par = s.par[b];
  const T* pold = (par ? p1 : p0) + off;
  T* pnew = (par ? p0 : p1) + off;
  const T* z = first ? pold : zbuf + off;
  T* q = qbuf + off;
  const T rzp = s.rz_prev[b], rzc = s.rz[b];
  const T beta = (!first && rzp > T(0)) ? rzc / rzp : T(0);
  const int gi0 = tl.i0 - H, gj0 = tl.j0 - H;
  T* sp = reinterpret_cast<T*>(smem_raw);
  const Coefs<T, H, NC, MF> co(sp, gi0, gj0, dm);
  constexpr int NZ = 3 + march::PD, NO = 1 + march::PD;
  T* PZ = sp;                          // z, then p in place: NZ slices
  T* PO = sp + NZ * G::N;              // p_old: NO slices
  const int t0 = tl.zs - H > 0 ? tl.zs - H : 0;
  const int t1 = tl.ze - 1 + H < dm.nz - 1 ? tl.ze - 1 + H : dm.nz - 1;
  auto issue = [&](int k) {
    if (k > t1) return;
    co.win.stage(PZ + (k % NZ) * G::N, z, k, dm);
    if (!first) co.win.stage(PO + (k % NO) * G::N, pold, k, dm);
    co.issue(v, off, k);
  };
  prologue(co, v, off, t0, issue);
  double acc = 0.0;
  for (int t = t0; t <= tl.ze - 1 + H; ++t) {
    issue(t + march::PD);
    march::cp_commit();
    march::cp_wait_step();
    if (t <= t1) {
      co.rebuild(v, t);
      T* pt = PZ + (t % NZ) * G::N;
      const T* ot = first ? pt : PO + (t % NO) * G::N;
      for (int e = threadIdx.x; e < G::N; e += NT) pt[e] = pt[e] + beta * ot[e];
      __syncthreads();
    }
    const int k = t - 1;
    if (k >= tl.zs && k < tl.ze) {
      const Tri<T> pv = tri<G::N, NZ>(PZ, k);
      const T* aw = co.AW(k);
      const T* an = co.AN(k);
      const T* au = co.AU(k);
      const T* au1 = co.AU(k + 1);
      const T* di = co.DI(k);
      const size_t ks = (size_t)k * dm.plane();
      for_win<G, 1>(gi0, gj0, [&](int e, int gi, int gj) {
        const T pc = pv.c[e];
        const T qv = diag_of(di[e]) * pc -
                     nb7<G::WX>(aw, an, au, au1, pv, e, k, dm);
        if (!march::in_plane(gi, gj, dm)) return;
        const size_t g = ks + (size_t)gi * dm.nx + gj;
        pnew[g] = pc;
        q[g] = qv;
        const T prod = pc * qv;
        acc += (double)prod;
      });
    }
    __syncthreads();
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_a[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// ---- pass X: x += alpha p, r_new = r - alpha q (partials of sum|r_new|),
// then T1 on r_new: K6's DOWN pass (levelpass3d.cuh) with the CG update.
template <typename T, int NU, bool MF>
__global__ void __launch_bounds__(NT)
march_x3_kernel(Vol0<T> v, T* __restrict__ x, const T* p0, const T* p1,
                T* r0, T* r1, const T* __restrict__ qbuf,
                T* __restrict__ ebuf, T* __restrict__ rc, Dims3 dc,
                CgState<T> s, W3 ws, int seglen) {
  march::down3_body<T, NU, MF, true>(v, x, p0, p1, r0, r1, qbuf, ebuf, rc,
                                     dc, s.live, s, ws, seglen);
}

// ---- pass Z: K6's UP pass (levelpass3d.cuh) on r_new gives z, pinned to
// 0 where D <= 0 when matrix-free; partials of <r_new, z>.
template <typename T, int NU, bool MF>
__global__ void __launch_bounds__(NT)
march_z3_kernel(Vol0<T> v, const T* r0, const T* r1,
                const T* __restrict__ ebuf, const T* __restrict__ ec,
                Dims3 dc, T over, T* __restrict__ zbuf, CgState<T> s, W3 ws,
                int seglen) {
  march::up3_body<T, NU, MF, true>(v, r0, r1, ebuf, ec, dc, over, zbuf,
                                   s.live, s, ws, seglen);
}

// Scratch per volume, in elements of `elem_bytes` (4 or 8): the three
// double partial arrays first (8-byte aligned at the start), then z, the
// second p, the second r, e, q, the coarse residual, e_c, the coarse
// tail's scratch, and three scalars (rz_prev, alpha, spare).
long long cg3d_scratch_elems(int L, const int* nz, const int* ny,
                             const int* nx, int elem_bytes) {
  if (L < 2) return 0;
  const long long n0 = (long long)nz[0] * ny[0] * nx[0];
  const long long n1 = (long long)nz[1] * ny[1] * nx[1];
  return 3LL * march::part_slots(nz[0], ny[0], nx[0], elem_bytes) *
             (8 / elem_bytes) +
         5 * n0 + 2 * n1 +
         cycle3_scratch_elems(L - 1, nz + 1, ny + 1, nx + 1) + 3;
}

#define DEFF_TRY3(...)                         \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

// Buffers of one window.
template <typename T>
struct Bufs3 {
  T* x;
  T* r0;
  T* r1;
  T* p0;
  T* p1;
  T* z;
  T* q;
  T* e;
  T* rc;
  T* ec;
  T* cyc;
};

// The three passes' launches for one nu and coefficient mode.
template <typename T, int NU, bool MF>
struct Passes3 {
  static cudaError_t p(const Vol0<T>& v, const Bufs3<T>& u, int first,
                       const CgState<T>& s, dim3 grid, int seglen,
                       cudaStream_t st) {
    static unsigned done = 0;
    const size_t sm = march::smem_bytes(0, sizeof(T), 1, MF);
    auto kern = march_p3_kernel<T, MF>;
    DEFF_TRY3(allow_smem(kern, sm, &done));
    DEFF_LAUNCH(kern<<<grid, NT, sm, st>>>(v, u.p0, u.p1, u.z, u.q, first, s,
                                           seglen));
    return cudaSuccess;
  }
  static cudaError_t x(const Vol0<T>& v, const Bufs3<T>& u, Dims3 dc,
                       const CgState<T>& s, W3 ws, dim3 grid, int seglen,
                       cudaStream_t st) {
    static unsigned done = 0;
    const size_t sm = march::smem_bytes(1, sizeof(T), NU, MF);
    auto kern = march_x3_kernel<T, NU, MF>;
    DEFF_TRY3(allow_smem(kern, sm, &done));
    DEFF_LAUNCH(kern<<<grid, NT, sm, st>>>(v, u.x, u.p0, u.p1, u.r0, u.r1,
                                           u.q, u.e, u.rc, dc, s, ws,
                                           seglen));
    return cudaSuccess;
  }
  static cudaError_t z(const Vol0<T>& v, const Bufs3<T>& u, Dims3 dc,
                       T over, const CgState<T>& s, W3 ws, dim3 grid,
                       int seglen, cudaStream_t st) {
    static unsigned done = 0;
    const size_t sm = march::smem_bytes(2, sizeof(T), NU, MF);
    auto kern = march_z3_kernel<T, NU, MF>;
    DEFF_TRY3(allow_smem(kern, sm, &done));
    DEFF_LAUNCH(kern<<<grid, NT, sm, st>>>(v, u.r0, u.r1, u.e, u.ec, dc,
                                           over, u.z, s, ws, seglen));
    return cudaSuccess;
  }
};

// The k-iteration window for one nu and coefficient mode.
template <typename T, int NU, bool MF>
cudaError_t run_window(int B, int L, const Level3<T>* lv, const Vol0<T>& v,
                       const Bufs3<T>& u, CgState<T> s, const T* active,
                       int k, const double* ws_, int coarse_iters,
                       double over, cudaStream_t st) {
  using P = Passes3<T, NU, MF>;
  const Dims3 d0 = lv[0].dm, d1 = lv[1].dm;
  const int n0 = d0.cells();
  const int shortest = march::min_seg(NU);
  const int seglen = march::seg_len(d0.nz, d0.ny, d0.nx, sizeof(T), shortest);
  const int ncta = march::ctas(d0.nz, d0.ny, d0.nx, sizeof(T), shortest);
  const dim3 grid(ncta, B), per_image(1, B);
  const W3 ws = march::make_w3(ws_, NU);
  if (MF) {
    const long long n = (long long)B * n0;
    const int nb = (int)((n + THREADS - 1) / THREADS < 65536
                             ? (n + THREADS - 1) / THREADS : 65536);
    DEFF_LAUNCH(pin_kernel<T><<<nb, THREADS, 0, st>>>(v.d, u.x, u.r0, u.p0,
                                                      n));
  }
  // the entry's sum|r| by plain blocks, then the passes' partials by CTA
  CgState<T> s0 = s;
  s0.ntiles = blocks_for(n0);
  DEFF_LAUNCH(abs_parts3_kernel<T><<<dim3(s0.ntiles, B), THREADS, 0, st>>>(
      u.r0, n0, s0.part_b, s0.ntiles));
  WindowExit wx(st);
  DEFF_TRY3(wx.status());
  s0.any = wx.slot(0);
  DEFF_LAUNCH(fin_init_kernel<T><<<per_image, THREADS, 0, st>>>(s0, active));
  DEFF_TRY3(wx.mark(0));
  s.ntiles = ncta;
  for (int i = 0; i < k; ++i) {
    bool stop_now = false;
    DEFF_TRY3(wx.stop_before(i, &stop_now));
    if (stop_now) break;
    ++g_window_iters;
    DEFF_TRY3(P::p(v, u, i == 0 ? 1 : 0, s, grid, seglen, st));
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, THREADS, 0, st>>>(s));
    DEFF_TRY3(P::x(v, u, d1, s, ws, grid, seglen, st));
    DEFF_TRY3(run_cycle3<T>(B, L - 1, lv + 1, u.rc, u.ec, u.cyc, ws_, NU,
                            coarse_iters, over, s.live, st));
    DEFF_TRY3(P::z(v, u, d1, (T)over, s, ws, grid, seglen, st));
    CgState<T> sl = s;
    sl.any = wx.slot(i + 1);
    DEFF_LAUNCH(fin_live_kernel<T><<<per_image, THREADS, 0, st>>>(sl));
    DEFF_TRY3(wx.mark(i + 1));
  }
  DEFF_LAUNCH(copy_back_kernel<T><<<dim3(blocks_for(n0), B), THREADS, 0,
                                    st>>>(u.r0, u.r1, u.p0, u.p1, n0, s.par));
  return cudaSuccess;
}

template <typename T, bool MF>
cudaError_t run_nu(int nu, int B, int L, const Level3<T>* lv,
                   const Vol0<T>& v, const Bufs3<T>& u, CgState<T> s,
                   const T* active, int k, const double* ws,
                   int coarse_iters, double over, cudaStream_t st) {
  switch (nu) {
    case 1:
      return run_window<T, 1, MF>(B, L, lv, v, u, s, active, k, ws,
                                  coarse_iters, over, st);
    case 2:
      return run_window<T, 2, MF>(B, L, lv, v, u, s, active, k, ws,
                                  coarse_iters, over, st);
    case 3:
      return run_window<T, 3, MF>(B, L, lv, v, u, s, active, k, ws,
                                  coarse_iters, over, st);
    default:
      return cudaErrorInvalidValue;
  }
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
      B < 1 || B > 65535 || k < 0 || nu < 1 || nu > 3 || nz[0] % 2 ||
      ny[0] % 2 || nx[0] % 2)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const long long n0 = lv[0].dm.cells(), n1 = lv[1].dm.cells();
  const long long np = march::part_slots(nz[0], ny[0], nx[0], sizeof(T));
  CgState<T> s{};
  s.part_a = static_cast<double*>(scratch_);
  s.part_b = s.part_a + (size_t)B * np;
  s.part_c = s.part_b + (size_t)B * np;
  Bufs3<T> u{};
  u.z = reinterpret_cast<T*>(s.part_c + (size_t)B * np);
  u.p1 = u.z + (size_t)B * n0;
  u.r1 = u.p1 + (size_t)B * n0;
  u.e = u.r1 + (size_t)B * n0;
  u.q = u.e + (size_t)B * n0;
  u.rc = u.q + (size_t)B * n0;
  u.ec = u.rc + (size_t)B * n1;
  u.cyc = u.ec + (size_t)B * n1;
  s.rz_prev = u.cyc + (size_t)B * cycle3_scratch_elems(L - 1, nz + 1, ny + 1,
                                                       nx + 1);
  s.alpha = s.rz_prev + B;
  s.rz = static_cast<T*>(rz_);
  s.stop = static_cast<const T*>(stop_);
  s.hi = static_cast<const T*>(hi_);
  s.live = static_cast<int*>(iscratch_);
  s.par = s.live + B;
  s.k_done = static_cast<int*>(k_done_);
  u.x = static_cast<T*>(x_);
  u.r0 = static_cast<T*>(r_);
  u.p0 = static_cast<T*>(p_);
  Vol0<T> v{};
  v.aw = lv[0].co.aw;
  v.an = lv[0].co.an;
  v.au = lv[0].co.au;
  v.dinv = lv[0].co.dinv;
  v.d = static_cast<const T*>(d_);
  v.fx = (T)fx;
  v.fy = (T)fy;
  v.fz = (T)fz;
  v.bcf = (T)bcf;
  v.nxr = nxr;
  v.dm = lv[0].dm;
  const T* active = static_cast<const T*>(active_);
  if (v.d == nullptr)
    return run_nu<T, false>(nu, B, L, lv, v, u, s, active, k, ws,
                            coarse_iters, over, st);
  return run_nu<T, true>(nu, B, L, lv, v, u, s, active, k, ws, coarse_iters,
                         over, st);
}

}  // namespace
}  // namespace deff

extern "C" {

long long deff_cg3d_scratch_elems(int L, const int* nz, const int* ny,
                                  const int* nx, int elem_bytes) {
  return deff::cg3d_scratch_elems(L, nz, ny, nx, elem_bytes);
}

// The z-marching rule (march3d.cuh), for the Python twin's card test:
// K7's segments, and those of K6's level passes.
int deff_march3_seg_len(int nz, int ny, int nx, int itemsize, int nu) {
  return deff::march::seg_len(nz, ny, nx, itemsize, deff::march::min_seg(nu));
}

int deff_march3_level_seg_len(int nz, int ny, int nx, int itemsize) {
  return deff::march::seg_len(nz, ny, nx, itemsize,
                              deff::march::LEVEL_MIN_SEG);
}

long long deff_march3_smem(int pass, int itemsize, int nu, int mf) {
  return deff::march::smem_bytes(pass, itemsize, nu, mf != 0);
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
