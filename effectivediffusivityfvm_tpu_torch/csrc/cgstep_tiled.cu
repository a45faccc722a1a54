// K5: up to k multigrid-preconditioned CG iterations per image for fine
// grids past the whole-cycle engine's size, each iteration three tile
// passes over level 0 with per-image scalars computed on the device between
// them, as one host loop of batch-wide launches on one stream (no host
// synchronisation inside the window).  No refresh: the solver refreshes
// through K4 between windows.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/cgstep_tiled.py
// (cg_steps_tiled: _pass_a, _pass_b, _pass_c, _coeffs_from_dwin2).  Per
// iteration, for every live image:
//   P  beta = rz/rz_prev (0 on the first iteration or if rz_prev <= 0);
//      p = z + beta p_old on the tile and a 1-cell halo, q = A p on the
//      tile; writes p and q, partials of <p, q>;
//   .  alpha = rz/<p,q> (0 unless <p,q> > 0);
//   X  x += alpha p; r_new = r - alpha q on the tile and an nu-cell halo,
//      partials of sum|r_new|; then T1: e0 = (w0 dinv) r_new recomputed
//      where the second sweep reads it, the further pre-sweeps each on a
//      halo one smaller, the residual r_new - A e and its 2x2 restriction.
//      Writes x, r_new, e and the quarter plane;
//   .  the coarse tail: K2's cycle on levels[1:] (vcycle.cuh);
//   Z  e + over P e_c on the tile and an nu-cell halo, the nu post-sweeps:
//      z, pinned to 0 where D <= 0 when matrix-free; partials of <r, z>;
//   .  rz_prev = rz, rz = <r, z>, k_done += 1, live &= stop < sum|r| < hi.
// On entry z = p, live = active > 0 & stop < sum|r_in| < hi; when
// matrix-free, x, r and p are first multiplied by (D > 0), as the TPU
// kernel does for every image.
//
// The passes follow K1's level-0 design (cgstep.cu) on its tile scaffolding
// (tile2d.cuh): 64x16 tiles of 256 threads, every window staged in shared
// memory by cp.async with the smallest halo its chain needs (1 for P, nu
// for X and Z), index arithmetic by compile-time widths, and P writing q so
// that X does not recompute it.  The pass bodies differ from K1's in three
// ways, which is why they are separate kernels: the tiled smoothing form (1 - w) x + (w (b + nbsum)) dinv of the
// plain version (ops/kernels/vcycle_tiled.py) at every sweep, up to nu =
// MAX_NU - 2 sweeps a side inside the passes; level 0 stored or rebuilt
// from D once a window (a_w, a_n from the faces' two cells, diag_inv from
// them and the east / south neighbours' faces, term for term as
// coeffs_from_d); and the window's scalars in cgscalars.cuh's CgState with
// no refresh.
//
// The TPU passes read p_old, r_old and wrote p, r over the same arrays band
// by band in order; blocks here run in parallel and read their neighbours'
// halos, so p and r alternate between the caller's plane and a scratch
// plane, image by image (`par`), and the last copies go back to the
// caller's planes at the end.  A frozen or retired image's blocks return at
// once.  Reductions: per-tile partials in double, summed in a fixed order by
// one block per image, rounded to T once -- iteration counts do not change
// from run to run.
//
// Bounds on an H100: memory bandwidth.  Stored level 0, fp32, reckoned per
// iteration and cell: P reads z, p_old and 3 coefficient planes and writes
// p and q (28 B); X reads r, q, x, p and the coefficients and writes x, r,
// e and a quarter plane (41 B); Z reads e, r, the coefficients and a
// quarter plane and writes z (25 B): 94 B/cell, plus K2's tail.
// Matrix-free the three coefficient planes become one D plane in each pass:
// 70 B/cell.
#include "cgscalars.cuh"
#include "tile2d.cuh"

namespace deff {
namespace {

constexpr int MAX_NU = 8;     // the TPU engine's HALO; nu <= MAX_NU - 2

// Level 0 of a (B, py, px) batch: the stored planes, or (d != nullptr) the
// diffusivity field the passes rebuild them from (matrix-free).
template <typename T>
struct Fine2 {
  const T* aw;
  const T* an;
  const T* dinv;
  const T* d;
  T fx, fy, bcf;   // assembly factors of the unpadded grid
  int nxr;         // unpadded width: the Dirichlet columns are 0 and nxr - 1
  int ny, nx;
};

static_assert(MAX_NU <= WK_MAX, "a leg's damping factors fit WK");

// The level-0 windows AW, AN, DI of a pass with halo H: staged (stored) or
// rebuilt from the staged D window DW (matrix-free).
template <typename T, int H, bool MF>
struct Coef2 {
  using RG = Reg<H>;
  T* aw;
  T* an;
  T* di;
  T* dw;

  __device__ Coef2(T* sp) {
    aw = sp;
    an = aw + RG::N;
    di = an + RG::N;
    dw = di + RG::N;
  }
  __host__ __device__ static constexpr int elems() {
    return 3 * RG::N + (MF ? RG::DN : 0);
  }

  __device__ void stage(const Fine2<T>& f, size_t off, int i0, int j0) const {
    if (MF) {
      stage_win<RG::DW, RG::DN>(dw, f.d + off, i0 - H - 1, j0 - H - 1, f.ny,
                                f.nx);
    } else {
      stage_win<RG::W, RG::N>(aw, f.aw + off, i0 - H, j0 - H, f.ny, f.nx);
      stage_win<RG::W, RG::N>(an, f.an + off, i0 - H, j0 - H, f.ny, f.nx);
      stage_win<RG::W, RG::N>(di, f.dinv + off, i0 - H, j0 - H, f.ny, f.nx);
    }
  }

  // Matrix-free, after the staged D landed: the faces, then diag_inv;
  // synchronises.
  __device__ void rebuild(const Fine2<T>& f, int i0, int j0) const {
    if (!MF) return;
    for_cells<H, H>(i0, j0, f.ny, f.nx, [&](int e, int gi, int gj) {
      const int dc = (gi - i0 + H + 1) * RG::DW + (gj - j0 + H + 1);
      const T dcc = dw[dc];
      aw[e] = gj > 0 ? hmean(dw[dc - 1], dcc) * f.fx : T(0);
      an[e] = gi > 0 ? hmean(dw[dc - RG::DW], dcc) * f.fy : T(0);
    });
    __syncthreads();
    for_cells<H, H>(i0, j0, f.ny, f.nx, [&](int e, int gi, int gj) {
      const int a = gi - i0 + H, bcol = gj - j0 + H;
      const int dc = (a + 1) * RG::DW + bcol + 1;
      const T dcc = dw[dc];
      const T ae = gj + 1 < f.nx
                       ? (bcol + 1 < RG::W ? aw[e + 1]
                                           : hmean(dcc, dw[dc + 1]) * f.fx)
                       : T(0);
      const T as = gi + 1 < f.ny
                       ? (a + 1 < RG::R ? an[e + RG::W]
                                        : hmean(dcc, dw[dc + RG::DW]) * f.fy)
                       : T(0);
      T dg = ((aw[e] + ae) + an[e]) + as;
      if (gj == 0 || gj == f.nxr - 1) dg = dg + dcc * f.bcf;
      di[e] = dg > T(0) ? T(1) / dg : T(0);
    });
    __syncthreads();
  }

 private:
  // Guarded product-form harmonic mean (2a) b / (a + b), 0 where a + b <= 0.
  __device__ static __forceinline__ T hmean(T a, T b) {
    const T s = a + b;
    return s > T(0) ? ((T(2) * a) * b) / s : T(0);
  }
};

// Per-tile partials of sum|r| over the padded plane.
template <typename T>
__global__ void __launch_bounds__(THREADS)
abs_parts_kernel(const T* __restrict__ r, int ny, int nx, double* part,
                 int nt) {
  __shared__ double sh[THREADS];
  const TileAt t(nx);
  const T* rb = r + (size_t)blockIdx.y * ny * nx;
  double acc = 0.0;
  for_cells<0, 0>(t.i0, t.j0, ny, nx, [&](int, int gi, int gj) {
    const T v = rb[(size_t)gi * nx + gj];
    acc += (double)(v < T(0) ? -v : v);
  });
  const double s = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) part[(size_t)blockIdx.y * nt + blockIdx.x] = s;
}

// ---- pass P: p = z + beta p_old on the window, q = A p on the tile;
// writes p and q, partials of <p, q>.
template <typename T, bool MF>
__global__ void __launch_bounds__(THREADS)
tile_p_kernel(Fine2<T> f, T* p0, T* p1, const T* zbuf, T* qbuf, int first,
              CgState<T> s) {
  __shared__ double sh[THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  constexpr int H = 1;
  using RG = Reg<H>;
  T* sp = reinterpret_cast<T*>(smem_raw);
  const Coef2<T, H, MF> co(sp);
  T* ps = sp + co.elems();               // z, then p in place
  T* os = ps + RG::N;                    // p_old (not on the first iteration)
  const int ny = f.ny, nx = f.nx;
  const size_t off = (size_t)b * ny * nx;
  const TileAt t(nx);
  const int par = s.par[b];
  const T* pold = (par ? p1 : p0) + off;
  T* pnew = (par ? p0 : p1) + off;
  const T rzp = s.rz_prev[b], rzc = s.rz[b];
  const T beta = (!first && rzp > T(0)) ? rzc / rzp : T(0);
  stage<H>(ps, first ? pold : zbuf + off, t.i0, t.j0, ny, nx);
  if (!first) stage<H>(os, pold, t.i0, t.j0, ny, nx);
  co.stage(f, off, t.i0, t.j0);
  cp_async_wait();
  co.rebuild(f, t.i0, t.j0);
  const T* ov = first ? ps : os;
  for (int e = threadIdx.x; e < RG::N; e += THREADS) ps[e] = ps[e] + beta * ov[e];
  __syncthreads();
  auto v = [&](int e) { return ps[e]; };
  double acc = 0.0;
  for_cells<H, 0>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    const size_t g = off + (size_t)gi * nx + gj;
    const T pc = ps[e];
    const T qv = diag_of(co.di[e]) * pc -
                 nbsum_s<RG::W>(co.aw, co.an, v, e, gi, gj, ny, nx);
    pnew[g - off] = pc;
    qbuf[g] = qv;
    const T prod = pc * qv;
    acc += (double)prod;
  });
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_a[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// ---- pass X: x += alpha p, r_new = r - alpha q on the window (partials of
// sum|r_new| on the tile), the NU pre-sweeps into e, the residual
// restricted 2x2 into rc (py/2 x px/2).
template <typename T, int NU, bool MF>
__global__ void __launch_bounds__(THREADS)
tile_x_kernel(Fine2<T> f, T* __restrict__ x, const T* p0, const T* p1,
              T* r0, T* r1, const T* __restrict__ qbuf, T* __restrict__ ebuf,
              T* __restrict__ rc, CgState<T> s, WK ws) {
  __shared__ double sh[THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  constexpr int H = NU;
  using RG = Reg<H>;
  T* sp = reinterpret_cast<T*>(smem_raw);
  const Coef2<T, H, MF> co(sp);
  T* rs = sp + co.elems();               // r, then r_new in place
  T* qs = rs + RG::N;
  T* ea = qs + RG::N;                    // sweeps 1, 3, 5
  T* eb2 = ea + RG::N;                   // sweeps 2, 4 (NU >= 3)
  const int ny = f.ny, nx = f.nx;
  const size_t off = (size_t)b * ny * nx;
  const TileAt t(nx);
  const int par = s.par[b];
  const T* p = (par ? p0 : p1) + off;
  const T* rold = (par ? r1 : r0) + off;
  T* rnew = (par ? r0 : r1) + off;
  const T alpha = s.alpha[b];
  stage<H>(rs, rold, t.i0, t.j0, ny, nx);
  stage<H>(qs, qbuf + off, t.i0, t.j0, ny, nx);
  co.stage(f, off, t.i0, t.j0);
  cp_async_wait();
  co.rebuild(f, t.i0, t.j0);
  for (int e = threadIdx.x; e < RG::N; e += THREADS)
    rs[e] = rs[e] - alpha * qs[e];
  __syncthreads();
  const T w0 = (T)ws.w[0];
  const T* di = co.di;
  auto e0 = [&](int e) { return (w0 * di[e]) * rs[e]; };
  // sweep 1 reads e0; sweep s >= 2 reads the previous sweep's buffer
  if constexpr (NU >= 2) {
    const T w = (T)ws.w[1], omw = (T)(1.0 - ws.w[1]);
    for_cells<H, H - 1>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
      const T nb = nbsum_s<RG::W>(co.aw, co.an, e0, e, gi, gj, ny, nx);
      ea[e] = omw * e0(e) + (w * (rs[e] + nb)) * di[e];
    });
    __syncthreads();
    for (int sw = 2; sw < NU; ++sw) {
      const T* src = (sw & 1) ? eb2 : ea;
      T* dst = (sw & 1) ? ea : eb2;
      const T ww = (T)ws.w[sw], om = (T)(1.0 - ws.w[sw]);
      auto sv = [&](int e) { return src[e]; };
      for_ring<H>(H - sw, t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
        const T nb = nbsum_s<RG::W>(co.aw, co.an, sv, e, gi, gj, ny, nx);
        dst[e] = om * src[e] + (ww * (rs[e] + nb)) * di[e];
      });
      __syncthreads();
    }
  }
  const T* ef = ((NU - 1) & 1) ? ea : eb2;   // the last sweep's buffer
  auto ev = [&](int e) { return NU == 1 ? e0(e) : ef[e]; };
  double acc = 0.0;
  for_cells<H, 0>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    const size_t g = off + (size_t)gi * nx + gj;
    x[g] = x[g] + alpha * p[g - off];
    const T rv = rs[e];
    rnew[g - off] = rv;
    ebuf[g] = ev(e);
    acc += (double)(rv < T(0) ? -rv : rv);
  });
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_b[(size_t)b * s.ntiles + blockIdx.x] = sum;
  const int I = t.i0 / 2 + threadIdx.x / (TX / 2);
  const int J = t.j0 / 2 + threadIdx.x % (TX / 2);
  if (2 * I >= ny || 2 * J >= nx) return;
  auto res = [&](int gi, int gj) {
    const int e = (gi - t.i0 + H) * RG::W + (gj - t.j0 + H);
    return rs[e] - (diag_of(di[e]) * ev(e) -
                    nbsum_s<RG::W>(co.aw, co.an, ev, e, gi, gj, ny, nx));
  };
  const int i = 2 * I, j = 2 * J;
  rc[(size_t)b * (ny / 2) * (nx / 2) + (size_t)I * (nx / 2) + J] =
      (res(i, j) + res(i + 1, j)) + (res(i, j + 1) + res(i + 1, j + 1));
}

// ---- pass Z: src = e + over e_c[i/2, j/2] on the window, then the NU
// post-sweeps (ws reversed) give z on the tile, pinned to 0 where D <= 0
// when matrix-free; partials of <r_new, z>.
template <typename T, int NU, bool MF>
__global__ void __launch_bounds__(THREADS)
tile_z_kernel(Fine2<T> f, const T* r0, const T* r1,
              const T* __restrict__ ebuf, const T* __restrict__ ec, T over,
              T* __restrict__ zbuf, CgState<T> s, WK ws) {
  __shared__ double sh[THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  constexpr int H = NU;
  using RG = Reg<H>;
  T* sp = reinterpret_cast<T*>(smem_raw);
  const Coef2<T, H, MF> co(sp);
  T* ss = sp + co.elems();               // e, then the sweeps' ping-pong
  T* rs = ss + RG::N;
  T* es = rs + RG::N;                    // (NU >= 2)
  const int ny = f.ny, nx = f.nx;
  const size_t off = (size_t)b * ny * nx;
  const TileAt t(nx);
  const T* rnew = (s.par[b] ? r0 : r1) + off;
  const int nxc = nx / 2;
  const T* cb = ec + (size_t)b * (ny / 2) * nxc;
  stage<H>(ss, ebuf + off, t.i0, t.j0, ny, nx);
  stage<H>(rs, rnew, t.i0, t.j0, ny, nx);
  co.stage(f, off, t.i0, t.j0);
  cp_async_wait();
  co.rebuild(f, t.i0, t.j0);
  for_cells<H, H>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    ss[e] = ss[e] + over * cb[(size_t)(gi >> 1) * nxc + (gj >> 1)];
  });
  __syncthreads();
  const T* di = co.di;
  // sweeps 1..NU-1 ping-pong ss -> es -> ss ...
  for (int sw = 1; sw < NU; ++sw) {
    const T* src = (sw & 1) ? ss : es;
    T* dst = (sw & 1) ? es : ss;
    const double wd = ws.w[NU - sw];
    const T w = (T)wd, omw = (T)(1.0 - wd);
    auto sv = [&](int e) { return src[e]; };
    for_ring<H>(H - sw, t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
      const T nb = nbsum_s<RG::W>(co.aw, co.an, sv, e, gi, gj, ny, nx);
      dst[e] = omw * src[e] + (w * (rs[e] + nb)) * di[e];
    });
    __syncthreads();
  }
  const T* src = ((NU - 1) & 1) ? es : ss;
  auto sv = [&](int e) { return src[e]; };
  const T w = (T)ws.w[0], omw = (T)(1.0 - ws.w[0]);
  double acc = 0.0;
  for_cells<H, 0>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    const size_t g = off + (size_t)gi * nx + gj;
    const T nb = nbsum_s<RG::W>(co.aw, co.an, sv, e, gi, gj, ny, nx);
    T zv = omw * src[e] + (w * (rs[e] + nb)) * di[e];
    if (MF && !(f.d[g] > T(0))) zv = T(0);
    zbuf[g] = zv;
    const T prod = rs[e] * zv;
    acc += (double)prod;
  });
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0) s.part_c[(size_t)b * s.ntiles + blockIdx.x] = sum;
}

// Dynamic shared memory of each pass, in elements.
template <typename T, bool MF>
constexpr int p_elems() { return Coef2<T, 1, MF>::elems() + 2 * Reg<1>::N; }
template <typename T, int NU, bool MF>
constexpr int x_elems() {
  return Coef2<T, NU, MF>::elems() + (NU >= 3 ? 4 : 3) * Reg<NU>::N;
}
template <typename T, int NU, bool MF>
constexpr int z_elems() {
  return Coef2<T, NU, MF>::elems() + (NU >= 2 ? 3 : 2) * Reg<NU>::N;
}

// Scratch per image, in elements of `elem_bytes` (4 or 8): the three double
// partial arrays first (8-byte aligned at the start), then z, the second p
// and r, e, q, the coarse residual, e_c, the coarse tail's scratch, and
// three scalars (rz_prev, alpha, spare).
long long cg_tiled_scratch_elems(int L, const int* ny, const int* nx,
                                 int elem_bytes) {
  if (L < 2) return 0;
  const long long n0 = (long long)ny[0] * nx[0];
  const long long n1 = (long long)ny[1] * nx[1];
  return 3LL * tiles_for(ny[0], nx[0]) * (8 / elem_bytes) + 5 * n0 + n1 +
         n1 + cycle_scratch_elems(L - 1, ny + 1, nx + 1) + 3;
}

#define DEFF_TRY5(...)                         \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

template <typename T>
struct Bufs2 {
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

// The k-iteration window for one nu and coefficient mode.
template <typename T, int NU, bool MF>
cudaError_t run_window(int B, int L, const Level<T>* lv, const Fine2<T>& f,
                       const Bufs2<T>& u, CgState<T> s, const T* active,
                       int k, const double* ws_, int coarse_iters,
                       double over, cudaStream_t st) {
  static unsigned done_p = 0, done_x = 0, done_z = 0;
  const size_t sp = sizeof(T) * p_elems<T, MF>();
  const size_t sx = sizeof(T) * x_elems<T, NU, MF>();
  const size_t sz = sizeof(T) * z_elems<T, NU, MF>();
  auto kp = tile_p_kernel<T, MF>;
  auto kx = tile_x_kernel<T, NU, MF>;
  auto kz = tile_z_kernel<T, NU, MF>;
  DEFF_TRY5(allow_smem(kp, sp, &done_p));
  DEFF_TRY5(allow_smem(kx, sx, &done_x));
  DEFF_TRY5(allow_smem(kz, sz, &done_z));
  const int n0 = f.ny * f.nx;
  const dim3 tiles(s.ntiles, B), per_image(1, B);
  WK ws{};
  for (int i = 0; i < NU; ++i) ws.w[i] = ws_[i];
  if (MF) {
    const long long n = (long long)B * n0;
    const int nb = (int)((n + THREADS - 1) / THREADS < 65536
                             ? (n + THREADS - 1) / THREADS : 65536);
    DEFF_LAUNCH(pin_kernel<T><<<nb, THREADS, 0, st>>>(f.d, u.x, u.r0, u.p0,
                                                      n));
  }
  DEFF_LAUNCH(abs_parts_kernel<T><<<tiles, THREADS, 0, st>>>(
      u.r0, f.ny, f.nx, s.part_b, s.ntiles));
  WindowExit wx(st);
  DEFF_TRY5(wx.status());
  s.any = wx.slot(0);
  DEFF_LAUNCH(fin_init_kernel<T><<<per_image, THREADS, 0, st>>>(s, active));
  DEFF_TRY5(wx.mark(0));
  s.any = nullptr;
  for (int i = 0; i < k; ++i) {
    bool stop_now = false;
    DEFF_TRY5(wx.stop_before(i, &stop_now));
    if (stop_now) break;
    ++g_window_iters;
    DEFF_LAUNCH(kp<<<tiles, THREADS, sp, st>>>(f, u.p0, u.p1, u.z, u.q,
                                               i == 0 ? 1 : 0, s));
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, THREADS, 0, st>>>(s));
    DEFF_LAUNCH(kx<<<tiles, THREADS, sx, st>>>(f, u.x, u.p0, u.p1, u.r0,
                                               u.r1, u.q, u.e, u.rc, s, ws));
    DEFF_TRY5(run_cycle<T>(B, L - 1, lv + 1, u.rc, u.ec, u.cyc, ws_, NU,
                           coarse_iters, over, s.live, st));
    DEFF_LAUNCH(kz<<<tiles, THREADS, sz, st>>>(f, u.r0, u.r1, u.e, u.ec,
                                               (T)over, u.z, s, ws));
    CgState<T> sl = s;
    sl.any = wx.slot(i + 1);
    DEFF_LAUNCH(fin_live_kernel<T><<<per_image, THREADS, 0, st>>>(sl));
    DEFF_TRY5(wx.mark(i + 1));
  }
  DEFF_LAUNCH(copy_back_kernel<T><<<dim3(blocks_for(n0), B), THREADS, 0,
                                    st>>>(u.r0, u.r1, u.p0, u.p1, n0, s.par));
  return cudaSuccess;
}

template <typename T, bool MF>
cudaError_t run_nu(int nu, int B, int L, const Level<T>* lv,
                   const Fine2<T>& f, const Bufs2<T>& u, CgState<T> s,
                   const T* active, int k, const double* ws,
                   int coarse_iters, double over, cudaStream_t st) {
#define DEFF_NU_CASE(N)                                                      \
  case N:                                                                    \
    return run_window<T, N, MF>(B, L, lv, f, u, s, active, k, ws,            \
                                coarse_iters, over, st);
  switch (nu) {
    DEFF_NU_CASE(1)
    DEFF_NU_CASE(2)
    DEFF_NU_CASE(3)
    DEFF_NU_CASE(4)
    DEFF_NU_CASE(5)
    DEFF_NU_CASE(6)
    default:
      return cudaErrorInvalidValue;
  }
#undef DEFF_NU_CASE
}
static_assert(MAX_NU - 2 == 6, "run_nu instantiates nu = 1..MAX_NU - 2");

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
      B > 65535 || k < 0 || nu < 1 || nu > MAX_NU - 2)
    return cudaErrorInvalidValue;
  const int py = ny[0], px = nx[0];
  if (py % 2 || px % 2 || ny[1] != py / 2 || nx[1] != px / 2)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  Fine2<T> f{};
  f.aw = lv[0].aw;
  f.an = lv[0].an;
  f.dinv = lv[0].dinv;
  f.d = static_cast<const T*>(d);
  f.fx = (T)fx;
  f.fy = (T)fy;
  f.bcf = (T)bcf;
  f.nxr = nxr;
  f.ny = py;
  f.nx = px;

  const long long n0 = (long long)py * px, n1 = (long long)ny[1] * nx[1];
  const int nt = tiles_for(py, px);
  CgState<T> s{};
  s.part_a = static_cast<double*>(scratch_);
  s.part_b = s.part_a + (size_t)B * nt;
  s.part_c = s.part_b + (size_t)B * nt;
  Bufs2<T> u{};
  u.z = reinterpret_cast<T*>(s.part_c + (size_t)B * nt);
  u.p1 = u.z + (size_t)B * n0;
  u.r1 = u.p1 + (size_t)B * n0;
  u.e = u.r1 + (size_t)B * n0;
  u.q = u.e + (size_t)B * n0;
  u.rc = u.q + (size_t)B * n0;
  u.ec = u.rc + (size_t)B * n1;
  u.cyc = u.ec + (size_t)B * n1;
  s.rz_prev = u.cyc + (size_t)B * cycle_scratch_elems(L - 1, ny + 1, nx + 1);
  s.alpha = s.rz_prev + B;
  s.rz = static_cast<T*>(rz_);
  s.stop = static_cast<const T*>(stop_);
  s.hi = static_cast<const T*>(hi_);
  s.live = static_cast<int*>(iscratch_);
  s.par = s.live + B;
  s.k_done = static_cast<int*>(k_done_);
  s.ntiles = nt;
  u.x = static_cast<T*>(x_);
  u.r0 = static_cast<T*>(r_);
  u.p0 = static_cast<T*>(p_);
  const T* active = static_cast<const T*>(active_);
  if (f.d == nullptr)
    return run_nu<T, false>(nu, B, L, lv, f, u, s, active, k, ws,
                            coarse_iters, over, st);
  return run_nu<T, true>(nu, B, L, lv, f, u, s, active, k, ws, coarse_iters,
                         over, st);
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
