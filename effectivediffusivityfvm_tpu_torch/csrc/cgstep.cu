// K1: up to k multigrid-preconditioned CG iterations per image, then the
// true-residual refresh and restart, as one host loop of batch-wide
// launches on one stream (no host synchronisation inside the window).
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/cgstep_vmem.py
// (cg_steps_pallas(refresh=True) / _kernel).  The TPU kernel kept one
// image's CG state and pyramid resident in VMEM for a whole window; on
// Hopper an image's state (~14 MiB at 512^2 fp32) does not fit an SM, so
// each step is a batch-wide pass over 64x16 tiles (blockIdx = (tile,
// image)), every tile staged in shared memory with a halo by cp.async.
//
// What bounds it on an H100: memory bandwidth, so the design is about the
// bytes a cell crosses HBM with per iteration.  Level 0's CG updates are
// fused with the cycle's level-0 work into three tile passes:
//   P  p = z + beta p_old, recomputed on the tile and a 1-cell halo; q = A p
//      and partials of <p, q>.  Reads z, p_old, a_w, a_n, diag_inv; writes
//      p, q (28 B/cell fp32).
//   X  after alpha: x += alpha p; r_new = r - alpha q on the tile and a
//      2-cell halo; the two pre-sweeps e (pre_first's form: e0 = w0 dinv r
//      recomputed where the second sweep reads it) on the tile and a 1-cell
//      halo; the residual r_new - A e and its 2x2 restriction.  Reads x, p,
//      r, q, a_w, a_n, diag_inv; writes x, r_new, e and the quarter plane
//      (41 B/cell).
//   .  the cycle's levels >= 1 (vcycle.cuh, cycle_from(l0 = 1), shared with
//      K2) on the restricted residual.
//   Z  the first post-sweep with the prolongation e + over P e_c recomputed
//      on the tile and a 1-cell halo, the second sweep on the tile, then z
//      and partials of <r, z> and sum|r|.  Reads e, e_c, r, a_w, a_n,
//      diag_inv; writes z (25 B/cell).
// That is 94 B/cell at level 0 an iteration (the eight passes this
// replaces moved 154), plus K2's levels from 1 (~15 at 512^2: two tile
// passes a level above the resident bottom).  V(1,1) fuses the same
// way with one sweep each side; for nu > 2 the passes do the first two
// pre-sweeps and the last two post-sweeps, and K2's smooth, residual-
// restriction and prolongation kernels do the rest.  A one-level hierarchy
// runs pass X's updates, K2's whole cycle and pass Z's dot products.
//
// The arithmetic is K2's (vcycle_vmem's form: w dinv folded, the diagonal
// rebuilt as 1/diag_inv) and the plain version's, operation for operation
// and with FMA contraction off, so x, r and p equal the plain version's
// wherever the double sums round to the same T.
//
// Reductions: products are formed in T, accumulated in double over a tile
// in a fixed order, one partial per tile and image; a one-block-per-image
// finalize kernel sums an image's partials in a fixed order (no float
// atomics, so iteration counts do not change from run to run) and computes
// alpha, beta, rz and the image's live flag on the device.
//
// Per-image control: `live` is i < k && stop < sum|r| < hi, recomputed on
// the device after every iteration; every pass of an image whose flag is 0
// returns at once, so an image that exited early, or a frozen one
// (active <= 0), moves no data.  p and r ping-pong between the caller's
// planes and scratch planes (a tile's halo must read the old values), and
// the refresh writes the caller's r and p for every active image.
#include "tile2d.cuh"
#include "window.cuh"

namespace deff {
namespace {

constexpr int CW = TX / 2 + 2;           // coarse region of a tile: one
constexpr int CN = CW * (TY / 2 + 2);    // coarse cell around it

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

// Fixed-order sum of one image's per-tile partials.
__device__ double sum_parts(const double* part, int nt, double* sh) {
  double acc = 0.0;
  for (int j = threadIdx.x; j < nt; j += THREADS) acc += part[j];
  return block_sum(acc, sh);
}

template <typename T>
__global__ void set_act_kernel(const T* active, int* act, int* it, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  act[b] = active[b] > T(0) ? 1 : 0;
  it[b] = 0;
}

// ---- pass P: MODE 0 q = A p (p as given, the window's first iteration);
// MODE 1 p = z + beta p_old, q = A p; both write partials of <p, q>.
// MODE 2 (the refresh): out = b - A x.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
pass_p_kernel(Level<T> lv, const T* __restrict__ v_in,
              const T* __restrict__ z, const T* __restrict__ b,
              const T* __restrict__ beta, T* __restrict__ p_out,
              T* __restrict__ q, double* part, int ntiles, const int* flag) {
  __shared__ double sh[THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  using RG = Reg<1>;
  T* vs = reinterpret_cast<T*>(smem_raw);
  T* aws = vs + RG::N;
  T* ans = aws + RG::N;
  T* dis = ans + RG::N;
  T* zs = dis + RG::N;                   // MODE 1 only
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const TileAt t(nx);
  stage<1>(vs, v_in + off, t.i0, t.j0, ny, nx);
  stage<1>(aws, lv.aw + off, t.i0, t.j0, ny, nx);
  stage<1>(ans, lv.an + off, t.i0, t.j0, ny, nx);
  stage<1>(dis, lv.dinv + off, t.i0, t.j0, ny, nx);
  if (MODE == 1) stage<1>(zs, z + off, t.i0, t.j0, ny, nx);
  cp_async_wait();
  if (MODE == 1) {
    const T bt = beta[blockIdx.y];
    for (int e = threadIdx.x; e < RG::N; e += THREADS)
      vs[e] = zs[e] + bt * vs[e];
    __syncthreads();
  }
  auto v = [&](int e) { return vs[e]; };
  double acc = 0.0;
  for_cells<1, 0>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    const size_t c = off + (size_t)gi * nx + gj;
    const T av = diag_of(dis[e]) * vs[e] -
                 nbsum_s<RG::W>(aws, ans, v, e, gi, gj, ny, nx);
    if (MODE == 2) {
      p_out[c] = b[c] - av;
    } else {
      q[c] = av;
      if (MODE == 1) p_out[c] = vs[e];
      const T prod = vs[e] * av;
      acc += (double)prod;
    }
  });
  if (MODE == 2) return;
  const double s = block_sum(acc, sh);
  if (threadIdx.x == 0) part[(size_t)blockIdx.y * ntiles + blockIdx.x] = s;
}

// ---- pass X: x += alpha p, r_new = r - alpha q, then SWEEPS (0, 1 or 2)
// pre-sweeps into e and, if RESTRICT, the residual r_new - A e restricted
// 2x2 into rc (level 1, nyc x nxc).
template <int SWEEPS, bool RESTRICT>
struct XHalo {
  static constexpr int H =
      SWEEPS + (RESTRICT ? 1 : 0) - 1 > 0 ? SWEEPS + (RESTRICT ? 1 : 0) - 1
                                          : 0;
};

template <typename T, int SWEEPS, bool RESTRICT>
__global__ void __launch_bounds__(THREADS)
pass_x_kernel(Level<T> lv, int nyc, int nxc, T* __restrict__ x,
              const T* __restrict__ p, const T* __restrict__ r,
              const T* __restrict__ q, T* __restrict__ r_new,
              T* __restrict__ e_out, T* __restrict__ rc,
              const T* __restrict__ alpha, T w0, T w1, T omw1,
              const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  constexpr int H = XHalo<SWEEPS, RESTRICT>::H;
  using RG = Reg<H>;
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* qs = rs + RG::N;
  T* aws = qs + RG::N;
  T* ans = aws + RG::N;
  T* dis = ans + RG::N;
  T* e1 = dis + RG::N;                   // SWEEPS == 2 only
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const TileAt t(nx);
  stage<H>(rs, r + off, t.i0, t.j0, ny, nx);
  stage<H>(qs, q + off, t.i0, t.j0, ny, nx);
  if (SWEEPS > 0 || RESTRICT) {
    stage<H>(aws, lv.aw + off, t.i0, t.j0, ny, nx);
    stage<H>(ans, lv.an + off, t.i0, t.j0, ny, nx);
    stage<H>(dis, lv.dinv + off, t.i0, t.j0, ny, nx);
  }
  cp_async_wait();
  const T a = alpha[blockIdx.y];
  for (int e = threadIdx.x; e < RG::N; e += THREADS) rs[e] = rs[e] - a * qs[e];
  __syncthreads();
  auto e0 = [&](int e) { return (w0 * dis[e]) * rs[e]; };
  if constexpr (SWEEPS == 2) {
    for_cells<H, H - 1>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
      const T nb = nbsum_s<RG::W>(aws, ans, e0, e, gi, gj, ny, nx);
      e1[e] = omw1 * e0(e) + (rs[e] + nb) * (w1 * dis[e]);
    });
    __syncthreads();
  }
  auto ev = [&](int e) { return SWEEPS == 2 ? e1[e] : e0(e); };
  for_cells<H, 0>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    const size_t c = off + (size_t)gi * nx + gj;
    x[c] = x[c] + a * p[c];
    r_new[c] = rs[e];
    if (SWEEPS > 0) e_out[c] = ev(e);
  });
  if (!RESTRICT) return;
  const int I = t.i0 / 2 + threadIdx.x / (TX / 2);
  const int J = t.j0 / 2 + threadIdx.x % (TX / 2);
  if (2 * I >= ny || 2 * J >= nx) return;  // beyond the grid: stays 0
  auto res = [&](int gi, int gj) {
    const int e = (gi - t.i0 + H) * RG::W + (gj - t.j0 + H);
    return rs[e] - (diag_of(dis[e]) * ev(e) -
                    nbsum_s<RG::W>(aws, ans, ev, e, gi, gj, ny, nx));
  };
  const int i = 2 * I, j = 2 * J;
  rc[(size_t)blockIdx.y * nyc * nxc + (size_t)I * nxc + J] =
      (res(i, j) + res(i + 1, j)) + (res(i, j + 1) + res(i + 1, j + 1));
}

// ---- pass Z: src = e (+ over P e_c if PROLONG); SWEEPS (0, 1 or 2) post-
// sweeps with weights wa then wb give z (SWEEPS == 0: z = src, not
// written); partials of <r, z> (if part_rz) and sum|r|.
template <typename T, bool PROLONG, int SWEEPS>
__global__ void __launch_bounds__(THREADS)
pass_z_kernel(Level<T> lv, int nyc, int nxc, const T* __restrict__ es,
              const T* __restrict__ ec, T over, const T* __restrict__ r,
              T* __restrict__ z, T wa, T omwa, T wb, T omwb, double* part_rz,
              double* part_abs, int ntiles, const int* flag) {
  __shared__ double sh[THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  constexpr int H = SWEEPS;
  using RG = Reg<H>;
  T* ss = reinterpret_cast<T*>(smem_raw);
  T* rs = ss + RG::N;
  T* aws = rs + RG::N;
  T* ans = aws + RG::N;
  T* dis = ans + RG::N;
  T* s1 = dis + RG::N;                   // SWEEPS == 2
  T* ecs = s1 + (SWEEPS == 2 ? RG::N : 0);  // PROLONG
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const TileAt t(nx);
  const int ci0 = t.i0 / 2 - 1, cj0 = t.j0 / 2 - 1;
  stage<H>(ss, es + off, t.i0, t.j0, ny, nx);
  stage<H>(rs, r + off, t.i0, t.j0, ny, nx);
  if (SWEEPS > 0) {
    stage<H>(aws, lv.aw + off, t.i0, t.j0, ny, nx);
    stage<H>(ans, lv.an + off, t.i0, t.j0, ny, nx);
    stage<H>(dis, lv.dinv + off, t.i0, t.j0, ny, nx);
  }
  if (PROLONG) {
    const T* cb = ec + (size_t)blockIdx.y * nyc * nxc;
    for (int e = threadIdx.x; e < CN; e += THREADS) {
      const int a = e / CW, bcol = e - a * CW;
      const int I = ci0 + a, J = cj0 + bcol;
      const bool ok = I >= 0 && I < nyc && J >= 0 && J < nxc;
      cp_async(ecs + e, ok ? cb + (size_t)I * nxc + J : cb, ok);
    }
  }
  cp_async_wait();
  if constexpr (PROLONG) {
    for_cells<H, H>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
      ss[e] = ss[e] + over * ecs[((gi >> 1) - ci0) * CW + ((gj >> 1) - cj0)];
    });
    __syncthreads();
  }
  auto sv = [&](int e) { return ss[e]; };
  auto s1v = [&](int e) { return s1[e]; };
  if constexpr (SWEEPS == 2) {
    for_cells<H, 1>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
      const T nb = nbsum_s<RG::W>(aws, ans, sv, e, gi, gj, ny, nx);
      s1[e] = omwa * ss[e] + (rs[e] + nb) * (wa * dis[e]);
    });
    __syncthreads();
  }
  double arz = 0.0, aab = 0.0;
  for_cells<H, 0>(t.i0, t.j0, ny, nx, [&](int e, int gi, int gj) {
    T zc;
    if (SWEEPS == 2) {
      const T nb = nbsum_s<RG::W>(aws, ans, s1v, e, gi, gj, ny, nx);
      zc = omwb * s1[e] + (rs[e] + nb) * (wb * dis[e]);
    } else if (SWEEPS == 1) {
      const T nb = nbsum_s<RG::W>(aws, ans, sv, e, gi, gj, ny, nx);
      zc = omwa * ss[e] + (rs[e] + nb) * (wa * dis[e]);
    } else {
      zc = ss[e];
    }
    if (SWEEPS > 0) z[off + (size_t)gi * nx + gj] = zc;
    const T rv = rs[e];
    if (part_rz != nullptr) {
      const T prod = rv * zc;
      arz += (double)prod;
    }
    aab += (double)(rv < T(0) ? -rv : rv);
  });
  const size_t slot = (size_t)blockIdx.y * ntiles + blockIdx.x;
  if (part_rz != nullptr) {
    const double s = block_sum(arz, sh);
    if (threadIdx.x == 0) part_rz[slot] = s;
  }
  const double s = block_sum(aab, sh);
  if (threadIdx.x == 0) part_abs[slot] = s;
}

// ---- per-image finalize kernels: grid (1, B), one block per image ----

template <typename T>
__global__ void fin_init_kernel(const double* part_abs, int nt,
                                const int* act, int* live, const T* stop,
                                const T* hi, int k, int* any) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!act[b]) {
    if (threadIdx.x == 0) live[b] = 0;
    return;
  }
  const T sr = (T)sum_parts(part_abs + (size_t)b * nt, nt, sh);
  const bool lv = 0 < k && sr > stop[b] && sr < hi[b];
  if (threadIdx.x == 0) live[b] = lv;
  mark_live(any, lv);
}

template <typename T>
__global__ void fin_alpha_kernel(const double* part, int nt, const T* rz,
                                 T* alpha, const int* live) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!live[b]) return;
  const T pap = (T)sum_parts(part + (size_t)b * nt, nt, sh);
  if (threadIdx.x == 0) alpha[b] = pap > T(0) ? rz[b] / pap : T(0);
}

template <typename T>
__global__ void fin_beta_kernel(const double* part_rz, const double* part_abs,
                                int nt, T* rz, T* beta, int* it, int* live,
                                const T* stop, const T* hi, int k, int* any) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!live[b]) return;
  const T rzn = (T)sum_parts(part_rz + (size_t)b * nt, nt, sh);
  const T sr = (T)sum_parts(part_abs + (size_t)b * nt, nt, sh);
  if (threadIdx.x == 0) {
    const T rzo = rz[b];
    beta[b] = rzo > T(0) ? rzn / rzo : T(0);
    rz[b] = rzn;
    const int i = it[b] + 1;
    it[b] = i;
    const bool lv = i < k && sr > stop[b] && sr < hi[b];
    live[b] = lv;
    mark_live(any, lv);
  }
}

template <typename T>
__global__ void fin_refresh_kernel(const double* part_rz,
                                   const double* part_abs, int nt,
                                   const int* act, const int* it, T* rz,
                                   T* sr_true, int* k_done) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!act[b]) {
    if (threadIdx.x == 0) { sr_true[b] = T(0); k_done[b] = 0; }
    return;
  }
  const T rzv = (T)sum_parts(part_rz + (size_t)b * nt, nt, sh);
  const T sr = (T)sum_parts(part_abs + (size_t)b * nt, nt, sh);
  if (threadIdx.x == 0) {
    rz[b] = rzv;
    sr_true[b] = sr;
    k_done[b] = it[b];
  }
}

// Dynamic shared memory of each tile pass, in elements.
template <int MODE>
constexpr int p_smem() { return (MODE == 1 ? 5 : 4) * Reg<1>::N; }
template <int SWEEPS, bool RESTRICT>
constexpr int x_smem() {
  return (SWEEPS == 2 ? 6 : 5) * Reg<XHalo<SWEEPS, RESTRICT>::H>::N;
}
template <bool PROLONG, int SWEEPS>
constexpr int z_smem() {
  return (SWEEPS == 2 ? 6 : 5) * Reg<SWEEPS>::N + (PROLONG ? CN : 0);
}

// Scratch per image in elements of `elem_bytes` (4 or 8): three double
// partial arrays first (8-byte aligned at the start), then q, z, the second
// p and r planes, level 1's correction, the cycle's scratch, alpha, beta.
long long cg_scratch_elems(int L, const int* ny, const int* nx,
                           int elem_bytes) {
  const long long n0 = (long long)ny[0] * nx[0];
  const long long n1 = L > 1 ? (long long)ny[1] * nx[1] : 0;
  return 3LL * tiles_for(ny[0], nx[0]) * (8 / elem_bytes) + 4 * n0 + n1 +
         cycle_scratch_elems(L, ny, nx) + 2;
}

// Launches of the tile passes: grid (tiles, images), THREADS a block, the
// dynamic shared memory each pass stages.
template <typename T>
struct Launch {
  int nt;
  dim3 tiles, blk;
  cudaStream_t st;
  Level<T> l0;

  template <int MODE>
  cudaError_t pass_p(const T* v, const T* z, const T* b, const T* beta,
                     T* p_out, T* q, double* part, const int* flag) {
    static unsigned done = 0;
    const size_t sm = sizeof(T) * p_smem<MODE>();
    auto kern = pass_p_kernel<T, MODE>;
    cudaError_t e = allow_smem(kern, sm, &done);
    if (e != cudaSuccess) return e;
    DEFF_LAUNCH(kern<<<tiles, blk, sm, st>>>(l0, v, z, b, beta, p_out, q,
                                              part, nt, flag));
    return cudaSuccess;
  }

  template <int SWEEPS, bool RESTRICT>
  cudaError_t pass_x(int nyc, int nxc, T* x, const T* p, const T* r,
                     const T* q, T* r_new, T* e_out, T* rc, const T* alpha,
                     const double* ws, int nu, const int* flag) {
    static unsigned done = 0;
    const size_t sm = sizeof(T) * x_smem<SWEEPS, RESTRICT>();
    auto kern = pass_x_kernel<T, SWEEPS, RESTRICT>;
    cudaError_t e = allow_smem(kern, sm, &done);
    if (e != cudaSuccess) return e;
    const double w1 = nu > 1 ? ws[1] : 0.0;
    DEFF_LAUNCH(kern<<<tiles, blk, sm, st>>>(
        l0, nyc, nxc, x, p, r, q, r_new, e_out, rc, alpha, (T)ws[0], (T)w1,
        (T)(1.0 - w1), flag));
    return cudaSuccess;
  }

  template <bool PROLONG, int SWEEPS>
  cudaError_t pass_z(int nyc, int nxc, const T* es, const T* ec, double over,
                     const T* r, T* z, double wa, double wb, double* part_rz,
                     double* part_abs, const int* flag) {
    static unsigned done = 0;
    const size_t sm = sizeof(T) * z_smem<PROLONG, SWEEPS>();
    auto kern = pass_z_kernel<T, PROLONG, SWEEPS>;
    cudaError_t e = allow_smem(kern, sm, &done);
    if (e != cudaSuccess) return e;
    DEFF_LAUNCH(kern<<<tiles, blk, sm, st>>>(
        l0, nyc, nxc, es, ec, (T)over, r, z, (T)wa, (T)(1.0 - wa), (T)wb,
        (T)(1.0 - wb), part_rz, part_abs, nt, flag));
    return cudaSuccess;
  }
};

#define DEFF_TRY(...)                          \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

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
  if (!fill_levels<T>(L, ny, nx, aw, an, dinv, lv) || B < 1 || B > 65535 ||
      k < 0 || nu < 1 || (ny[0] | nx[0]) & 1)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* rhs = static_cast<const T*>(b_);
  T* x = static_cast<T*>(x_);
  T* rz = static_cast<T*>(rz_);
  const T* active = static_cast<const T*>(active_);
  const T* stop = static_cast<const T*>(stop_);
  const T* hi = static_cast<const T*>(hi_);

  const long long n0 = (long long)ny[0] * nx[0];
  const int nyc = L > 1 ? ny[1] : 0, nxc = L > 1 ? nx[1] : 0;
  const long long n1 = (long long)nyc * nxc;
  const int nt = tiles_for(ny[0], nx[0]);
  double* part_a = static_cast<double*>(scratch_);   // <p, q>
  double* part_b = part_a + (size_t)B * nt;          // sum|r|
  double* part_c = part_b + (size_t)B * nt;          // <r, z>
  T* q = reinterpret_cast<T*>(part_c + (size_t)B * nt);
  T* z = q + (size_t)B * n0;
  T* P[2] = {static_cast<T*>(p_), z + (size_t)B * n0};
  T* R[2] = {static_cast<T*>(r_), P[1] + (size_t)B * n0};
  T* ecb = R[1] + (size_t)B * n0;                    // level 1's correction
  T* cyc = ecb + (size_t)B * n1;
  T* alpha = cyc + (size_t)B * cycle_scratch_elems(L, ny, nx);
  T* beta = alpha + B;
  // the cycle scratch's level-0 planes and level-1 residual (cycle_from)
  T* E0 = cyc;
  T* F0 = cyc + (size_t)B * n0;
  T* R1 = cyc + 2 * (size_t)B * n0;
  int* act = static_cast<int*>(iscratch_);
  int* live = act + B;
  int* it = live + B;

  Launch<T> go{nt, dim3(nt, B), dim3(THREADS), st, lv[0]};
  const dim3 blk(THREADS), per_image(1, B);
  const bool fused = L > 1 && nu <= 2;
  // pass X writes the coarse cells under the fine grid; those past it
  // (level 1's even padding) stay 0 for the whole call
  if (fused) DEFF_TRY(cudaMemsetAsync(R1, 0, sizeof(T) * B * n1, st));
  DEFF_LAUNCH(set_act_kernel<T><<<(B + THREADS - 1) / THREADS, blk, 0, st>>>(
      active, act, it, B));
  DEFF_TRY(go.template pass_z<false, 0>(0, 0, R[0], nullptr, 0.0, R[0],
                                        nullptr, 0.0, 0.0, nullptr, part_b,
                                        act));
  WindowExit wx(st);
  DEFF_TRY(wx.status());
  DEFF_LAUNCH(fin_init_kernel<T><<<per_image, blk, 0, st>>>(
      part_b, nt, act, live, stop, hi, k, wx.slot(0)));
  DEFF_TRY(wx.mark(0));

  int pc = 0;                    // P[pc] holds the current p
  for (int i = 0; i < k; ++i) {
    bool stop_now = false;
    DEFF_TRY(wx.stop_before(i, &stop_now));
    if (stop_now) break;
    ++g_window_iters;
    T* r_cur = R[i & 1];
    T* r_nxt = R[(i & 1) ^ 1];
    if (i == 0) {
      DEFF_TRY(go.template pass_p<0>(P[0], nullptr, nullptr, nullptr,
                                     nullptr, q, part_a, live));
    } else {
      DEFF_TRY(go.template pass_p<1>(P[pc], z, nullptr, beta, P[pc ^ 1], q,
                                     part_a, live));
      pc ^= 1;
    }
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, blk, 0, st>>>(
        part_a, nt, rz, alpha, live));
    const T* p = P[pc];
    if (fused && nu == 2) {
      DEFF_TRY(go.template pass_x<2, true>(nyc, nxc, x, p, r_cur, q, r_nxt,
                                           E0, R1, alpha, ws, nu, live));
      DEFF_TRY(cycle_from<T>(B, L, lv, 1, R1, ecb, cyc, ws, nu, coarse_iters,
                             over, live, st));
      DEFF_TRY(go.template pass_z<true, 2>(nyc, nxc, E0, ecb, over, r_nxt, z,
                                           ws[1], ws[0], part_c, part_b,
                                           live));
    } else if (fused) {
      DEFF_TRY(go.template pass_x<1, true>(nyc, nxc, x, p, r_cur, q, r_nxt,
                                           E0, R1, alpha, ws, nu, live));
      DEFF_TRY(cycle_from<T>(B, L, lv, 1, R1, ecb, cyc, ws, nu, coarse_iters,
                             over, live, st));
      DEFF_TRY(go.template pass_z<true, 1>(nyc, nxc, E0, ecb, over, r_nxt, z,
                                           ws[0], 0.0, part_c, part_b,
                                           live));
    } else if (L > 1) {
      // nu > 2: the passes take the first two pre-sweeps and the last two
      // post-sweeps; K2's level kernels the rest, as in its cycle
      DEFF_TRY(go.template pass_x<2, false>(nyc, nxc, x, p, r_cur, q, r_nxt,
                                            E0, nullptr, alpha, ws, nu,
                                            live));
      const dim3 cells(blocks_for(n0), B);
      T* cur = E0;
      T* oth = F0;
      for (int s = 2; s < nu; ++s) {
        DEFF_LAUNCH(smooth_kernel<T><<<cells, blk, 0, st>>>(
            lv[0], cur, r_nxt, oth, (T)ws[s], (T)(1.0 - ws[s]), live));
        T* tmp = cur; cur = oth; oth = tmp;
      }
      DEFF_LAUNCH(resid_restrict_kernel<T><<<dim3(blocks_for(n1), B), blk, 0,
                                             st>>>(lv[0], r_nxt, cur, R1, nyc,
                                                   nxc, live));
      DEFF_TRY(cycle_from<T>(B, L, lv, 1, R1, ecb, cyc, ws, nu, coarse_iters,
                             over, live, st));
      T* bufs[2] = {oth, cur};
      T* dst = bufs[0];
      DEFF_LAUNCH(post_first_kernel<T><<<cells, blk, 0, st>>>(
          lv[0], cur, ecb, nyc, nxc, (T)over, r_nxt, dst, (T)ws[nu - 1],
          (T)(1.0 - ws[nu - 1]), live));
      for (int s = 1; s < nu - 2; ++s) {
        T* src = dst;
        dst = bufs[s & 1];
        const double w = ws[nu - 1 - s];
        DEFF_LAUNCH(smooth_kernel<T><<<cells, blk, 0, st>>>(
            lv[0], src, r_nxt, dst, (T)w, (T)(1.0 - w), live));
      }
      DEFF_TRY(go.template pass_z<false, 2>(nyc, nxc, dst, nullptr, 0.0,
                                            r_nxt, z, ws[1], ws[0], part_c,
                                            part_b, live));
    } else {
      // one level: the cycle is the coarse solve on level 0
      DEFF_TRY(go.template pass_x<0, false>(0, 0, x, p, r_cur, q, r_nxt,
                                            nullptr, nullptr, alpha, ws, nu,
                                            live));
      DEFF_TRY(run_cycle<T>(B, L, lv, r_nxt, z, cyc, ws, nu, coarse_iters,
                            over, live, st));
      DEFF_TRY(go.template pass_z<false, 0>(0, 0, z, nullptr, 0.0, r_nxt,
                                            nullptr, 0.0, 0.0, part_c,
                                            part_b, live));
    }
    DEFF_LAUNCH(fin_beta_kernel<T><<<per_image, blk, 0, st>>>(
        part_c, part_b, nt, rz, beta, it, live, stop, hi, k,
        wx.slot(i + 1)));
    DEFF_TRY(wx.mark(i + 1));
  }

  // refresh + restart for every active image, into the caller's r and p:
  // r = b - A x, p = z = M r
  DEFF_TRY(go.template pass_p<2>(x, nullptr, rhs, nullptr, R[0], nullptr,
                                 nullptr, act));
  DEFF_TRY(run_cycle<T>(B, L, lv, R[0], P[0], cyc, ws, nu, coarse_iters,
                        over, act, st));
  DEFF_TRY(go.template pass_z<false, 0>(0, 0, P[0], nullptr, 0.0, R[0],
                                        nullptr, 0.0, 0.0, part_c, part_b,
                                        act));
  DEFF_LAUNCH(fin_refresh_kernel<T><<<per_image, blk, 0, st>>>(
      part_c, part_b, nt, act, it, rz, static_cast<T*>(sr_true_),
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
