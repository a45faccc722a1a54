// The DOWN and UP tile passes over one level of a 2D batch, one body each,
// shared by K2 (vcycle.cu: every level above the resident bottom), K4
// (vcycle_tiled.cu: the banded cycle's T1 and T2) and K8
// (vcycle_sharded.cu: T1 and T2 on every shard of a mesh row):
//
//   DOWN  a tile of the level and a halo of HS cells (nu rounded up to
//         even, so that the window is made of whole 2x2 blocks and each
//         block lies on one coarse cell) staged in shared memory by
//         cp.async (r, a_w, a_n, diag_inv); each thread owns 2x2 blocks of
//         the window with their coefficients and values in registers, so a
//         stencil reads two neighbours from shared memory and two from its
//         own block.  e0 = w0 dinv r and the nu - 1 sweeps on the window
//         (sweep s valid on the halo of HS - s), then the residual r - A e
//         and its 2x2 restriction inside each block of the tile.  Writes e
//         and the quarter plane.
//   UP    e, r, the coefficients and the coarse correction under the
//         window (one coarse cell a block) staged; the prolongation
//         e + over P e_c in registers, then the nu post-sweeps, the last on
//         the tile.  Writes the correction.
//
// Two compile-time choices:
//
//   the sweep form: K2's (1 - w) v + (r + nbsum(v)) (w dinv)
//     (vcycle_vmem's folded form), or the banded and sharded engines'
//     (1 - w) v + (w (r + nbsum(v))) dinv (_smooth_w);
//   the loader: a level plane of an image (PlaneIn: rows and columns off
//     the plane read as 0, and the stencil skips the terms across the
//     grid's edges, as K2's plain version's zero-padded shifts make them
//     0), or a row shard (RowsIn: the rows above and below come from the
//     neighbours' planes, read in place or from exchanged strips, and read
//     as 0 past the global top and bottom; a cell there has zero
//     coefficients and stays 0 through every sweep, so the stencil takes
//     every term on the window).
//
// A tile recomputes its halo's values in the plain version's order, as the
// neighbouring tile (or shard) computes them for its own cells, so every
// tile agrees with the plain version bit for bit.  The passes reach
// ~1.8-2 TB/s of their bytes on an H100 (PERF.md); a first design that read
// every stencil operand from shared memory (~35 accesses a cell against
// the 2x2 blocks' ~15) and a 32x32 window reached ~1.6.
#pragma once

#include <type_traits>

#include "vcycle.cuh"

namespace deff {
namespace lp {
namespace {

constexpr int LT_THREADS = 256;         // threads of a level pass
constexpr int MAX_NU = 8;               // sweeps a leg the passes take

enum Form { K2_FORM = 0, BANDED_FORM = 1 };

// The window of a level pass: the tile and a halo of HS cells, two 2x2
// blocks a thread.  For nu <= 2 a 64x32 window around a 60x28 tile: of the
// shapes tried on the card (32x32, 64x16, 64x32, 96x32, 128x16; 192 to 512
// threads) the fastest at B=512 x 512^2, its rows long enough for full DRAM
// bursts and its halo a fifth of the tile.
template <int NU>
struct Geo {
  static constexpr int HS = 2 * ((NU + 1) / 2);
  static constexpr int WX = HS <= 2 ? 64 : 48;     // window width
  static constexpr int WY = HS <= 2 ? 32 : 48;     // window height
  static constexpr int TX = WX - 2 * HS, TY = WY - 2 * HS;  // the tile
  static constexpr int N = WX * WY;
  static constexpr int BX = WX / 2, BY = WY / 2, NB = BX * BY;  // 2x2 blocks
  static constexpr int PER = (NB + LT_THREADS - 1) / LT_THREADS;
};

// Dynamic shared memory of the passes, in elements.
template <int NU>
constexpr int down_elems() { return 6 * Geo<NU>::N; }
template <int NU>
constexpr int up_elems() { return 6 * Geo<NU>::N + Geo<NU>::NB; }

// The damping factors of one leg in T: w and 1 - w (taken in double, as the
// plain version's Python floats are, then rounded).
template <typename T>
struct Sweeps {
  T w[MAX_NU];
  T omw[MAX_NU];
  int nu;
};

template <typename T>
Sweeps<T> make_sweeps(const double* ws, int nu) {
  Sweeps<T> s{};
  s.nu = nu;
  for (int i = 0; i < nu && i < MAX_NU; ++i) {
    s.w[i] = (T)ws[i];
    s.omw[i] = (T)(1.0 - ws[i]);
  }
  return s;
}

// One image's level plane, ny x nx: at() gives cell (gi, gj)'s address in
// src and whether the plane holds it.
template <typename T>
struct PlaneIn {
  const T* p;
  int ny, nx;
  __device__ __forceinline__ bool at(int gi, int gj, const T*& src) const {
    const bool ok = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    src = ok ? p + (size_t)gi * nx + gj : p;
    return ok;
  }
};

// One image's rows of a row shard, ny x nx: rows 0..ny-1 from body, row
// -k from north - k nx (north points one row past the last row above the
// shard), row ny + k from south + k nx, for k <= lim; nullptr past the
// global top or bottom (north or south null), beyond lim rows (a tile may
// reach past the neighbour's rows; the rows a pass needs exactly are the
// HS next to the shard, HS / 2 on a coarse plane) and off the columns.
template <typename T>
struct RowsIn {
  const T* body;
  const T* north;
  const T* south;
  int ny, nx, lim;
  __device__ __forceinline__ bool at(int gi, int gj, const T*& src) const {
    src = body;
    if (gj < 0 || gj >= nx || gi < -lim || gi >= ny + lim) return false;
    if (gi < 0) {
      if (north == nullptr) return false;
      src = north + (ptrdiff_t)gi * nx + gj;
    } else if (gi < ny) {
      src = body + (size_t)gi * nx + gj;
    } else {
      if (south == nullptr) return false;
      src = south + (size_t)(gi - ny) * nx + gj;
    }
    return true;
  }
};

// Stage a window with origin (y0, x0); cells the loader does not hold read
// as 0.
template <int NU, typename T, class In>
__device__ __forceinline__ void stage(T* dst, const In& in, int y0, int x0) {
  using G = Geo<NU>;
  for (int e = threadIdx.x; e < G::N; e += LT_THREADS) {
    const int li = e / G::WX, lj = e - li * G::WX;
    const T* src;
    const bool ok = in.at(y0 + li, x0 + lj, src);
    cp_async(dst + e, src, ok);
  }
}

// A thread's 2x2 block of the window: the window index of its top-left
// cell, its level row and column, and the coefficients and right-hand side
// of its four cells ([row][column]) in registers, with a_w east of its
// right column and a_n south of its bottom row.
template <typename T>
struct Quad {
  int e, gi, gj, bi, bj;
  bool on;                       // the block index lies inside the window
  T aw[2][2], an[2][2], di[2][2], r[2][2];
  T awe[2], ans[2];
};

template <int NU, typename T>
__device__ __forceinline__ void load_quad(Quad<T>& k, int q, int y0, int x0,
                                          const T* rs, const T* aws,
                                          const T* ans, const T* dis) {
  using G = Geo<NU>;
  k.on = q < G::NB;
  k.bi = q / G::BX;
  k.bj = q - k.bi * G::BX;
  k.e = 2 * k.bi * G::WX + 2 * k.bj;
  k.gi = y0 + 2 * k.bi;
  k.gj = x0 + 2 * k.bj;
  if (!k.on) return;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int e = k.e + a * G::WX + b;
      k.aw[a][b] = aws[e];
      k.an[a][b] = ans[e];
      k.di[a][b] = dis[e];
      k.r[a][b] = rs[e];
    }
  const bool east = 2 * k.bj + 2 < G::WX, south = 2 * k.bi + 2 < G::WY;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    k.awe[a] = east ? aws[k.e + a * G::WX + 2] : T(0);
    k.ans[a] = south ? ans[k.e + 2 * G::WX + a] : T(0);
  }
}

// nbsum (vcycle.cuh) at cell (a, b) of a block whose values are v, the
// neighbours outside the block read from the window plane p: the same terms
// in the same order, the column bounds taken from the level index and the
// row bounds too when ROWCHK (a neighbour off the window reads 0; only
// cells in the invalid margin have one).
template <int NU, int A, int B, bool ROWCHK, typename T>
__device__ __forceinline__ T quad_nbsum(const Quad<T>& k, const T (&v)[2][2],
                                        const T* p, int ny, int nx) {
  constexpr int W = Geo<NU>::WX, H = Geo<NU>::WY;
  const int e = k.e + A * W + B;
  const int wi = 2 * k.bi + A, wj = 2 * k.bj + B;
  const int gi = k.gi + A, gj = k.gj + B;
  const T west = B == 1 ? v[A][0] : (wj > 0 ? p[e - 1] : T(0));
  const T east = B == 0 ? v[A][1] : (wj + 1 < W ? p[e + 1] : T(0));
  const T north = A == 1 ? v[0][B] : (wi > 0 ? p[e - W] : T(0));
  const T south = A == 0 ? v[1][B] : (wi + 1 < H ? p[e + W] : T(0));
  const T awe = B == 0 ? k.aw[A][1] : k.awe[A];
  const T ans = A == 0 ? k.an[1][B] : k.ans[B];
  T s = (gj > 0) ? k.aw[A][B] * west : T(0);
  if (gj + 1 < nx) s = s + awe * east;
  if (!ROWCHK || gi > 0) s = s + k.an[A][B] * north;
  if (!ROWCHK || gi + 1 < ny) s = s + ans * south;
  return s;
}

template <int NU, typename T>
__device__ __forceinline__ void put(T* p, const Quad<T>& k,
                                    const T (&v)[2][2]) {
  constexpr int W = Geo<NU>::WX;
  p[k.e] = v[0][0];
  p[k.e + 1] = v[0][1];
  p[k.e + W] = v[1][0];
  p[k.e + W + 1] = v[1][1];
}

// One damped-Jacobi sweep of cell (A, B) in the chosen form.
template <int NU, int A, int B, int FORM, bool ROWCHK, typename T>
__device__ __forceinline__ T sweep_cell(const Quad<T>& k, const T (&v)[2][2],
                                        const T* p, T w, T omw, int ny,
                                        int nx) {
  const T nb = quad_nbsum<NU, A, B, ROWCHK>(k, v, p, ny, nx);
  if constexpr (FORM == K2_FORM)
    return omw * v[A][B] + (k.r[A][B] + nb) * (w * k.di[A][B]);
  else
    return omw * v[A][B] + (w * (k.r[A][B] + nb)) * k.di[A][B];
}

// One damped-Jacobi sweep of a block, the neighbours read from p.
template <int NU, int FORM, bool ROWCHK, typename T>
__device__ __forceinline__ void sweep_quad(const Quad<T>& k, T (&v)[2][2],
                                           const T* p, T w, T omw, int ny,
                                           int nx) {
  T o[2][2];
  o[0][0] = sweep_cell<NU, 0, 0, FORM, ROWCHK>(k, v, p, w, omw, ny, nx);
  o[0][1] = sweep_cell<NU, 0, 1, FORM, ROWCHK>(k, v, p, w, omw, ny, nx);
  o[1][0] = sweep_cell<NU, 1, 0, FORM, ROWCHK>(k, v, p, w, omw, ny, nx);
  o[1][1] = sweep_cell<NU, 1, 1, FORM, ROWCHK>(k, v, p, w, omw, ny, nx);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) v[a][b] = o[a][b];
}

// The residual r - (diag v - nbsum(v)) of cell (A, B), diag = 1/dinv.
template <int NU, int A, int B, bool ROWCHK, typename T>
__device__ __forceinline__ T quad_res(const Quad<T>& k, const T (&v)[2][2],
                                      const T* p, int ny, int nx) {
  return k.r[A][B] - (diag_of(k.di[A][B]) * v[A][B] -
                      quad_nbsum<NU, A, B, ROWCHK>(k, v, p, ny, nx));
}

// The tiles of a DOWN pass along one axis (tile width t): they cover the
// coarse plane (t/2 coarse cells each) and the fine one.
inline int down_tiles(int t, int n, int nc) {
  const int a = (nc + t / 2 - 1) / (t / 2), b = (n + t - 1) / t;
  return a > b ? a : b;
}

template <int NU>
inline int down_ntx(int nx, int nxc) { return down_tiles(Geo<NU>::TX, nx, nxc); }
template <int NU>
inline int down_count(int ny, int nx, int nyc, int nxc) {
  return down_tiles(Geo<NU>::TY, ny, nyc) * down_ntx<NU>(nx, nxc);
}
template <int NU>
inline int up_ntx(int nx) { return (nx + Geo<NU>::TX - 1) / Geo<NU>::TX; }
template <int NU>
inline int up_count(int ny, int nx) {
  return ((ny + Geo<NU>::TY - 1) / Geo<NU>::TY) * up_ntx<NU>(nx);
}

// ---- DOWN on tile (ty, tx) of one image: e0 = w0 dinv r and nu - 1 sweeps
// on the window (sweep s valid on the tile and a halo of HS - s cells),
// then the residual restricted 2x2 into rc (the next level, nyc x nxc, row
// stride nxc; a coarse cell past the fine grid receives 0).  Each sweep's
// values go to a window plane for the neighbouring blocks, ping-ponging
// between two.  The image's e and rc planes start at e_out + eo and rc +
// co (added at the stores, so no pointer stays live across the sweeps).
template <typename T, int NU, int FORM, bool ROWCHK, class In>
__device__ __forceinline__ void down_body(
    const In& r, const In& aw, const In& an, const In& di, int ny, int nx,
    T* __restrict__ e_out, size_t eo, T* __restrict__ rc, size_t co, int nyc,
    int nxc, int ty, int tx, Sweeps<T> ws, T* smem) {
  using G = Geo<NU>;
  T* rs = smem;
  T* aws = rs + G::N;
  T* ans = aws + G::N;
  T* dis = ans + G::N;
  T* pv[2] = {dis + G::N, dis + 2 * G::N};
  const int I0 = ty * (G::TY / 2), J0 = tx * (G::TX / 2);
  const int y0 = 2 * I0 - G::HS, x0 = 2 * J0 - G::HS;
  stage<NU>(rs, r, y0, x0);
  stage<NU>(aws, aw, y0, x0);
  stage<NU>(ans, an, y0, x0);
  stage<NU>(dis, di, y0, x0);
  cp_async_wait();
  Quad<T> k[G::PER];
  T v[G::PER][2][2];
  const T w0 = ws.w[0];
#pragma unroll
  for (int p = 0; p < G::PER; ++p) {
    load_quad<NU>(k[p], threadIdx.x + p * LT_THREADS, y0, x0, rs, aws, ans,
                  dis);
    if (!k[p].on) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        v[p][a][b] = (w0 * k[p].di[a][b]) * k[p].r[a][b];
    put<NU>(pv[0], k[p], v[p]);
  }
  __syncthreads();
#pragma unroll
  for (int s = 1; s < NU; ++s) {
#pragma unroll
    for (int p = 0; p < G::PER; ++p)
      if (k[p].on)
        sweep_quad<NU, FORM, ROWCHK>(k[p], v[p], pv[(s - 1) & 1], ws.w[s],
                                     ws.omw[s], ny, nx);
#pragma unroll
    for (int p = 0; p < G::PER; ++p)
      if (k[p].on) put<NU>(pv[s & 1], k[p], v[p]);
    __syncthreads();
  }
  const T* pe = pv[(NU - 1) & 1];
  constexpr int R = G::HS / 2;                     // blocks of the halo
#pragma unroll
  for (int p = 0; p < G::PER; ++p) {
    const Quad<T>& q = k[p];
    const int tbi = q.bi - R, tbj = q.bj - R;
    if (!q.on || tbi < 0 || tbj < 0 || tbi >= G::TY / 2 || tbj >= G::TX / 2)
      continue;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (q.gi + a < ny && q.gj + b < nx)
          e_out[eo + (size_t)(q.gi + a) * nx + q.gj + b] = v[p][a][b];
    const int I = I0 + tbi, J = J0 + tbj;
    if (I >= nyc || J >= nxc) continue;
    T out = T(0);
    if (2 * I < ny && 2 * J < nx)
      out = (quad_res<NU, 0, 0, ROWCHK>(q, v[p], pe, ny, nx) +
             quad_res<NU, 1, 0, ROWCHK>(q, v[p], pe, ny, nx)) +
            (quad_res<NU, 0, 1, ROWCHK>(q, v[p], pe, ny, nx) +
             quad_res<NU, 1, 1, ROWCHK>(q, v[p], pe, ny, nx));
    rc[co + (size_t)I * nxc + J] = out;
  }
}

// ---- UP on tile (ty, tx) of one image: src = es + over ec[i/2, j/2] on
// the window (one coarse cell a block; ec is the next level, nyc x nxc),
// the nu post-sweeps in reverse weight order (sweep s valid on the tile and
// a halo of HS - s cells), the tile's correction into the image's plane at
// out + oo.
template <typename T, int NU, int FORM, bool ROWCHK, class In, class InC>
__device__ __forceinline__ void up_body(
    const In& es, const InC& ec, T over, const In& rhs, const In& aw,
    const In& an, const In& di, int ny, int nx, T* __restrict__ out,
    size_t oo, int ty, int tx, Sweeps<T> ws, T* smem) {
  using G = Geo<NU>;
  T* rs = smem;
  T* aws = rs + G::N;
  T* ans = aws + G::N;
  T* dis = ans + G::N;
  T* pv[2] = {dis + G::N, dis + 2 * G::N};
  T* ecs = dis + 3 * G::N;                         // BX x BX coarse cells
  const int y0 = ty * G::TY - G::HS, x0 = tx * G::TX - G::HS;
  const int cy0 = y0 / 2, cx0 = x0 / 2;            // y0, x0 are even
  stage<NU>(pv[1], es, y0, x0);                    // e, read once
  stage<NU>(rs, rhs, y0, x0);
  stage<NU>(aws, aw, y0, x0);
  stage<NU>(ans, an, y0, x0);
  stage<NU>(dis, di, y0, x0);
  for (int e = threadIdx.x; e < G::NB; e += LT_THREADS) {
    const int a = e / G::BX, bcol = e - a * G::BX;
    const T* src;
    const bool ok = ec.at(cy0 + a, cx0 + bcol, src);
    cp_async(ecs + e, src, ok);
  }
  cp_async_wait();
  Quad<T> k[G::PER];
  T v[G::PER][2][2];
#pragma unroll
  for (int p = 0; p < G::PER; ++p) {
    const int q = threadIdx.x + p * LT_THREADS;
    load_quad<NU>(k[p], q, y0, x0, rs, aws, ans, dis);
    if (!k[p].on) continue;
    const T c = over * ecs[q];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        v[p][a][b] = pv[1][k[p].e + a * G::WX + b] + c;
    put<NU>(pv[0], k[p], v[p]);
  }
  __syncthreads();
#pragma unroll
  for (int s = 1; s <= NU; ++s) {
#pragma unroll
    for (int p = 0; p < G::PER; ++p)
      if (k[p].on)
        sweep_quad<NU, FORM, ROWCHK>(k[p], v[p], pv[(s - 1) & 1],
                                     ws.w[NU - s], ws.omw[NU - s], ny, nx);
    if (s == NU) break;
#pragma unroll
    for (int p = 0; p < G::PER; ++p)
      if (k[p].on) put<NU>(pv[s & 1], k[p], v[p]);
    __syncthreads();
  }
  constexpr int R = G::HS / 2;
#pragma unroll
  for (int p = 0; p < G::PER; ++p) {
    const Quad<T>& q = k[p];
    const int tbi = q.bi - R, tbj = q.bj - R;
    if (!q.on || tbi < 0 || tbj < 0 || tbi >= G::TY / 2 || tbj >= G::TX / 2)
      continue;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (q.gi + a < ny && q.gj + b < nx)
          out[oo + (size_t)(q.gi + a) * nx + q.gj + b] = v[p][a][b];
  }
}

// ---- the plane passes (K2's levels, K4's T1 and T2): tile blockIdx.x of
// image blockIdx.y, gated by the image's flag.  P names the caller and its
// sweep form (the name shows in a profile).  The bodies take the weights by
// value: bound to a reference, a kernel parameter is copied to each
// thread's stack (K2 took 12% longer so on the card), and read through a
// __grid_constant__ reference it still took ~1.3% longer.
struct K2Level { static constexpr int form = K2_FORM; };
struct BandedLeg { static constexpr int form = BANDED_FORM; };

template <typename T, int NU, class P>
__global__ void __launch_bounds__(LT_THREADS)
level_down_kernel(Level<T> lv, const T* __restrict__ r, T* __restrict__ e_out,
                  T* __restrict__ rc, int nyc, int nxc, int ntx,
                  Sweeps<T> ws, const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  down_body<T, NU, P::form, true>(
      PlaneIn<T>{r + off, ny, nx}, PlaneIn<T>{lv.aw + off, ny, nx},
      PlaneIn<T>{lv.an + off, ny, nx}, PlaneIn<T>{lv.dinv + off, ny, nx}, ny,
      nx, e_out, off, rc, (size_t)blockIdx.y * nyc * nxc, nyc, nxc, ty, tx,
      ws, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int NU, class P>
__global__ void __launch_bounds__(LT_THREADS)
level_up_kernel(Level<T> lv, const T* __restrict__ es,
                const T* __restrict__ ec, int nyc, int nxc, T over,
                const T* __restrict__ rhs, T* __restrict__ out, int ntx,
                Sweeps<T> ws, const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  up_body<T, NU, P::form, true>(
      PlaneIn<T>{es + off, ny, nx},
      PlaneIn<T>{ec + (size_t)blockIdx.y * nyc * nxc, nyc, nxc}, over,
      PlaneIn<T>{rhs + off, ny, nx}, PlaneIn<T>{lv.aw + off, ny, nx},
      PlaneIn<T>{lv.an + off, ny, nx}, PlaneIn<T>{lv.dinv + off, ny, nx}, ny,
      nx, out, off, ty, tx, ws, reinterpret_cast<T*>(smem_raw));
}

#define DEFF_LP_TRY(...)                       \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

// Call f(std::integral_constant<int, nu>) for nu in 1..MAX_NU.
template <int NU = 1, typename F>
cudaError_t with_nu(int nu, F&& f) {
  if constexpr (NU > MAX_NU) {
    return cudaErrorInvalidValue;
  } else {
    if (nu == NU) return f(std::integral_constant<int, NU>{});
    return with_nu<NU + 1>(nu, f);
  }
}

template <typename T, int NU, class P>
cudaError_t launch_down(int B, const Level<T>& lv, const T* r, T* e, T* rc,
                        int nyc, int nxc, const Sweeps<T>& sw,
                        const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  const size_t sm = sizeof(T) * down_elems<NU>();
  auto kern = level_down_kernel<T, NU, P>;
  DEFF_LP_TRY(allow_smem(kern, sm, &done));
  const int ntx = down_ntx<NU>(lv.nx, nxc);
  DEFF_LAUNCH(kern<<<dim3(down_count<NU>(lv.ny, lv.nx, nyc, nxc), B),
                     LT_THREADS, sm, st>>>(lv, r, e, rc, nyc, nxc, ntx, sw,
                                           flag));
  return cudaSuccess;
}

template <typename T, int NU, class P>
cudaError_t launch_up(int B, const Level<T>& lv, const T* es, const T* ec,
                      int nyc, int nxc, T over, const T* rhs, T* out,
                      const Sweeps<T>& sw, const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  const size_t sm = sizeof(T) * up_elems<NU>();
  auto kern = level_up_kernel<T, NU, P>;
  DEFF_LP_TRY(allow_smem(kern, sm, &done));
  DEFF_LAUNCH(kern<<<dim3(up_count<NU>(lv.ny, lv.nx), B), LT_THREADS, sm,
                     st>>>(lv, es, ec, nyc, nxc, over, rhs, out,
                           up_ntx<NU>(lv.nx), sw, flag));
  return cudaSuccess;
}

}  // namespace
}  // namespace lp
}  // namespace deff
