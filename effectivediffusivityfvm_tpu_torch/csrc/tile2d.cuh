// The level-0 tile scaffolding of the 2D CG passes (K1, cgstep.cu; K5,
// cgstep_tiled.cu; K9, cgstep_sharded.cu): 64x16 tiles of THREADS
// threads, each staged in shared memory with a halo by cp.async, the cells
// of a ring inside that halo visited by compile-time widths, and the
// neighbour sum on staged arrays.
#pragma once

#include "vcycle.cuh"

namespace deff {
namespace {

constexpr int TX = 64;   // tile columns
constexpr int TY = 16;   // tile rows
static_assert(TX * TY == THREADS * 4, "four tile cells a thread");
static_assert((TX / 2) * (TY / 2) == THREADS, "one coarse cell a thread");

// A tile with an h-cell halo, as a (TY + 2h) x (TX + 2h) array; a D window
// (matrix-free level 0) is one cell wider a side.
template <int H>
struct Reg {
  static constexpr int W = TX + 2 * H;
  static constexpr int R = TY + 2 * H;
  static constexpr int N = W * R;
  static constexpr int DW = W + 2;
  static constexpr int DN = DW * (R + 2);
};

// The origin of the tile of blockIdx.x (tiles in row-major order).
struct TileAt {
  int i0, j0;
  __device__ TileAt(int nx) {
    const int ntx = (nx + TX - 1) / TX;
    const int t = blockIdx.x;
    i0 = (t / ntx) * TY;
    j0 = (t - (t / ntx) * ntx) * TX;
  }
};

inline int tiles_for(int ny, int nx) {
  return ((ny + TY - 1) / TY) * ((nx + TX - 1) / TX);
}

// Stage an image plane's (rows x W) window with cell (0, 0) at (gi0, gj0);
// cells beyond the grid read as 0.
template <int W, int N, typename T>
__device__ __forceinline__ void stage_win(T* dst, const T* img, int gi0,
                                          int gj0, int ny, int nx) {
  for (int e = threadIdx.x; e < N; e += THREADS) {
    const int li = e / W, lj = e - li * W;
    const int gi = gi0 + li, gj = gj0 + lj;
    const bool ok = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    cp_async(dst + e, ok ? img + (size_t)gi * nx + gj : img, ok);
  }
}

// Stage the tile at (i0, j0) with an H-cell halo.
template <int H, typename T>
__device__ __forceinline__ void stage(T* dst, const T* img, int i0, int j0,
                                      int ny, int nx) {
  stage_win<Reg<H>::W, Reg<H>::N>(dst, img, i0 - H, j0 - H, ny, nx);
}

// Run f(e, gi, gj) on every in-grid cell of the tile grown by h (h <= H)
// inside an H-halo array (both compile-time, so the index division is by
// a constant).
template <int H, int h, typename F>
__device__ __forceinline__ void for_cells(int i0, int j0, int ny, int nx,
                                          F f) {
  static_assert(0 <= h && h <= H, "a ring inside the staged halo");
  constexpr int w = TX + 2 * h, n = w * (TY + 2 * h);
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const int a = c / w, bcol = c - a * w;
    const int gi = i0 - h + a, gj = j0 - h + bcol;
    if (gi < 0 || gi >= ny || gj < 0 || gj >= nx) continue;
    f((a + H - h) * Reg<H>::W + (bcol + H - h), gi, gj);
  }
}

// for_cells with a halo h known only at run time: the H-halo array's cells
// at least H - h from its edge.
template <int H, typename F>
__device__ __forceinline__ void for_ring(int h, int i0, int j0, int ny,
                                         int nx, F f) {
  using RG = Reg<H>;
  const int m = H - h;
  for (int c = threadIdx.x; c < RG::N; c += THREADS) {
    const int a = c / RG::W, bcol = c - a * RG::W;
    if (a < m || a >= RG::R - m || bcol < m || bcol >= RG::W - m) continue;
    const int gi = i0 - H + a, gj = j0 - H + bcol;
    if (gi < 0 || gi >= ny || gj < 0 || gj >= nx) continue;
    f(c, gi, gj);
  }
}

// Damping factors of one V(nu, nu) leg, by value into the kernels.
constexpr int WK_MAX = 8;
struct WK {
  double w[WK_MAX];
};

// nbsum (vcycle.cuh) on staged arrays of row width W: the same terms in the
// same order, with the grid bounds taken from the global index.
template <int W, typename T, typename V>
__device__ __forceinline__ T nbsum_s(const T* aw, const T* an, V v, int e,
                                     int gi, int gj, int ny, int nx) {
  T s = (gj > 0) ? aw[e] * v(e - 1) : T(0);
  if (gj + 1 < nx) s = s + aw[e + 1] * v(e + 1);
  if (gi > 0) s = s + an[e] * v(e - W);
  if (gi + 1 < ny) s = s + an[e + W] * v(e + W);
  return s;
}

}  // namespace
}  // namespace deff
