// Device code of the row-sharded engine's K9 (cgstep_sharded.cu): its three
// passes stage a shard's windows -- a TY x TX tile plus a halo of h = nu + 2
// cells on all four sides, read through the shard's halo strips (Rows, at
// the end of this file) -- in shared memory and compute every stencil step
// over the whole window from there; a step reads one neighbour, so each
// step leaves one more ring at the window's edge invalid, and h rings cover
// the deepest chain a pass runs (pass B: q, then nu - 1 sweeps, then the
// residual: nu + 1).  That is the TPU kernel's own idea -- all nu sweeps of
// a leg in one pass over device memory -- carried to a 2D tile.  K4 and K8,
// which began on these bodies, run K2's level passes now
// (levelpass2d.cuh); K5 runs K1's tile passes.
//
// Bounds on an H100: memory bandwidth.  A pass reads its input planes once
// (plus the halo, (1 + 2h/32)^2 - 1 ~ 56% at nu = 2, mostly served by L2)
// and writes its outputs once; the sweeps run out of shared memory.
//
// Cells outside the padded plane read as 0 in every window (coefficients
// included), which is what the whole-plane plain versions see through their
// zero-padded shifts: the boundary couplings are 0, so the window sums equal
// the plain version's bit for bit on the valid region.  Arithmetic follows
// the plain versions (ops/kernels/cgstep_sharded.py) operation for
// operation; the build turns FMA contraction off.
#pragma once

#include "vcycle.cuh"

namespace deff {

constexpr int TY = 32;                  // output rows of a tile
constexpr int TX = 32;                  // output columns of a tile
constexpr int TILE_THREADS = 256;       // = (TY / 2) * (TX / 2): one thread
                                        //   per coarse cell in the restriction
constexpr int MAX_NU = 8;               // the TPU engine's HALO

// Damping factors of one V(nu, nu) leg, by value into the kernels.
struct Weights {
  double w[MAX_NU];
  int nu;
};

inline Weights make_weights(const double* ws, int nu) {
  Weights out{};
  out.nu = nu;
  for (int s = 0; s < nu && s < MAX_NU; ++s) out.w[s] = ws[s];
  return out;
}

struct Tile {
  int py, px;      // the plane
  int ty0, tx0;    // first output cell
  int h;           // halo
  int wy, wx;      // window: (TY + 2h) x (TX + 2h)
  int i0, j0;      // plane coordinates of window cell (0, 0)
};

inline int tiles_for(int py, int px) {
  return ((py + TY - 1) / TY) * ((px + TX - 1) / TX);
}

inline size_t win_cells(int h) { return (size_t)(TY + 2 * h) * (TX + 2 * h); }

// Dynamic shared memory of a kernel holding `planes` windows.
inline size_t tile_smem(int planes, int h, size_t item) {
  return planes * win_cells(h) * item;
}

__device__ __forceinline__ Tile make_tile(int py, int px, int h) {
  Tile t;
  t.py = py;
  t.px = px;
  t.h = h;
  const int ntx = (px + TX - 1) / TX;
  t.ty0 = (blockIdx.x / ntx) * TY;
  t.tx0 = (blockIdx.x % ntx) * TX;
  t.wy = TY + 2 * h;
  t.wx = TX + 2 * h;
  t.i0 = t.ty0 - h;
  t.j0 = t.tx0 - h;
  return t;
}

// Neighbour sum of the symmetric stencil inside the window, in the plain
// version's order (west, east, north, south); a neighbour off the window
// is skipped (that cell is in the invalid margin).
template <typename T>
__device__ __forceinline__ T wnbsum(const T* aw, const T* an, const T* v,
                                    int c, int wi, int wj, int wy, int wx) {
  T s = (wj > 0) ? aw[c] * v[c - 1] : T(0);
  if (wj + 1 < wx) s = s + aw[c + 1] * v[c + 1];
  if (wi > 0) s = s + an[c] * v[c - wx];
  if (wi + 1 < wy) s = s + an[c + wx] * v[c + wx];
  return s;
}

// dst = (1 - w) src + (w (rhs + nbsum(src))) dinv over the window.
template <typename T>
__device__ void sweep_window(const T* AW, const T* AN, const T* DI,
                             const T* rhs, const T* src, T* dst, T w, T omw,
                             const Tile& t) {
  const int n = t.wy * t.wx;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int wi = c / t.wx, wj = c - wi * t.wx;
    const T nb = wnbsum(AW, AN, src, c, wi, wj, t.wy, t.wx);
    dst[c] = omw * src[c] + (w * (rhs[c] + nb)) * DI[c];
  }
}

// T1's smoothing: e = (w0 dinv) r, then the sweeps at ws[1:]; R must be
// complete (synchronised).  Returns the plane that holds e, synchronised.
template <typename T>
__device__ T* pre_smooth(const T* AW, const T* AN, const T* DI, const T* R,
                         T* E0, T* E1, const Weights& ws, const Tile& t) {
  const int n = t.wy * t.wx;
  const T w0 = (T)ws.w[0];
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    E0[c] = (w0 * DI[c]) * R[c];
  __syncthreads();
  T* cur = E0;
  T* oth = E1;
  for (int s = 1; s < ws.nu; ++s) {
    sweep_window(AW, AN, DI, R, cur, oth, (T)ws.w[s], (T)(1.0 - ws.w[s]), t);
    __syncthreads();
    T* tmp = cur; cur = oth; oth = tmp;
  }
  return cur;
}

// T1's tail: res = r - (diag e - nbsum(e)) with diag = 1/dinv, summed over
// each 2x2 block of the tile (row pairs, then column pairs) into the
// image's coarse plane (py/2, px/2).
template <typename T>
__device__ void restrict_tile(const T* AW, const T* AN, const T* DI,
                              const T* R, const T* E, const Tile& t,
                              T* __restrict__ rc) {
  const int pxc = t.px / 2;
  for (int cc = threadIdx.x; cc < (TY / 2) * (TX / 2); cc += blockDim.x) {
    const int I = cc / (TX / 2), J = cc - I * (TX / 2);
    const int gi = t.ty0 + 2 * I, gj = t.tx0 + 2 * J;
    if (gi >= t.py || gj >= t.px) continue;
    auto res = [&](int a, int b) {
      const int wi = 2 * I + a + t.h, wj = 2 * J + b + t.h;
      const int c = wi * t.wx + wj;
      return R[c] - (diag_of(DI[c]) * E[c] -
                     wnbsum(AW, AN, E, c, wi, wj, t.wy, t.wx));
    };
    rc[(size_t)(gi / 2) * pxc + gj / 2] =
        (res(0, 0) + res(1, 0)) + (res(0, 1) + res(1, 1));
  }
}

// Copy the tile's output cells of window plane S to the image plane g.
template <typename T>
__device__ void store_interior(T* __restrict__ g, const T* S, const Tile& t) {
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi < t.py && gj < t.px)
      g[(size_t)gi * t.px + gj] = S[(ti + t.h) * t.wx + tj + t.h];
  }
}

// ---------------------------------------------------------------- shards
// A row shard of a larger plane (K9, the sharded engine): its own
// (B, py, px) block plus the halo strips exchanged from its neighbours,
// `sh` rows each, per image: north holds rows -sh..-1, south rows
// py..py+sh-1 (zeros at the global top and bottom).  A window row in one
// of the strips reads it; a row beyond them, or a column off the plane,
// reads 0.  The tile halo h must not exceed sh.
template <typename T>
struct Rows {
  const T* body;
  const T* north;
  const T* south;
  int sh;
};

template <typename T>
__device__ __forceinline__ T rows_at(const Rows<T>& g, int b, int gi, int gj,
                                     int py, int px) {
  if (gj < 0 || gj >= px) return T(0);
  if (gi >= 0 && gi < py) return g.body[((size_t)b * py + gi) * px + gj];
  if (gi < 0 && gi >= -g.sh)
    return g.north[((size_t)b * g.sh + (size_t)(g.sh + gi)) * px + gj];
  if (gi >= py && gi < py + g.sh)
    return g.south[((size_t)b * g.sh + (size_t)(gi - py)) * px + gj];
  return T(0);
}

// True where window row gi lies on the shard or in one of its strips.
template <typename T>
__device__ __forceinline__ bool rows_has(const Rows<T>& g, int gi, int py) {
  return gi >= -g.sh && gi < py + g.sh;
}

// The window of image b of a shard plane.
template <typename T>
__device__ void load_window_rows(T* s, const Rows<T>& g, int b,
                                 const Tile& t) {
  const int n = t.wy * t.wx;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int wi = c / t.wx, wj = c - wi * t.wx;
    s[c] = rows_at(g, b, t.i0 + wi, t.j0 + wj, t.py, t.px);
  }
}

// The three level coefficient windows of image b of a shard.
template <typename T>
struct ShardCoef {
  Rows<T> aw, an, dinv;
};

template <typename T>
__device__ void coeff_windows_rows(const ShardCoef<T>& f, int b,
                                   const Tile& t, T* AW, T* AN, T* DI) {
  load_window_rows(AW, f.aw, b, t);
  load_window_rows(AN, f.an, b, t);
  load_window_rows(DI, f.dinv, b, t);
}

// post_smooth on a shard: e = e_pre + over ec[floor(i/2), j/2] on the
// window, e_pre read through its strips (fine rows) and ec through its own
// strips of sh/2 coarse rows (fine window row i takes coarse row i >> 1:
// every shard starts on an even global row and the strips are even), 0
// beyond them; then the sweeps in reverse order.  R must be complete.
// Returns the plane that holds z, synchronised.
template <typename T>
__device__ T* post_smooth_rows(const T* AW, const T* AN, const T* DI,
                               const T* R, T* E0, T* E1, const Rows<T>& e_pre,
                               const Rows<T>& ec, int b, T over,
                               const Weights& ws, const Tile& t) {
  const int n = t.wy * t.wx;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int wi = c / t.wx, wj = c - wi * t.wx;
    const int gi = t.i0 + wi, gj = t.j0 + wj;
    E0[c] = (rows_has(e_pre, gi, t.py) && gj >= 0 && gj < t.px)
                ? rows_at(e_pre, b, gi, gj, t.py, t.px) +
                      over * rows_at(ec, b, gi >> 1, gj >> 1, t.py / 2,
                                     t.px / 2)
                : T(0);
  }
  __syncthreads();
  T* cur = E0;
  T* oth = E1;
  for (int s = ws.nu - 1; s >= 0; --s) {
    sweep_window(AW, AN, DI, R, cur, oth, (T)ws.w[s], (T)(1.0 - ws.w[s]), t);
    __syncthreads();
    T* tmp = cur; cur = oth; oth = tmp;
  }
  return cur;
}

// Raise the dynamic shared memory limit of `kernel` to `bytes` if needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace deff
