// Z-marching tile passes over one level of a 3D batch: K7's three passes an
// iteration over level 0 (cgstep3d.cu) and K6's DOWN and UP passes over
// the levels of its V-cycle above the resident bottom (levelpass3d.cuh,
// vcycle3d.cu).  This header holds the tile and segment rule,
// shared-memory slice rings, staging, the coefficient rings (stored, or
// rebuilt from the diffusivity volume once a pass) and the 7-point stencil
// on staged slices.
//
// Each CTA owns a (TY x TX) tile of the (y, x) plane with a halo of H cells
// on its four sides, and marches along z through one segment of slices
// (2.5D blocking).  A pass is a chain of stages: stage 0 works pointwise on
// the newest slice t, stage s >= 1 on slice t - s, reading stage s - 1 at
// the slices t - s - 1 .. t - s + 1 from a ring of three slices in shared
// memory.  Each input slice crosses HBM once a pass (plus the xy halo, from
// L2), staged by cp.async PD steps before it is worked on (one commit group
// a step).  Stage s is computed on the window shrunk by s cells a side, so
// the last stage of a chain of depth H lands on the tile; its valid z range
// shrinks the same way, so a CTA starts H slices before its segment and
// ends H slices after it.  On the H100 the stages' arithmetic, most of it
// index arithmetic, sets a pass's pace, not its loads (with the waits
// removed a call took as long), so the stencil tests no (y, x) bounds
// (nb7) and stages run on whole windows.
//
// Fill the card at B = 1: z is cut into segments so that a volume gives at
// least TARGET_CTAS CTAs where the segments stay at least min_seg(nu)
// slices long (K7; K6's level passes: 2); segments are even so a 2x2x2
// restriction never straddles two CTAs.  The passes' shared memory holds
// two CTAs an SM at nu = 2 in float32, so 256 CTAs (2 segments of 128
// tiles at 256^3) run as one wave on the H100's 132 SMs; 264 would take a
// third segment and a second, mostly empty wave (measured slower).  The
// rule is a function of the shape, the element size and nu alone; its
// Python twin is ops/kernels/cgstep3d.py::march3_plan, held equal by a
// card test.
//
// Matrix-free, the coefficients are rebuilt once a pass: at step t the
// face conductances a_w, a_n, a_u of slice t + 1 (hm of D at the face's two
// cells, 3 divisions a cell) and diag_inv of slice t (a_e, a_s and a_d
// taken from the neighbour's a_w, a_n and the next slice's a_u, which are
// the same products of the same operands; 1 division a cell), term for
// term as ops/kernels/vcycle3d.py's coeffs_from_d3.  The D ring holds
// slices t and t + 1 and the PD staged after them, one more cell a side.
#pragma once

#include "vcycle3d.cuh"

namespace deff {
namespace march {

constexpr int NT = THREADS;          // threads a CTA
constexpr int TX = 32;               // tile columns
constexpr int TARGET_CTAS = 256;     // one wave of two CTAs an SM
constexpr int PD = 1;                // slices staged ahead of the one in use

// Tile rows: 16 in float32, 8 in float64 (the nu = 3 passes fit 227 KB).
__host__ __device__ constexpr int tile_rows(int itemsize) {
  return itemsize == 8 ? 8 : 16;
}

inline int tiles_xy(int ny, int nx, int itemsize) {
  const int ty = tile_rows(itemsize);
  return ((ny + ty - 1) / ty) * ((nx + TX - 1) / TX);
}

// The shortest segment of K7's passes: a CTA re-reads 2 nu slices around
// its own, so over level 0 the segments stay at least 4 nu long.  K6's
// level passes take segments of LEVEL_MIN_SEG slices: on the cycle's small
// levels the latency of a CTA's z-steps, not the halo's re-reads from L2,
// sets a pass's time, so more and shorter segments finish sooner.
inline int min_seg(int nu) { return 4 * nu < 8 ? 8 : 4 * nu; }
constexpr int LEVEL_MIN_SEG = 2;

// Slices a z-segment (even), no shorter than `shortest` where the volume
// gives fewer than TARGET_CTAS CTAs.
inline int seg_len(int nz, int ny, int nx, int itemsize, int shortest) {
  const int t = tiles_xy(ny, nx, itemsize);
  int nseg = (TARGET_CTAS + t - 1) / t;
  int most = nz / shortest;
  if (most < 1) most = 1;
  if (nseg > most) nseg = most;
  const int len = (nz + nseg - 1) / nseg;
  return len + (len & 1);
}

inline int ctas(int nz, int ny, int nx, int itemsize, int shortest) {
  const int len = seg_len(nz, ny, nx, itemsize, shortest);
  return tiles_xy(ny, nx, itemsize) * ((nz + len - 1) / len);
}

// Partial slots per volume that any nu's passes (and the plain per-block
// reduction of the entry) may fill.
inline long long part_slots(int nz, int ny, int nx, int itemsize) {
  const long long nb = blocks_for((long long)nz * ny * nx);
  const long long nc = (long long)tiles_xy(ny, nx, itemsize) * ((nz + 1) / 2);
  return nb > nc ? nb : nc;
}

// Window geometry of a pass with halo H: the staged slice (WY x WX) and the
// matrix-free D slice, one cell wider a side (DY x DX).
__host__ __device__ constexpr int win_cells(int itemsize, int h) {
  return (tile_rows(itemsize) + 2 * h) * (TX + 2 * h);
}
__host__ __device__ constexpr int dwin_cells(int itemsize, int h) {
  return (tile_rows(itemsize) + 2 * h + 2) * (TX + 2 * h + 2);
}

// Slice rings of each pass (in window slices): pass 0 is K7's P, 1 its X,
// 2 its Z, 3 K6's DOWN (X without the CG update) and 4 K6's UP (Z without
// the pin and the dot product).  A staged ring holds the slices its stages
// read at step t plus the PD slices in flight: the coefficient rings NC
// slices each of a_w, a_n, a_u and diag_inv (read back to t - 1 in P, t -
// nu in the others); P stages z (then p in place; read at t - 2 .. t) and
// p_old (read at t); X stages r (then r - alpha q in place; read back to t
// - nu) and q (read at t), plus a ring of 3 for e0 = (w0 dinv) r_new and
// one for each of its nu - 1 sweeps, and the tile's residuals of a slice;
// DOWN is X without q; Z and UP stage e (then e + over P e_c in place; read
// at t - 2 .. t) and r (read at t - nu .. t - 1, slice t landed), plus a
// ring of 3 for each of their nu - 1 sweeps before the last.  The
// matrix-free D ring holds D(t), D(t + 1) and PD slices in flight.
__host__ __device__ constexpr int coef_slots(int pass, int nu) {
  return (pass == 0 ? 2 : nu + 1) + PD;
}
__host__ __device__ constexpr int field_slots(int pass, int nu) {
  return pass == 0 ? (3 + PD) + (1 + PD)
         : pass == 1 ? (nu + 1 + PD) + (1 + PD) + 3 + 3 * (nu - 1)
         : pass == 3 ? (nu + 1 + PD) + 3 + 3 * (nu - 1)
                     : (3 + PD) + (nu + 1 + PD) + 3 * (nu - 1);
}
// Coarse window of passes Z and UP: the coarse cells under a window with
// halo h.
__host__ __device__ constexpr int coarse_cells(int itemsize, int h) {
  return (tile_rows(itemsize) / 2 + h + 1) * (TX / 2 + h + 1);
}
// Tile-sized slices (TY x TX): X stages x and p at their cells (1 + PD
// each) and keeps the residuals of a slice, DOWN the residuals; Z keeps D
// at its cells for the pin (nu + 1, matrix-free).
__host__ __device__ constexpr int tile_slots(int pass, int nu, bool mf) {
  return pass == 1 ? 2 * (1 + PD) + 1
         : pass == 3 ? 1
         : pass == 2 && mf ? nu + 1 : 0;
}
constexpr int D_SLOTS = 2 + PD;
__host__ __device__ constexpr int pass_halo(int pass, int nu) {
  return pass == 0 ? 1 : nu;
}
__host__ __device__ constexpr bool has_coarse(int pass) {
  return pass == 2 || pass == 4;
}

// Dynamic shared memory of pass 0 (P), 1 (X), 2 (Z), 3 (DOWN) or 4 (UP),
// in bytes.
__host__ __device__ constexpr long long smem_bytes(int pass, int itemsize,
                                                   int nu, bool mf) {
  return (long long)itemsize *
         ((4LL * coef_slots(pass, nu) + field_slots(pass, nu)) *
              win_cells(itemsize, pass_halo(pass, nu)) +
          (mf ? (long long)D_SLOTS * dwin_cells(itemsize, pass_halo(pass, nu))
              : 0LL) +
          (long long)tile_slots(pass, nu, mf) * tile_rows(itemsize) * TX +
          (has_coarse(pass) ? (1LL + PD) * coarse_cells(itemsize, nu) : 0LL));
}

template <typename T, int H_>
struct Geo {
  static constexpr int H = H_;
  static constexpr int TY = tile_rows(sizeof(T));
  static constexpr int WY = TY + 2 * H, WX = TX + 2 * H, N = WY * WX;
  static constexpr int DY = WY + 2, DX = WX + 2, DN = DY * DX;
};

// One level of a (B, nz, ny, nx) batch: the stored volumes, or (d != null,
// K7's level 0) the diffusivity volume the passes rebuild them from.
template <typename T>
struct Vol0 {
  const T* aw;
  const T* an;
  const T* au;
  const T* dinv;
  const T* d;
  T fx, fy, fz, bcf;
  int nxr;
  Dims3 dm;
};

// A CTA's tile and z-segment: blockIdx.x = segment * tiles + tile.
struct Tile3 {
  int i0, j0;      // first tile cell in the plane
  int zs, ze;      // the segment's slices [zs, ze)
};

template <int TY>
__device__ __forceinline__ Tile3 tile3(const Dims3& dm, int seglen) {
  const int ntx = (dm.nx + TX - 1) / TX;
  const int ntl = ntx * ((dm.ny + TY - 1) / TY);
  const int seg = blockIdx.x / ntl, tl = blockIdx.x - seg * ntl;
  Tile3 t;
  t.i0 = (tl / ntx) * TY;
  t.j0 = (tl - (tl / ntx) * ntx) * TX;
  t.zs = seg * seglen;
  t.ze = t.zs + seglen < dm.nz ? t.zs + seglen : dm.nz;
  return t;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most the PD newest commit groups are in flight (the one of
// the current step has landed), then synchronise the block.
__device__ __forceinline__ void cp_wait_step() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PD) : "memory");
  __syncthreads();
}

// Stage slice k of an image volume into a (WY x WX) window whose cell
// (0, 0) lies at plane coordinates (gi0, gj0); cells off the plane read 0.
template <int WY, int WX, typename T>
__device__ __forceinline__ void stage_slice(T* dst, const T* img, int k,
                                            int gi0, int gj0,
                                            const Dims3& dm) {
  const T* sl = img + (size_t)k * dm.plane();
  for (int e = threadIdx.x; e < WY * WX; e += NT) {
    const int li = e / WX, lj = e - li * WX;
    const int gi = gi0 + li, gj = gj0 + lj;
    const bool ok = gi >= 0 && gi < dm.ny && gj >= 0 && gj < dm.nx;
    cp_async(dst + e, ok ? sl + (size_t)gi * dm.nx + gj : sl, ok);
  }
}

// The cells of a (WY x WX) window that a thread stages, as their offsets
// gi * nx + gj in a slice of the plane, or -1 off the plane.  A window keeps
// its place in the plane while its pass marches along z, so a CTA works the
// offsets out once and stages every slice of every field with them, where
// stage_slice would work out each cell's place again for each.
template <int WY, int WX>
struct WinCells {
  static constexpr int N = WY * WX, PER = (N + NT - 1) / NT;
  int off[PER];

  __device__ WinCells(int gi0, int gj0, const Dims3& dm) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * NT;
      const int li = e / WX, lj = e - li * WX;
      const int gi = gi0 + li, gj = gj0 + lj;
      off[j] = e < N && gi >= 0 && gi < dm.ny && gj >= 0 && gj < dm.nx
                   ? gi * dm.nx + gj
                   : -1;
    }
  }

  // stage_slice of slice k of an image volume into the window.
  template <typename T>
  __device__ __forceinline__ void stage(T* dst, const T* img, int k,
                                        const Dims3& dm) const {
    const T* sl = img + (size_t)k * dm.plane();
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * NT;
      if (N % NT == 0 || j + 1 < PER || e < N)
        cp_async(dst + e, off[j] >= 0 ? sl + off[j] : sl, off[j] >= 0);
    }
  }
};

// Stage slice k of an image volume's (R x C) block whose cell (0, 0) lies at
// (i0, j0) of a (ny, nx) plane (a tile, or a coarse window); cells off the
// plane read 0.
template <int R, int C, typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* img, int k,
                                            int i0, int j0, int ny, int nx) {
  const T* sl = img + (size_t)k * ny * nx;
  for (int e = threadIdx.x; e < R * C; e += NT) {
    const int li = e / C, lj = e - li * C;
    const int gi = i0 + li, gj = j0 + lj;
    const bool ok = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    cp_async(dst + e, ok ? sl + (size_t)gi * nx + gj : sl, ok);
  }
}

// Run f(e, gi, gj) on every cell of G's window (origin (gi0, gj0)) shrunk
// by S cells a side, on the plane or off it; e is the window index.  A
// cell off the plane is staged as 0 in every field and its coefficients
// are 0, so what a stage computes there is finite and reaches no cell on
// the plane (nb7); only stores and sums check in_plane.
template <typename G, int S, typename F>
__device__ __forceinline__ void for_win(int gi0, int gj0, F f) {
  constexpr int w = G::WX - 2 * S, n = w * (G::WY - 2 * S);
  for (int c = threadIdx.x; c < n; c += NT) {
    const int a = c / w, bcol = c - a * w;
    f((a + S) * G::WX + (bcol + S), gi0 + S + a, gj0 + S + bcol);
  }
}

__device__ __forceinline__ bool in_plane(int gi, int gj, const Dims3& dm) {
  return gi >= 0 && gi < dm.ny && gj >= 0 && gj < dm.nx;
}

// vcycle3d.cuh's nbsum3 on staged slices: v(dz, e) is the value at window
// index e of slice k + dz; aw/an/au are slice k's coefficients and au1 is
// slice k + 1's a_u.  The same terms in the same order.  In (y, x) no
// bounds are tested: at the plane's edges the coupling is 0 (a_w at column
// 0, a_n at row 0, and the staged zeros off the plane), so the term adds 0
// as the plain version's zero-padded shifts do; in z the slices beyond the
// volume are not staged, so those terms are skipped (k is uniform).
template <int WX, typename T, typename V>
__device__ __forceinline__ T nb7(const T* aw, const T* an, const T* au,
                                 const T* au1, V v, int e, int k,
                                 const Dims3& dm) {
  T s = aw[e] * v(0, e - 1);
  s = s + aw[e + 1] * v(0, e + 1);
  s = s + an[e] * v(0, e - WX);
  s = s + an[e + WX] * v(0, e + WX);
  if (k > 0) s = s + au[e] * v(-1, e);
  if (k + 1 < dm.nz) s = s + au1[e] * v(1, e);
  return s;
}

// The coefficient rings of one pass: NC slices each of a_w, a_n,
// a_u and diag_inv, staged (stored) or rebuilt from a ring of three D
// slices (MF).
template <typename T, int H, int NC, bool MF>
struct Coefs {
  using G = Geo<T, H>;
  T* aw;
  T* an;
  T* au;
  T* di;
  T* d;            // MF: D_SLOTS D slices of DY x DX
  int gi0, gj0;    // window origin
  WinCells<G::WY, G::WX> win;   // the pass's window, for every field

  __device__ Coefs(T*& sp, int gi0_, int gj0_, const Dims3& dm)
      : gi0(gi0_), gj0(gj0_), win(gi0_, gj0_, dm) {
    aw = sp; sp += NC * G::N;
    an = sp; sp += NC * G::N;
    au = sp; sp += NC * G::N;
    di = sp; sp += NC * G::N;
    d = sp; sp += MF ? D_SLOTS * G::DN : 0;
  }
  __device__ __forceinline__ const T* AW(int k) const { return aw + (k % NC) * G::N; }
  __device__ __forceinline__ const T* AN(int k) const { return an + (k % NC) * G::N; }
  __device__ __forceinline__ const T* AU(int k) const { return au + (k % NC) * G::N; }
  __device__ __forceinline__ const T* DI(int k) const { return di + (k % NC) * G::N; }
  __device__ __forceinline__ T* Dk(int k) const {
    return d + (k % D_SLOTS) * G::DN;
  }

  __device__ __forceinline__ void stage_d(const Vol0<T>& v, size_t off,
                                          int k) const {
    if (k >= 0 && k < v.dm.nz)
      stage_slice<G::DY, G::DX>(Dk(k), v.d + off, k, gi0 - 1, gj0 - 1, v.dm);
  }

  // Before the first step t0: MF stages D(t0 - 1) and D(t0) (the caller's
  // first issues add D(t0 + 1) .. D(t0 + PD) to the same commit group).
  __device__ void prime(const Vol0<T>& v, size_t off, int t0) const {
    if (MF) {
      stage_d(v, off, t0 - 1);
      stage_d(v, off, t0);
    }
  }
  // What step k needs: the stored slices k, or D(k + 1).
  __device__ void issue(const Vol0<T>& v, size_t off, int k) const {
    if (MF) {
      stage_d(v, off, k + 1);
    } else if (k < v.dm.nz) {
      win.stage(aw + (k % NC) * G::N, v.aw + off, k, v.dm);
      win.stage(an + (k % NC) * G::N, v.an + off, k, v.dm);
      win.stage(au + (k % NC) * G::N, v.au + off, k, v.dm);
      win.stage(di + (k % NC) * G::N, v.dinv + off, k, v.dm);
    }
  }

  // MF: the face conductances of slice k from D(k - 1) and D(k).
  __device__ void faces(const Vol0<T>& v, int k) const {
    const T* dk = Dk(k);
    const T* dm1 = Dk(k + D_SLOTS - 1);   // D(k - 1)
    T* w = aw + (k % NC) * G::N;
    T* n = an + (k % NC) * G::N;
    T* u = au + (k % NC) * G::N;
    for_win<G, 0>(gi0, gj0, [&](int e, int gi, int gj) {
      const int dc = (gi - gi0 + 1) * G::DX + (gj - gj0 + 1);
      const T dcc = dk[dc];
      w[e] = gj > 0 ? hmean3(dk[dc - 1], dcc) * v.fx : T(0);
      n[e] = gi > 0 ? hmean3(dk[dc - G::DX], dcc) * v.fy : T(0);
      u[e] = k > 0 ? hmean3(dm1[dc], dcc) * v.fz : T(0);
    });
  }

  // MF: diag_inv of slice k from its faces, its east / south neighbours'
  // a_w / a_n (rebuilt from D at the window's east and south edges) and
  // slice k + 1's a_u.
  __device__ void diag(const Vol0<T>& v, int k) const {
    const T* dk = Dk(k);
    const T* w = AW(k);
    const T* n = AN(k);
    const T* u = AU(k);
    const T* u1 = AU(k + 1);
    T* out = di + (k % NC) * G::N;
    const Dims3 dm = v.dm;
    for_win<G, 0>(gi0, gj0, [&](int e, int gi, int gj) {
      const int a = gi - gi0, bcol = gj - gj0;
      const int dc = (a + 1) * G::DX + bcol + 1;
      const T dcc = dk[dc];
      const T ae = gj + 1 < dm.nx
                       ? (bcol + 1 < G::WX ? w[e + 1]
                                           : hmean3(dcc, dk[dc + 1]) * v.fx)
                       : T(0);
      const T as = gi + 1 < dm.ny
                       ? (a + 1 < G::WY ? n[e + G::WX]
                                        : hmean3(dcc, dk[dc + G::DX]) * v.fy)
                       : T(0);
      const T ad = k + 1 < dm.nz ? u1[e] : T(0);
      T dg = w[e] + ae + n[e] + as + u[e] + ad;
      if (gj == 0 || gj == v.nxr - 1) dg = dg + dcc * v.bcf;
      out[e] = dg > T(0) ? T(1) / dg : T(0);
    });
  }

  // MF, before the first step t0 (D(t0 - 1), D(t0) landed): slice t0's faces.
  __device__ void first_faces(const Vol0<T>& v, int t0) const {
    if (MF) faces(v, t0);
  }
  // MF, at step t (D(t), D(t + 1) landed): slice t + 1's faces, then slice
  // t's diag_inv; synchronises.
  __device__ void rebuild(const Vol0<T>& v, int t) const {
    if (!MF) return;
    if (t + 1 < v.dm.nz) faces(v, t + 1);
    __syncthreads();
    diag(v, t);
    __syncthreads();
  }
};

}  // namespace march
}  // namespace deff
