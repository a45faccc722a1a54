// K2's cycle (declared in vcycle.cuh) and its C entry points, loaded with
// ctypes by effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle.py.  Every
// entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launches.
//
// The TPU kernel (vcycle_vmem.py, v_cycle_pallas) held an image's whole
// pyramid in VMEM for one cycle.  On an H100 the upper levels are too large
// for an SM, and the cycle is bound by memory bandwidth there and by
// latency (launches, barriers) at the bottom.  So the residency comes back
// in two regimes:
//
//   DOWN (each level l above the bottom): a tile of level l and a halo of
//     nu cells (rounded up to even) staged in shared memory by cp.async (r,
//     a_w, a_n, diag_inv); each thread owns 2x2 blocks of the window with
//     their coefficients and values in registers, so a stencil reads two
//     neighbours from shared memory and two from its own block.  e0 = w0
//     dinv r and the nu - 1 sweeps on the window (sweep s valid on the halo
//     of nu - s), then the residual r - A e and its 2x2 restriction inside
//     each block of the tile.  Writes e and the quarter plane: ~21 B a cell
//     in fp32 (16 read, 4 + 1 written).
//   UP (the same levels, in reverse): e, r, the coefficients and the coarse
//     correction under the window (one coarse cell a block) staged; the
//     prolongation e + over P e_c in registers, then the nu post-sweeps, the
//     last on the tile.  Writes the correction: ~25 B a cell.
//   BOTTOM (the levels from cycle_resident_from down): one CTA per image
//     loads a_w, a_n, diag_inv of every level and the first level's right-
//     hand side into shared memory, runs the down legs, the coarse sweeps
//     and the up legs there with a barrier between sweeps, and writes the
//     first level's correction: one launch for the rest of the cycle.
//
// A level above the bottom costs 2 launches and ~46 B a cell (the per-sweep
// kernels this replaces: nu + 2 launches and ~90 B a cell at nu = 2).  The
// passes reach ~1.8-2 TB/s of their bytes on an H100; a first version that
// read every stencil operand from shared memory (~35 accesses a cell
// against the 2x2 blocks' ~15) and a 32x32 window reached ~1.6 (PERF.md).
// A tile recomputes its halo's values in the plain version's order, as the
// neighbouring tile computes them for its own cells, so every tile agrees
// with the plain version bit for bit.  When even the coarsest level does
// not fit one CTA, it runs its sweeps from global memory in one block per
// image (coarse_solve_kernel).
#include <type_traits>

#include "vcycle.cuh"

namespace deff {

long long g_launches = 0;
long long g_cycles = 0;

namespace {

// Per image, the cycles whose image was not gated, counted on the device
// (a replayed CUDA graph advances it; the host counts above only count
// launches made from the host).
__device__ unsigned long long g_image_cycles = 0;

constexpr int LT_THREADS = 256;         // threads of a level pass
constexpr int MAX_NU = 8;               // sweeps a leg the passes take
constexpr int BOT_THREADS = 1024;       // the resident bottom's CTA

#define DEFF_TRY(...)                          \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

// The window of a level pass: the tile and a halo of HS cells (nu rounded
// up to even, so that the window is made of whole 2x2 blocks of the level
// and each block lies on one coarse cell), two 2x2 blocks a thread.  For
// nu <= 2 a 64x32 window around a 60x28 tile: of the shapes tried on the
// card (32x32, 64x16, 64x32, 96x32, 128x16; 192 to 512 threads) the fastest
// at B=512 x 512^2, its rows long enough for full DRAM bursts and its halo
// a fifth of the tile.
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

// Stage a level plane's window with origin (y0, x0); cells beyond the grid
// read as 0.
template <int NU, typename T>
__device__ __forceinline__ void stage(T* dst, const T* img, int y0, int x0,
                                      int ny, int nx) {
  using G = Geo<NU>;
  for (int e = threadIdx.x; e < G::N; e += LT_THREADS) {
    const int li = e / G::WX, lj = e - li * G::WX;
    const int gi = y0 + li, gj = x0 + lj;
    const bool ok = gi >= 0 && gi < ny && gj >= 0 && gj < nx;
    cp_async(dst + e, ok ? img + (size_t)gi * nx + gj : img, ok);
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
// in the same order, with the grid bounds taken from the level index (a
// neighbour off the window reads 0; only cells in the invalid margin have
// one).
template <int NU, int A, int B, typename T>
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
  if (gi > 0) s = s + k.an[A][B] * north;
  if (gi + 1 < ny) s = s + ans * south;
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

// One damped-Jacobi sweep of a block: v = (1 - w) v + (r + nbsum(v))
// (w dinv), as smooth_kernel, the neighbours read from p.
template <int NU, typename T>
__device__ __forceinline__ void sweep_quad(const Quad<T>& k, T (&v)[2][2],
                                           const T* p, T w, T omw, int ny,
                                           int nx) {
  T o[2][2];
  o[0][0] = omw * v[0][0] + (k.r[0][0] + quad_nbsum<NU, 0, 0>(k, v, p, ny,
                                                              nx)) *
                                (w * k.di[0][0]);
  o[0][1] = omw * v[0][1] + (k.r[0][1] + quad_nbsum<NU, 0, 1>(k, v, p, ny,
                                                              nx)) *
                                (w * k.di[0][1]);
  o[1][0] = omw * v[1][0] + (k.r[1][0] + quad_nbsum<NU, 1, 0>(k, v, p, ny,
                                                              nx)) *
                                (w * k.di[1][0]);
  o[1][1] = omw * v[1][1] + (k.r[1][1] + quad_nbsum<NU, 1, 1>(k, v, p, ny,
                                                              nx)) *
                                (w * k.di[1][1]);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) v[a][b] = o[a][b];
}

// The residual r - (diag v - nbsum(v)) of cell (A, B), diag = 1/dinv.
template <int NU, int A, int B, typename T>
__device__ __forceinline__ T quad_res(const Quad<T>& k, const T (&v)[2][2],
                                      const T* p, int ny, int nx) {
  return k.r[A][B] - (diag_of(k.di[A][B]) * v[A][B] -
                      quad_nbsum<NU, A, B>(k, v, p, ny, nx));
}

// The tiles of a DOWN pass along one axis (tile width t): they cover the
// coarse plane (t/2 coarse cells each) and the fine one.
inline int down_tiles(int t, int n, int nc) {
  const int a = (nc + t / 2 - 1) / (t / 2), b = (n + t - 1) / t;
  return a > b ? a : b;
}

// ---- DOWN: e0 = w0 dinv r and nu - 1 sweeps on the window (sweep s valid
// on the tile and a halo of HS - s cells), then the residual restricted 2x2
// into rc (the next level, nyc x nxc; a coarse cell past the fine grid
// receives 0).  Each sweep's values go to a window plane for the
// neighbouring blocks, ping-ponging between two.
template <typename T, int NU>
__global__ void __launch_bounds__(LT_THREADS)
level_down_kernel(Level<T> lv, const T* __restrict__ r, T* __restrict__ e_out,
                  T* __restrict__ rc, int nyc, int nxc, int ntx, Sweeps<T> ws,
                  const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  using G = Geo<NU>;
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* aws = rs + G::N;
  T* ans = aws + G::N;
  T* dis = ans + G::N;
  T* pv[2] = {dis + G::N, dis + 2 * G::N};
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int I0 = ty * (G::TY / 2), J0 = tx * (G::TX / 2);
  const int y0 = 2 * I0 - G::HS, x0 = 2 * J0 - G::HS;
  stage<NU>(rs, r + off, y0, x0, ny, nx);
  stage<NU>(aws, lv.aw + off, y0, x0, ny, nx);
  stage<NU>(ans, lv.an + off, y0, x0, ny, nx);
  stage<NU>(dis, lv.dinv + off, y0, x0, ny, nx);
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
        sweep_quad<NU>(k[p], v[p], pv[(s - 1) & 1], ws.w[s], ws.omw[s], ny,
                       nx);
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
          e_out[off + (size_t)(q.gi + a) * nx + q.gj + b] = v[p][a][b];
    const int I = I0 + tbi, J = J0 + tbj;
    if (I >= nyc || J >= nxc) continue;
    T out = T(0);
    if (2 * I < ny && 2 * J < nx)
      out = (quad_res<NU, 0, 0>(q, v[p], pe, ny, nx) +
             quad_res<NU, 1, 0>(q, v[p], pe, ny, nx)) +
            (quad_res<NU, 0, 1>(q, v[p], pe, ny, nx) +
             quad_res<NU, 1, 1>(q, v[p], pe, ny, nx));
    rc[(size_t)blockIdx.y * nyc * nxc + (size_t)I * nxc + J] = out;
  }
}

// ---- UP: src = es + over ec[i/2, j/2] on the window (one coarse cell a
// block), the nu post-sweeps in reverse weight order (sweep s valid on the
// tile and a halo of HS - s cells), the tile's correction into out.
template <typename T, int NU>
__global__ void __launch_bounds__(LT_THREADS)
level_up_kernel(Level<T> lv, const T* __restrict__ es,
                const T* __restrict__ ec, int nyc, int nxc, T over,
                const T* __restrict__ rhs, T* __restrict__ out, int ntx,
                Sweeps<T> ws, const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (gated_off(flag)) return;
  using G = Geo<NU>;
  T* rs = reinterpret_cast<T*>(smem_raw);
  T* aws = rs + G::N;
  T* ans = aws + G::N;
  T* dis = ans + G::N;
  T* pv[2] = {dis + G::N, dis + 2 * G::N};
  T* ecs = dis + 3 * G::N;                         // BX x BX coarse cells
  const int ny = lv.ny, nx = lv.nx;
  const size_t off = (size_t)blockIdx.y * ny * nx;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int y0 = ty * G::TY - G::HS, x0 = tx * G::TX - G::HS;
  const int cy0 = y0 / 2, cx0 = x0 / 2;            // y0, x0 are even
  stage<NU>(pv[1], es + off, y0, x0, ny, nx);      // e, read once
  stage<NU>(rs, rhs + off, y0, x0, ny, nx);
  stage<NU>(aws, lv.aw + off, y0, x0, ny, nx);
  stage<NU>(ans, lv.an + off, y0, x0, ny, nx);
  stage<NU>(dis, lv.dinv + off, y0, x0, ny, nx);
  const T* cb = ec + (size_t)blockIdx.y * nyc * nxc;
  for (int e = threadIdx.x; e < G::NB; e += LT_THREADS) {
    const int a = e / G::BX, bcol = e - a * G::BX;
    const int I = cy0 + a, J = cx0 + bcol;
    const bool ok = I >= 0 && I < nyc && J >= 0 && J < nxc;
    cp_async(ecs + e, ok ? cb + (size_t)I * nxc + J : cb, ok);
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
        sweep_quad<NU>(k[p], v[p], pv[(s - 1) & 1], ws.w[NU - s],
                       ws.omw[NU - s], ny, nx);
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
          out[off + (size_t)(q.gi + a) * nx + q.gj + b] = v[p][a][b];
  }
}

// ---- BOTTOM: the rest of the cycle from its first level, one CTA per image
// (blockIdx.y) with the pyramid in shared memory.
template <typename T>
struct Pyramid {
  Level<T> lv[RESIDENT_LEVELS];
  int n;
};

// One damped-Jacobi sweep over a whole level in shared memory.
template <typename T>
__device__ __forceinline__ void sweep_plane(const T* aw, const T* an,
                                            const T* di, const T* rhs,
                                            const T* src, T* dst, int ny,
                                            int nx, T w, T omw) {
  auto v = [&](int k) { return src[k]; };
  const int n = ny * nx;
  for (int c = threadIdx.x; c < n; c += BOT_THREADS) {
    const int i = c / nx, j = c - i * nx;
    const T nb = nbsum(aw, an, v, c, i, j, ny, nx);
    dst[c] = omw * src[c] + (rhs[c] + nb) * (w * di[c]);
  }
  __syncthreads();
}

// Shared memory: per level k, a_w, a_n, diag_inv, right-hand side and e
// (5 planes of level k), then one ping-pong plane of level 0's size.
template <typename T>
__global__ void __launch_bounds__(BOT_THREADS, 1)
bottom_kernel(Pyramid<T> py, const T* __restrict__ r, T* __restrict__ z,
              Sweeps<T> ws, T over, int iters, const int* flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Level<T> slv[RESIDENT_LEVELS];
  __shared__ int base[RESIDENT_LEVELS + 1];
  __shared__ T sw[MAX_NU], somw[MAX_NU];
  if (gated_off(flag)) return;
  if (threadIdx.x == 0) atomicAdd(&g_image_cycles, 1ULL);
  const int b = blockIdx.y;
  const int n = py.n, nu = ws.nu;
#pragma unroll
  for (int k = 0; k < RESIDENT_LEVELS; ++k)
    if (threadIdx.x == k && k < n) slv[k] = py.lv[k];
#pragma unroll
  for (int k = 0; k < MAX_NU; ++k)
    if (threadIdx.x == 32 + k) {
      sw[k] = ws.w[k];
      somw[k] = ws.omw[k];
    }
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0;
    for (int k = 0; k < n; ++k) {
      base[k] = o;
      o += 5 * slv[k].ny * slv[k].nx;
    }
    base[n] = o;
  }
  __syncthreads();
  T* S = reinterpret_cast<T*>(smem_raw);
  T* tmp = S + base[n];
  auto plane = [&](int k, int p) {
    return S + base[k] + p * slv[k].ny * slv[k].nx;
  };
  // planes: 0 a_w, 1 a_n, 2 diag_inv, 3 right-hand side, 4 e
  for (int k = 0; k < n; ++k) {
    const Level<T> L = slv[k];
    const int nk = L.ny * L.nx;
    const size_t off = (size_t)b * nk;
    T* aw = plane(k, 0);
    T* an = plane(k, 1);
    T* di = plane(k, 2);
    T* rh = plane(k, 3);
    for (int c = threadIdx.x; c < nk; c += BOT_THREADS) {
      aw[c] = L.aw[off + c];
      an[c] = L.an[off + c];
      di[c] = L.dinv[off + c];
      if (k == 0) rh[c] = r[off + c];
    }
  }
  __syncthreads();

  // way down: the pre-sweeps end in e (e0 starts in tmp when nu - 1 sweeps
  // follow it and nu - 1 is odd), then the residual restricted into the
  // next level's right-hand side
  for (int k = 0; k + 1 < n; ++k) {
    const int ny = slv[k].ny, nx = slv[k].nx;
    const T* aw = plane(k, 0);
    const T* an = plane(k, 1);
    const T* di = plane(k, 2);
    const T* rh = plane(k, 3);
    T* e = plane(k, 4);
    T* cur = ((nu - 1) & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    const T w0 = sw[0];
    for (int c = threadIdx.x; c < ny * nx; c += BOT_THREADS)
      cur[c] = (w0 * di[c]) * rh[c];
    __syncthreads();
    for (int s = 1; s < nu; ++s) {
      sweep_plane(aw, an, di, rh, cur, oth, ny, nx, sw[s], somw[s]);
      T* t = cur; cur = oth; oth = t;
    }
    const int nyc = slv[k + 1].ny, nxc = slv[k + 1].nx;
    T* rc = plane(k + 1, 3);
    auto ev = [&](int cc) { return e[cc]; };
    auto res = [&](int i, int j) {
      const int c = i * nx + j;
      return rh[c] - (diag_of(di[c]) * e[c] - nbsum(aw, an, ev, c, i, j, ny,
                                                     nx));
    };
    for (int cc = threadIdx.x; cc < nyc * nxc; cc += BOT_THREADS) {
      const int I = cc / nxc, J = cc - I * nxc;
      T out = T(0);
      if (2 * I < ny && 2 * J < nx) {
        const int i = 2 * I, j = 2 * J;
        out = (res(i, j) + res(i + 1, j)) +
              (res(i, j + 1) + res(i + 1, j + 1));
      }
      rc[cc] = out;
    }
    __syncthreads();
  }

  // coarsest level: iters sweeps at the last weight from zero, ending in e
  {
    const int k = n - 1;
    const int ny = slv[k].ny, nx = slv[k].nx;
    T* e = plane(k, 4);
    T* cur = (iters & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    for (int c = threadIdx.x; c < ny * nx; c += BOT_THREADS) cur[c] = T(0);
    __syncthreads();
    for (int s = 0; s < iters; ++s) {
      sweep_plane(plane(k, 0), plane(k, 1), plane(k, 2), plane(k, 3), cur,
                  oth, ny, nx, sw[nu - 1], somw[nu - 1]);
      T* t = cur; cur = oth; oth = t;
    }
  }

  // way up: src = e + over P e_c (in tmp when nu is odd), the post-sweeps
  // in reverse weight order, ending in e
  for (int k = n - 2; k >= 0; --k) {
    const int ny = slv[k].ny, nx = slv[k].nx, nxc = slv[k + 1].nx;
    T* e = plane(k, 4);
    const T* ec = plane(k + 1, 4);
    T* cur = (nu & 1) ? tmp : e;
    T* oth = cur == e ? tmp : e;
    for (int c = threadIdx.x; c < ny * nx; c += BOT_THREADS) {
      const int i = c / nx, j = c - i * nx;
      cur[c] = e[c] + over * ec[(i >> 1) * nxc + (j >> 1)];
    }
    __syncthreads();
    for (int s = 1; s <= nu; ++s) {
      sweep_plane(plane(k, 0), plane(k, 1), plane(k, 2), plane(k, 3), cur,
                  oth, ny, nx, sw[nu - s], somw[nu - s]);
      T* t = cur; cur = oth; oth = t;
    }
  }

  const T* e0 = plane(0, 4);
  const int n0 = slv[0].ny * slv[0].nx;
  for (int c = threadIdx.x; c < n0; c += BOT_THREADS)
    z[(size_t)b * n0 + c] = e0[c];
}

// Coarsest level from global memory (when it does not fit one CTA): `iters`
// damped-Jacobi sweeps at w from e = 0, one block per image (blockIdx.y),
// ping-ponging between `other` and `out` so that the last sweep lands in
// `out`.
template <typename T>
__global__ void coarse_solve_kernel(Level<T> lv, const T* __restrict__ rhs,
                                    T* out, T* other, T w, T omw, int iters,
                                    const int* flag) {
  if (gated_off(flag)) return;
  if (threadIdx.x == 0) atomicAdd(&g_image_cycles, 1ULL);
  const int n = lv.ny * lv.nx;
  const size_t off = (size_t)blockIdx.y * n;
  const T* aw = lv.aw + off;
  const T* an = lv.an + off;
  const T* di = lv.dinv + off;
  const T* rb = rhs + off;
  T* bufs[2] = {out + off, other + off};
  // sweep s writes bufs[(iters - 1 - s) & 1]; its source is the other one
  T* src = bufs[iters & 1];
  for (int c = threadIdx.x; c < n; c += blockDim.x) src[c] = T(0);
  __syncthreads();
  for (int s = 0; s < iters; ++s) {
    T* dst = bufs[(iters - 1 - s) & 1];
    const T* sv = src;
    auto v = [&](int cc) { return sv[cc]; };
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int i = c / lv.nx, j = c - i * lv.nx;
      const T nb = nbsum(aw, an, v, c, i, j, lv.ny, lv.nx);
      dst[c] = omw * sv[c] + (rb[c] + nb) * (w * di[c]);
    }
    __syncthreads();
    src = dst;
  }
}

// ---- launches

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

template <typename T, int NU>
cudaError_t launch_down(int B, const Level<T>& lv, const T* r, T* e, T* rc,
                        int nyc, int nxc, const Sweeps<T>& sw,
                        const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  const size_t sm = sizeof(T) * 6 * Geo<NU>::N;
  auto kern = level_down_kernel<T, NU>;
  DEFF_TRY(allow_smem(kern, sm, &done));
  const int ntx = down_tiles(Geo<NU>::TX, lv.nx, nxc);
  const int tiles = down_tiles(Geo<NU>::TY, lv.ny, nyc) * ntx;
  DEFF_LAUNCH(kern<<<dim3(tiles, B), LT_THREADS, sm, st>>>(
      lv, r, e, rc, nyc, nxc, ntx, sw, flag));
  return cudaSuccess;
}

template <typename T, int NU>
cudaError_t launch_up(int B, const Level<T>& lv, const T* es, const T* ec,
                      int nyc, int nxc, T over, const T* rhs, T* out,
                      const Sweeps<T>& sw, const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  const size_t sm = sizeof(T) * (6 * Geo<NU>::N + Geo<NU>::NB);
  auto kern = level_up_kernel<T, NU>;
  DEFF_TRY(allow_smem(kern, sm, &done));
  using G = Geo<NU>;
  const int ntx = (lv.nx + G::TX - 1) / G::TX;
  const int tiles = ((lv.ny + G::TY - 1) / G::TY) * ntx;
  DEFF_LAUNCH(kern<<<dim3(tiles, B), LT_THREADS, sm, st>>>(
      lv, es, ec, nyc, nxc, over, rhs, out, ntx, sw, flag));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bottom(int B, int n, const Level<T>* lv, const T* r, T* z,
                          const Sweeps<T>& sw, T over, int iters,
                          const int* flag, cudaStream_t st) {
  static unsigned done = 0;
  if (n < 1 || n > RESIDENT_LEVELS) return cudaErrorInvalidValue;
  Pyramid<T> p{};
  p.n = n;
  long long cells = (long long)lv[0].ny * lv[0].nx;
  for (int k = 0; k < n; ++k) {
    p.lv[k] = lv[k];
    cells += 5LL * lv[k].ny * lv[k].nx;
  }
  const size_t sm = sizeof(T) * cells;
  if ((long long)sm > RESIDENT_SMEM) return cudaErrorInvalidValue;
  auto kern = bottom_kernel<T>;
  DEFF_TRY(allow_smem(kern, (size_t)RESIDENT_SMEM, &done));
  DEFF_LAUNCH(kern<<<dim3(1, B), BOT_THREADS, sm, st>>>(p, r, z, sw, over,
                                                        iters, flag));
  return cudaSuccess;
}

}  // namespace

template <typename T>
cudaError_t cycle_from(int B, int L, const Level<T>* lv, int l0, const T* r,
                       T* z, T* scratch, const double* ws, int nu,
                       int coarse_iters, double over, const int* flag,
                       cudaStream_t st) {
  if (L < 1 || L > MAX_LEVELS || l0 < 0 || l0 >= L || nu < 1 ||
      nu > MAX_NU || coarse_iters < 0 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  ++g_cycles;
  T* R[MAX_LEVELS];
  T* E[MAX_LEVELS];
  T* P[MAX_LEVELS];
  int ny[MAX_LEVELS], nx[MAX_LEVELS];
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    ny[l] = lv[l].ny;
    nx[l] = lv[l].nx;
    const long long n = (long long)B * ny[l] * nx[l];
    R[l] = nullptr;
    if (l > 0) { R[l] = scratch + off; off += n; }
    E[l] = scratch + off; off += n;
    P[l] = scratch + off; off += n;
  }
  int lb = cycle_resident_from(L, ny, nx, (int)sizeof(T));
  if (lb < l0) lb = l0;
  const Sweeps<T> sw = make_sweeps<T>(ws, nu);
  const T tover = (T)over;
  // level l's right-hand side and the plane that receives its correction
  auto rhs = [&](int l) -> const T* { return l == l0 ? r : R[l]; };
  auto cor = [&](int l) -> T* { return l == l0 ? z : P[l]; };

  const int top = lb < L ? lb : L - 1;   // the first level not in passes
  for (int l = l0; l < top; ++l)
    DEFF_TRY(with_nu(nu, [&](auto k) {
      return launch_down<T, decltype(k)::value>(
          B, lv[l], rhs(l), E[l], R[l + 1], ny[l + 1], nx[l + 1], sw, flag,
          st);
    }));
  if (lb < L) {
    DEFF_TRY(launch_bottom<T>(B, L - lb, lv + lb, rhs(lb), cor(lb), sw, tover,
                              coarse_iters, flag, st));
  } else {
    const int lc = L - 1;
    DEFF_LAUNCH(coarse_solve_kernel<T><<<dim3(1, B), THREADS, 0, st>>>(
        lv[lc], rhs(lc), cor(lc), E[lc], sw.w[nu - 1], sw.omw[nu - 1],
        coarse_iters, flag));
  }
  for (int l = top - 1; l >= l0; --l)
    DEFF_TRY(with_nu(nu, [&](auto k) {
      return launch_up<T, decltype(k)::value>(
          B, lv[l], E[l], cor(l + 1), ny[l + 1], nx[l + 1], tover, rhs(l),
          cor(l), sw, flag, st);
    }));
  return cudaSuccess;
}

template cudaError_t cycle_from<float>(int, int, const Level<float>*, int,
                                       const float*, float*, float*,
                                       const double*, int, int, double,
                                       const int*, cudaStream_t);
template cudaError_t cycle_from<double>(int, int, const Level<double>*, int,
                                        const double*, double*, double*,
                                        const double*, int, int, double,
                                        const int*, cudaStream_t);

}  // namespace deff

namespace {

template <typename T>
int v_cycle_entry(int B, int L, const int* ny, const int* nx,
                  const void* const* aw, const void* const* an,
                  const void* const* dinv, const void* r, void* z,
                  void* scratch, const double* ws, int nu, int coarse_iters,
                  double over, const int* flag, void* stream) {
  deff::Level<T> lv[deff::MAX_LEVELS];
  if (!deff::fill_levels<T>(L, ny, nx, aw, an, dinv, lv))
    return cudaErrorInvalidValue;
  return deff::run_cycle<T>(B, L, lv, static_cast<const T*>(r),
                            static_cast<T*>(z), static_cast<T*>(scratch), ws,
                            nu, coarse_iters, over, flag,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

long long deff_cycle_scratch_elems(int L, const int* ny, const int* nx) {
  return deff::cycle_scratch_elems(L, ny, nx);
}

int deff_cycle_resident_from(int L, const int* ny, const int* nx,
                             int itemsize) {
  if (L < 1 || L > deff::MAX_LEVELS) return -1;
  return deff::cycle_resident_from(L, ny, nx, itemsize);
}

long long deff_launch_count() { return deff::g_launches; }

long long deff_cycle_count() { return deff::g_cycles; }

// The device count of image cycles (see g_image_cycles) on the current
// device; synchronises with it.  -1 if the read fails.
long long deff_image_cycle_count() {
  unsigned long long v = 0;
  if (cudaMemcpyFromSymbol(&v, deff::g_image_cycles, sizeof(v)) !=
      cudaSuccess)
    return -1;
  return (long long)v;
}

int deff_v_cycle_f32(int B, int L, const int* ny, const int* nx,
                     const void* const* aw, const void* const* an,
                     const void* const* dinv, const void* r, void* z,
                     void* scratch, const double* ws, int nu,
                     int coarse_iters, double over, const int* flag,
                     void* stream) {
  return v_cycle_entry<float>(B, L, ny, nx, aw, an, dinv, r, z, scratch, ws,
                              nu, coarse_iters, over, flag, stream);
}

int deff_v_cycle_f64(int B, int L, const int* ny, const int* nx,
                     const void* const* aw, const void* const* an,
                     const void* const* dinv, const void* r, void* z,
                     void* scratch, const double* ws, int nu,
                     int coarse_iters, double over, const int* flag,
                     void* stream) {
  return v_cycle_entry<double>(B, L, ny, nx, aw, an, dinv, r, z, scratch, ws,
                               nu, coarse_iters, over, flag, stream);
}

}  // extern "C"
