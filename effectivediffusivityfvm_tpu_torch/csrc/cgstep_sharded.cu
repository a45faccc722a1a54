// K9: the three passes of one multigrid-preconditioned CG iteration on
// every shard of a mesh row that lives on one device -- one launch a pass,
// the shard in blockIdx.z -- with per-image scalars summed over every
// shard of an image on the device.  Loaded with ctypes by
// effectivediffusivityfvm_tpu_torch/ops/kernels/cgstep_sharded.py, which
// runs an iteration as: pass P on the row, the alpha finalize, pass X on
// the row, the coarse levels (K2 or K8, through the caller), pass Z on the
// row and the live finalize, with no host synchronisation -- captured once
// per solve as a CUDA graph for each parity of the p/r ping-pong when the
// shards share one device, launched from a host loop when they span
// several.
//
// Replaces effectivediffusivityfvm_tpu/parallel/fused2d_cg.py
// (_cg_steps_sharded: _pa_cg, _pb_cg, _pc_cg; _cg_steps_sharded_banded:
// cgstep_tiled's _pass_a, _pass_b and _pc_cg_banded).  Per iteration, for
// every live image:
//   P  beta = rz/rz_prev (0 on the image's first iteration of the window,
//      k_done = 0, or if rz_prev <= 0); p = z + beta p_old on the tile and
//      a 1-cell halo, q = A p on the tile; writes p and q, partials of
//      <p, q>;
//   .  alpha = rz/<p,q> summed over all shards (0 unless it is > 0);
//   X  x += alpha p; r_new = r - alpha q on the tile and an nu-cell halo,
//      partials of sum|r_new|; then T1: e0 = (w0 dinv) r_new, the further
//      pre-sweeps each on a halo one smaller, the residual r_new - A e and
//      its 2x2 restriction.  Writes x, r_new, e and the shard's coarse rows
//      (its own plane, or its rows of the gathered tail's plane);
//   .  the coarse correction: the caller's cycle from level 1;
//   Z  e + over e_c[i/2, j/2] on the tile and an nu-cell halo, the nu
//      post-sweeps: z; partials of <r, z>;
//   .  rz_prev = rz, rz = <r, z>, k_done += 1, par ^= 1,
//      live &= stop < sum|r| < hi.
//
// The passes are K5's (cgstep_tiled.cu) on its tile scaffolding
// (tile2d.cuh): 64x16 tiles of 256 threads, every window staged in shared
// memory by cp.async with the smallest halo its chain needs (1 for P, nu
// for X and Z), index arithmetic by compile-time widths, P writing q so
// that X does not recompute it, and the banded sweep form (1 - w) v +
// (w (r + nbsum(v))) dinv of the plain version.  What differs is the
// loader.  A shard's tiles start on its first row; each window row is read
// where it lies -- the shard's own plane, the plane of the shard above or
// below (in place when it shares the device, an exchanged strip when it
// does not), or 0 past the global top and bottom and beyond the nu rows a
// pass needs next to the shard -- and that source is picked once a window
// row, into a table in shared memory, not once an element.  Each shard's
// row table (body, north and south pointers with their own image strides,
// for every plane a pass reads, and its outputs) is passed by value, as
// K8's (vcycle_sharded.cu).  Cells are indexed by their global row, so the
// stencil skips the terms across the global edges only, as K5 skips them
// across the plane's; the plain version adds them as 0 * 0 (the same
// numbers up to the sign of a zero).  A tile recomputes its halo in the
// plain version's order, so every shard agrees with the plain version bit
// for bit outside the (double) reductions.  Where ny_l is not a multiple of
// 16 the shard's last tile row is partial: its rows past the shard are
// computed from zeros and never stored.
//
// Freeze contract, as K5's: every pass of a non-live image returns at once,
// so an iteration after the last image died costs only the gated launches.
// p and r alternate between two buffers for the live images; `par` (per
// image, on the device) says which one holds an image's current p and r,
// and select_kernel copies them to the caller's planes after the window.
// All live images of a window share the iteration's parity, so the host
// passes each pass the buffers of that parity.
//
// Scalars: each pass writes one double partial per tile into slot
// [b][shard * tiles + tile] of a (B, S * tiles) buffer; the finalize
// kernels of cgscalars.cuh sum an image's S * tiles partials in a fixed
// order, so every shard that reads the result reads the same alpha, live
// and rz, and the shards stay in lockstep.  Shards on several devices keep
// one buffer and one scalar state per device, with the partials copied
// between them before each finalize.
//
// Window exit (graph route): the live finalize marks a flag of a ring of
// window.cuh's kind, one ring per workspace (the graphs hold its
// addresses), and the host leaves the window as K5's does (a lag of one
// iteration).  Flag j -- any image live at the start of iteration j --
// lives in slot j % 2: iteration i, replayed from the graph of parity
// i % 2, writes flag i + 1, so each graph writes one fixed slot and the
// two graphs of the ping-pong suffice.  Two slots are enough for a lag of
// one: before replay i the host reads flag i - 1, whose writer (replay
// i - 2) has ended, then zeroes that slot for flag i + 1.  A device-side
// step counter would index the slot in a graph as well, at the cost of a
// counter kernel an iteration.
//
// Bounds on an H100: memory bandwidth, as K5's: per iteration and cell,
// P reads z, p_old and three coefficient planes and writes p and q; X reads
// r, q, x, p and the coefficients and writes x, r, e and a quarter plane;
// Z reads e, r, the coefficients and a quarter plane and writes z.
#include <type_traits>

#include "cgscalars.cuh"
#include "tile2d.cuh"

namespace deff {
namespace {

constexpr int MAX_NU = 4;          // the sharded engine's nu (HALO - 4)
constexpr int MAX_SHARDS = 8;      // shards of one launch
constexpr int MIN_ROWS = 8;        // a shard's rows (the strips' HALO)
constexpr int K9_SLOTS = 2;        // window flags of the graph route
static_assert(WINDOW_LAG == 1 && K9_SLOTS == WINDOW_LAG + 1 &&
                  K9_SLOTS <= WINDOW_RING,
              "the graphs of the two parities write flag slots 1 and 0");
static_assert(MAX_NU <= WK_MAX, "a leg's damping factors fit WK");
static_assert(MAX_NU <= MIN_ROWS, "a pass reads at most nu rows beyond a "
                                  "shard, all inside its neighbour or strip");

// One plane of a shard, image 0: its rows, the row one past the last row
// above it (null past the global top) and the first row below it (null
// past the global bottom), each with its image stride in elements.
template <typename T>
struct Src {
  const T* body;
  const T* north;
  const T* south;
  long long sb, sn, ss;

  // Row r of image b (shard rows 0..ny-1; r < 0 above, r >= ny below):
  // the address of its column 0, or null where the row reads 0 (past the
  // global edges, or more than lim rows beyond the shard).
  __device__ __forceinline__ const T* row(int b, int r, int ny, int nx,
                                          int lim) const {
    if (r < -lim || r >= ny + lim) return nullptr;
    if (r < 0)
      return north != nullptr ? north + b * sn + (long long)r * nx : nullptr;
    if (r < ny) return body + b * sb + (long long)r * nx;
    return south != nullptr ? south + b * ss + (long long)(r - ny) * nx
                            : nullptr;
  }
};

// The shards' tables.  Staged planes first (in[0..2] the coefficients
// a_w, a_n, diag_inv); outputs at image stride ny * nx (rc at its own).
template <typename T>
struct PShard {
  Src<T> in[5];          // a_w, a_n, diag_inv, z, p_old
  T* p;
  T* q;
  int idx;               // the shard's place in the row
};

template <typename T>
struct XShard {
  Src<T> in[5];          // a_w, a_n, diag_inv, r_old, q
  const T* p;
  T* x;
  T* r;
  T* e;
  T* rc;
  long long src;         // rc's image stride
  int idx;
};

template <typename T>
struct ZShard {
  Src<T> in[5];          // a_w, a_n, diag_inv, e, r_new
  Src<T> ec;             // the coarse correction (ny/2 x nx/2 a shard)
  T* z;
  int idx;
};

template <typename S>
struct Row {
  S s[MAX_SHARDS];
};

// Stage the NP planes `in` of image b on the tile at (i0, j0) (shard rows)
// with an H-cell halo into dst, plane k at dst + k N: each window row's
// source first, once, into `rows`, then the row's cells by cp.async.
// Synchronises once, before the copies; the caller waits for them.
template <int H, int NP, typename T>
__device__ __forceinline__ void stage_shard(const T* (&rows)[NP][Reg<H>::R],
                                            const Src<T>* in, int b, int i0,
                                            int j0, int ny, int nx, T* dst) {
  using RG = Reg<H>;
  for (int c = threadIdx.x; c < NP * RG::R; c += THREADS) {
    const int k = c / RG::R, li = c - k * RG::R;
    rows[k][li] = in[k].row(b, i0 - H + li, ny, nx, H);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const T* const* rk = rows[k];
    const T* fallback = in[k].body;
    T* d = dst + k * RG::N;
    for (int e = threadIdx.x; e < RG::N; e += THREADS) {
      const int li = e / RG::W, gj = j0 - H + (e - li * RG::W);
      const T* rp = rk[li];
      const bool ok = rp != nullptr && gj >= 0 && gj < nx;
      cp_async(d + e, ok ? rp + gj : fallback, ok);
    }
  }
}

// Per-tile partials of sum|r| over a shard, into its slots of part.
template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_abs_parts_kernel(const T* __restrict__ r, int ny, int nx, double* part,
                       int ntot, int poff) {
  __shared__ double sh[THREADS];
  const TileAt t(nx);
  const T* rb = r + (size_t)blockIdx.y * ny * nx;
  double acc = 0.0;
  for_cells<0, 0>(t.i0, t.j0, ny, nx, [&](int, int gi, int gj) {
    const T v = rb[(size_t)gi * nx + gj];
    acc += (double)(v < T(0) ? -v : v);
  });
  const double s = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0)
    part[(size_t)blockIdx.y * ntot + poff + blockIdx.x] = s;
}

// ---- pass P: p = z + beta p_old on the window, q = A p on the tile;
// writes p and q, partials of <p, q>.
template <typename T>
__global__ void __launch_bounds__(THREADS)
shard_p_kernel(const __grid_constant__ Row<PShard<T>> row, int ny, int nx,
               int nyg, CgState<T> s) {
  constexpr int H = 1, NP = 5;
  using RG = Reg<H>;
  __shared__ double red[THREADS];
  __shared__ const T* rows[NP][RG::R];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const PShard<T>& sh = row.s[blockIdx.z];
  T* aw = reinterpret_cast<T*>(smem_raw);
  T* an = aw + RG::N;
  T* di = an + RG::N;
  T* ps = di + RG::N;                    // z, then p in place
  const T* os = ps + RG::N;              // p_old
  const TileAt t(nx);
  stage_shard<H, NP>(rows, sh.in, b, t.i0, t.j0, ny, nx, aw);
  cp_async_wait();
  const T rzp = s.rz_prev[b], rzc = s.rz[b];
  const T beta = (s.k_done[b] != 0 && rzp > T(0)) ? rzc / rzp : T(0);
  for (int e = threadIdx.x; e < RG::N; e += THREADS)
    ps[e] = ps[e] + beta * os[e];
  __syncthreads();
  auto v = [&](int e) { return ps[e]; };
  const int g0 = sh.idx * ny;            // the shard's first global row
  const size_t off = (size_t)b * ny * nx;
  double acc = 0.0;
  for_cells<H, 0>(g0 + t.i0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
    const int li = gi - g0;
    if (li >= ny) return;
    const T pc = ps[e];
    const T qv = diag_of(di[e]) * pc -
                 nbsum_s<RG::W>(aw, an, v, e, gi, gj, nyg, nx);
    const size_t g = off + (size_t)li * nx + gj;
    sh.p[g] = pc;
    sh.q[g] = qv;
    const T prod = pc * qv;
    acc += (double)prod;
  });
  const double sum = block_sum_fixed(acc, red);
  if (threadIdx.x == 0)
    s.part_a[(size_t)b * s.ntiles + (size_t)sh.idx * gridDim.x + blockIdx.x] =
        sum;
}

// ---- pass X: x += alpha p, r_new = r - alpha q on the window (partials of
// sum|r_new| on the tile), the NU pre-sweeps into e, the residual
// restricted 2x2 into the shard's coarse rows.
template <typename T, int NU>
__global__ void __launch_bounds__(THREADS)
shard_x_kernel(const __grid_constant__ Row<XShard<T>> row, int ny, int nx,
               int nyg, CgState<T> s, WK ws) {
  constexpr int H = NU, NP = 5;
  using RG = Reg<H>;
  __shared__ double red[THREADS];
  __shared__ const T* rows[NP][RG::R];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const XShard<T>& sh = row.s[blockIdx.z];
  T* aw = reinterpret_cast<T*>(smem_raw);
  T* an = aw + RG::N;
  T* di = an + RG::N;
  T* rs = di + RG::N;                    // r, then r_new in place
  const T* qs = rs + RG::N;
  T* ea = rs + 2 * RG::N;                // sweeps 1, 3
  T* eb2 = ea + RG::N;                   // sweep 2 (NU >= 3)
  const TileAt t(nx);
  stage_shard<H, NP>(rows, sh.in, b, t.i0, t.j0, ny, nx, aw);
  cp_async_wait();
  const T alpha = s.alpha[b];
  for (int e = threadIdx.x; e < RG::N; e += THREADS)
    rs[e] = rs[e] - alpha * qs[e];
  __syncthreads();
  const int g0 = sh.idx * ny;
  const int gi0 = g0 + t.i0;
  const T w0 = (T)ws.w[0];
  auto e0 = [&](int e) { return (w0 * di[e]) * rs[e]; };
  // sweep 1 reads e0; sweep s >= 2 reads the previous sweep's buffer
  if constexpr (NU >= 2) {
    const T w = (T)ws.w[1], omw = (T)(1.0 - ws.w[1]);
    for_cells<H, H - 1>(gi0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
      const T nb = nbsum_s<RG::W>(aw, an, e0, e, gi, gj, nyg, nx);
      ea[e] = omw * e0(e) + (w * (rs[e] + nb)) * di[e];
    });
    __syncthreads();
    for (int sw = 2; sw < NU; ++sw) {
      const T* src = (sw & 1) ? eb2 : ea;
      T* dst = (sw & 1) ? ea : eb2;
      const T ww = (T)ws.w[sw], om = (T)(1.0 - ws.w[sw]);
      auto sv = [&](int e) { return src[e]; };
      for_ring<H>(H - sw, gi0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
        const T nb = nbsum_s<RG::W>(aw, an, sv, e, gi, gj, nyg, nx);
        dst[e] = om * src[e] + (ww * (rs[e] + nb)) * di[e];
      });
      __syncthreads();
    }
  }
  const T* ef = ((NU - 1) & 1) ? ea : eb2;   // the last sweep's buffer
  auto ev = [&](int e) { return NU == 1 ? e0(e) : ef[e]; };
  const size_t off = (size_t)b * ny * nx;
  double acc = 0.0;
  for_cells<H, 0>(gi0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
    const int li = gi - g0;
    if (li >= ny) return;
    const size_t g = off + (size_t)li * nx + gj;
    sh.x[g] = sh.x[g] + alpha * sh.p[g];
    const T rv = rs[e];
    sh.r[g] = rv;
    sh.e[g] = ev(e);
    acc += (double)(rv < T(0) ? -rv : rv);
  });
  const double sum = block_sum_fixed(acc, red);
  if (threadIdx.x == 0)
    s.part_b[(size_t)b * s.ntiles + (size_t)sh.idx * gridDim.x + blockIdx.x] =
        sum;
  const int I = t.i0 / 2 + threadIdx.x / (TX / 2);
  const int J = t.j0 / 2 + threadIdx.x % (TX / 2);
  if (2 * I >= ny || 2 * J >= nx) return;
  auto res = [&](int li, int gj) {
    const int e = (li - t.i0 + H) * RG::W + (gj - t.j0 + H);
    return rs[e] - (diag_of(di[e]) * ev(e) -
                    nbsum_s<RG::W>(aw, an, ev, e, g0 + li, gj, nyg, nx));
  };
  const int i = 2 * I, j = 2 * J;
  sh.rc[(size_t)b * sh.src + (size_t)I * (nx / 2) + J] =
      (res(i, j) + res(i + 1, j)) + (res(i, j + 1) + res(i + 1, j + 1));
}

// ---- pass Z: src = e + over e_c[i/2, j/2] on the window, then the NU
// post-sweeps (ws reversed) give z on the tile; partials of <r_new, z>.
template <typename T, int NU>
__global__ void __launch_bounds__(THREADS)
shard_z_kernel(const __grid_constant__ Row<ZShard<T>> row, int ny, int nx,
               int nyg, T over, CgState<T> s, WK ws) {
  constexpr int H = NU, NP = 5;
  using RG = Reg<H>;
  constexpr int CR = TY / 2 + H + 1;     // coarse rows under a window
  __shared__ double red[THREADS];
  __shared__ const T* rows[NP][RG::R];
  __shared__ const T* crow[CR];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const ZShard<T>& sh = row.s[blockIdx.z];
  T* aw = reinterpret_cast<T*>(smem_raw);
  T* an = aw + RG::N;
  T* di = an + RG::N;
  T* ss = di + RG::N;                    // e, then the sweeps' ping-pong
  const T* rs = ss + RG::N;
  T* es = ss + 2 * RG::N;                // (NU >= 2)
  const TileAt t(nx);
  // coarse row (i0 - H) >> 1 first: fine window row li reads coarse row
  // li >> 1 (every shard starts on an even global row)
  const int c0 = (t.i0 - H) >> 1;
  const int nxc = nx / 2;
  for (int c = threadIdx.x; c < CR; c += THREADS)
    crow[c] = sh.ec.row(b, c0 + c, ny / 2, nxc, (H + 1) / 2);
  stage_shard<H, NP>(rows, sh.in, b, t.i0, t.j0, ny, nx, aw);
  cp_async_wait();
  const int g0 = sh.idx * ny;
  const int gi0 = g0 + t.i0;
  for_cells<H, H>(gi0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
    const T* cr = crow[((gi - g0) >> 1) - c0];
    ss[e] = ss[e] + over * (cr != nullptr ? cr[gj >> 1] : T(0));
  });
  __syncthreads();
  // sweeps 1..NU-1 ping-pong ss -> es -> ss ...
  for (int sw = 1; sw < NU; ++sw) {
    const T* src = (sw & 1) ? ss : es;
    T* dst = (sw & 1) ? es : ss;
    const double wd = ws.w[NU - sw];
    const T w = (T)wd, omw = (T)(1.0 - wd);
    auto sv = [&](int e) { return src[e]; };
    for_ring<H>(H - sw, gi0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
      const T nb = nbsum_s<RG::W>(aw, an, sv, e, gi, gj, nyg, nx);
      dst[e] = omw * src[e] + (w * (rs[e] + nb)) * di[e];
    });
    __syncthreads();
  }
  const T* src = ((NU - 1) & 1) ? es : ss;
  auto sv = [&](int e) { return src[e]; };
  const T w = (T)ws.w[0], omw = (T)(1.0 - ws.w[0]);
  const size_t off = (size_t)b * ny * nx;
  double acc = 0.0;
  for_cells<H, 0>(gi0, t.j0, nyg, nx, [&](int e, int gi, int gj) {
    const int li = gi - g0;
    if (li >= ny) return;
    const T nb = nbsum_s<RG::W>(aw, an, sv, e, gi, gj, nyg, nx);
    const T zv = omw * src[e] + (w * (rs[e] + nb)) * di[e];
    sh.z[off + (size_t)li * nx + gj] = zv;
    const T prod = rs[e] * zv;
    acc += (double)prod;
  });
  const double sum = block_sum_fixed(acc, red);
  if (threadIdx.x == 0)
    s.part_c[(size_t)b * s.ntiles + (size_t)sh.idx * gridDim.x + blockIdx.x] =
        sum;
}

// Dynamic shared memory of each pass, in elements.
constexpr int p_elems() { return 5 * Reg<1>::N; }
template <int NU>
constexpr int x_elems() { return (NU >= 3 ? 7 : 6) * Reg<NU>::N; }
template <int NU>
constexpr int z_elems() { return (NU >= 2 ? 6 : 5) * Reg<NU>::N; }

// The caller's p and r of every image from the buffer its parity names:
// dst = par ? src1 : src0.
template <typename T>
__global__ void select_kernel(T* dst_r, const T* r0, const T* r1, T* dst_p,
                              const T* p0, const T* p1, int n,
                              const int* par) {
  const size_t off = (size_t)blockIdx.y * n;
  const bool one = par[blockIdx.y] != 0;
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    dst_r[off + c] = (one ? r1 : r0)[off + c];
    dst_p[off + c] = (one ? p1 : p0)[off + c];
  }
}

// st: rz, rz_prev, alpha, stop, hi, live, par, k_done, part_a, part_b,
// part_c (device pointers); ntot = partials per image over all shards.
template <typename T>
CgState<T> state_of(const void* const* st, int ntot) {
  CgState<T> s{};
  s.rz = static_cast<T*>(const_cast<void*>(st[0]));
  s.rz_prev = static_cast<T*>(const_cast<void*>(st[1]));
  s.alpha = static_cast<T*>(const_cast<void*>(st[2]));
  s.stop = static_cast<const T*>(st[3]);
  s.hi = static_cast<const T*>(st[4]);
  s.live = static_cast<int*>(const_cast<void*>(st[5]));
  s.par = static_cast<int*>(const_cast<void*>(st[6]));
  s.k_done = static_cast<int*>(const_cast<void*>(st[7]));
  s.part_a = static_cast<double*>(const_cast<void*>(st[8]));
  s.part_b = static_cast<double*>(const_cast<void*>(st[9]));
  s.part_c = static_cast<double*>(const_cast<void*>(st[10]));
  s.ntiles = ntot;
  return s;
}

// Plane k of a shard's table: three pointers and three strides.
template <typename T>
Src<T> src_of(const void* const* p, const long long* s, int k) {
  return Src<T>{static_cast<const T*>(p[3 * k]),
                static_cast<const T*>(p[3 * k + 1]),
                static_cast<const T*>(p[3 * k + 2]), s[3 * k], s[3 * k + 1],
                s[3 * k + 2]};
}

template <typename T>
T* out_of(const void* const* p, int k) {
  return static_cast<T*>(const_cast<void*>(p[k]));
}

// Per shard of a launch: the staged planes (a pointer triple and a stride
// triple each), then the outputs (one slot each); idx[k] its place in the
// row of nsh shards.
constexpr int P_SLOTS = 17;    // a_w, a_n, diag_inv, z, p_old; p, q
constexpr int X_SLOTS = 20;    // a_w, a_n, diag_inv, r_old, q; p, x, r, e, rc
constexpr int Z_SLOTS = 19;    // a_w, a_n, diag_inv, e, r_new, e_c; z

bool bad_row(int S, int nsh, int B, int ny, int nx, const int* idx, int nu) {
  if (S < 1 || S > MAX_SHARDS || nsh < S || B < 1 || B > 65535 ||
      ny < MIN_ROWS || nx < 2 || ny % 2 || nx % 2 || nu < 1 || nu > MAX_NU)
    return true;
  for (int k = 0; k < S; ++k)
    if (idx[k] < 0 || idx[k] >= nsh) return true;
  return false;
}

template <typename F>
cudaError_t with_nu(int nu, F f) {
  switch (nu) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return cudaErrorInvalidValue;
  }
}
static_assert(MAX_NU == 4, "with_nu instantiates nu = 1..MAX_NU");

WK make_wk(const double* ws, int nu) {
  WK w{};
  for (int i = 0; i < nu && i < MAX_NU; ++i) w.w[i] = ws[i];
  return w;
}

#define DEFF_TRY9(...)                         \
  do {                                         \
    cudaError_t _t = (__VA_ARGS__);            \
    if (_t != cudaSuccess) return _t;          \
  } while (0)

template <typename T>
int p_entry(int S, int nsh, int B, int ny, int nx, const void* const* p,
            const long long* s, const int* idx, const void* const* st,
            void* stream) {
  if (bad_row(S, nsh, B, ny, nx, idx, 1)) return cudaErrorInvalidValue;
  Row<PShard<T>> row{};
  for (int k = 0; k < S; ++k) {
    const void* const* q = p + k * P_SLOTS;
    PShard<T>& sh = row.s[k];
    for (int j = 0; j < 5; ++j) sh.in[j] = src_of<T>(q, s + k * P_SLOTS, j);
    sh.p = out_of<T>(q, 15);
    sh.q = out_of<T>(q, 16);
    sh.idx = idx[k];
  }
  static unsigned done = 0;
  const size_t sm = sizeof(T) * p_elems();
  auto kern = shard_p_kernel<T>;
  DEFF_TRY9(allow_smem(kern, sm, &done));
  const int nt = tiles_for(ny, nx);
  DEFF_LAUNCH(kern<<<dim3(nt, B, S), THREADS, sm,
                     static_cast<cudaStream_t>(stream)>>>(
      row, ny, nx, nsh * ny, state_of<T>(st, nsh * nt)));
  return cudaSuccess;
}

template <typename T>
int x_entry(int S, int nsh, int B, int ny, int nx, const void* const* p,
            const long long* s, const int* idx, const void* const* st,
            const double* ws, int nu, void* stream) {
  if (bad_row(S, nsh, B, ny, nx, idx, nu)) return cudaErrorInvalidValue;
  Row<XShard<T>> row{};
  for (int k = 0; k < S; ++k) {
    const void* const* q = p + k * X_SLOTS;
    XShard<T>& sh = row.s[k];
    for (int j = 0; j < 5; ++j) sh.in[j] = src_of<T>(q, s + k * X_SLOTS, j);
    sh.p = out_of<T>(q, 15);
    sh.x = out_of<T>(q, 16);
    sh.r = out_of<T>(q, 17);
    sh.e = out_of<T>(q, 18);
    sh.rc = out_of<T>(q, 19);
    sh.src = s[k * X_SLOTS + 19];
    sh.idx = idx[k];
  }
  const WK w = make_wk(ws, nu);
  const auto stp = static_cast<cudaStream_t>(stream);
  const int nt = tiles_for(ny, nx);
  const CgState<T> cs = state_of<T>(st, nsh * nt);
  return with_nu(nu, [&](auto kk) -> cudaError_t {
    constexpr int NU = decltype(kk)::value;
    static unsigned done = 0;
    const size_t sm = sizeof(T) * x_elems<NU>();
    auto kern = shard_x_kernel<T, NU>;
    DEFF_TRY9(allow_smem(kern, sm, &done));
    DEFF_LAUNCH(kern<<<dim3(nt, B, S), THREADS, sm, stp>>>(
        row, ny, nx, nsh * ny, cs, w));
    return cudaSuccess;
  });
}

template <typename T>
int z_entry(int S, int nsh, int B, int ny, int nx, const void* const* p,
            const long long* s, const int* idx, const void* const* st,
            const double* ws, int nu, double over, void* stream) {
  if (bad_row(S, nsh, B, ny, nx, idx, nu)) return cudaErrorInvalidValue;
  Row<ZShard<T>> row{};
  for (int k = 0; k < S; ++k) {
    const void* const* q = p + k * Z_SLOTS;
    ZShard<T>& sh = row.s[k];
    for (int j = 0; j < 5; ++j) sh.in[j] = src_of<T>(q, s + k * Z_SLOTS, j);
    sh.ec = src_of<T>(q, s + k * Z_SLOTS, 5);
    sh.z = out_of<T>(q, 18);
    sh.idx = idx[k];
  }
  const WK w = make_wk(ws, nu);
  const auto stp = static_cast<cudaStream_t>(stream);
  const int nt = tiles_for(ny, nx);
  const CgState<T> cs = state_of<T>(st, nsh * nt);
  return with_nu(nu, [&](auto kk) -> cudaError_t {
    constexpr int NU = decltype(kk)::value;
    static unsigned done = 0;
    const size_t sm = sizeof(T) * z_elems<NU>();
    auto kern = shard_z_kernel<T, NU>;
    DEFF_TRY9(allow_smem(kern, sm, &done));
    DEFF_LAUNCH(kern<<<dim3(nt, B, S), THREADS, sm, stp>>>(
        row, ny, nx, nsh * ny, (T)over, cs, w));
    return cudaSuccess;
  });
}

template <typename T>
int abs_parts_entry(int B, int ny, int nx, const void* r, void* part,
                    int ntot, int poff, void* stream) {
  if (B < 1 || B > 65535 || ny < 1 || nx < 1) return cudaErrorInvalidValue;
  DEFF_LAUNCH(shard_abs_parts_kernel<T><<<dim3(tiles_for(ny, nx), B),
                                          THREADS, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), ny, nx, static_cast<double*>(part), ntot,
      poff));
  return cudaSuccess;
}

// kind 0: init (live from active and sum|r|), 1: alpha, 2: live and rz;
// any: the window flag the live or init finalize marks (or null).
template <typename T>
int fin_entry(int kind, int B, const void* const* st, int ntot,
              const void* active, void* any, void* stream) {
  if (B < 1 || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  CgState<T> s = state_of<T>(st, ntot);
  s.any = static_cast<int*>(any);
  const auto stp = static_cast<cudaStream_t>(stream);
  const dim3 per_image(1, B);
  if (kind == 0)
    DEFF_LAUNCH(fin_init_kernel<T><<<per_image, THREADS, 0, stp>>>(
        s, static_cast<const T*>(active)));
  else if (kind == 1)
    DEFF_LAUNCH(fin_alpha_kernel<T><<<per_image, THREADS, 0, stp>>>(s));
  else
    DEFF_LAUNCH(fin_live_kernel<T><<<per_image, THREADS, 0, stp>>>(s));
  return cudaSuccess;
}

template <typename T>
int select_entry(int B, int n, void* dst_r, const void* r0, const void* r1,
                 void* dst_p, const void* p0, const void* p1, const int* par,
                 void* stream) {
  if (B < 1 || n < 1) return cudaErrorInvalidValue;
  DEFF_LAUNCH(select_kernel<T><<<dim3(blocks_for(n), B), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(dst_r), static_cast<const T*>(r0),
      static_cast<const T*>(r1), static_cast<T*>(dst_p),
      static_cast<const T*>(p0), static_cast<const T*>(p1), n, par));
  return cudaSuccess;
}

}  // namespace
}  // namespace deff

extern "C" {

int deff_shard_tiles(int ny, int nx) { return deff::tiles_for(ny, nx); }

// The graph route's window ring (window.cuh), one per workspace, on the
// current device; null if it cannot be made.
void* deff_shard_ring_new() {
  auto* r = new deff::WindowRing;
  if (deff::ring_alloc(*r) != cudaSuccess) {
    delete r;
    return nullptr;
  }
  return r;
}

void deff_shard_ring_free(void* h) {
  auto* r = static_cast<deff::WindowRing*>(h);
  if (r == nullptr) return;
  for (int j = 0; j < deff::WINDOW_RING; ++j)
    if (r->ev[j] != nullptr) {
      cudaEventSynchronize(r->ev[j]);
      cudaEventDestroy(r->ev[j]);
    }
  if (r->host != nullptr) cudaFreeHost(r->host);
  delete r;
}

// Flag j's slot zeroed; its device address, for the finalize that marks it.
void* deff_shard_ring_flag(void* h, int j) {
  auto* r = static_cast<deff::WindowRing*>(h);
  const int k = j % deff::K9_SLOTS;
  r->host[k] = 0;
  return r->dev + k;
}

// An event behind the finalize that marks flag j.
int deff_shard_ring_mark(void* h, int j, void* stream) {
  auto* r = static_cast<deff::WindowRing*>(h);
  return cudaEventRecord(r->ev[j % deff::K9_SLOTS],
                         static_cast<cudaStream_t>(stream));
}

// Flag j once its event has passed: 1 if an image was live, 0 if none, a
// negative cudaError_t on failure.
int deff_shard_ring_live(void* h, int j) {
  auto* r = static_cast<deff::WindowRing*>(h);
  const int k = j % deff::K9_SLOTS;
  const cudaError_t e = cudaEventSynchronize(r->ev[k]);
  if (e != cudaSuccess) return -(int)e;
  return reinterpret_cast<volatile int*>(r->host)[k] != 0 ? 1 : 0;
}

#define DEFF_SHARD_CG_ENTRIES(SUF, T)                                         \
  int deff_shard_abs_parts_##SUF(int B, int ny, int nx, const void* r,        \
                                 void* part, int ntot, int poff,              \
                                 void* stream) {                              \
    return deff::abs_parts_entry<T>(B, ny, nx, r, part, ntot, poff, stream);  \
  }                                                                           \
  int deff_shard_fin_##SUF(int kind, int B, const void* const* st, int ntot,  \
                           const void* active, void* any, void* stream) {     \
    return deff::fin_entry<T>(kind, B, st, ntot, active, any, stream);        \
  }                                                                           \
  int deff_shard_select_##SUF(int B, int n, void* dst_r, const void* r0,      \
                              const void* r1, void* dst_p, const void* p0,    \
                              const void* p1, const int* par, void* stream) { \
    return deff::select_entry<T>(B, n, dst_r, r0, r1, dst_p, p0, p1, par,     \
                                 stream);                                     \
  }                                                                           \
  int deff_shard_p_##SUF(int S, int nsh, int B, int ny, int nx,               \
                         const void* const* p, const long long* s,            \
                         const int* idx, const void* const* st,               \
                         void* stream) {                                      \
    return deff::p_entry<T>(S, nsh, B, ny, nx, p, s, idx, st, stream);        \
  }                                                                           \
  int deff_shard_x_##SUF(int S, int nsh, int B, int ny, int nx,               \
                         const void* const* p, const long long* s,            \
                         const int* idx, const void* const* st,               \
                         const double* ws, int nu, void* stream) {            \
    return deff::x_entry<T>(S, nsh, B, ny, nx, p, s, idx, st, ws, nu,         \
                            stream);                                          \
  }                                                                           \
  int deff_shard_z_##SUF(int S, int nsh, int B, int ny, int nx,               \
                         const void* const* p, const long long* s,            \
                         const int* idx, const void* const* st,               \
                         const double* ws, int nu, double over,               \
                         void* stream) {                                      \
    return deff::z_entry<T>(S, nsh, B, ny, nx, p, s, idx, st, ws, nu, over,   \
                            stream);                                          \
  }

DEFF_SHARD_CG_ENTRIES(f32, float)
DEFF_SHARD_CG_ENTRIES(f64, double)

}  // extern "C"
