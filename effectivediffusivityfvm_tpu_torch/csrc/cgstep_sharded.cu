// K9: the three passes of one multigrid-preconditioned CG iteration on one
// row shard, with per-image scalars summed over every shard of an image on
// the device.  Loaded with ctypes by
// effectivediffusivityfvm_tpu_torch/ops/kernels/cgstep_sharded.py, which
// runs an iteration as: pass A on every shard, the alpha finalize, pass B on
// every shard, the coarse levels (K8 / K2, through the caller), pass C on
// every shard and the live finalize, with the halo strips exchanged between
// the passes and no host synchronisation -- captured once per solve as a
// CUDA graph for each parity of the p/r ping-pong when the shards share one
// device, launched from a host loop when they span several.
//
// Replaces effectivediffusivityfvm_tpu/parallel/fused2d_cg.py
// (_cg_steps_sharded: _pa_cg, _pb_cg, _pc_cg; _cg_steps_sharded_banded:
// cgstep_tiled's _pass_a, _pass_b and _pc_cg_banded).  Per iteration, for
// every live image:
//   A  beta = rz/rz_prev (0 on the image's first iteration of the window,
//      k_done = 0, or if rz_prev <= 0); p = z + beta p_old on the window,
//      q = A p, partials of <p, q>;
//   .  alpha = rz/<p,q> summed over all shards (0 unless it is > 0);
//   B  x += alpha p; r -= alpha q with q recomputed from p on the window;
//      T1 (tiled.cuh) on the new r; partials of sum|r|;
//   C  T2 from the coarse correction gives z; partials of <r, z>;
//   .  rz_prev = rz, rz = <r, z>, k_done += 1, par ^= 1,
//      live &= stop < sum|r| < hi.
// The TPU's band split existed for VMEM; here a shard is tiled as any plane
// and the window loader reads the neighbours' rows from the exchanged
// strips (tiled.cuh, Rows).
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
// Bounds on an H100: memory bandwidth, as K5 (cgstep_tiled.cu): per
// iteration and cell, A reads z, p_old and three coefficient planes and
// writes p; B reads x, p, r and the coefficients and writes x, r, e and a
// quarter plane; C reads e, r, the coefficients and a quarter plane and
// writes z.
#include "cgscalars.cuh"
#include "tiled.cuh"

namespace deff {
namespace {

static_assert(TILE_THREADS == THREADS, "tile blocks are THREADS wide");

template <typename T>
Rows<T> rows_of(const void* const* p, int sh) {
  Rows<T> g;
  g.body = static_cast<const T*>(p[0]);
  g.north = static_cast<const T*>(p[1]);
  g.south = static_cast<const T*>(p[2]);
  g.sh = sh;
  return g;
}

template <typename T>
ShardCoef<T> coef_of(const void* const* p, int sh) {
  ShardCoef<T> f;
  f.aw = rows_of<T>(p, sh);
  f.an = rows_of<T>(p + 3, sh);
  f.dinv = rows_of<T>(p + 6, sh);
  return f;
}

// st: rz, rz_prev, alpha, stop, hi, live, par, k_done, part_a, part_b,
// part_c (device pointers); ntiles = partials per image over all shards.
template <typename T>
CgState<T> state_of(const void* const* st, int ntiles) {
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
  s.ntiles = ntiles;
  return s;
}

// Per-tile partials of sum|r| over a shard, into its slots of part.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
shard_abs_parts_kernel(const T* __restrict__ r, int py, int px, double* part,
                       int ntiles, int poff) {
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
  if (threadIdx.x == 0)
    part[(size_t)blockIdx.y * ntiles + poff + blockIdx.x] = s;
}

// Pass A: p = z + beta p_old, q = A p, partials of <p, q>.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
shard_pass_a_kernel(ShardCoef<T> f, Rows<T> z, Rows<T> pold, int py, int px,
                    T* __restrict__ pnew, CgState<T> s, int poff, int h) {
  __shared__ double sh[TILE_THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const Tile t = make_tile(py, px, h);
  T* S = reinterpret_cast<T*>(smem_raw);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *P = S + 3 * n;
  const T rzp = s.rz_prev[b], rzc = s.rz[b];
  const bool first = s.k_done[b] == 0;
  const T beta = (!first && rzp > T(0)) ? rzc / rzp : T(0);
  coeff_windows_rows(f, b, t, AW, AN, DI);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int wi = c / t.wx, wj = c - wi * t.wx;
    const int gi = t.i0 + wi, gj = t.j0 + wj;
    P[c] = (rows_has(pold, gi, py) && gj >= 0 && gj < px)
               ? rows_at(z, b, gi, gj, py, px) +
                     beta * rows_at(pold, b, gi, gj, py, px)
               : T(0);
  }
  __syncthreads();
  double acc = 0.0;
  T* pb = pnew + (size_t)b * py * px;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi >= py || gj >= px) continue;
    const int wi = ti + h, wj = tj + h, wc = wi * t.wx + wj;
    const T pc = P[wc];
    const T q = diag_of(DI[wc]) * pc -
                wnbsum(AW, AN, P, wc, wi, wj, t.wy, t.wx);
    pb[(size_t)gi * px + gj] = pc;
    const T prod = pc * q;
    acc += (double)prod;
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0)
    s.part_a[(size_t)b * s.ntiles + poff + blockIdx.x] = sum;
}

// Pass B: x += alpha p, r -= alpha q, partials of sum|r|, then T1 on r.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
shard_pass_b_kernel(ShardCoef<T> f, T* __restrict__ x, Rows<T> p,
                    Rows<T> rold, int py, int px, T* __restrict__ rnew,
                    T* __restrict__ e, T* __restrict__ rc, CgState<T> s,
                    int poff, Weights ws, int h) {
  __shared__ double sh[TILE_THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const Tile t = make_tile(py, px, h);
  const size_t off = (size_t)b * py * px;
  T* S = reinterpret_cast<T*>(smem_raw);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *P = S + 3 * n, *R = S + 4 * n;
  T *E0 = S + 5 * n, *E1 = S + 6 * n;
  const T alpha = s.alpha[b];
  coeff_windows_rows(f, b, t, AW, AN, DI);
  load_window_rows(P, p, b, t);
  load_window_rows(R, rold, b, t);
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
  T* rb = rnew + off;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi >= py || gj >= px) continue;
    const int wc = (ti + h) * t.wx + tj + h;
    const size_t g = (size_t)gi * px + gj;
    xb[g] = xb[g] + alpha * P[wc];
    const T rv = R[wc];
    rb[g] = rv;
    acc += (double)(rv < T(0) ? -rv : rv);
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0)
    s.part_b[(size_t)b * s.ntiles + poff + blockIdx.x] = sum;
  const T* E = pre_smooth(AW, AN, DI, R, E0, E1, ws, t);
  store_interior(e + off, E, t);
  restrict_tile(AW, AN, DI, R, E, t, rc + (size_t)b * (py / 2) * (px / 2));
}

// Pass C: T2 gives z, partials of <r, z>.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
shard_pass_c_kernel(ShardCoef<T> f, Rows<T> e, Rows<T> r, Rows<T> ec,
                    int py, int px, T* __restrict__ z, T over, CgState<T> s,
                    int poff, Weights ws, int h) {
  __shared__ double sh[TILE_THREADS];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  T* S = reinterpret_cast<T*>(smem_raw);
  const Tile t = make_tile(py, px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *R = S + 3 * n;
  T *E0 = S + 4 * n, *E1 = S + 5 * n;
  coeff_windows_rows(f, b, t, AW, AN, DI);
  load_window_rows(R, r, b, t);
  const T* Z = post_smooth_rows(AW, AN, DI, R, E0, E1, e, ec, b, over, ws, t);
  double acc = 0.0;
  T* zb = z + (size_t)b * py * px;
  for (int c = threadIdx.x; c < TY * TX; c += blockDim.x) {
    const int ti = c / TX, tj = c - ti * TX;
    const int gi = t.ty0 + ti, gj = t.tx0 + tj;
    if (gi >= py || gj >= px) continue;
    const int wc = (ti + h) * t.wx + tj + h;
    const T zv = Z[wc];
    zb[(size_t)gi * px + gj] = zv;
    const T prod = R[wc] * zv;
    acc += (double)prod;
  }
  const double sum = block_sum_fixed(acc, sh);
  if (threadIdx.x == 0)
    s.part_c[(size_t)b * s.ntiles + poff + blockIdx.x] = sum;
}

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

bool bad_shard(int B, int py, int px, int sh, int nu) {
  return B < 1 || py < 2 || px < 2 || py % 2 || px % 2 || sh % 2 ||
         nu < 1 || nu + 2 > sh || nu > MAX_NU - 2;
}

template <typename K>
cudaError_t smem_for(K kernel, int planes, int h, size_t item,
                     size_t* bytes) {
  *bytes = tile_smem(planes, h, item);
  return allow_smem(kernel, *bytes);
}

template <typename T>
int abs_parts_entry(int B, int py, int px, const void* r, void* part,
                    int ntiles, int poff, void* stream) {
  if (B < 1 || py < 1 || px < 1) return cudaErrorInvalidValue;
  DEFF_LAUNCH(shard_abs_parts_kernel<T><<<dim3(tiles_for(py, px), B),
                                          TILE_THREADS, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), py, px, static_cast<double*>(part), ntiles,
      poff));
  return cudaSuccess;
}

// kind 0: init (live from active and sum|r|), 1: alpha, 2: live and rz.
template <typename T>
int fin_entry(int kind, int B, const void* const* st, int ntiles,
              const void* active, void* stream) {
  if (B < 1 || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  const CgState<T> s = state_of<T>(st, ntiles);
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

// in: aw, awN, awS, an, anN, anS, dinv, dinvN, dinvS, z, zN, zS, p, pN, pS
template <typename T>
int pass_a_entry(int B, int py, int px, int sh, const void* const* in,
                 void* pnew, const void* const* st, int ntiles, int poff,
                 int nu, void* stream) {
  if (bad_shard(B, py, px, sh, nu)) return cudaErrorInvalidValue;
  const int h = nu + 2;
  size_t smem;
  cudaError_t err = smem_for(shard_pass_a_kernel<T>, 4, h, sizeof(T), &smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(shard_pass_a_kernel<T><<<dim3(tiles_for(py, px), B),
                                       TILE_THREADS, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      coef_of<T>(in, sh), rows_of<T>(in + 9, sh), rows_of<T>(in + 12, sh), py,
      px, static_cast<T*>(pnew), state_of<T>(st, ntiles), poff, h));
  return cudaSuccess;
}

// in: the nine coefficient planes, p, pN, pS, r_old, rN, rS
template <typename T>
int pass_b_entry(int B, int py, int px, int sh, const void* const* in,
                 void* x, void* rnew, void* e, void* rc,
                 const void* const* st, int ntiles, int poff,
                 const double* ws, int nu, void* stream) {
  if (bad_shard(B, py, px, sh, nu)) return cudaErrorInvalidValue;
  const int h = nu + 2;
  size_t smem;
  cudaError_t err = smem_for(shard_pass_b_kernel<T>, 7, h, sizeof(T), &smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(shard_pass_b_kernel<T><<<dim3(tiles_for(py, px), B),
                                       TILE_THREADS, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      coef_of<T>(in, sh), static_cast<T*>(x), rows_of<T>(in + 9, sh),
      rows_of<T>(in + 12, sh), py, px, static_cast<T*>(rnew),
      static_cast<T*>(e), static_cast<T*>(rc), state_of<T>(st, ntiles), poff,
      make_weights(ws, nu), h));
  return cudaSuccess;
}

// in: the nine coefficient planes, e, eN, eS, r, rN, rS, ec, ecN, ecS
// (ec's strips hold sh/2 coarse rows)
template <typename T>
int pass_c_entry(int B, int py, int px, int sh, const void* const* in,
                 void* z, double over, const void* const* st, int ntiles,
                 int poff, const double* ws, int nu, void* stream) {
  if (bad_shard(B, py, px, sh, nu)) return cudaErrorInvalidValue;
  const int h = nu + 2;
  size_t smem;
  cudaError_t err = smem_for(shard_pass_c_kernel<T>, 6, h, sizeof(T), &smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(shard_pass_c_kernel<T><<<dim3(tiles_for(py, px), B),
                                       TILE_THREADS, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      coef_of<T>(in, sh), rows_of<T>(in + 9, sh), rows_of<T>(in + 12, sh),
      rows_of<T>(in + 15, sh / 2), py, px, static_cast<T*>(z), (T)over,
      state_of<T>(st, ntiles), poff, make_weights(ws, nu), h));
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

int deff_shard_tiles(int py, int px) { return deff::tiles_for(py, px); }

#define DEFF_SHARD_CG_ENTRIES(SUF, T)                                         \
  int deff_shard_abs_parts_##SUF(int B, int py, int px, const void* r,        \
                                 void* part, int ntiles, int poff,            \
                                 void* stream) {                              \
    return deff::abs_parts_entry<T>(B, py, px, r, part, ntiles, poff,         \
                                    stream);                                  \
  }                                                                           \
  int deff_shard_fin_##SUF(int kind, int B, const void* const* st,            \
                           int ntiles, const void* active, void* stream) {    \
    return deff::fin_entry<T>(kind, B, st, ntiles, active, stream);           \
  }                                                                           \
  int deff_shard_pass_a_##SUF(int B, int py, int px, int sh,                  \
                              const void* const* in, void* pnew,              \
                              const void* const* st, int ntiles, int poff,    \
                              int nu, void* stream) {                         \
    return deff::pass_a_entry<T>(B, py, px, sh, in, pnew, st, ntiles, poff,   \
                                 nu, stream);                                 \
  }                                                                           \
  int deff_shard_select_##SUF(int B, int n, void* dst_r, const void* r0,      \
                              const void* r1, void* dst_p, const void* p0,    \
                              const void* p1, const int* par, void* stream) { \
    return deff::select_entry<T>(B, n, dst_r, r0, r1, dst_p, p0, p1, par,     \
                                 stream);                                     \
  }                                                                           \
  int deff_shard_pass_b_##SUF(int B, int py, int px, int sh,                  \
                              const void* const* in, void* x, void* rnew,     \
                              void* e, void* rc, const void* const* st,       \
                              int ntiles, int poff, const double* ws, int nu, \
                              void* stream) {                                 \
    return deff::pass_b_entry<T>(B, py, px, sh, in, x, rnew, e, rc, st,       \
                                 ntiles, poff, ws, nu, stream);               \
  }                                                                           \
  int deff_shard_pass_c_##SUF(int B, int py, int px, int sh,                  \
                              const void* const* in, void* z, double over,    \
                              const void* const* st, int ntiles, int poff,    \
                              const double* ws, int nu, void* stream) {       \
    return deff::pass_c_entry<T>(B, py, px, sh, in, z, over, st, ntiles,      \
                                 poff, ws, nu, stream);                       \
  }

DEFF_SHARD_CG_ENTRIES(f32, float)
DEFF_SHARD_CG_ENTRIES(f64, double)

}  // extern "C"
