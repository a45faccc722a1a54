// K8: one shard's level of the row-sharded V-cycle -- T1 (pre-smoothing,
// residual, restriction) and T2 (prolongation, add, post-smoothing) on a
// shard's own rows, reading its neighbours' rows from the halo strips the
// caller exchanged.  Loaded with ctypes by
// effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle_sharded.py; the
// recursion over levels, the strip exchanges and the coarse tail (K2) are
// the caller's (parallel/fused2d.py).
//
// Replaces effectivediffusivityfvm_tpu/parallel/fused2d.py
// (_v_cycle_sharded_fused_impl: _t1s_kernel, _t2s_kernel; the in-shard
// banded _banded_level: vcycle_tiled's _pre_kernel and _t2b_kernel).  The
// TPU split a shard into bands because its window had to fit VMEM; here a
// shard is tiled like any plane (tiled.cuh: a TY x TX tile with a halo of
// nu + 2 cells in shared memory), and only the window loader differs: rows
// above and below the shard come from its north and south strips (HALO =
// 8 rows, zeros at the global edges), so a tile at the shard's edge sees
// exactly the rows the TPU kernel's strip-augmented window held.  The
// prolongation reads the coarse correction through its own strips of
// HALO/2 rows: fine row i takes coarse row floor(i/2), exact because every
// shard starts on an even global row.  The 0/1 selection matmuls become a
// direct 2x2 sum and a direct read.
//
// Bounds on an H100: memory bandwidth, as K4 (vcycle_tiled.cu): T1 reads r
// and the three coefficient planes and writes e and a quarter plane; T2
// reads e, r, the coefficients and a quarter plane and writes z.  The
// strips add 2 x 8 rows per shard, read once.
//
// Every entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launch.
#include "tiled.cuh"

namespace deff {
namespace {

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

// T1 on a shard: pre-smoothing, residual and restriction, one tile per
// block.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
shard_t1_kernel(ShardCoef<T> f, Rows<T> r, int py, int px,
                T* __restrict__ e, T* __restrict__ rc, Weights ws, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.y;
  const Tile t = make_tile(py, px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *R = S + 3 * n;
  T *E0 = S + 4 * n, *E1 = S + 5 * n;
  coeff_windows_rows(f, b, t, AW, AN, DI);
  load_window_rows(R, r, b, t);
  __syncthreads();
  const T* E = pre_smooth(AW, AN, DI, R, E0, E1, ws, t);
  store_interior(e + (size_t)b * py * px, E, t);
  restrict_tile(AW, AN, DI, R, E, t, rc + (size_t)b * (py / 2) * (px / 2));
}

// T2 on a shard: prolongation, add, post-smoothing, one tile per block.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
shard_t2_kernel(ShardCoef<T> f, Rows<T> e, Rows<T> r, Rows<T> ec, int py,
                int px, T* __restrict__ z, T over, Weights ws, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.y;
  const Tile t = make_tile(py, px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *R = S + 3 * n;
  T *E0 = S + 4 * n, *E1 = S + 5 * n;
  coeff_windows_rows(f, b, t, AW, AN, DI);
  load_window_rows(R, r, b, t);
  const T* Z = post_smooth_rows(AW, AN, DI, R, E0, E1, e, ec, b, over, ws, t);
  store_interior(z + (size_t)b * py * px, Z, t);
}

bool bad_shard(int B, int py, int px, int sh, int nu) {
  return B < 1 || py < 2 || px < 2 || py % 2 || px % 2 || sh % 2 ||
         nu < 1 || nu + 2 > sh || nu > MAX_NU;
}

// in: aw, awN, awS, an, anN, anS, dinv, dinvN, dinvS, r, rN, rS
template <typename T>
int t1_entry(int B, int py, int px, int sh, const void* const* in, void* e,
             void* rc, const double* ws, int nu, void* stream) {
  if (bad_shard(B, py, px, sh, nu)) return cudaErrorInvalidValue;
  const int h = nu + 2;
  const size_t smem = tile_smem(6, h, false, sizeof(T));
  cudaError_t err = allow_smem(shard_t1_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(shard_t1_kernel<T><<<dim3(tiles_for(py, px), B), TILE_THREADS,
                                   smem, static_cast<cudaStream_t>(stream)>>>(
      coef_of<T>(in, sh), rows_of<T>(in + 9, sh), py, px, static_cast<T*>(e),
      static_cast<T*>(rc), make_weights(ws, nu), h));
  return cudaSuccess;
}

// in: the nine coefficient planes as for T1, then e, eN, eS, r, rN, rS,
// ec, ecN, ecS (ec's strips hold sh/2 coarse rows)
template <typename T>
int t2_entry(int B, int py, int px, int sh, const void* const* in, void* z,
             const double* ws, int nu, double over, void* stream) {
  if (bad_shard(B, py, px, sh, nu)) return cudaErrorInvalidValue;
  const int h = nu + 2;
  const size_t smem = tile_smem(6, h, false, sizeof(T));
  cudaError_t err = allow_smem(shard_t2_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(shard_t2_kernel<T><<<dim3(tiles_for(py, px), B), TILE_THREADS,
                                   smem, static_cast<cudaStream_t>(stream)>>>(
      coef_of<T>(in, sh), rows_of<T>(in + 9, sh), rows_of<T>(in + 12, sh),
      rows_of<T>(in + 15, sh / 2), py, px, static_cast<T*>(z), (T)over,
      make_weights(ws, nu), h));
  return cudaSuccess;
}

}  // namespace
}  // namespace deff

extern "C" {

#define DEFF_SHARD_CYCLE_ENTRIES(SUF, T)                                      \
  int deff_shard_t1_##SUF(int B, int py, int px, int sh,                      \
                          const void* const* in, void* e, void* rc,           \
                          const double* ws, int nu, void* stream) {           \
    return deff::t1_entry<T>(B, py, px, sh, in, e, rc, ws, nu, stream);       \
  }                                                                           \
  int deff_shard_t2_##SUF(int B, int py, int px, int sh,                      \
                          const void* const* in, void* z, const double* ws,   \
                          int nu, double over, void* stream) {                \
    return deff::t2_entry<T>(B, py, px, sh, in, z, ws, nu, over, stream);     \
  }

DEFF_SHARD_CYCLE_ENTRIES(f32, float)
DEFF_SHARD_CYCLE_ENTRIES(f64, double)

}  // extern "C"
