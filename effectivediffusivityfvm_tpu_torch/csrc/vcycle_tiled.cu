// K4: the level-0 legs of the banded V-cycle for fine grids past the
// whole-cycle engine's size, loaded with ctypes by
// effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle_tiled.py, which runs
// T1, then the coarse tail (K2 on levels[1:]), then T2.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/vcycle_tiled.py
// (v_cycle_tiled: _pre_kernel, _post_kernel).  The TPU's 0/1 selection
// matmuls become a direct 2x2 sum (restriction) and a direct e_c[i/2, j/2]
// read (prolongation); its row bands become 2D tiles (tiled.cuh).
//
// Bounds on an H100: memory bandwidth.  T1 reads r, a_w, a_n, diag_inv and
// writes e and the quarter-size coarse residual (fp32: 24.5 B a cell); T2
// reads e, r, the three coefficient planes and a quarter-size e_c and writes
// z (28.5 B a cell).  The nu sweeps of each leg run in shared memory, so a
// leg costs one pass over device memory whatever nu is.
//
// Every entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launch.
#include "tiled.cuh"

namespace deff {
namespace {

// T1: pre-smoothing, residual and restriction, one tile per block.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
tiled_pre_kernel(Fine<T> f, const T* __restrict__ r, T* __restrict__ e,
                 T* __restrict__ rc, Weights ws, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  const Tile t = make_tile(f.py, f.px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *R = S + 3 * n;
  T *E0 = S + 4 * n, *E1 = S + 5 * n, *Dw = S + 6 * n;
  const size_t off = (size_t)blockIdx.y * f.py * f.px;
  coeff_windows(f, off, t, AW, AN, DI, Dw);
  load_window(R, r + off, t, 0);
  __syncthreads();
  const T* E = pre_smooth(AW, AN, DI, R, E0, E1, ws, t);
  store_interior(e + off, E, t);
  restrict_tile(AW, AN, DI, R, E, t,
                rc + (size_t)blockIdx.y * (f.py / 2) * (f.px / 2));
}

// T2: prolongation, add, post-smoothing, one tile per block.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
tiled_post_kernel(Fine<T> f, const T* __restrict__ e,
                  const T* __restrict__ r, const T* __restrict__ ec,
                  T* __restrict__ z, T over, Weights ws, int h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  const Tile t = make_tile(f.py, f.px, h);
  const int n = t.wy * t.wx;
  T *AW = S, *AN = S + n, *DI = S + 2 * n, *R = S + 3 * n;
  T *E0 = S + 4 * n, *E1 = S + 5 * n, *Dw = S + 6 * n;
  const size_t off = (size_t)blockIdx.y * f.py * f.px;
  coeff_windows(f, off, t, AW, AN, DI, Dw);
  load_window(R, r + off, t, 0);
  const T* Z = post_smooth(AW, AN, DI, R, E0, E1, e + off,
                           ec + (size_t)blockIdx.y * (f.py / 2) * (f.px / 2),
                           over, ws, t);
  store_interior(z + off, Z, t);
}

template <typename T>
Fine<T> stored_fine(int py, int px, const void* aw, const void* an,
                    const void* dinv) {
  Fine<T> f{};
  f.aw = static_cast<const T*>(aw);
  f.an = static_cast<const T*>(an);
  f.dinv = static_cast<const T*>(dinv);
  f.d = nullptr;
  f.py = py;
  f.px = px;
  return f;
}

bool bad_shape(int B, int py, int px, int nu) {
  return B < 1 || py < 2 || px < 2 || py % 2 || px % 2 || nu < 1 ||
         nu > MAX_NU;
}

template <typename T>
int pre_entry(int B, int py, int px, const void* aw, const void* an,
              const void* dinv, const void* r, void* e, void* rc,
              const double* ws, int nu, void* stream) {
  if (bad_shape(B, py, px, nu)) return cudaErrorInvalidValue;
  const Fine<T> f = stored_fine<T>(py, px, aw, an, dinv);
  const int h = nu + 2;
  const size_t smem = tile_smem(6, h, false, sizeof(T));
  cudaError_t err = allow_smem(tiled_pre_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(tiled_pre_kernel<T><<<dim3(tiles_for(py, px), B), TILE_THREADS,
                                    smem, static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const T*>(r), static_cast<T*>(e), static_cast<T*>(rc),
      make_weights(ws, nu), h));
  return cudaSuccess;
}

template <typename T>
int post_entry(int B, int py, int px, const void* aw, const void* an,
               const void* dinv, const void* e, const void* r, const void* ec,
               void* z, const double* ws, int nu, double over, void* stream) {
  if (bad_shape(B, py, px, nu)) return cudaErrorInvalidValue;
  const Fine<T> f = stored_fine<T>(py, px, aw, an, dinv);
  const int h = nu + 2;
  const size_t smem = tile_smem(6, h, false, sizeof(T));
  cudaError_t err = allow_smem(tiled_post_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  DEFF_LAUNCH(tiled_post_kernel<T><<<dim3(tiles_for(py, px), B),
                                     TILE_THREADS, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      f, static_cast<const T*>(e), static_cast<const T*>(r),
      static_cast<const T*>(ec), static_cast<T*>(z), (T)over,
      make_weights(ws, nu), h));
  return cudaSuccess;
}

}  // namespace
}  // namespace deff

extern "C" {

#define DEFF_TILED_ENTRIES(SUF, T)                                            \
  int deff_tiled_pre_##SUF(int B, int py, int px, const void* aw,             \
                           const void* an, const void* dinv, const void* r,   \
                           void* e, void* rc, const double* ws, int nu,       \
                           void* stream) {                                    \
    return deff::pre_entry<T>(B, py, px, aw, an, dinv, r, e, rc, ws, nu,      \
                              stream);                                        \
  }                                                                           \
  int deff_tiled_post_##SUF(int B, int py, int px, const void* aw,            \
                            const void* an, const void* dinv, const void* e,  \
                            const void* r, const void* ec, void* z,           \
                            const double* ws, int nu, double over,            \
                            void* stream) {                                   \
    return deff::post_entry<T>(B, py, px, aw, an, dinv, e, r, ec, z, ws, nu,  \
                               over, stream);                                 \
  }

DEFF_TILED_ENTRIES(f32, float)
DEFF_TILED_ENTRIES(f64, double)

}  // extern "C"
