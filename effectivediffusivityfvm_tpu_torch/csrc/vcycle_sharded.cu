// K8: one level of the row-sharded V-cycle on every shard of a mesh row
// that lives on one device -- T1 (pre-smoothing, residual, restriction)
// and T2 (prolongation, add, post-smoothing), one launch a leg, the shard
// in blockIdx.z.  Loaded with ctypes by
// effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle_sharded.py; the
// recursion over levels, the row's tables and the coarse tail (K2) are the
// caller's (parallel/fused2d.py).
//
// Replaces effectivediffusivityfvm_tpu/parallel/fused2d.py
// (_v_cycle_sharded_fused_impl: _t1s_kernel, _t2s_kernel; the in-shard
// banded _banded_level: vcycle_tiled's _pre_kernel and _t2b_kernel).  The
// TPU kernels read a shard's window augmented with HALO = 8-row strips that
// a ppermute had exchanged, zeros at the global edges.  Here the legs are
// K2's level passes (levelpass2d.cuh) in the banded sweep form with the
// row-shard loader: a window row above or below the shard is read where it
// lies -- in place from the neighbour's plane when the neighbour shares the
// device, from an exchanged strip when it does not -- and reads 0 past the
// global top and bottom.  Each shard's row table (body, north and south
// pointers with their own image strides, for every plane the leg reads, and
// its outputs) is passed by value.  The prolongation reads the coarse
// correction the same way (fine row i takes coarse row floor(i/2), exact
// because every shard starts on an even global row); T1's restriction may
// land at the shard's row offset in the gathered coarse plane, and T2 then
// reads e_c from it, so the gathered tail needs no gather and no split.
// The 0/1 selection matmuls become a direct 2x2 sum and a direct read.
//
// Bounds on an H100: memory bandwidth, as K4 (vcycle_tiled.cu) over the
// whole row: T1 reads r and the three coefficient planes and writes e and a
// quarter plane; T2 reads e, r, the coefficients and a quarter plane and
// writes z.
//
// Every entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launch.
#include "levelpass2d.cuh"

namespace deff {
namespace {

using namespace lp;

constexpr int MAX_SHARDS = 8;           // shards of one launch

// One plane of a shard, image 0: its rows, the row one past the last row
// above it (null past the global top) and the first row below it (null
// past the global bottom), each with its image stride in elements.
template <typename T>
struct Src {
  const T* body;
  const T* north;
  const T* south;
  long long sb, sn, ss;
  __device__ __forceinline__ RowsIn<T> image(int b, int ny, int nx,
                                             int lim) const {
    return RowsIn<T>{body + b * sb, north != nullptr ? north + b * sn : nullptr,
                     south != nullptr ? south + b * ss : nullptr, ny, nx,
                     lim};
  }
};

template <typename T>
struct T1Shard {
  Src<T> aw, an, di, r;
  T* e;                  // (B, ny, nx) at image stride se
  T* rc;                 // the shard's coarse rows at image stride src
  long long se, src;
};

template <typename T>
struct T2Shard {
  Src<T> aw, an, di, e, r, ec;
  T* z;
  long long sz;
};

template <typename S>
struct Row {
  S s[MAX_SHARDS];
};

template <typename T, int NU>
__global__ void __launch_bounds__(LT_THREADS)
row_t1_kernel(const __grid_constant__ Row<T1Shard<T>> row, int ny, int nx,
              int ntx, Sweeps<T> ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T1Shard<T>& sh = row.s[blockIdx.z];
  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  constexpr int H = Geo<NU>::HS;
  down_body<T, NU, BANDED_FORM, false>(
      sh.r.image(b, ny, nx, H), sh.aw.image(b, ny, nx, H),
      sh.an.image(b, ny, nx, H), sh.di.image(b, ny, nx, H), ny, nx, sh.e,
      (size_t)b * sh.se, sh.rc, (size_t)b * sh.src, ny / 2, nx / 2, ty, tx,
      ws, reinterpret_cast<T*>(smem_raw));
}

template <typename T, int NU>
__global__ void __launch_bounds__(LT_THREADS)
row_t2_kernel(const __grid_constant__ Row<T2Shard<T>> row, int ny, int nx,
              int ntx, T over, Sweeps<T> ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T2Shard<T>& sh = row.s[blockIdx.z];
  const int b = blockIdx.y;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  constexpr int H = Geo<NU>::HS;
  up_body<T, NU, BANDED_FORM, false>(
      sh.e.image(b, ny, nx, H), sh.ec.image(b, ny / 2, nx / 2, H / 2), over,
      sh.r.image(b, ny, nx, H), sh.aw.image(b, ny, nx, H),
      sh.an.image(b, ny, nx, H), sh.di.image(b, ny, nx, H), ny, nx, sh.z,
      (size_t)b * sh.sz, ty, tx, ws, reinterpret_cast<T*>(smem_raw));
}

// Plane k of a shard's table: three pointers and three strides.
template <typename T>
Src<T> src_of(const void* const* p, const long long* s, int k) {
  return Src<T>{static_cast<const T*>(p[3 * k]),
                static_cast<const T*>(p[3 * k + 1]),
                static_cast<const T*>(p[3 * k + 2]), s[3 * k], s[3 * k + 1],
                s[3 * k + 2]};
}

bool bad_row(int S, int B, int ny, int nx, int nu) {
  return S < 1 || S > MAX_SHARDS || B < 1 || B > 65535 || ny < 2 || nx < 2 ||
         ny % 2 || nx % 2 || nu < 1 || nu > MAX_NU ||
         ny < 2 * ((nu + 1) / 2);
}

// T1 table per shard: aw, an, dinv, r (a pointer triple and a stride
// triple each), then e and rc (a pointer and a stride each).
constexpr int T1_SLOTS = 14;
// T2 table per shard: aw, an, dinv, e, r, e_c, then z.
constexpr int T2_SLOTS = 19;

template <typename T>
int t1_entry(int S, int B, int ny, int nx, const void* const* p,
             const long long* s, const double* ws, int nu, void* stream) {
  if (bad_row(S, B, ny, nx, nu)) return cudaErrorInvalidValue;
  Row<T1Shard<T>> row{};
  for (int k = 0; k < S; ++k) {
    const void* const* q = p + k * T1_SLOTS;
    const long long* t = s + k * T1_SLOTS;
    T1Shard<T>& sh = row.s[k];
    sh.aw = src_of<T>(q, t, 0);
    sh.an = src_of<T>(q, t, 1);
    sh.di = src_of<T>(q, t, 2);
    sh.r = src_of<T>(q, t, 3);
    sh.e = static_cast<T*>(const_cast<void*>(q[12]));
    sh.rc = static_cast<T*>(const_cast<void*>(q[13]));
    sh.se = t[12];
    sh.src = t[13];
  }
  const Sweeps<T> sw = make_sweeps<T>(ws, nu);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_nu(nu, [&](auto kk) -> cudaError_t {
    constexpr int NU = decltype(kk)::value;
    static unsigned done = 0;
    const size_t sm = sizeof(T) * down_elems<NU>();
    auto kern = row_t1_kernel<T, NU>;
    DEFF_LP_TRY(allow_smem(kern, sm, &done));
    const int ntx = down_ntx<NU>(nx, nx / 2);
    DEFF_LAUNCH(kern<<<dim3(down_count<NU>(ny, nx, ny / 2, nx / 2), B, S),
                       LT_THREADS, sm, st>>>(row, ny, nx, ntx, sw));
    return cudaSuccess;
  });
}

template <typename T>
int t2_entry(int S, int B, int ny, int nx, const void* const* p,
             const long long* s, const double* ws, int nu, double over,
             void* stream) {
  if (bad_row(S, B, ny, nx, nu)) return cudaErrorInvalidValue;
  Row<T2Shard<T>> row{};
  for (int k = 0; k < S; ++k) {
    const void* const* q = p + k * T2_SLOTS;
    const long long* t = s + k * T2_SLOTS;
    T2Shard<T>& sh = row.s[k];
    sh.aw = src_of<T>(q, t, 0);
    sh.an = src_of<T>(q, t, 1);
    sh.di = src_of<T>(q, t, 2);
    sh.e = src_of<T>(q, t, 3);
    sh.r = src_of<T>(q, t, 4);
    sh.ec = src_of<T>(q, t, 5);
    sh.z = static_cast<T*>(const_cast<void*>(q[18]));
    sh.sz = t[18];
  }
  const Sweeps<T> sw = make_sweeps<T>(ws, nu);
  const auto st = static_cast<cudaStream_t>(stream);
  return with_nu(nu, [&](auto kk) -> cudaError_t {
    constexpr int NU = decltype(kk)::value;
    static unsigned done = 0;
    const size_t sm = sizeof(T) * up_elems<NU>();
    auto kern = row_t2_kernel<T, NU>;
    DEFF_LP_TRY(allow_smem(kern, sm, &done));
    DEFF_LAUNCH(kern<<<dim3(up_count<NU>(ny, nx), B, S), LT_THREADS, sm,
                       st>>>(row, ny, nx, up_ntx<NU>(nx), (T)over, sw));
    return cudaSuccess;
  });
}

}  // namespace
}  // namespace deff

extern "C" {

int deff_shard_row_max() { return deff::MAX_SHARDS; }

#define DEFF_SHARD_ROW_ENTRIES(SUF, T)                                        \
  int deff_shard_row_t1_##SUF(int S, int B, int ny, int nx,                   \
                              const void* const* p, const long long* s,       \
                              const double* ws, int nu, void* stream) {       \
    return deff::t1_entry<T>(S, B, ny, nx, p, s, ws, nu, stream);             \
  }                                                                           \
  int deff_shard_row_t2_##SUF(int S, int B, int ny, int nx,                   \
                              const void* const* p, const long long* s,       \
                              const double* ws, int nu, double over,          \
                              void* stream) {                                 \
    return deff::t2_entry<T>(S, B, ny, nx, p, s, ws, nu, over, stream);       \
  }

DEFF_SHARD_ROW_ENTRIES(f32, float)
DEFF_SHARD_ROW_ENTRIES(f64, double)

}  // extern "C"
