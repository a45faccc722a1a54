// C entry points of K6 (the 3D V-cycle, see vcycle3d.cuh), loaded with
// ctypes by effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle3d.py: the
// whole cycle, and T1 / T2 of the banded cycle on level 0 (the wrapper runs
// the whole cycle on levels[1:] between them).  Every entry launches on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// cudaError_t of its launches.
#include "vcycle3d.cuh"

namespace deff {
long long g_cycles3 = 0;
}

namespace {

template <typename T>
int v_cycle3d_entry(int B, int L, const int* nz, const int* ny, const int* nx,
                    const void* const* aw, const void* const* an,
                    const void* const* au, const void* const* dinv,
                    const void* r, void* z, void* scratch, const double* ws,
                    int nu, int coarse_iters, double over, void* stream) {
  deff::Level3<T> lv[deff::MAX_LEVELS];
  if (!deff::fill_levels3<T>(L, nz, ny, nx, aw, an, au, dinv, lv))
    return cudaErrorInvalidValue;
  return deff::run_cycle3<T>(B, L, lv, static_cast<const T*>(r),
                             static_cast<T*>(z), static_cast<T*>(scratch), ws,
                             nu, coarse_iters, over, nullptr,
                             static_cast<cudaStream_t>(stream));
}

template <typename T>
deff::Stored3<T> stored(const void* aw, const void* an, const void* au,
                        const void* dinv) {
  return deff::Stored3<T>{static_cast<const T*>(aw),
                          static_cast<const T*>(an),
                          static_cast<const T*>(au),
                          static_cast<const T*>(dinv)};
}

bool bad_dims(int B, deff::Dims3 d0, deff::Dims3 d1, int nu) {
  return B < 1 || nu < 1 || d0.nz < 2 || d0.ny < 2 || d0.nx < 2 ||
         d0.nz % 2 || d0.ny % 2 || d0.nx % 2 || d1.nz < d0.nz / 2 ||
         d1.ny < d0.ny / 2 || d1.nx < d0.nx / 2;
}

template <typename T>
int t1_entry(int B, int nz, int ny, int nx, int nz1, int ny1, int nx1,
             const void* aw, const void* an, const void* au, const void* dinv,
             const void* r, void* e, void* spare, void* rc, const double* ws,
             int nu, void* stream) {
  const deff::Dims3 d0{nz, ny, nx}, d1{nz1, ny1, nx1};
  if (bad_dims(B, d0, d1, nu)) return cudaErrorInvalidValue;
  return deff::down3<T>(B, stored<T>(aw, an, au, dinv), d0,
                        static_cast<const T*>(r), static_cast<T*>(e),
                        static_cast<T*>(spare), static_cast<T*>(rc), d1, ws,
                        nu, nullptr, static_cast<cudaStream_t>(stream));
}

template <typename T>
int t2_entry(int B, int nz, int ny, int nx, int nz1, int ny1, int nx1,
             const void* aw, const void* an, const void* au, const void* dinv,
             void* e, const void* ec, const void* r, void* z, void* spare,
             const double* ws, int nu, double over, void* stream) {
  const deff::Dims3 d0{nz, ny, nx}, d1{nz1, ny1, nx1};
  if (bad_dims(B, d0, d1, nu)) return cudaErrorInvalidValue;
  return deff::up3<T>(B, stored<T>(aw, an, au, dinv), d0, static_cast<T*>(e),
                      static_cast<const T*>(ec), d1, (T)over,
                      static_cast<const T*>(r), static_cast<T*>(z),
                      static_cast<T*>(spare), ws, nu, nullptr,
                      static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace

extern "C" {

long long deff_cycle3_count() { return deff::g_cycles3; }

long long deff_cycle3_scratch_elems(int L, const int* nz, const int* ny,
                                    const int* nx) {
  return deff::cycle3_scratch_elems(L, nz, ny, nx);
}

#define DEFF_V_CYCLE3D_ENTRIES(SUF, T)                                        \
  int deff_v_cycle3d_##SUF(int B, int L, const int* nz, const int* ny,        \
                           const int* nx, const void* const* aw,              \
                           const void* const* an, const void* const* au,      \
                           const void* const* dinv, const void* r, void* z,   \
                           void* scratch, const double* ws, int nu,           \
                           int coarse_iters, double over, void* stream) {     \
    return v_cycle3d_entry<T>(B, L, nz, ny, nx, aw, an, au, dinv, r, z,       \
                              scratch, ws, nu, coarse_iters, over, stream);   \
  }                                                                           \
  int deff_t1_3d_##SUF(int B, int nz, int ny, int nx, int nz1, int ny1,       \
                       int nx1, const void* aw, const void* an,               \
                       const void* au, const void* dinv, const void* r,       \
                       void* e, void* spare, void* rc, const double* ws,      \
                       int nu, void* stream) {                                \
    return t1_entry<T>(B, nz, ny, nx, nz1, ny1, nx1, aw, an, au, dinv, r, e,  \
                       spare, rc, ws, nu, stream);                            \
  }                                                                           \
  int deff_t2_3d_##SUF(int B, int nz, int ny, int nx, int nz1, int ny1,       \
                       int nx1, const void* aw, const void* an,               \
                       const void* au, const void* dinv, void* e,             \
                       const void* ec, const void* r, void* z, void* spare,   \
                       const double* ws, int nu, double over, void* stream) { \
    return t2_entry<T>(B, nz, ny, nx, nz1, ny1, nx1, aw, an, au, dinv, e, ec, \
                       r, z, spare, ws, nu, over, stream);                    \
  }

DEFF_V_CYCLE3D_ENTRIES(f32, float)
DEFF_V_CYCLE3D_ENTRIES(f64, double)

}  // extern "C"
