// C entry points of K2 (the V-cycle, see vcycle.cuh), loaded with ctypes by
// effectivediffusivityfvm_tpu_torch/ops/kernels/vcycle.py.  Every entry
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns the cudaError_t of its launches.
#include "vcycle.cuh"

namespace deff {
long long g_launches = 0;
long long g_cycles = 0;
}

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

long long deff_launch_count() { return deff::g_launches; }

long long deff_cycle_count() { return deff::g_cycles; }

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
