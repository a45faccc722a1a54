// K4: the banded V-cycle for fine grids past the whole-cycle engine's size,
// loaded with ctypes by effectivediffusivityfvm_tpu_torch/ops/kernels/
// vcycle_tiled.py: T1 on level 0, the coarse tail (K2's cycle from level 1)
// and T2, from one entry.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/vcycle_tiled.py
// (v_cycle_tiled: _pre_kernel, _post_kernel, coarse_tail).  The TPU's 0/1
// selection matmuls become a direct 2x2 sum (restriction) and a direct
// e_c[i/2, j/2] read (prolongation); its row bands become K2's level passes
// (levelpass2d.cuh) in the banded sweep form (1 - w) e + (w (r + nbsum))
// dinv: T1 is the DOWN pass (pre-smoothing, residual, restriction into
// level 1's right-hand side), T2 the UP pass (prolongation, add,
// post-smoothing).
//
// Bounds on an H100: memory bandwidth.  T1 reads r, a_w, a_n, diag_inv and
// writes e and the quarter-size coarse residual (fp32: ~21 B a cell with
// the halo); T2 reads e, r, the three coefficient planes and a quarter-size
// e_c and writes z (~25 B a cell).  The nu sweeps of each leg run on the
// tile's window, so a leg costs one pass over device memory whatever nu is.
//
// The entry launches on the caller's stream, allocates nothing, does not
// synchronise, and returns the cudaError_t of its launches.
#include "levelpass2d.cuh"

namespace deff {
namespace {

using namespace lp;

// Scratch per image: K2's cycle scratch over the whole hierarchy (its
// level-0 e plane holds T1's e, its level-1 right-hand side T1's
// restriction) and level 1's correction.
long long tiled_scratch_elems(int L, const int* ny, const int* nx) {
  return cycle_scratch_elems(L, ny, nx) + (long long)ny[1] * nx[1];
}

template <typename T>
int cycle_entry(int B, int L, const int* ny, const int* nx,
                const void* const* aw, const void* const* an,
                const void* const* dinv, const void* r_, void* z_,
                void* scratch_, const double* ws, int nu, int coarse_iters,
                double over, void* stream) {
  Level<T> lv[MAX_LEVELS];
  if (!fill_levels<T>(L, ny, nx, aw, an, dinv, lv) || L < 2 || B < 1 ||
      B > 65535 || nu < 1 || nu > MAX_NU || ny[0] % 2 || nx[0] % 2 ||
      ny[1] != ny[0] / 2 || nx[1] != nx[0] / 2)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* r = static_cast<const T*>(r_);
  T* z = static_cast<T*>(z_);
  T* scratch = static_cast<T*>(scratch_);
  const long long n0 = (long long)ny[0] * nx[0];
  T* e0 = scratch;                                  // the cycle's E[0]
  T* r1 = scratch + 2 * B * n0;                     // the cycle's R[1]
  T* ec = scratch + B * cycle_scratch_elems(L, ny, nx);
  const Sweeps<T> sw = make_sweeps<T>(ws, nu);
  return with_nu(nu, [&](auto k) -> cudaError_t {
    constexpr int NU = decltype(k)::value;
    DEFF_LP_TRY((launch_down<T, NU, BandedLeg>(B, lv[0], r, e0, r1, ny[1],
                                                  nx[1], sw, nullptr, st)));
    DEFF_LP_TRY(cycle_from<T>(B, L, lv, 1, r1, ec, scratch, ws, nu,
                              coarse_iters, over, nullptr, st));
    return launch_up<T, NU, BandedLeg>(B, lv[0], e0, ec, ny[1], nx[1],
                                         (T)over, r, z, sw, nullptr, st);
  });
}

}  // namespace
}  // namespace deff

extern "C" {

long long deff_cycle_tiled_scratch_elems(int L, const int* ny,
                                         const int* nx) {
  if (L < 2 || L > deff::MAX_LEVELS) return -1;
  return deff::tiled_scratch_elems(L, ny, nx);
}

#define DEFF_TILED_ENTRY(SUF, T)                                              \
  int deff_v_cycle_tiled_##SUF(int B, int L, const int* ny, const int* nx,    \
                               const void* const* aw, const void* const* an,  \
                               const void* const* dinv, const void* r,        \
                               void* z, void* scratch, const double* ws,      \
                               int nu, int coarse_iters, double over,         \
                               void* stream) {                                \
    return deff::cycle_entry<T>(B, L, ny, nx, aw, an, dinv, r, z, scratch,    \
                                ws, nu, coarse_iters, over, stream);          \
  }

DEFF_TILED_ENTRY(f32, float)
DEFF_TILED_ENTRY(f64, double)

}  // extern "C"
