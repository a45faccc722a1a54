// Per-image CG scalars on the device, shared by the three-pass CG engines:
// K5 (cgstep_tiled.cu, 2D), K7 (cgstep3d.cu, 3D) and K9
// (cgstep_sharded.cu).
//
// The passes write one double partial per block and image; a one-block-
// per-image finalize kernel sums an image's partials in a fixed order and
// sets alpha, rz and the image's live flag, so a window runs with no host
// synchronisation and its iteration counts do not change from run to run.
#pragma once

#include "window.cuh"

namespace deff {

template <typename T>
struct CgState {
  T* rz;            // rz of the current iteration (the caller's rz array)
  T* rz_prev;
  T* alpha;
  const T* stop;
  const T* hi;
  int* live;
  int* par;         // 1 where the current p (and, in 2D, r) is the scratch
  int* k_done;      // the caller's k_done array
  double* part_a;   // (B, ntiles) partials of <p, q>
  double* part_b;   // sum|r|
  double* part_c;   // <r, z>
  int ntiles;       // partials per image
  int* any;         // the window's flag of this step (window.cuh), or null
};

// Sum of one value per thread of a THREADS-wide block, in double, in a
// fixed order (the passes' per-block partials).
__device__ __forceinline__ double block_sum_fixed(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const double out = sh[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ double sum_tiles(const double* part, int nt,
                                            double* sh) {
  double acc = 0.0;
  for (int j = threadIdx.x; j < nt; j += THREADS) acc += part[j];
  return block_sum_fixed(acc, sh);
}

// x, r, p *= (D > 0) for every image (matrix-free entry pin).
template <typename T>
__global__ void pin_kernel(const T* __restrict__ d, T* x, T* r, T* p,
                           long long n) {
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += (long long)gridDim.x * blockDim.x) {
    const T ind = d[c] > T(0) ? T(1) : T(0);
    x[c] = x[c] * ind;
    r[c] = r[c] * ind;
    p[c] = p[c] * ind;
  }
}

template <typename T>
__global__ void fin_init_kernel(CgState<T> s, const T* active) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  const T sr = (T)sum_tiles(s.part_b + (size_t)b * s.ntiles, s.ntiles, sh);
  const bool lv = active[b] > T(0) && sr > s.stop[b] && sr < s.hi[b];
  mark_live(s.any, lv);
  if (threadIdx.x == 0) {
    s.live[b] = lv;
    s.rz_prev[b] = s.rz[b];
    s.par[b] = 0;
    s.k_done[b] = 0;
  }
}

template <typename T>
__global__ void fin_alpha_kernel(CgState<T> s) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const T pap = (T)sum_tiles(s.part_a + (size_t)b * s.ntiles, s.ntiles, sh);
  if (threadIdx.x == 0) s.alpha[b] = pap > T(0) ? s.rz[b] / pap : T(0);
}

template <typename T>
__global__ void fin_live_kernel(CgState<T> s) {
  __shared__ double sh[THREADS];
  const int b = blockIdx.y;
  if (!s.live[b]) return;
  const T sr = (T)sum_tiles(s.part_b + (size_t)b * s.ntiles, s.ntiles, sh);
  const T rzn = (T)sum_tiles(s.part_c + (size_t)b * s.ntiles, s.ntiles, sh);
  if (threadIdx.x == 0) {
    s.rz_prev[b] = s.rz[b];
    s.rz[b] = rzn;
    s.k_done[b] += 1;
    s.par[b] ^= 1;
    const bool lv = sr > s.stop[b] && sr < s.hi[b];
    s.live[b] = lv;
    mark_live(s.any, lv);
  }
}

// dst = src for the images whose flag is set (r skipped when dst_r is null).
template <typename T>
__global__ void copy_back_kernel(T* dst_r, const T* src_r, T* dst_p,
                                 const T* src_p, int n, const int* flag) {
  if (gated_off(flag)) return;
  const size_t off = (size_t)blockIdx.y * n;
  for (int k = 0; k < CPT; ++k) {
    const int c = blockIdx.x * TILE + k * THREADS + threadIdx.x;
    if (c >= n) break;
    if (dst_r != nullptr) dst_r[off + c] = src_r[off + c];
    dst_p[off + c] = src_p[off + c];
  }
}

}  // namespace deff
