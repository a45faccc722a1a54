// K3: k damped-Jacobi sweeps on a (B, ny, nx) batch, in two routes chosen
// by image size and dtype (ops/kernels/jacobi.py, jacobi_resident_fits):
//
//  * resident: one launch per call.  One thread-block cluster per image,
//    each CTA of the cluster owning a band of rows, each thread a column
//    segment of the band.  A thread keeps its cells' x, b, diag_inv and
//    conductances in registers for all k sweeps; the band's x lives
//    in shared memory too (double-buffered), where the neighbouring
//    columns and segments read it.  A band's north and south halo rows of
//    x are read from the neighbouring CTAs' shared memory (distributed
//    shared memory, cooperative_groups::this_cluster().map_shared_rank),
//    and one cluster.sync() per sweep orders the double buffer.  The image
//    crosses HBM once per call: read 5 planes, write 1.
//  * streaming (images the cluster cannot hold): one launch per sweep,
//    blockIdx = (column tile, row tile, image), ping-ponging between the
//    output and one scratch plane, so it pays the 24 B/cell (fp32) once
//    per sweep.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/jacobi_vmem.py
// (jacobi_sweeps_pallas), the reference's updateX_SOR (Deff2D.cuh:69-92).
// The TPU kernel kept an image in VMEM for all k sweeps; the resident
// route is that residency idea rebuilt for Hopper, where a 128^2 image's
// planes (384 KB fp32, 768 KB fp64) exceed one SM's 227 KB of shared
// memory but fit the registers and shared memory of a cluster of 8.  The
// wrapper and the plain version are in ops/kernels/jacobi.py.
//
// What it computes, per sweep and cell (i, j):
//   num = b + aw*xw + east + an*xn + south
//   x'  = (1-w) x + w num dinv
// with east = aw[i,j+1] x[i,j+1] and south = an[i+1,j] x[i+1,j], zero
// beyond the grid.  The TPU kernel took the same terms from pltpu.roll's
// wrap-around times the zero boundary conductance; here the neighbour
// reads are bounded.  Only a_w, a_n, diag_inv and b are read, so the
// system must be the symmetric assembly (unmasked, or symmetric=True).
// The sums run in the TPU kernel's order, and the library is built with
// -fmad=false, so both routes equal the plain version bit for bit.
//
// What bounds it on an H100: resident, the sweep's latency — one cluster
// barrier plus a thread's 4-8 cells of register stencil work (~12 flops
// and four shared-memory loads a cell); the bytes, 24 B/cell once per call
// (fp32), are negligible at k in the thousands.  With many images the
// clusters run in waves, bounded by the SMs' registers (a 256-thread CTA
// is compiled to 80 a thread, three CTAs an SM).  Streaming: memory, 24 B/cell (fp32) a sweep, and at 128^2 the
// launches.
//
// Per-image freezing: an image whose flag is 0 does no sweeps; its input
// is copied into the fresh output, so it comes back bitwise unchanged.
#include <cooperative_groups.h>

#include "vcycle.cuh"

namespace {

constexpr int TX = 32;  // columns per block
constexpr int TY = 8;   // rows per block

template <typename T>
__global__ void __launch_bounds__(TX * TY)
jacobi_sweep_kernel(int ny, int nx, const T* __restrict__ aw,
                    const T* __restrict__ an, const T* __restrict__ dinv,
                    const T* __restrict__ b, const T* __restrict__ src,
                    T* __restrict__ dst, const T* __restrict__ x_in,
                    const int* __restrict__ active, bool last, T w1, T w) {
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= ny || j >= nx) return;
  const long long c = ((long long)blockIdx.z * ny + i) * nx + j;
  if (active != nullptr && active[blockIdx.z] == 0) {
    if (last) dst[c] = x_in[c];
    return;
  }
  const T xw = (j > 0) ? src[c - 1] : T(0);
  const T xn = (i > 0) ? src[c - nx] : T(0);
  const T east = (j + 1 < nx) ? aw[c + 1] * src[c + 1] : T(0);
  const T south = (i + 1 < ny) ? an[c + nx] * src[c + nx] : T(0);
  const T num = b[c] + aw[c] * xw + east + an[c] * xn + south;
  dst[c] = w1 * src[c] + w * num * dinv[c];
}

// ---- resident route: one cluster per image, all k sweeps in one launch
//
// A thread owns a column segment of SEG cells (rows i0 .. i0+SEG-1 of its
// CTA's band, column j) and keeps their x, b, diag_inv, a_w, a_n and the
// east and south neighbours' a_w and a_n in registers for the whole call;
// the neighbours' x come from the band's x in shared memory (or, across
// the band's edge, from the neighbouring CTA's through distributed shared
// memory).  So a sweep costs four shared-memory loads and one store a
// cell, and one cluster barrier.

constexpr int RES_THREADS = 512;    // most threads a CTA may have
constexpr int RES_MAX_CLUSTER = 8;  // portable cluster size

template <typename T>
struct Seg {                        // cells a thread keeps in registers
  static constexpr int N = sizeof(T) == 4 ? 8 : 4;
};

// MAXT threads at most a CTA, at least MINB CTAs an SM: the register
// budget the compiler keeps to (a 256-thread CTA at 3 an SM: 85 a thread).
template <typename T, int SEG, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
jacobi_resident_kernel(int ny, int nx, int rows, const T* __restrict__ aw,
                       const T* __restrict__ an, const T* __restrict__ dinv,
                       const T* __restrict__ b, const T* __restrict__ x,
                       T* __restrict__ out, const int* __restrict__ active,
                       int k, T w1, T w) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs0 = reinterpret_cast<T*>(smem_raw);
  T* xs1 = xs0 + rows * nx;
  const int img = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * rows;                     // the band's first row
  const int nr = max(0, min(rows, ny - r0));      // its rows
  const int j = threadIdx.x % nx;
  const int i0 = (threadIdx.x / nx) * SEG;        // the segment's first row
  const int ns = max(0, min(SEG, nr - i0));       // its cells
  const size_t base = (size_t)img * ny * nx;
  const size_t c0 = base + (size_t)(r0 + i0) * nx + j;
  // every CTA of the cluster reads the same flag, so all leave together
  if (active != nullptr && active[img] == 0) {
    for (int m = 0; m < ns; ++m) out[c0 + (size_t)m * nx] = x[c0 + (size_t)m * nx];
    return;
  }
  T xr[SEG], rb[SEG], rd[SEG], rw[SEG], re[SEG], rn[SEG], rs[SEG];
#pragma unroll
  for (int m = 0; m < SEG; ++m) {
    if (m < ns) {
      const size_t c = c0 + (size_t)m * nx;
      xr[m] = x[c];
      rb[m] = b[c];
      rd[m] = dinv[c];
      rw[m] = aw[c];
      re[m] = (j + 1 < nx) ? aw[c + 1] : T(0);
      rn[m] = an[c];
      rs[m] = (r0 + i0 + m + 1 < ny) ? an[c + nx] : T(0);
      xs0[(i0 + m) * nx + j] = xr[m];
    }
  }
  const bool south_band = r0 + nr < ny;           // a band below this one
  cluster.sync();  // every band loaded before any halo read
  const T* hn0 = nullptr;
  const T* hn1 = nullptr;
  const T* hs0 = nullptr;
  const T* hs1 = nullptr;
  if (rank > 0) {
    hn0 = cluster.map_shared_rank(xs0, rank - 1) + (rows - 1) * nx;
    hn1 = cluster.map_shared_rank(xs1, rank - 1) + (rows - 1) * nx;
  }
  if (south_band) {
    hs0 = cluster.map_shared_rank(xs0, rank + 1);
    hs1 = cluster.map_shared_rank(xs1, rank + 1);
  }
  for (int s = 0; s < k; ++s) {
    const bool odd = s & 1;
    const T* src = odd ? xs1 : xs0;
    T* dst = odd ? xs0 : xs1;
    const T* nrow = odd ? hn1 : hn0;
    const T* srow = odd ? hs1 : hs0;
#pragma unroll
    for (int m = 0; m < SEG; ++m) {
      if (m < ns) {
        const int i = i0 + m;                     // the cell's row in the band
        const int e = i * nx + j;
        const T xw = (j > 0) ? src[e - 1] : T(0);
        const T xn = (i > 0) ? src[e - nx] : (rank > 0 ? nrow[j] : T(0));
        const T east = (j + 1 < nx) ? re[m] * src[e + 1] : T(0);
        T south = T(0);
        if (i + 1 < nr) south = rs[m] * src[e + nx];
        else if (south_band) south = rs[m] * srow[j];
        const T num = rb[m] + rw[m] * xw + east + rn[m] * xn + south;
        xr[m] = w1 * xr[m] + w * num * rd[m];
        dst[e] = xr[m];
      }
    }
    // dst complete everywhere before the next sweep reads it, and every
    // read of src done before the sweep after overwrites it; the last one
    // also keeps this CTA's shared memory alive for its neighbours' reads
    cluster.sync();
  }
#pragma unroll
  for (int m = 0; m < SEG; ++m)
    if (m < ns) out[c0 + (size_t)m * nx] = xr[m];
}

// Threads a CTA needs for `rows` rows of an nx-wide image.
inline long long res_threads(int rows, int nx, int seg) {
  return (long long)nx * ((rows + seg - 1) / seg);
}

// C CTAs a cluster: the size rule (which C an image takes) is
// ops/kernels/jacobi.py::resident_cluster; here only whether C can run.
template <typename T>
int jacobi_resident_entry(int B, int ny, int nx, int C, const void* aw,
                          const void* an, const void* dinv, const void* b,
                          const void* x, void* out, const int* active, int k,
                          double omega, void* stream) {
  if (B < 1 || B > 65535 || ny < 1 || nx < 1 || k < 1 || C < 1 ||
      C > RES_MAX_CLUSTER || (C & (C - 1)) != 0)
    return cudaErrorInvalidValue;
  const int rows = (ny + C - 1) / C;
  const long long need = res_threads(rows, nx, Seg<T>::N);
  if (need > RES_THREADS) return cudaErrorInvalidValue;
  const int threads = (int)((need + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)rows * nx * sizeof(T);
  // CTAs of up to 256 threads take the instantiation that fits three an SM
  auto kern = threads <= 256
                  ? jacobi_resident_kernel<T, Seg<T>::N, 256, 3>
                  : jacobi_resident_kernel<T, Seg<T>::N, RES_THREADS, 1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const T w1 = (T)(1.0 - omega);
  const T w = (T)omega;
  DEFF_LAUNCH(e = cudaLaunchKernelEx(
      &cfg, kern, ny, nx, rows, static_cast<const T*>(aw),
      static_cast<const T*>(an), static_cast<const T*>(dinv),
      static_cast<const T*>(b), static_cast<const T*>(x),
      static_cast<T*>(out), active, k, w1, w));
  return e;
}

// ---- streaming route: one launch per sweep

template <typename T>
int jacobi_entry(int B, int ny, int nx, const void* aw, const void* an,
                 const void* dinv, const void* b, const void* x, void* out,
                 void* scratch, const int* active, int k, double omega,
                 void* stream) {
  if (B < 1 || ny < 1 || nx < 1 || k < 0 || B > 65535 ||
      (ny + TY - 1) / TY > 65535)
    return cudaErrorInvalidValue;
  const dim3 block(TX, TY);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the factors round to T as the plain version's scalar products do
  const T w1 = (T)(1.0 - omega);
  const T w = (T)omega;
  const T* src = static_cast<const T*>(x);
  for (int s = 0; s < k; ++s) {
    // alternate so that the last sweep (s == k-1) writes `out`
    T* dst = static_cast<T*>(((k - s) % 2 == 1) ? out : scratch);
    DEFF_LAUNCH(jacobi_sweep_kernel<T><<<grid, block, 0, st>>>(
        ny, nx, static_cast<const T*>(aw), static_cast<const T*>(an),
        static_cast<const T*>(dinv), static_cast<const T*>(b), src, dst,
        static_cast<const T*>(x), active, s == k - 1, w1, w));
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int deff_jacobi_resident_f32(int B, int ny, int nx, int cluster,
                             const void* aw, const void* an,
                             const void* dinv, const void* b, const void* x,
                             void* out, const int* active, int k,
                             double omega, void* stream) {
  return jacobi_resident_entry<float>(B, ny, nx, cluster, aw, an, dinv, b, x,
                                      out, active, k, omega, stream);
}

int deff_jacobi_resident_f64(int B, int ny, int nx, int cluster,
                             const void* aw, const void* an,
                             const void* dinv, const void* b, const void* x,
                             void* out, const int* active, int k,
                             double omega, void* stream) {
  return jacobi_resident_entry<double>(B, ny, nx, cluster, aw, an, dinv, b, x,
                                       out, active, k, omega, stream);
}

int deff_jacobi_sweeps_f32(int B, int ny, int nx, const void* aw,
                           const void* an, const void* dinv, const void* b,
                           const void* x, void* out, void* scratch,
                           const int* active, int k, double omega,
                           void* stream) {
  return jacobi_entry<float>(B, ny, nx, aw, an, dinv, b, x, out, scratch,
                             active, k, omega, stream);
}

int deff_jacobi_sweeps_f64(int B, int ny, int nx, const void* aw,
                           const void* an, const void* dinv, const void* b,
                           const void* x, void* out, void* scratch,
                           const int* active, int k, double omega,
                           void* stream) {
  return jacobi_entry<double>(B, ny, nx, aw, an, dinv, b, x, out, scratch,
                              active, k, omega, stream);
}

}  // extern "C"
