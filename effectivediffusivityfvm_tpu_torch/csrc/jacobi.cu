// K3: k damped-Jacobi sweeps on a (B, ny, nx) batch, one launch per sweep.
//
// Replaces effectivediffusivityfvm_tpu/ops/kernels/jacobi_vmem.py
// (jacobi_sweeps_pallas), the reference's updateX_SOR (Deff2D.cuh:69-92).
// The wrapper and the plain version are in ops/kernels/jacobi.py.
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
// -fmad=false, so the kernel equals its plain version bit for bit.
//
// What bounds it on an H100: memory.  A sweep reads five planes and writes
// one (24 B/cell in fp32, 48 in fp64) for 12 flops a cell.  The TPU kernel
// kept an image in VMEM for all k sweeps; this first version streams every
// sweep through L2/HBM with blockIdx = (column tile, row tile, image),
// ping-ponging between the output and one scratch plane, so it pays the
// 24 B/cell once per sweep and one launch per sweep.  A 128^2 image sits
// in L2, so at that size the launches, not the bytes, set the pace.
//
// Per-image freezing: a block whose image flag is 0 reads and writes
// nothing, except on the last sweep, where it copies its image's input
// into the fresh output, so a frozen image comes back bitwise unchanged.
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
