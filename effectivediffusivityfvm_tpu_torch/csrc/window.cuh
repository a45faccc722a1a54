// Leaving a CG window once no image is live, shared by the host loops of
// K1 (cgstep.cu), K5 (cgstep_tiled.cu) and K7 (cgstep3d.cu), and by K9's
// graph replays (cgstep_sharded.cu, a ring of its own per workspace).
//
// The JAX windows are while_loops that stop at the first iteration that
// starts with no live image ((i < k) & any(live)).  The liveness lives on
// the device, and reading it back after every iteration would drain the
// stream each time.  So the finalize kernels also mark a flag in pinned,
// mapped host memory -- any(live) after the step, one slot per step in a
// ring -- and an event is recorded behind each.  Before launching iteration
// i (i >= LAG) the host waits on the event of flag i - LAG (live at the
// start of iteration i - LAG) and stops if it reads 0.  The host thus stays
// at most LAG iterations ahead of the device: with LAG = 1 iteration i - 1
// is queued while iteration i is launched, so the device does not wait for
// the host, and a window launches at most LAG iterations in which no image
// is live (gated: their CTAs return at once, so results are unchanged).
//
// A ring per device, locked for the window; at the start of a window the
// host waits for the previous window's last flag (the driver reads back
// between windows, so that wait is already over).  While the stream is
// being captured into a graph the window cannot wait, so it launches all k
// iterations (gated) as before.
#pragma once

#include <mutex>

#include "vcycle.cuh"

namespace deff {

extern long long g_window_iters;        // iterations launched by windows

constexpr int WINDOW_LAG = 1;           // dead iterations a window may launch
constexpr int WINDOW_RING = 4;          // flag slots, > WINDOW_LAG + 1
constexpr int WINDOW_DEVICES = 32;

// Thread 0 of a finalize block whose image is live after its step marks
// the step's flag.
__device__ __forceinline__ void mark_live(int* any, bool live) {
  if (any != nullptr && live && threadIdx.x == 0)
    *reinterpret_cast<volatile int*>(any) = 1;
}

struct WindowRing {
  std::mutex mu;
  int* host = nullptr;                  // WINDOW_RING flags, pinned
  int* dev = nullptr;                   // their device address
  cudaEvent_t ev[WINDOW_RING] = {};
  int last = -1;                        // the previous window's last event
};

// The ring's pinned, mapped flags and their events, on the current device.
inline cudaError_t ring_alloc(WindowRing& r) {
  cudaError_t e = cudaHostAlloc(reinterpret_cast<void**>(&r.host),
                                WINDOW_RING * sizeof(int),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e == cudaSuccess)
    e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&r.dev), r.host,
                                 0);
  for (int j = 0; j < WINDOW_RING && e == cudaSuccess; ++j)
    e = cudaEventCreateWithFlags(&r.ev[j], cudaEventDisableTiming);
  return e;
}

inline WindowRing& window_ring(int device) {
  static WindowRing rings[WINDOW_DEVICES];
  return rings[device];
}

class WindowExit {
 public:
  // Opens the window of the current device on stream st.
  explicit WindowExit(cudaStream_t st) {
    cudaStreamCaptureStatus cs = cudaStreamCaptureStatusNone;
    err_ = cudaStreamIsCapturing(st, &cs);
    if (err_ != cudaSuccess || cs != cudaStreamCaptureStatusNone) return;
    int d = 0;
    err_ = cudaGetDevice(&d);
    if (err_ != cudaSuccess) return;
    if (d >= WINDOW_DEVICES) { err_ = cudaErrorInvalidDevice; return; }
    ring_ = &window_ring(d);
    lock_ = std::unique_lock<std::mutex>(ring_->mu);
    if (ring_->host == nullptr) {
      err_ = ring_alloc(*ring_);
      if (err_ != cudaSuccess) { ring_ = nullptr; return; }
    }
    if (ring_->last >= 0) err_ = cudaEventSynchronize(ring_->ev[ring_->last]);
    ring_->last = -1;
    st_ = st;
  }

  cudaError_t status() const { return err_; }

  // Flag j's slot, zeroed, for the kernel that writes it (null when the
  // window launches every iteration).
  int* slot(int j) {
    if (ring_ == nullptr) return nullptr;
    ring_->host[j % WINDOW_RING] = 0;
    return ring_->dev + j % WINDOW_RING;
  }

  // Behind the kernel that writes flag j.
  cudaError_t mark(int j) {
    if (ring_ == nullptr) return cudaSuccess;
    ring_->last = j % WINDOW_RING;
    return cudaEventRecord(ring_->ev[j % WINDOW_RING], st_);
  }

  // Before iteration i: true when no image is live at the start of
  // iteration i - LAG (and so at every later one).
  cudaError_t stop_before(int i, bool* stop) {
    *stop = false;
    if (ring_ == nullptr || i < WINDOW_LAG) return cudaSuccess;
    const int j = (i - WINDOW_LAG) % WINDOW_RING;
    const cudaError_t e = cudaEventSynchronize(ring_->ev[j]);
    if (e != cudaSuccess) return e;
    *stop = reinterpret_cast<volatile int*>(ring_->host)[j] == 0;
    return cudaSuccess;
  }

 private:
  WindowRing* ring_ = nullptr;
  std::unique_lock<std::mutex> lock_;
  cudaStream_t st_ = nullptr;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace deff
