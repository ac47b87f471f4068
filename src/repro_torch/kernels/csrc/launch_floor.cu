// launch_floor: an empty kernel, the yardstick of the per-block kernels.
//
// Not a port of a TPU kernel.  It is built with the same flags as the
// kernel libraries and bound the same way (ctypes, a plain C entry point),
// so its time per call in a replayed CUDA graph is what any launch costs
// the card: chip_smoke.py prints it as the `launch floor` line and states
// each kernel's time as a multiple of it.  metl_empty_n issues n launches
// from one C call, as the engines' chunk launchers issue theirs: its host
// time over n is the host cost of one launch (the roofline's LAUNCH_S).

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches empty_kernel<<<1, 128>>> on `stream`; returns cudaGetLastError().
extern "C" int metl_empty(void* stream) {
  empty_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Launches empty_kernel<<<1, 128>>> `n` times on `stream` from this one
// call; returns the first launch error, or cudaSuccess.
extern "C" int metl_empty_n(void* stream, int n) {
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
