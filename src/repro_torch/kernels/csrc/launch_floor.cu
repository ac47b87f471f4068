// launch_floor: an empty kernel, the yardstick of the per-block kernels.
//
// Not a port of a TPU kernel.  It is built with the same flags as the
// kernel libraries and bound the same way (ctypes, a plain C entry point),
// so its time per call in a replayed CUDA graph is what any launch costs
// the card: chip_smoke.py prints it as the `launch floor` line and states
// each kernel's time as a multiple of it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches empty_kernel<<<1, 128>>> on `stream`; returns cudaGetLastError().
extern "C" int metl_empty(void* stream) {
  empty_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
