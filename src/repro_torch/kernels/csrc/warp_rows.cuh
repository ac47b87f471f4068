// warp_rows.cuh: what the two warp-per-row mapping bodies share,
// segmented_gather.cu and densify_map.cu, and their chunk entries.
//
// Both bodies give one output row to one warp and cover it 4 * 32 = 128
// columns at a time, lane l the four columns 4l .. 4l + 3: one 16-byte load
// of the block-table row and one 16-byte store of values and one 4-byte store
// of the mask a lane, or scalar accesses on the lane's own addresses where
// W % 4 != 0 or an address is not aligned.  Values travel as int32 bit
// patterns, so NaN and inf payloads are moved, never computed on.
//
// The chunk entries (metl_segmented_gather_chunk, metl_densify_map_chunk)
// take a pinned host arena, make the card of the parameter block current
// for the call and report what they issued through it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_rows {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;  // output rows (warps) per thread block
constexpr int kSpan = 4 * kWarp;   // output columns a warp covers per pass
constexpr int kNotPinned = -1;     // a chunk entry's host arena is pageable

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the four table entries of columns q .. q + 3, each < 0 as -1 (no column
// past the width names a slot)
__device__ __forceinline__ void load_table(const int32_t* __restrict__ row,
                                           int q, int width, int p[4]) {
  if (q + 3 < width && aligned(row + q, 16)) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(row + q));
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = q + i < width ? __ldg(row + q + i) : -1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = max(p[i], -1);
}

// columns q .. q + 3 of an output row: values (bits) and the mask, whose
// byte i is bit 8i of `hit`
__device__ __forceinline__ void store(int32_t* __restrict__ ov,
                                      int8_t* __restrict__ om, int q,
                                      int width, const int32_t acc[4],
                                      uint32_t hit) {
  if (q + 3 < width && aligned(ov + q, 16) && aligned(om + q, 4)) {
    *reinterpret_cast<int4*>(ov + q) = make_int4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<uint32_t*>(om + q) = hit;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q + i < width) {
        ov[q + i] = acc[i];
        om[q + i] = static_cast<int8_t>((hit >> (8 * i)) & 1);
      }
    }
  }
}

// whether `host` is page-locked host memory (a pageable pointer leaves no
// error in the context)
inline bool pinned(const void* host) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, host) != cudaSuccess ||
      attr.type != cudaMemoryTypeHost) {
    cudaGetLastError();
    return false;
  }
  return true;
}

// makes `device` current until it goes out of scope
struct DeviceGuard {
  int prev = -1;
  bool changed = false;
  int err = 0;
  explicit DeviceGuard(int device) {
    err = static_cast<int>(cudaGetDevice(&prev));
    if (err == 0 && prev != device) {
      err = static_cast<int>(cudaSetDevice(device));
      changed = err == 0;
    }
  }
  ~DeviceGuard() {
    if (changed) cudaSetDevice(prev);
  }
};

}  // namespace warp_rows
