// onehot_map: one compacted block applied as an explicit 0/1 matrix -- the
// paper's pre-DMM baseline, where the mapping matrix itself is the operator.
//
// Replaces the Pallas TPU kernel repro/kernels/onehot_map.py (onehot_map).
// With M[q, p] = (p == src[q]) it computes, in float32 whatever the value type,
//
//   acc_v[b, q] = sum_p values[b, p] * M[q, p]
//   acc_m[b, q] = sum_p mask[b, p]   * M[q, p]
//   out_m[b, q] = acc_m[b, q] > 0.5, as int8
//   out_v[b, q] = out_m ? acc_v : fill, stored in the value type
//
// for float32 or bfloat16 values.  This is a true contraction, on purpose:
// it is the cost the compacted gather (masked_gather.cu) removes, so it must
// not short-circuit to a gather.  Two consequences follow, as through the
// TPU's matrix unit: a non-finite value anywhere in an event row turns every
// mask-set output of that row non-finite (x * 0 is NaN for x = inf or NaN),
// and the sign of a zero result depends on the order of the sum, so values
// agree with the plain version within a tolerance and masks bit for bit.
//
// What bounds it on an H100: at the per-block engine's shapes the launch.
// At the median group (B 1, N_in 9, N_out 128) a call moves ~1.2 KB and does
// 4,608 float32 operations, both far under a microsecond, against the ~1 us
// an empty kernel takes (chip_smoke.py's `launch floor` line, graph-replayed:
// 0.8-1.3 us on an H100 80GB HBM3 at 700 W) and ~2.4 us for a call; so
// shared-memory tiling beyond the staging below, TMA and wgmma buy nothing
// there, and what a chunk can save is the host's cost of issuing its
// launches (metl_onehot_map_blocks below).  The operations grow with
// N_in * N_out while the bytes grow with N_in + N_out, which is the paper's
// point: at wide versions the contraction is the bound.
//
// Design: one thread block per (tile of kTileB event rows, tile of kTileQ
// output columns).  The row tile's values and mask are staged in shared
// memory, converted to float32, kTileP input columns at a time; each thread
// owns one output column q, forms its one-hot column from src[q] on the fly
// and accumulates kTileB rows of values and of mask with IEEE float32 FFMA
// over the true N_in.  No tensor cores: TF32 would truncate the values.
// Shared-memory reads are broadcasts (every thread of a warp reads the same
// element), so they have no bank conflicts.  Rows past B and columns past
// N_out are masked, so any shape works.  The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blocks.cuh"

namespace {

constexpr int kTileQ = 128;  // output columns per thread block (one per thread)
constexpr int kTileB = 8;    // event rows per thread block
constexpr int kTileP = 64;   // input columns staged per step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint16_t from_f32<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kTileQ)
onehot_map_kernel(const T* __restrict__ values,
                  const int8_t* __restrict__ mask,
                  const int32_t* __restrict__ src,
                  T* __restrict__ out_v,
                  int8_t* __restrict__ out_m,
                  int n_rows, int n_in, int n_out, float fill) {
  __shared__ float sv[kTileB][kTileP];
  __shared__ float sm[kTileB][kTileP];
  const int q = blockIdx.x * kTileQ + threadIdx.x;
  const int b0 = blockIdx.y * kTileB;
  const int s = q < n_out ? __ldg(src + q) : -1;
  float acc_v[kTileB];
  float acc_m[kTileB];
#pragma unroll
  for (int r = 0; r < kTileB; ++r) {
    acc_v[r] = 0.0f;
    acc_m[r] = 0.0f;
  }
  for (int p0 = 0; p0 < n_in; p0 += kTileP) {
    const int np = min(kTileP, n_in - p0);
    __syncthreads();  // the previous step's tile is consumed
    for (int i = threadIdx.x; i < kTileB * kTileP; i += kTileQ) {
      const int r = i / kTileP;
      const int c = i % kTileP;
      const int b = b0 + r;
      float v = 0.0f;
      float m = 0.0f;
      if (b < n_rows && c < np) {
        const int64_t off = static_cast<int64_t>(b) * n_in + p0 + c;
        v = to_f32(values[off]);
        m = static_cast<float>(mask[off]);
      }
      sv[r][c] = v;
      sm[r][c] = m;
    }
    __syncthreads();
    for (int c = 0; c < np; ++c) {
      const float w = (p0 + c == s) ? 1.0f : 0.0f;
#pragma unroll
      for (int r = 0; r < kTileB; ++r) {
        acc_v[r] = __fmaf_rn(sv[r][c], w, acc_v[r]);
        acc_m[r] = __fmaf_rn(sm[r][c], w, acc_m[r]);
      }
    }
  }
  if (q >= n_out) return;
#pragma unroll
  for (int r = 0; r < kTileB; ++r) {
    const int b = b0 + r;
    if (b < n_rows) {
      const bool hit = acc_m[r] > 0.5f;
      const int64_t off = static_cast<int64_t>(b) * n_out + q;
      out_v[off] = from_f32<T>(hit ? acc_v[r] : fill);
      out_m[off] = hit ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const void* values, const void* mask, const void* src, void* out_v,
           void* out_m, int n_rows, int n_in, int n_out, float fill,
           cudaStream_t stream) {
  const dim3 grid((n_out + kTileQ - 1) / kTileQ,
                  (n_rows + kTileB - 1) / kTileB);
  onehot_map_kernel<T><<<grid, kTileQ, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const int8_t*>(mask),
      static_cast<const int32_t*>(src), static_cast<T*>(out_v),
      static_cast<int8_t*>(out_m), n_rows, n_in, n_out, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success).  Shapes: values/mask (n_rows, n_in), src (n_out,),
// out_v/out_m (n_rows, n_out); all contiguous, all on the current device.
// elem_bytes is 4 (float32) or 2 (bfloat16).
extern "C" int metl_onehot_map(const void* values, const void* mask,
                               const void* src, void* out_v, void* out_m,
                               int n_rows, int n_in, int n_out, int elem_bytes,
                               float fill, void* stream) {
  if (n_rows <= 0 || n_out <= 0) return 0;
  if (n_in < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<float>(values, mask, src, out_v, out_m, n_rows, n_in, n_out,
                         fill, s);
  if (elem_bytes == 2)
    return launch<uint16_t>(values, mask, src, out_v, out_m, n_rows, n_in,
                            n_out, fill, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry point of the per-block engine's chunk (blocks.cuh): every group's
// two copies, host arena -> device arena, and one launch of onehot_map_kernel
// per block, on `stream`.  float32 payloads only; src_flat is the plan's flat
// int32 index table, out_v/out_m the chunk's float32/int8 output arenas.  A
// group with N_in 0 maps to fill, as metl_onehot_map does.  Returns the first
// error (0 on success); *n_copies and *n_launches count what was issued.
extern "C" int metl_onehot_map_blocks(
    const void* host, void* dev, const int64_t* groups, int64_t n_groups,
    const int64_t* blocks, int64_t n_blocks, const void* src_flat, void* out_v,
    void* out_m, float fill, void* stream, int64_t* n_copies,
    int64_t* n_launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(src_flat);
  float* ov = static_cast<float*>(out_v);
  int8_t* om = static_cast<int8_t*>(out_m);
  return launch_chunk(
      static_cast<const uint8_t*>(host), static_cast<uint8_t*>(dev), groups,
      n_groups, blocks, n_blocks, s, n_copies, n_launches,
      [&](const float* values, const int8_t* mask, int64_t src_off,
          int64_t out_off, int rows, int n_in, int n_out) {
        return launch<float>(values, mask, src + src_off, ov + out_off,
                             om + out_off, rows, n_in, n_out, fill, s);
      });
}
