// masked_gather: the DMM mapping of one compacted block (the paper's
// Algorithm 6), batched over the events of one (schema, version) group.
//
// Replaces the Pallas TPU kernel repro/kernels/masked_gather.py
// (masked_gather).  It computes
//
//   out_v[b, q] = values[b, src[q]]   where src[q] >= 0 and mask[b, src[q]] != 0,
//               = fill                otherwise
//   out_m[b, q] = that predicate, as int8
//
// for float32 or bfloat16 values.  It only moves values (bfloat16 travels as
// its 16-bit pattern), so it agrees with its plain version bit for bit.
//
// What bounds it on an H100: the launch.  It does no arithmetic; per output
// element it needs one int32 of src (once per column of threads), one int8 of
// mask and, on a hit, one value, and writes a value and an int8.  At the
// per-block engine's median group (B 1, N_in 9, N_out 128) one call moves
// ~1.2 KB, 0.00035 us at 3.35 TB/s, against the ~1 us an empty kernel takes
// (chip_smoke.py's `launch floor` line, graph-replayed: 0.8-1.3 us on an
// H100 80GB HBM3 at 700 W) and ~1.5-1.7 us for a call of this kernel.
// Shared-memory tiling, TMA and wgmma buy nothing at that size: a body that
// staged the tile's rows in shared memory was no faster at B 1-3 and
// 1.3-7.7x slower at B 37-256.  What a call can save is dependent memory round trips
// inside it, and the host's cost of issuing it (metl_masked_gather_blocks).
//
// Design: one thread owns one output column q of a tile of up to
// kRowsPerBlock event rows; the block is kThreadsQ threads along q by 1-4
// along b, picked from B so that a small group leaves no row-less threads.
// Each thread reads src[q] once and walks its rows blockDim.y apart, so a
// warp stores 32 neighbouring outputs (coalesced).  For each row it loads
// the mask byte and the value together and selects after both arrive, so a
// call waits on two dependent round trips to memory (src, then mask and
// value) and not three; in one graph-replayed A/B that made a call 7-9 %
// faster at B 1-8 and ~30 % faster at B 37-256 than loading the value after
// its mask.  Where the Pallas kernel padded N_in to 128 lanes and N_out to
// 128-wide tiles, this kernel masks the ragged edge itself (q < N_out,
// b < B), so it takes any N_in and any N_out.  A src entry at or past N_in
// is clamped into range instead of faulting; the plan lowering never
// produces one.  The kernel allocates nothing and launches on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blocks.cuh"

namespace {

constexpr int kThreadsQ = 128;     // threads along the output width
constexpr int kMaxThreadsB = 4;    // most threads along the event rows
constexpr int kRowsPerBlock = 32;  // event rows per thread block

// fill in the value type's bit pattern; bfloat16 rounds to nearest even, as
// PyTorch rounds a float to bfloat16
template <typename T>
__device__ __forceinline__ T fill_bits(float fill);
template <>
__device__ __forceinline__ uint32_t fill_bits<uint32_t>(float fill) {
  return __float_as_uint(fill);
}
template <>
__device__ __forceinline__ uint16_t fill_bits<uint16_t>(float fill) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(fill));
}

template <typename T>
__global__ void __launch_bounds__(kThreadsQ * kMaxThreadsB)
masked_gather_kernel(const T* __restrict__ values,
                     const int8_t* __restrict__ mask,
                     const int32_t* __restrict__ src,
                     T* __restrict__ out_v,
                     int8_t* __restrict__ out_m,
                     int n_rows, int n_in, int n_out, float fill_f32) {
  const int q = blockIdx.x * kThreadsQ + threadIdx.x;
  if (q >= n_out) return;
  const T fill = fill_bits<T>(fill_f32);
  const int p = __ldg(src + q);
  const bool named = p >= 0;
  const int pc = min(max(p, 0), n_in - 1);
  const int b_end = min(n_rows, (blockIdx.y + 1) * kRowsPerBlock);
  for (int b = blockIdx.y * kRowsPerBlock + threadIdx.y; b < b_end;
       b += blockDim.y) {
    const int64_t in = static_cast<int64_t>(b) * n_in + pc;
    const int8_t m = __ldg(mask + in);  // the value's load does not wait on it
    const T x = __ldg(values + in);
    const bool ok = named && m != 0;
    const int64_t o = static_cast<int64_t>(b) * n_out + q;
    out_v[o] = ok ? x : fill;
    out_m[o] = ok ? 1 : 0;
  }
}

template <typename T>
int launch(const void* values, const void* mask, const void* src, void* out_v,
           void* out_m, int n_rows, int n_in, int n_out, float fill,
           cudaStream_t stream) {
  const dim3 block(kThreadsQ, n_rows < kMaxThreadsB ? n_rows : kMaxThreadsB);
  const dim3 grid((n_out + kThreadsQ - 1) / kThreadsQ,
                  (n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
  masked_gather_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const int8_t*>(mask),
      static_cast<const int32_t*>(src), static_cast<T*>(out_v),
      static_cast<int8_t*>(out_m), n_rows, n_in, n_out, fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success).  Shapes: values/mask (n_rows, n_in), src (n_out,),
// out_v/out_m (n_rows, n_out); all contiguous, all on the current device.
// elem_bytes is 4 (float32) or 2 (bfloat16); fill is rounded to bfloat16
// (to nearest even, as PyTorch rounds) for bfloat16 values.
extern "C" int metl_masked_gather(const void* values, const void* mask,
                                  const void* src, void* out_v, void* out_m,
                                  int n_rows, int n_in, int n_out,
                                  int elem_bytes, float fill, void* stream) {
  if (n_rows <= 0 || n_out <= 0) return 0;
  if (n_in <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(values, mask, src, out_v, out_m, n_rows, n_in,
                            n_out, fill, s);
  if (elem_bytes == 2)
    return launch<uint16_t>(values, mask, src, out_v, out_m, n_rows, n_in,
                            n_out, fill, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry point of the per-block engine's chunk (blocks.cuh): every group's
// two copies, host arena -> device arena, and one launch of
// masked_gather_kernel per block, on `stream`.  float32 payloads only;
// src_flat is the plan's flat int32 index table, out_v/out_m the chunk's
// float32/int8 output arenas.  A block whose group has N_in 0 fails with
// cudaErrorInvalidValue, as metl_masked_gather does.  Returns the first
// error (0 on success); *n_copies and *n_launches count what was issued.
extern "C" int metl_masked_gather_blocks(
    const void* host, void* dev, const int64_t* groups, int64_t n_groups,
    const int64_t* blocks, int64_t n_blocks, const void* src_flat, void* out_v,
    void* out_m, float fill, void* stream, int64_t* n_copies,
    int64_t* n_launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* src = static_cast<const int32_t*>(src_flat);
  uint32_t* ov = static_cast<uint32_t*>(out_v);
  int8_t* om = static_cast<int8_t*>(out_m);
  return launch_chunk(
      static_cast<const uint8_t*>(host), static_cast<uint8_t*>(dev), groups,
      n_groups, blocks, n_blocks, s, n_copies, n_launches,
      [&](const float* values, const int8_t* mask, int64_t src_off,
          int64_t out_off, int rows, int n_in, int n_out) {
        if (n_in <= 0) return static_cast<int>(cudaErrorInvalidValue);
        return launch<uint32_t>(values, mask, src + src_off, ov + out_off,
                                om + out_off, rows, n_in, n_out, fill, s);
      });
}
