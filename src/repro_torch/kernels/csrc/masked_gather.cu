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
// What bounds it on an H100: bytes.  It does no arithmetic; per output element
// it reads one int32 of src (once per column of threads), one int8 of mask and,
// on a hit, one value, and writes a value and an int8.  At the per-block
// engine's shapes (a group of tens to hundreds of events, N_in about 10,
// N_out = 128) one call moves a few tens of kilobytes, a few hundredths of a
// microsecond at 3.35 TB/s, so the launch is what a call costs.
//
// Design: one thread owns one output column q of a tile of event rows.  A
// thread block is kThreadsQ threads along q by kThreadsB along b; each thread
// reads src[q] once and walks the tile's rows kThreadsB apart, so a warp
// stores 32 neighbouring outputs (coalesced).  Where the Pallas kernel padded
// N_in to 128 lanes and N_out to 128-wide tiles, this kernel masks the ragged
// edge itself (q < N_out, b < B), so it takes any N_in and any N_out.  A src
// entry at or past N_in is clamped into range instead of faulting; the plan
// lowering never produces one.  The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsQ = 128;     // threads along the output width
constexpr int kThreadsB = 4;       // threads along the event rows
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
__global__ void __launch_bounds__(kThreadsQ * kThreadsB)
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
       b += kThreadsB) {
    const int64_t row = static_cast<int64_t>(b);
    T v = fill;
    int8_t ok = 0;
    if (named && __ldg(mask + row * n_in + pc) != 0) {
      v = __ldg(values + row * n_in + pc);
      ok = 1;
    }
    out_v[row * n_out + q] = v;
    out_m[row * n_out + q] = ok;
  }
}

template <typename T>
int launch(const void* values, const void* mask, const void* src, void* out_v,
           void* out_m, int n_rows, int n_in, int n_out, float fill,
           cudaStream_t stream) {
  const dim3 block(kThreadsQ, kThreadsB);
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
