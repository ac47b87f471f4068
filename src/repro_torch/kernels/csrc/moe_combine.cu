// moe_combine: the MoE combine as one tiled product,
//
//   out[t, d] = sum_{e,c} combine[t, e, c] * expert_out[e, c, d]
//
// a (T, E*C) x (E*C, D) product with a float32 accumulator, rounded once to
// expert_out's dtype.  combine and expert_out are each float32 or bfloat16.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_combine.py (moe_combine),
// whose grid walks (T/bt, D/bd, EC/bk) with the contraction axis innermost
// and an f32 VMEM accumulator, on operands padded to its tiles.
//
// What bounds it on an H100: the dense product is 2 T (E*C) D operations on
// T (E*C) + (E*C) D + T D elements.  At the qwen3-moe group shape (T 512,
// E 128, C 40, D 2048) that is 10.7 GFLOP for ~57 MB in float32, so a dense
// kernel is bound by operations; but combine holds top_k non-zeros per row,
// so the function this data needs is ~2 T top_k D operations, and then the
// bytes bound it.  This kernel is the reference's dense formulation: float32
// inputs go through IEEE float32 FFMA on the CUDA cores (TF32 would fail the
// reference's atol 1e-4), so it is ~0.16 ms of operations at best.  Skipping
// the zeros (the paper's compacted mapping) is later work.
//
// Design: one thread block per (kBT x kBD) output tile, 16 x 16 threads each
// owning a 4 x 4 sub-tile.  Blocks run in no order on Hopper, so the
// reference's sequential contraction axis is a loop inside the block: each
// step stages a kBT x kBK slice of combine (transposed, rows padded by one
// float) and a kBK x kBD slice of expert_out in shared memory as float32.
// Every ragged edge (T, E*C, D) is masked when the tiles are loaded and when
// the output is stored, so no operand is padded.  Each output sums its terms
// in ascending E*C order.  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 64;  // output rows (tokens) per block
constexpr int kBD = 64;  // output columns per block
constexpr int kBK = 16;  // contraction depth per shared-memory step
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBT / kTY;
constexpr int kCols = kBD / kTX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // nearest even, as PyTorch rounds
}

template <typename TC, typename TE>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const TC* __restrict__ combine, const TE* __restrict__ expert,
                   TE* __restrict__ out, int t_len, int k_len, int d_len) {
  __shared__ float as[kBK][kBT + 1];  // combine slice, transposed
  __shared__ float bs[kBK][kBD];      // expert_out slice
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const int t0 = blockIdx.y * kBT, d0 = blockIdx.x * kBD;

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_len; k0 += kBK) {
#pragma unroll
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int t = i / kBK, kk = i % kBK;
      float x = 0.f;
      if (t0 + t < t_len && k0 + kk < k_len)
        x = to_f32(combine[static_cast<int64_t>(t0 + t) * k_len + k0 + kk]);
      as[kk][t] = x;
    }
#pragma unroll
    for (int i = tid; i < kBK * kBD; i += kThreads) {
      const int kk = i / kBD, d = i % kBD;
      float x = 0.f;
      if (k0 + kk < k_len && d0 + d < d_len)
        x = to_f32(expert[static_cast<int64_t>(k0 + kk) * d_len + d0 + d]);
      bs[kk][d] = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = as[kk][ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = bs[kk][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = t0 + ty + kTY * i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = d0 + tx + kTX * j;
      if (d < d_len) out[static_cast<int64_t>(t) * d_len + d] = from_f32<TE>(acc[i][j]);
    }
  }
}

template <typename TC, typename TE>
int launch(const void* combine, const void* expert, void* out, int t_len,
           int k_len, int d_len, cudaStream_t stream) {
  const dim3 grid((d_len + kBD - 1) / kBD, (t_len + kBT - 1) / kBT);
  const dim3 block(kTX, kTY);
  moe_combine_kernel<TC, TE><<<grid, block, 0, stream>>>(
      static_cast<const TC*>(combine), static_cast<const TE*>(expert),
      static_cast<TE*>(out), t_len, k_len, d_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC>
int dispatch_expert(const void* combine, const void* expert, void* out,
                    int t_len, int k_len, int d_len, int expert_bytes,
                    cudaStream_t s) {
  if (expert_bytes == 4)
    return launch<TC, float>(combine, expert, out, t_len, k_len, d_len, s);
  if (expert_bytes == 2)
    return launch<TC, __nv_bfloat16>(combine, expert, out, t_len, k_len, d_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success).  Shapes: combine (t_len, k_len) and expert
// (k_len, d_len), k_len = E*C; out (t_len, d_len) in expert's dtype; all
// contiguous, on the current device.  combine_bytes and expert_bytes are 4
// (float32) or 2 (bfloat16); t_len <= 65535 * 64 (the grid's y extent).
extern "C" int metl_moe_combine(const void* combine, const void* expert,
                                void* out, int t_len, int k_len, int d_len,
                                int combine_bytes, int expert_bytes,
                                void* stream) {
  if (t_len <= 0 || d_len <= 0) return 0;
  if (k_len < 0 || (t_len + kBT - 1) / kBT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (combine_bytes == 4)
    return dispatch_expert<float>(combine, expert, out, t_len, k_len, d_len,
                                  expert_bytes, s);
  if (combine_bytes == 2)
    return dispatch_expert<__nv_bfloat16>(combine, expert, out, t_len, k_len,
                                          d_len, expert_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
