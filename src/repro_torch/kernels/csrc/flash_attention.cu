// flash_attention: forward attention with an online softmax, causal or not,
// grouped-query (GQA) by the KV index h / n_rep.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention).  It computes what the reference's oracle attention_ref
// computes:
//
//   out[h, i, :] = softmax_j(q[h, i, :] . k[h / n_rep, j, :] / sqrt(hd)) v[h / n_rep, j, :]
//
// over keys j < T, and with causal masking over j <= i only (absolute
// indices, also when S != T), for float32 or bfloat16 q, k, v and out.
// Scores, the running max (initialised to -1e30), the running denominator
// and the accumulator stay in float32; the output is acc / max(l, 1e-30),
// rounded once to the input dtype.
//
// What bounds it on an H100: operations.  Per query head it does 4 S T hd
// operations (2 S T hd for q.k, 2 S T hd for p.v; half that when causal)
// against 2 (S + T) hd elements moved: at the olmo-1b prefill (32 heads of
// S = T = 2048, hd 128, bfloat16) that is ~34 GFLOP of causal work for 67 MB,
// 0.035 ms on the bf16 tensor cores against 0.020 ms of bytes.  This first
// kernel runs every product as a float32 FFMA on the CUDA cores (~67 TFLOP/s
// at full clock), so it cannot come closer than ~0.5 ms a call; a bf16 mma
// would also round p to bf16 before p.v, where the reference keeps it in f32.
// Tensor cores (wgmma), TMA and warp specialisation are later work.
//
// Design: one thread block per (query head, tile of kBQ = 64 query rows),
// heaviest causal tiles first.  Blocks on Hopper run in no order, so the
// reference's sequential third grid axis (KV tiles) becomes a loop inside the
// block.  The block stages its Q tile once and each K/V tile of kBK = 64 keys
// in shared memory as float32 (rows padded by one float so that column reads
// are free of bank conflicts), and 16 x 16 threads each own a 4 x 4 tile of
// scores and 4 rows x hd/16 columns of the accumulator.  A row's max and sum
// are reduced over the 16 threads that share it with warp shuffles.  In
// causal mode the loop stops at the diagonal tile (the reference skips fully
// masked tiles with pl.when).  Ragged edges are masked inside the kernel: a
// key at index >= T never counts (causal or not, so the reference's
// T % block_k rule for non-causal attention is lifted), query rows >= S are
// not stored, and a head dim below the padded tile width (16, 32, 64, 128)
// reads zeros.  The kernel allocates nothing and launches on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;    // query rows per block
constexpr int kBK = 64;    // keys per shared-memory tile
constexpr int kTX = 16;    // threads along keys / head dim
constexpr int kTY = 16;    // threads along query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;  // query rows per thread
constexpr int kCols = kBK / kTX;  // score columns per thread
constexpr float kNegInf = -1e30f;

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

// max / sum over the 16 threads of a half warp that share a query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (HD + 1) + kBK * (HD + 1) + kBK * HD +
          kBQ * (kBK + 1));
}

// HD: the head dim padded to a multiple of 16 (16, 32, 64 or 128); hd <= HD
// is the true one.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int s_len, int t_len, int hd, int n_rep, int causal,
                       float scale) {
  constexpr int QS = HD + 1;   // row stride of the Q and K tiles
  constexpr int PS = kBK + 1;  // row stride of the P tile
  constexpr int kDims = HD / kTX;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][QS]
  float* ks = qs + kBQ * QS;    // [kBK][QS]
  float* vs = ks + kBK * QS;    // [kBK][HD]
  float* ps = vs + kBK * HD;    // [kBQ][PS]

  const int head = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTX + tx;
  const T* qh = q + static_cast<int64_t>(head) * s_len * hd;
  const int64_t kv_off = static_cast<int64_t>(head / n_rep) * t_len * hd;
  const T* kh = k + kv_off;
  const T* vh = v + kv_off;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < s_len && d < hd) x = to_f32(qh[static_cast<int64_t>(q0 + r) * hd + d]);
    qs[r * QS + d] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int t_end = causal ? min(t_len, q0 + kBQ) : t_len;
  for (int k0 = 0; k0 < t_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < t_len && d < hd) {
        const int64_t g = static_cast<int64_t>(k0 + r) * hd + d;
        kx = to_f32(kh[g]);
        vx = to_f32(vh[g]);
      }
      ks[r * QS + d] = kx;
      vs[r * HD + d] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRows], b[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + kTY * i) * QS + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) b[j] = ks[(tx + kTX * j) * QS + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTY * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + kTX * j;
        const bool keep = col < t_len && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + kTY * i) * PS + tx + kTX * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + kTY * i) * PS + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const float vv = vs[c * HD + tx + kTX * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* oh = out + static_cast<int64_t>(head) * s_len * hd;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + kTY * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int d = tx + kTX * j;
      if (d < hd) oh[static_cast<int64_t>(row) * hd + d] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int n,
           int s_len, int t_len, int hd, int n_rep, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kBQ - 1) / kBQ, n);
  const dim3 block(kTX, kTY);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  flash_attention_kernel<T, HD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, t_len, hd, n_rep,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out, int n,
                int s_len, int t_len, int hd, int n_rep, int causal,
                cudaStream_t s) {
  if (hd <= 16) return launch<T, 16>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
  if (hd <= 32) return launch<T, 32>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
  return launch<T, 128>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success).  Shapes: q and out (n, s_len, hd), k and v
// (n / n_rep, t_len, hd); all contiguous, of one dtype, on the current
// device.  elem_bytes is 4 (float32) or 2 (bfloat16); 1 <= hd <= 128;
// n <= 65535 (the grid's y extent).
extern "C" int metl_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int n, int s_len,
                                    int t_len, int hd, int n_rep, int causal,
                                    int elem_bytes, void* stream) {
  if (n <= 0 || s_len <= 0) return 0;
  if (t_len <= 0 || hd <= 0 || hd > 128 || n_rep <= 0 || n % n_rep != 0 ||
      n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return dispatch_hd<float>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
  if (elem_bytes == 2)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, n, s_len, t_len, hd, n_rep,
                                      causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
