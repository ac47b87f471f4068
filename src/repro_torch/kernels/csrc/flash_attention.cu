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
// indices, also when S != T), for any S and T and 1 <= hd <= 128.  The
// running max starts at -1e30 and masked scores are -1e30, the running
// denominator and the accumulator stay in float32, and the output is
// acc / max(l, 1e-30), rounded once to the input dtype.  Query rows >= S
// are not stored; keys >= T never count (so the reference's T % block_k
// rule for non-causal attention is lifted).
//
// What bounds it on an H100: operations.  Per query head it does 4 S T hd
// operations (2 S T hd for q.k, 2 S T hd for p.v; half that when causal)
// against 2 (S + T) hd elements moved: at the olmo-1b prefill (32 heads of
// S = T = 2048, hd 128, bfloat16) that is 34.4 GFLOP of causal work for
// 67 MB, 0.035 ms on the bf16 tensor cores against 0.020 ms of bytes.
//
// Two kernels share the entry point; the wrapper's rule picks one
// (kernels/flash_attention.py, kernel_variant):
//
// * wgmma (bfloat16 with hd % 8 == 0; the wrapper raises for operands that
//   do not start 16-byte aligned, as the tensor maps need): both
//   products on the tensor cores.  One block of two warpgroups (256
//   threads) per (query head, tile of kBQ = 128 query rows), heaviest
//   causal tiles first; each warpgroup owns 64 query rows and both share
//   each K/V tile of kBK = 128 keys.  Copies: TMA, chosen over cp.async
//   because one thread issues a whole tile, the hardware applies the
//   128-byte swizzle that wgmma's descriptors read, and zero-fills what
//   lies outside the tensor, which pads the head dim (8 and 16 in the smoke
//   configs) up to the 64-column box and the ragged S and T edges without a
//   branch.  Each operand is a 3-D tensor map (hd, rows, heads), so a box
//   never crosses a head.  Q is loaded once; K and V go through a ring of
//   kStages = 3 stages behind mbarriers, thread 0 issuing tile j + 2 as
//   soon as tile j - 1's stage is released, so two tiles are in flight
//   while one is multiplied.  S = Q K^T is wgmma m64n128k16 with Q and K
//   K-major as they lie in memory (hd / 16 steps over the padded head
//   dim); the softmax runs on the accumulator fragments in registers (the
//   scale folded into exp2f, row max over the quad of threads sharing a
//   row by shuffles, causal and T masks only on the diagonal and last
//   tiles); P is rounded to bfloat16 in registers, where the accumulator's
//   layout is the A-fragment layout of the next wgmma, and O += P V is
//   wgmma m64n{64,128}k16 with V as an MN-major B (transpose bit), so V
//   needs no transpose in memory.  Rounding p to bfloat16 is the one
//   difference from the reference's arithmetic (about 2^-9 relative per
//   weight; tests/test_torch_flash_tc.py emulates it against the reference
//   within chip_smoke.py's bf16 limit, atol 5e-3 / rtol 1e-2).  Shared
//   memory at hd 128: the Q tile (32 KB) and three stages of a K and a V
//   tile (32 KB each), 230,480 bytes with the
//   barriers and the slack that aligns the base to 1,024 bytes: one block
//   an SM.  ptxas (build.ptxas_report, CUDA 12.9) gives 167 registers a
//   thread at hd 128 and 128 at hd 64, no spills.  No warp
//   specialisation (thread 0 of the first warpgroup issues the copies and
//   waits for both warpgroups to free a stage) and no ping-pong between the
//   warpgroups: later work.  A variant that issued tile j's q.k^T with tile
//   j - 1's p.v, so that a warpgroup's softmax overlapped its own p.v, was
//   no faster on the card (PERF.md) and was not kept.  No CUTLASS: the few
//   primitives it would bring are in hopper.cuh, and the build stays a
//   plain nvcc of one file.
//
// * ffma (float32, and bfloat16 with hd % 8 != 0): every product as a
//   float32 FFMA on the CUDA cores, p kept in float32 as in the reference
//   (TF32 tensor cores would miss the float32 tolerance of 3e-5).  One
//   block per (query head, tile of 64 query rows), heaviest causal tiles
//   first; Hopper blocks run in no order, so the reference's sequential
//   KV grid axis is a loop inside the block.  The block stages its Q tile
//   once and each K/V tile of 64 keys in shared memory as float32 (rows
//   padded by one float, free of bank conflicts), and 16 x 16 threads each
//   own a 4 x 4 tile of scores and 4 rows x hd/16 columns of the
//   accumulator; a row's max and sum are reduced over the 16 threads that
//   share it with warp shuffles.  In causal mode the loop stops at the
//   diagonal tile.  A head dim below the padded width (16, 32, 64, 128)
//   reads zeros.
//
// Both allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace ffma {

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

}  // namespace ffma

namespace tc {

constexpr int kBQ = 128;        // query rows per block: two warpgroups of 64
constexpr int kBK = 128;        // keys per K/V tile
constexpr int kStages = 3;      // K/V tiles in the ring
constexpr int kThreads = 256;   // two warpgroups
constexpr int kRowBytes = 128;  // a row of a 64-column bf16 box: one swizzle-atom row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// D (64 x 128, f32) = (accumulate ? D : 0) + A B, A and B from shared memory
// through descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) += A B: A (64 x 16 bf16) from registers in the
// accumulator's fragment layout, B from shared memory, MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A B: A (64 x 16 bf16) from registers in the
// accumulator's fragment layout, B from shared memory, MN-major (trans-b)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// Shared memory, in bytes from a 1024-aligned base: the Q tile, kStages K
// tiles, kStages V tiles, then the barriers (Q full; per stage K full, V
// full, stage free).  A tile of R rows x HD columns is HD / 64 blocks of
// R x 128 bytes, each as one TMA box writes it.
template <int HD>
struct Smem {
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kTileBytes = kBK * HD * 2;  // one K or V tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kQBytes;
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kBar = kV + kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + base alignment
};
static_assert(Smem<128>::kBytes <= 232448, "more than the 227 KB a block can use");

// thread 0: K and V tile j into stage j % kStages
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk, const CUtensorMap* tv,
                                        uint32_t base, uint32_t bars, int j, int kv_head) {
  using L = Smem<HD>;
  const int s = j % kStages;
  const uint32_t ks = base + L::kK + s * L::kTileBytes, vs = base + L::kV + s * L::kTileBytes;
  const uint32_t bar_k = bars + 8 * (1 + s), bar_v = bars + 8 * (1 + kStages + s);
  hopper::mbar_expect_tx(bar_k, L::kTileBytes);
#pragma unroll
  for (int b = 0; b < HD / 64; ++b)
    hopper::tma_load_3d(ks + b * kBK * kRowBytes, tk, bar_k, 64 * b, j * kBK, kv_head);
  hopper::mbar_expect_tx(bar_v, L::kTileBytes);
#pragma unroll
  for (int b = 0; b < HD / 64; ++b)
    hopper::tma_load_3d(vs + b * kBK * kRowBytes, tv, bar_v, 64 * b, j * kBK, kv_head);
}

// HD: the head dim padded to 64 or 128 (TMA zero-fills the columns >= hd)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out, int n, int s_len, int t_len,
                             int hd, int n_rep, int causal, float scale_log2) {
  using L = Smem<HD>;
  constexpr int kSRegs = kBK / 2;  // score accumulator floats a thread (m64n128)
  constexpr int kORegs = HD / 2;   // output accumulator floats a thread (m64nHD)
  extern __shared__ uint8_t tc_smem[];  // (the FFMA kernel's `smem` is float)
  const uint32_t base = (hopper::smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;  // [0] Q full, then K full, V full, free per stage

  // one block per (head, query tile); the heaviest causal tiles of every
  // head first
  const int head = blockIdx.x % n;
  const int kv_head = head / n_rep;
  const int q0 = (gridDim.x / n - 1 - blockIdx.x / n) * kBQ;
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // this warpgroup's rows: q0 + 64 wg .. + 63
  const int lane = tid % 32;
  // accumulator fragments: this thread's rows row0 and row0 + 8, columns
  // 8 b + quad_col + {0, 1} of each 8-column block b
  const int row0 = q0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;
  const int quad_col = 2 * (lane % 4);
  const int t_end = causal ? min(t_len, q0 + kBQ) : t_len;
  const int n_tiles = (t_end + kBK - 1) / kBK;

  if (tid == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bars + 8 * (1 + s), 1);
      hopper::mbar_init(bars + 8 * (1 + kStages + s), 1);
      hopper::mbar_init(bars + 8 * (1 + 2 * kStages + s), kThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bars, L::kQBytes);
#pragma unroll
    for (int b = 0; b < HD / 64; ++b)
      hopper::tma_load_3d(base + L::kQ + b * kBQ * kRowBytes, &tq, bars, 64 * b, q0, head);
    for (int j = 0; j < min(kStages - 1, n_tiles); ++j) load_kv<HD>(&tk, &tv, base, bars, j, kv_head);
  }
  __syncwarp();

  float o[kORegs];
#pragma unroll
  for (int i = 0; i < kORegs; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // per row, l over this thread's columns
  const uint32_t q_wg = base + L::kQ + wg * 64 * kRowBytes;
  hopper::mbar_wait(bars, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t phase = (j / kStages) & 1;
    const int k0 = j * kBK;
    const uint32_t ks = base + L::kK + s * L::kTileBytes, vs = base + L::kV + s * L::kTileBytes;

    // S = Q K^T: hd / 16 steps of 16 columns, Q and K K-major
    float sc[kSRegs];
    hopper::mbar_wait(bars + 8 * (1 + s), phase);
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) hopper::fence_reg(sc[i]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
      const uint64_t da = hopper::desc_sw128(q_wg + (kk / 4) * kBQ * kRowBytes + col, 16, 1024);
      const uint64_t db = hopper::desc_sw128(ks + (kk / 4) * kBK * kRowBytes + col, 16, 1024);
      wgmma_ss_m64n128k16(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) hopper::fence_reg(sc[i]);

    // online softmax in the log2 domain; masks only where a key can be >= T
    // or past a row of this warpgroup
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) sc[i] *= scale_log2;
    if (k0 + kBK > t_len || (causal && k0 + kBK - 1 > q0 + 64 * wg)) {
#pragma unroll
      for (int i = 0; i < kSRegs; ++i) {
        const int key = k0 + 8 * (i / 4) + quad_col + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (key >= t_len || (causal && key > row)) sc[i] = kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kSRegs; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // P in bf16, in the A-fragment layout: registers 8 kk .. 8 kk + 7 of
    // the scores are keys 16 kk .. 16 kk + 15 of this thread's two rows
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 8 * kk + 2 * t, r = t & 1;
        const float p0 = exp2f(sc[i] - m[r]), p1 = exp2f(sc[i + 1] - m[r]);
        l[r] += p0 + p1;
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        pa[kk][t] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
#pragma unroll
    for (int i = 0; i < kORegs; ++i) o[i] *= corr[(i / 2) & 1];

    // O += P V: kBK / 16 steps of 16 keys, V MN-major
    hopper::mbar_wait(bars + 8 * (1 + kStages + s), phase);
#pragma unroll
    for (int i = 0; i < kORegs; ++i) hopper::fence_reg(o[i]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) hopper::fence_reg(pa[kk][t]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = hopper::desc_sw128(vs + kk * 16 * kRowBytes, kBK * kRowBytes, 1024);
      if constexpr (HD == 128)
        wgmma_rs_m64n128k16(o, pa[kk], db);
      else
        wgmma_rs_m64n64k16(o, pa[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kORegs; ++i) hopper::fence_reg(o[i]);
    hopper::mbar_arrive(bars + 8 * (1 + 2 * kStages + s));

    // refill: tile j + kStages - 1 goes where tile j - 1 was, once both
    // warpgroups have released it
    const int next = j + kStages - 1;
    if (tid == 0 && next < n_tiles) {
      if (next >= kStages)
        hopper::mbar_wait(bars + 8 * (1 + 2 * kStages + next % kStages),
                          (next / kStages - 1) & 1);
      load_kv<HD>(&tk, &tv, base, bars, next, kv_head);
    }
    __syncwarp();
  }

  // l over the quad sharing a row, then one rounding to bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<int64_t>(head) * s_len + row) * hd;
#pragma unroll
    for (int b = 0; b < HD / 8; ++b) {
      const int d = 8 * b + quad_col;  // hd % 8 == 0: d < hd implies d + 1 < hd
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[4 * b + 2 * r] / denom, o[4 * b + 2 * r + 1] / denom);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int n, int s_len, int t_len,
           int hd, int n_rep, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = hopper::tensor_map_bf16(&tq, q, n, s_len, hd, kBQ);
  if (err == 0) err = hopper::tensor_map_bf16(&tk, k, n / n_rep, t_len, hd, kBK);
  if (err == 0) err = hopper::tensor_map_bf16(&tv, v, n / n_rep, t_len, hd, kBK);
  if (err != 0) return err;
  constexpr int smem = Smem<HD>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = n * ((s_len + kBQ - 1) / kBQ);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(hd));
  flash_attention_wgmma_kernel<HD><<<blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), n, s_len, t_len, hd, n_rep, causal,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success), or the negated CUresult of a tensor map that could
// not be encoded.  Shapes: q and out (n, s_len, hd), k and v (n / n_rep,
// t_len, hd); all contiguous, of one dtype, on the current device.
// elem_bytes is 4 (float32) or 2 (bfloat16); 1 <= hd <= 128; n <= 65535.
// tensor_cores 1 runs the wgmma kernel, which takes bfloat16 with hd % 8 ==
// 0 and q, k and v 16-byte aligned; 0 the FFMA kernel.
extern "C" int metl_flash_attention(const void* q, const void* k, const void* v, void* out,
                                    int n, int s_len, int t_len, int hd, int n_rep, int causal,
                                    int elem_bytes, int tensor_cores, void* stream) {
  if (n <= 0 || s_len <= 0) return 0;
  if (t_len <= 0 || hd <= 0 || hd > 128 || n_rep <= 0 || n % n_rep != 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    const int64_t blocks = static_cast<int64_t>(n) * ((s_len + tc::kBQ - 1) / tc::kBQ);
    if (elem_bytes != 2 || hd % 8 != 0 || addr % 16 != 0 || blocks > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd <= 64) return tc::launch<64>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
    return tc::launch<128>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
  }
  if (elem_bytes == 4)
    return ffma::dispatch_hd<float>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal, s);
  if (elem_bytes == 2)
    return ffma::dispatch_hd<__nv_bfloat16>(q, k, v, out, n, s_len, t_len, hd, n_rep, causal,
                                            s);
  return static_cast<int>(cudaErrorInvalidValue);
}
