// moe_combine: the MoE combine, computed on the router's non-zero weights,
//
//   out[t, d] = sum_{e,c} combine[t, e, c] * expert_out[e, c, d]
//
// a (T, E*C) x (E*C, D) product with a float32 accumulator, rounded once to
// expert_out's dtype.  combine and expert_out are each float32 or bfloat16.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_combine.py (moe_combine),
// whose grid walks (T/bt, D/bd, EC/bk) with the contraction axis innermost
// and an f32 VMEM accumulator: the dense operator, every zero multiplied.
//
// What bounds it on an H100: bytes.  combine holds top_k non-zeros per row
// (at the qwen3-moe group shape, T 512, E 128, C 40, D 2048, 4,096 of
// 2,621,440 weights), so the products the data needs are ~2 T top_k D
// operations, 17 MFLOP.  But the function multiplies every weight, zeros
// included, so a NaN or inf anywhere in expert_out[:, :, d] makes column d
// NaN in every row (0 x NaN), even in a slot no token is routed to.  To
// keep that, every element of expert_out is read once: the function needs
// all of combine, all of expert_out and the output, 56.6 MB in float32 at
// that shape, 0.0169 ms at 3.35 TB/s.  The dense product would be 10.7
// GFLOP of IEEE float32 FFMA (TF32 would fail the reference's atol 1e-4).
//
// Design: two kernels.
// * moe_scan_kernel, one pass over both operands.  Blocks [0, n_tiles) each
//   take a tile of kBT tokens and walk combine's columns in order; a column
//   is a term of the tile if any of its kBT weights is != 0 (a NaN or inf
//   weight counts).  A block compacts its tile's columns in ascending order
//   (warp ballots and a prefix over the warps' counts) into list[tile] with
//   their kBT weights, as float32, into wlist[tile], and writes the count to
//   len[tile].  The other blocks stream expert_out in 16-byte vectors and
//   store bad[d] = 1 for every column holding a non-finite value: a plain,
//   idempotent store, so the result does not depend on block order (the
//   caller zeroes bad).  Both roles read their bytes once; the tiles' blocks
//   come first in the grid and overlap the stream.
// * moe_product_kernel, one block per (token tile, kBD columns).  Each
//   thread owns 8 tokens x 4 columns of float32 accumulators.  The block
//   walks its tile's list kBK entries a step.  A step's weights and row
//   indices are staged in shared memory, and the named expert_out rows'
//   kBD-column slices are copied there with cp.async, 16 B a thread; the
//   next step's copies and the step after's list entries are in flight
//   while this step's products run (32 KB of rows a block in float32).  A block
//   whose columns include a flagged one walks every column of E*C in order
//   instead, reading its weights from combine, so 0 x NaN comes out where
//   the dense product puts it.  The same branch makes a fully dense combine
//   correct (its list is then every column).  Each output sums its terms in
//   ascending E*C order without atomics, so a result is bit-identical from
//   run to run: kBK terms at a time into a partial sum, which is then added
//   to the total.  (One by one, the 5,120 terms of a fully dense qwen3-moe
//   row drift past the reference's atol 1e-4 at outputs near zero in
//   float32; two levels keep the drift near a blocked sum's.)
//   The terms a tile's list adds for a token that has no weight there are
//   exact zeros and change nothing.
//
// kBT = 16: at qwen3-moe density a tile's list holds ~128 of 5,120 columns,
// so the product does ~16 x the useful operations (0.27 GFLOP) and reads
// every named row once a tile (~33 MB, mostly from L2).  A smaller tile
// does fewer operations but reads the named rows at no lower cost and, at
// full density, reads all of expert_out once a tile: 16 keeps a fully dense
// combine at the qwen3-moe shape under 0.6 ms on an H100.  The kernels allocate
// nothing and launch on the caller's stream; every scratch buffer is the
// caller's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBT = 16;            // tokens per tile
constexpr int kHalf = kBT / 2;     // tokens per product thread
constexpr int kScanThreads = 512;  // moe_scan_kernel's block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanSub = 2;        // column sub-chunks in flight per union round
constexpr int kScanUnroll = 4;     // 16-byte vectors in flight per streaming thread
constexpr int kThreads = 128;      // moe_product_kernel's block
constexpr int kBK = 32;            // list entries per shared-memory step and partial sum
constexpr int kBD = 256;           // output columns per product block (4 a thread)

static_assert(kThreads == kBK * kBT / 4, "each product thread stages 4 weights a step");
static_assert(kBD == (kThreads / 32) * 16 * 4, "a warp covers 16 column groups x 2 token halves");

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

// A 32-bit word of float32 (one value) or bfloat16 (two) holds no inf or NaN.
__device__ __forceinline__ bool word_finite(uint32_t w, const float*) {
  return (w & 0x7f800000u) != 0x7f800000u;
}
__device__ __forceinline__ bool word_finite(uint32_t w, const __nv_bfloat16*) {
  return (w & 0x7f80u) != 0x7f80u && (w & 0x7f800000u) != 0x7f800000u;
}

// Tile role of moe_scan_kernel: the ascending list of combine's columns that
// hold a non-zero weight among tokens [tile * kBT, tile * kBT + kBT).
template <typename TC>
__device__ void union_tile(const TC* __restrict__ combine, int* __restrict__ list,
                           float* __restrict__ wlist, int* __restrict__ len, int t_len,
                           int k_len, int tile) {
  __shared__ int warp_count[kScanWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = tile * kBT;
  const int rows = min(kBT, t_len - t0);
  const TC* base = combine + static_cast<int64_t>(t0) * k_len;
  int* tile_list = list + static_cast<int64_t>(tile) * k_len;
  float* tile_w = wlist + static_cast<int64_t>(tile) * k_len * kBT;
  const unsigned below = (1u << lane) - 1u;
  int carry = 0;  // list entries written so far (the same in every thread)
  for (int k0 = 0; k0 < k_len; k0 += kScanThreads * kScanSub) {
    float w[kScanSub][kBT];
    bool nz[kScanSub];
#pragma unroll
    for (int j = 0; j < kScanSub; ++j) {
      const int k = k0 + j * kScanThreads + tid;
      nz[j] = false;
#pragma unroll
      for (int r = 0; r < kBT; ++r) {
        w[j][r] = (k < k_len && r < rows) ? to_f32(base[static_cast<int64_t>(r) * k_len + k])
                                          : 0.f;
        nz[j] = nz[j] || w[j][r] != 0.f;  // true for NaN: a NaN weight is a term
      }
    }
#pragma unroll
    for (int j = 0; j < kScanSub; ++j) {
      const unsigned ballot = __ballot_sync(0xffffffffu, nz[j]);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int v = 0; v < kScanWarps; ++v) {
        const int c = warp_count[v];
        before += v < warp ? c : 0;
        total += c;
      }
      if (nz[j]) {
        const int p = carry + before + __popc(ballot & below);
        tile_list[p] = k0 + j * kScanThreads + tid;
        float4* dst = reinterpret_cast<float4*>(tile_w + static_cast<int64_t>(p) * kBT);
#pragma unroll
        for (int r = 0; r < kBT; r += 4)
          dst[r / 4] = make_float4(w[j][r], w[j][r + 1], w[j][r + 2], w[j][r + 3]);
      }
      carry += total;
      __syncthreads();  // warp_count is rewritten by the next sub-chunk
    }
  }
  if (tid == 0) len[tile] = carry;
}

// Streaming role of moe_scan_kernel: bad[d] = 1 for every column d of
// expert_out (k_len x d_len elements) that holds an inf or a NaN.
template <typename TE>
__device__ void flag_columns(const TE* __restrict__ expert, int* __restrict__ bad,
                             int64_t n_elem, int d_len, int block, int n_blocks) {
  constexpr int kPer = 16 / sizeof(TE);  // elements in a 16-byte vector
  const bool aligned = (reinterpret_cast<uintptr_t>(expert) & 15) == 0;
  const int64_t n_vec = aligned ? n_elem / kPer : 0;
  const int64_t stride = static_cast<int64_t>(n_blocks) * kScanThreads;
  const int64_t first = static_cast<int64_t>(block) * kScanThreads + threadIdx.x;
  const uint4* vec = reinterpret_cast<const uint4*>(expert);
  for (int64_t v0 = first; v0 < n_vec; v0 += stride * kScanUnroll) {
    uint4 q[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int64_t v = v0 + u * stride;
      q[u] = v < n_vec ? vec[v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      if (word_finite(q[u].x, expert) && word_finite(q[u].y, expert) &&
          word_finite(q[u].z, expert) && word_finite(q[u].w, expert))
        continue;
      const int64_t e0 = (v0 + u * stride) * kPer;
      for (int i = 0; i < kPer; ++i)
        if (!isfinite(to_f32(expert[e0 + i]))) bad[(e0 + i) % d_len] = 1;
    }
  }
  // the elements after the last whole vector (all of them when expert_out
  // does not start 16-byte aligned)
  for (int64_t e = n_vec * kPer + first; e < n_elem; e += stride)
    if (!isfinite(to_f32(expert[e]))) bad[e % d_len] = 1;
}

template <typename TC, typename TE>
__global__ void __launch_bounds__(kScanThreads, 2)
moe_scan_kernel(const TC* __restrict__ combine, const TE* __restrict__ expert,
                int* __restrict__ list, float* __restrict__ wlist, int* __restrict__ len,
                int* __restrict__ bad, int t_len, int k_len, int d_len, int n_tiles) {
  const int block = static_cast<int>(blockIdx.x);
  if (block < n_tiles)
    union_tile(combine, list, wlist, len, t_len, k_len, block);
  else
    flag_columns(expert, bad, static_cast<int64_t>(k_len) * d_len, d_len, block - n_tiles,
                 static_cast<int>(gridDim.x) - n_tiles);
}

// Four consecutive values of a staged expert_out row, as float32.
__device__ __forceinline__ float4 read4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 read4(const __nv_bfloat16* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);  // a bfloat16 is a float32's top half
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void store4(float* out, int d, int d_len, bool vec, const float* a) {
  if (vec) {
    if (d < d_len) *reinterpret_cast<float4*>(out) = make_float4(a[0], a[1], a[2], a[3]);
    return;
  }
  for (int j = 0; j < 4; ++j)
    if (d + j < d_len) out[j] = a[j];
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, int d, int d_len, bool vec,
                                       const float* a) {
  if (vec) {
    if (d >= d_len) return;
    uint32_t h[4];
    for (int j = 0; j < 4; ++j) h[j] = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(a[j]));
    *reinterpret_cast<uint2*>(out) = make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
    return;
  }
  for (int j = 0; j < 4; ++j)
    if (d + j < d_len) out[j] = from_f32<__nv_bfloat16>(a[j]);
}

// The p-th term of a tile, as its expert_out row and the weights of tokens
// [lt, lt + 4) of the tile: from the tile's list, or (dense) column p of
// combine itself.  Past the n terms: row 0 and zero weights, never used.
template <typename TC>
__device__ __forceinline__ void fetch_term(const TC* __restrict__ combine,
                                           const int* __restrict__ list,
                                           const float* __restrict__ wlist, int64_t tile_off,
                                           int t0, int t_len, int k_len, int n, bool dense,
                                           int p, int lt, int* row, float4* w) {
  *row = 0;
  *w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p >= n) return;
  if (!dense) {
    *row = list[tile_off + p];
    *w = *reinterpret_cast<const float4*>(wlist + (tile_off + p) * kBT + lt);
    return;
  }
  *row = p;
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + lt + i;
    x[i] = t < t_len ? to_f32(combine[static_cast<int64_t>(t) * k_len + p]) : 0.f;
  }
  *w = make_float4(x[0], x[1], x[2], x[3]);
}

// Copy the kBD-column slices [d0, d0 + kBD) of the first `cnt` rows named by
// `rows` into xs (kBK x kBD): 16 bytes a thread a copy, asynchronous when
// each row starts 16-byte aligned (vec16), plain loads otherwise; columns
// past d_len are zeros.
template <typename TE>
__device__ __forceinline__ void stage_rows(TE* xs, const TE* __restrict__ expert,
                                           const int* rows, int cnt, int d0, int d_len,
                                           bool vec16) {
  constexpr int kPer = 16 / sizeof(TE);     // elements in 16 bytes
  constexpr int kChunks = kBD / kPer;       // 16-byte pieces of a staged row
  for (int c = threadIdx.x; c < kBK * kChunks; c += kThreads) {
    const int kk = c / kChunks, col = (c % kChunks) * kPer;
    if (kk >= cnt) break;  // c grows with kk
    TE* dst = xs + kk * kBD + col;
    const TE* src = expert + static_cast<int64_t>(rows[kk]) * d_len + d0 + col;
    if (vec16 && d0 + col < d_len) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[i] = d0 + col + i < d_len ? src[i] : from_f32<TE>(0.f);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void fma_row(float (&acc)[kHalf][4], const float* ws, float4 x) {
  const float4 wa = *reinterpret_cast<const float4*>(ws);
  const float4 wb = *reinterpret_cast<const float4*>(ws + 4);
  const float w[kHalf] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    acc[i][0] = fmaf(w[i], x.x, acc[i][0]);
    acc[i][1] = fmaf(w[i], x.y, acc[i][1]);
    acc[i][2] = fmaf(w[i], x.z, acc[i][2]);
    acc[i][3] = fmaf(w[i], x.w, acc[i][3]);
  }
}

// Dynamic shared memory of moe_product_kernel: kStages staged expert_out
// slices (the copies of the next kStages - 1 steps are in flight while a
// step's products run) and kStages + 1 buffers of a step's weights and rows
// (one more, because a step's are written while the step before still reads
// its own and the copies of the step after may still be issued).  Two
// stages: 72 KB a block in float32, three blocks an SM (three stages ran no
// faster at the qwen3-moe group and slower at dbrx's, two blocks an SM).
template <typename TE>
struct ProductSmem {
  static constexpr int kStages = 2, kMeta = kStages + 1;
  static constexpr size_t kWeights = sizeof(float) * kMeta * kBK * kBT;
  static constexpr size_t kRows = sizeof(int) * kMeta * kBK;
  static constexpr size_t kBytes = kWeights + kRows + sizeof(TE) * kStages * kBK * kBD;
};

template <typename TC, typename TE>
__global__ void __launch_bounds__(kThreads)
moe_product_kernel(const TC* __restrict__ combine, const TE* __restrict__ expert,
                   const int* __restrict__ list, const float* __restrict__ wlist,
                   const int* __restrict__ len, const int* __restrict__ bad,
                   TE* __restrict__ out, int t_len, int k_len, int d_len, int vec16, int vec) {
  using L = ProductSmem<TE>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);                     // [kMeta][kBK][kBT]
  int* rows_s = reinterpret_cast<int*>(smem + L::kWeights);       // [kMeta][kBK]
  TE* xs = reinterpret_cast<TE*>(smem + L::kWeights + L::kRows);  // [kStages][kBK][kBD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = static_cast<int>(blockIdx.x), t0 = tile * kBT;
  const int half = lane >> 4;  // this thread's tokens: [half * 8, half * 8 + 8) of the tile
  const int col = (warp * 16 + (lane & 15)) * 4;  // its 4 columns, within the block's
  const int d0 = static_cast<int>(blockIdx.y) * kBD, d = d0 + col;

  const int listed = len[tile];  // loaded beside the flags, used if none is set
  int flagged = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) flagged |= d + j < d_len ? bad[d + j] : 0;
  const bool dense = __syncthreads_or(flagged) != 0;
  const int n = dense ? k_len : listed;
  const int64_t tile_off = static_cast<int64_t>(tile) * k_len;
  const int steps = (n + kBK - 1) / kBK;

  // staging: term lk of a step, tokens [lt, lt + 4)
  const int lk = tid >> 2, lt = (tid & 3) * 4;
  int row;
  float4 w;
  auto fetch = [&](int s) {
    fetch_term(combine, list, wlist, tile_off, t0, t_len, k_len, n, dense, s * kBK + lk, lt,
               &row, &w);
  };
  auto put_meta = [&](int s) {
    *reinterpret_cast<float4*>(ws + ((s % L::kMeta) * kBK + lk) * kBT + lt) = w;
    if (lt == 0) rows_s[(s % L::kMeta) * kBK + lk] = row;
  };
  // one commit group a step, empty past the last step
  auto stage = [&](int s) {
    stage_rows(xs + (s % L::kStages) * kBK * kBD, expert, rows_s + (s % L::kMeta) * kBK,
               min(kBK, n - s * kBK), d0, d_len, vec16 != 0);
  };

  float acc[kHalf][4];
#pragma unroll
  for (int i = 0; i < kHalf; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {
    fetch(s);
    put_meta(s);
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) stage(s);
  fetch(L::kStages - 1);
  for (int s = 0; s < steps; ++s) {
    const int ahead = s + L::kStages - 1;
    // meta buffer ahead % kMeta was last read by step ahead - kMeta's
    // products and copies, behind the previous barrier
    put_meta(ahead);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(L::kStages - 2) : "memory");
    __syncthreads();  // step s's rows landed; nobody reads stage ahead % kStages any more
    stage(ahead);
    fetch(ahead + 1);

    const float* wstep = ws + (s % L::kMeta) * kBK * kBT + half * kHalf;
    const TE* xstep = xs + (s % L::kStages) * kBK * kBD + col;
    const int cnt = min(kBK, n - s * kBK);
    float part[kHalf][4];  // this step's terms, added to acc once
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < cnt; ++kk) fma_row(part, wstep + kk * kBT, read4(xstep + kk * kBD));
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
  }

#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const int t = t0 + half * kHalf + i;
    if (t < t_len) store4(out + static_cast<int64_t>(t) * d_len + d, d, d_len, vec != 0, acc[i]);
  }
}

template <typename TC, typename TE>
int launch(const void* combine, const void* expert, void* out, void* list, void* wlist,
           void* len, void* bad, int t_len, int k_len, int d_len, cudaStream_t stream) {
  const int n_tiles = (t_len + kBT - 1) / kBT;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough streaming blocks for kScanUnroll vectors a thread, at most 4 an SM
  const int64_t n_elem = static_cast<int64_t>(k_len) * d_len;
  const int64_t per_block = static_cast<int64_t>(kScanThreads) * kScanUnroll * (16 / sizeof(TE));
  const int64_t n_stream = n_elem == 0 ? 0
      : std::min<int64_t>((n_elem + per_block - 1) / per_block, 4 * static_cast<int64_t>(sms));
  moe_scan_kernel<TC, TE><<<static_cast<unsigned>(n_tiles + n_stream), kScanThreads, 0, stream>>>(
      static_cast<const TC*>(combine), static_cast<const TE*>(expert), static_cast<int*>(list),
      static_cast<float*>(wlist), static_cast<int*>(len), static_cast<int*>(bad), t_len, k_len,
      d_len, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t e_addr = reinterpret_cast<uintptr_t>(expert);
  const int vec16 = (static_cast<int64_t>(d_len) * sizeof(TE)) % 16 == 0 && e_addr % 16 == 0;
  const uintptr_t align = 4 * sizeof(TE);  // one store of 4 outputs
  const int vec = d_len % 4 == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
  constexpr size_t smem = ProductSmem<TE>::kBytes;
  err = cudaFuncSetAttribute(moe_product_kernel<TC, TE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (d_len + kBD - 1) / kBD);
  moe_product_kernel<TC, TE><<<grid, kThreads, smem, stream>>>(
      static_cast<const TC*>(combine), static_cast<const TE*>(expert),
      static_cast<const int*>(list), static_cast<const float*>(wlist),
      static_cast<const int*>(len), static_cast<const int*>(bad), static_cast<TE*>(out), t_len,
      k_len, d_len, vec16, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TC>
int dispatch_expert(const void* combine, const void* expert, void* out, void* list,
                    void* wlist, void* len, void* bad, int t_len, int k_len, int d_len,
                    int expert_bytes, cudaStream_t s) {
  if (expert_bytes == 4)
    return launch<TC, float>(combine, expert, out, list, wlist, len, bad, t_len, k_len, d_len, s);
  if (expert_bytes == 2)
    return launch<TC, __nv_bfloat16>(combine, expert, out, list, wlist, len, bad, t_len, k_len,
                                     d_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entry point, bound with ctypes: launches moe_scan_kernel, then
// moe_product_kernel, and returns cudaGetLastError() after them (0 on
// success; after a failed first launch the second is not made).  Shapes:
// combine (t_len, k_len) and expert (k_len, d_len), k_len = E*C; out
// (t_len, d_len) in expert's dtype; all contiguous, on the current device.
// combine_bytes and expert_bytes are 4 (float32) or 2 (bfloat16).  Scratch,
// the caller's, n_tiles = ceil(t_len / 16): list int32 (n_tiles, k_len),
// wlist float32 (n_tiles, k_len, 16) 16-byte aligned, len int32 (n_tiles),
// bad int32 (d_len) zeroed.  ceil(d_len / 256) <= 65535.
extern "C" int metl_moe_combine(const void* combine, const void* expert, void* out,
                                void* list, void* wlist, void* len, void* bad, int t_len,
                                int k_len, int d_len, int combine_bytes, int expert_bytes,
                                void* stream) {
  if (t_len <= 0 || d_len <= 0) return 0;
  if (k_len < 0 || (d_len + kBD - 1) / kBD > 65535 ||
      reinterpret_cast<uintptr_t>(wlist) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (combine_bytes == 4)
    return dispatch_expert<float>(combine, expert, out, list, wlist, len, bad, t_len, k_len,
                                  d_len, expert_bytes, s);
  if (combine_bytes == 2)
    return dispatch_expert<__nv_bfloat16>(combine, expert, out, list, wlist, len, bad, t_len,
                                          k_len, d_len, expert_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
