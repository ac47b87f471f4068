// decode_attention: one query token a row against its layer's KV cache, read
// where the cache lies and only over its valid slots,
//
//   out[b, h, :] = softmax_t(q[b, h, :] . k[b, t, h / Hg, :] / sqrt(hd)) v[b, t, h / Hg, :]
//
// over slots t < n_valid, query head h reading KV head h / Hg (Hg = H / KV).
// q is (B, H, hd) and k, v are (B, T, KV, hd), each read through its strides
// (the head dim contiguous); out is (B, H, hd), contiguous, in q's dtype
// (float32 or bfloat16).  Scores, softmax and the p.v sums are float32;
// the output is rounded once.
//
// Replaces no TPU kernel.  The reference decodes with a plain einsum over the
// whole cache (repro/models/attention.py, attention_decode) and a mask of the
// slots past the position, and the port did the same until this kernel: on
// the card that einsum makes a contiguous copy of every slot of K and V (the
// cache's (B, T, KV, hd) layout is not the product's), a layer a step,
// whatever the position, and the copies took ~95 % of an olmo-1b decode
// step over a 2,048-slot cache.  This kernel reads the first n_valid slots
// once, where they lie, and builds no mask.
//
// What bounds it on an H100: bytes.  A call needs 2 B n_valid KV hd elements
// of cache and does 4 B n_valid H hd operations: Hg operations a byte at
// most in bfloat16, far below the card's ~295 (olmo-1b: 2.08 GB a layer at
// n_valid 1,984, 0.62 ms at 3.35 TB/s).  On an H100 it reads olmo-1b's
// layer in 0.662-0.677 ms, 91-94 % of that bound; dbrx's 136 slots (three
// tiles a block) in 0.066 ms, a third of its bound, too few tiles a block
// to hide the copies' latency.
//
// Design.  One block of 128 threads per (row, KV head, split of the slots)
// reads each K and V tile once for all Hg query heads of its group, so the
// cache is read once whatever Hg is.  A tile is kTile = 64 slots; K and V
// tiles go through a ring of kStages = 3 stages with cp.async, 16 bytes a
// thread, neighbouring threads on neighbouring bytes of a slot's row, so two
// tiles are in flight while one is computed.  Rows are stored with their
// 16-byte chunks XOR-swizzled by the slot (chunk c of slot r at c ^ (r & 7)),
// so the reads below hit 8 distinct bank groups a quarter-warp.  A tile:
//   1. q.k on the CUDA cores: two threads a slot, each over half the head
//      dim, q (pre-scaled by log2(e) / sqrt(hd)) broadcast from shared
//      memory, the halves summed by a shuffle; slots past n_valid score -inf.
//   2. online softmax, float32: warp w takes heads w, w + 4, ...: tile max,
//      running max, p = exp2(s - max) written over the scores, running
//      denominator, and the accumulators' correction exp2(old - new).
//   3. p.v: each thread owns 2 dims of every head of the group over a slice
//      of the tile's slots (a float32 accumulator per head and dim); the
//      slices are summed through shared memory once, at the end.
// Head dims up to 128 run at a padded width HDP of 64 or 128 (the padding
// chunks are zeroed once and never copied); head groups at a compiled width
// G of 1, 2, 4, 6, 8 or 16 query heads, the heads past Hg computed on zero
// q and zero p and never stored: the loops over the heads carry no branch,
// so their loads and products interleave (loops that stopped at Hg, at a
// width of 8, took 0.0995 ms at dbrx's shape against 0.0656 ms).
//
// Splits.  The wrapper picks the split over the slots from B KV and n_valid
// so that the blocks fill the card (kernels/decode_attention.py,
// plan_splits): pairs that cover the SMs (the benchmark's cells, 2,048 and
// 1,024; olmo-1b at batch 8, 128) take one split and write the output
// directly; fewer take several, each writing its unnormalised accumulators
// and its running max and denominator to a float32 workspace, and
// decode_attention_combine joins them.
//
// Shared memory: three stages of a K and a V tile (96 KB at hd 128 in
// bfloat16, 192 KB in float32), q of the group and the tile's scores.  The
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                    // slots a tile
constexpr int kStages = 3;                   // tiles in the ring
constexpr int kQkLanes = kThreads / kTile;   // threads sharing a slot's q.k
constexpr int kQkRows = 32 / kQkLanes;       // slots a warp scores at once
constexpr int kMaxHeadDim = 128;
constexpr int kMaxGroup = 16;

// A bfloat16 is a float32's top half.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// A 16-byte chunk of a staged row, as float32.
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// Two neighbouring values of a staged row, as float32.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;  // splits > 1: [splits][B H][hd] accumulators, then [splits][B H][2] max, sum
  long long q_b, q_h;  // strides, in elements
  long long k_b, k_t, k_h;
  long long v_b, v_t, v_h;
  int batch, kv_heads, hg, hd, n_valid, splits, tiles_per_split;
  float scale;  // log2(e) / sqrt(hd)
};

template <typename T, int HDP>
struct Layout {
  static constexpr int kPer = 16 / sizeof(T);               // elements a chunk
  static constexpr int kChunks = HDP / kPer;                // chunks of a padded row
  static constexpr int kQkChunks = kChunks / kQkLanes;      // chunks a thread scores
  static constexpr int kPvLanes = HDP / 2;                  // threads across a row in p.v
  static constexpr int kPvGroups = kThreads / kPvLanes;     // slot slices in p.v
  static constexpr int kPvRows = kTile / kPvGroups;         // slots a slice
  static constexpr int kTileElems = kTile * HDP;
  static constexpr size_t kStageBytes = 2 * sizeof(T) * kTileElems;  // a K and a V tile
  static_assert(kChunks % 8 == 0, "the swizzle permutes chunks in groups of 8");
};

template <typename T, int HDP, int G>
struct Smem {
  using L = Layout<T, HDP>;
  static constexpr size_t kRing = kStages * L::kStageBytes;
  static constexpr size_t kQ = sizeof(float) * G * HDP;
  static constexpr size_t kScores = sizeof(float) * G * kTile;
  static constexpr size_t kStats = sizeof(float) * 3 * G;  // running max, sum, correction
  static constexpr size_t kBytes = kRing + kQ + kScores + kStats;
  // the slices' accumulators are summed at the end in the ring's memory
  static_assert(sizeof(float) * L::kPvGroups * G * HDP <= kRing, "");
};

template <typename T, int HDP, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Args a) {
  using L = Layout<T, HDP>;
  using S = Smem<T, HDP, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + S::kRing);  // [G][HDP]
  float* ss = qs + G * HDP;                                // [G][kTile] scores, then p
  float* m_run = ss + G * kTile;                           // [G], log2 domain
  float* l_run = m_run + G;                                // [G]
  float* corr = l_run + G;                                 // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int hg = a.hg, n_valid = a.n_valid;
  const int n_tiles = (n_valid + kTile - 1) / kTile;
  const int tile0 = split * a.tiles_per_split;
  const int n = max(min(a.tiles_per_split, n_tiles - tile0), 0);
  const int nc = a.hd / L::kPer;  // chunks of a row that hold the head dim

  const T* kb = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;

  if (nc < L::kChunks) {  // padded rows: the chunks past the head dim stay zero
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < static_cast<int>(S::kRing / 16); i += kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const T* qb = static_cast<const T*>(a.q) + b * a.q_b + static_cast<long long>(kvh) * hg * a.q_h;
  for (int i = tid; i < G * HDP; i += kThreads) {
    const int h = i / HDP, d = i % HDP;
    qs[i] = h < hg && d < a.hd ? to_f32(qb[h * a.q_h + d]) * a.scale : 0.f;
  }
  for (int i = tid; i < G * kTile; i += kThreads) ss[i] = 0.f;  // the rows past hg stay 0
  if (tid < G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
    corr[tid] = 0.f;
  }
  __syncthreads();  // the zeros are stored before any copy lands beside them

  // tile i of the split into stage i % kStages; one commit group a call,
  // empty past the last tile; slots past n_valid are never read
  auto stage = [&](int i) {
    if (i < n) {
      const int first = (tile0 + i) * kTile;
      const int rows = min(kTile, n_valid - first);
      T* ks = ring + (i % kStages) * 2 * L::kTileElems;
      T* vs = ks + L::kTileElems;
      if (nc == L::kChunks) {
#pragma unroll
        for (int j = 0; j < kTile * L::kChunks / kThreads; ++j) {
          const int idx = tid + j * kThreads;
          const int r = idx / L::kChunks, c = idx % L::kChunks;
          if (r < rows) {
            const long long slot = first + r;
            const int off = (r * L::kChunks + (c ^ (r & 7))) * L::kPer;
            cp_async16(ks + off, kb + slot * a.k_t + c * L::kPer);
            cp_async16(vs + off, vb + slot * a.v_t + c * L::kPer);
          }
        }
      } else {
        for (int idx = tid; idx < rows * nc; idx += kThreads) {
          const int r = idx / nc, c = idx % nc;
          const long long slot = first + r;
          const int off = (r * L::kChunks + (c ^ (r & 7))) * L::kPer;
          cp_async16(ks + off, kb + slot * a.k_t + c * L::kPer);
          cp_async16(vs + off, vb + slot * a.v_t + c * L::kPer);
        }
      }
    }
    cp_async_commit();
  };

  // q.k: slot qr of the tile, chunks [qj kQkChunks, (qj + 1) kQkChunks) of it
  const int qr = warp * kQkRows + lane % kQkRows, qj = lane / kQkRows;
  // p.v: dims pd, pd + 1 over the tile's slots [pg kPvRows, (pg + 1) kPvRows)
  const int pg = tid / L::kPvLanes, pd = (tid % L::kPvLanes) * 2;
  const int pc = pd / L::kPer, po = pd % L::kPer;

  float acc[G][2];
#pragma unroll
  for (int h = 0; h < G; ++h) acc[h][0] = acc[h][1] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage(i);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1's stage and p
    stage(i + kStages - 1);
    const T* ks = ring + (i % kStages) * 2 * L::kTileElems;
    const T* vs = ks + L::kTileElems;
    const int rows = min(kTile, n_valid - (tile0 + i) * kTile);

    float s[G];
#pragma unroll
    for (int h = 0; h < G; ++h) s[h] = 0.f;
    const T* krow = ks + qr * HDP;
#pragma unroll
    for (int cc = 0; cc < L::kQkChunks; ++cc) {
      const int c = qj * L::kQkChunks + cc;
      float kf[L::kPer];
      load_chunk(krow + (c ^ (qr & 7)) * L::kPer, kf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float* qh = qs + h * HDP + c * L::kPer;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < L::kPer; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qh + e);
          part = fmaf(q4.x, kf[e], part);
          part = fmaf(q4.y, kf[e + 1], part);
          part = fmaf(q4.z, kf[e + 2], part);
          part = fmaf(q4.w, kf[e + 3], part);
        }
        s[h] += part;
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int o = kQkRows; o < 32; o <<= 1) s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
    }
    if (qj == 0) {
#pragma unroll
      for (int h = 0; h < G; ++h)
        if (h < hg) ss[h * kTile + qr] = qr < rows ? s[h] : -INFINITY;
    }
    __syncthreads();

    for (int h = warp; h < hg; h += kWarps) {
      float* sh = ss + h * kTile;
      const float x0 = sh[lane], x1 = sh[lane + 32];
      const float m_old = m_run[h];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));  // finite: a tile has a slot
      const float p0 = exp2f(x0 - m_new), p1 = exp2f(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      sh[lane] = p0;
      sh[lane + 32] = p1;
      if (lane == 0) {
        const float c = exp2f(m_old - m_new);
        corr[h] = c;
        l_run[h] = l_run[h] * c + sum;
        m_run[h] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float c = corr[h];
      acc[h][0] *= c;
      acc[h][1] *= c;
    }
    const int t1 = min((pg + 1) * L::kPvRows, rows);
#pragma unroll 4
    for (int t = pg * L::kPvRows; t < t1; ++t) {
      const float2 x = load_pair(vs + t * HDP + (pc ^ (t & 7)) * L::kPer + po);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float p = ss[h * kTile + t];
        acc[h][0] = fmaf(p, x.x, acc[h][0]);
        acc[h][1] = fmaf(p, x.y, acc[h][1]);
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the slices' accumulators go there
  float* red = reinterpret_cast<float*>(smem);  // [kPvGroups][G][HDP]
#pragma unroll
  for (int h = 0; h < G; ++h) {
    red[(pg * G + h) * HDP + pd] = acc[h][0];
    red[(pg * G + h) * HDP + pd + 1] = acc[h][1];
  }
  __syncthreads();
  const long long heads = static_cast<long long>(a.kv_heads) * hg;
  const long long row0 = b * heads + static_cast<long long>(kvh) * hg;  // (b, first head)
  for (int i = tid; i < hg * a.hd; i += kThreads) {
    const int h = i / a.hd, d = i % a.hd;
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < L::kPvGroups; ++g) o += red[(g * G + h) * HDP + d];
    const long long row = row0 + h;
    if (a.splits == 1) {
      static_cast<T*>(a.out)[row * a.hd + d] = from_f32<T>(o / l_run[h]);
    } else {
      const long long rows_all = static_cast<long long>(a.batch) * heads;
      a.part[(split * rows_all + row) * a.hd + d] = o;
      if (d == 0) {
        float* ml = a.part + a.splits * rows_all * a.hd + (split * rows_all + row) * 2;
        ml[0] = m_run[h];
        ml[1] = l_run[h];
      }
    }
  }
}

// Joins the splits' partial softmaxes: one block a (row, head).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const float* __restrict__ part, T* __restrict__ out, long long rows_all,
                         int hd, int splits) {
  const long long row = blockIdx.x;
  const float* ml = part + splits * rows_all * hd;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[(s * rows_all + row) * 2]);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* x = ml + (s * rows_all + row) * 2;
    den += exp2f(x[0] - m) * x[1];
  }
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float num = 0.f;
    for (int s = 0; s < splits; ++s)
      num += exp2f(ml[(s * rows_all + row) * 2] - m) * part[(s * rows_all + row) * hd + d];
    out[row * hd + d] = from_f32<T>(num / den);
  }
}

template <typename T, int HDP, int G>
int launch(const Args& a, cudaStream_t stream) {
  using S = Smem<T, HDP, G>;
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, HDP, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.splits, a.kv_heads, a.batch);
  decode_attention_kernel<T, HDP, G><<<grid, kThreads, S::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const long long rows_all = static_cast<long long>(a.batch) * a.kv_heads * a.hg;
  decode_attention_combine<T><<<static_cast<unsigned>(rows_all), kThreads, 0, stream>>>(
      a.part, static_cast<T*>(a.out), rows_all, a.hd, a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HDP>
int launch_group(const Args& a, cudaStream_t stream) {
  if (a.hg <= 1) return launch<T, HDP, 1>(a, stream);
  if (a.hg <= 2) return launch<T, HDP, 2>(a, stream);
  if (a.hg <= 4) return launch<T, HDP, 4>(a, stream);
  if (a.hg <= 6) return launch<T, HDP, 6>(a, stream);
  if (a.hg <= 8) return launch<T, HDP, 8>(a, stream);
  return launch<T, HDP, 16>(a, stream);
}

template <typename T>
int launch_width(const Args& a, cudaStream_t stream) {
  return a.hd <= 64 ? launch_group<T, 64>(a, stream) : launch_group<T, 128>(a, stream);
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launches (0 on success; after a failed first launch the combine is not
// made), or cudaErrorInvalidValue for arguments outside the kernel's range.
// q (batch, kv_heads hg, hd), k and v (batch, T, kv_heads, hd) through the
// strides given (in elements; the head dim contiguous, every row 16-byte
// aligned); out (batch, kv_heads hg, hd) contiguous; part, when splits > 1,
// splits batch kv_heads hg (hd + 2) float32 values; all of one dtype
// (elem_bytes 4: float32, 2: bfloat16) on the current device.  The wrapper
// (kernels/decode_attention.py) checks what the kernel assumes.
extern "C" int metl_decode_attention(const void* q, const void* k, const void* v, void* out,
                                     void* part, long long q_b, long long q_h, long long k_b,
                                     long long k_t, long long k_h, long long v_b, long long v_t,
                                     long long v_h, int batch, int kv_heads, int hg, int hd,
                                     int n_valid, int splits, int elem_bytes, void* stream) {
  const int n_tiles = (n_valid + kTile - 1) / kTile;
  if (batch < 1 || batch > 65535 || kv_heads < 1 || kv_heads > 65535 || hg < 1 ||
      hg > kMaxGroup || hd < 1 || hd > kMaxHeadDim || n_valid < 1 || splits < 1 ||
      splits > n_tiles || (splits > 1 && part == nullptr) ||
      (elem_bytes != 2 && elem_bytes != 4) || (hd * elem_bytes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.part = static_cast<float*>(part);
  a.q_b = q_b;
  a.q_h = q_h;
  a.k_b = k_b;
  a.k_t = k_t;
  a.k_h = k_h;
  a.v_b = v_b;
  a.v_t = v_t;
  a.v_h = v_h;
  a.batch = batch;
  a.kv_heads = kv_heads;
  a.hg = hg;
  a.hd = hd;
  a.n_valid = n_valid;
  a.splits = splits;
  a.tiles_per_split = (n_tiles + splits - 1) / splits;
  a.scale = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return elem_bytes == 4 ? launch_width<float>(a, s) : launch_width<__nv_bfloat16>(a, s);
}
