// segmented_gather: the fused DMM mapping of one event chunk in one launch.
//
// Replaces the Pallas TPU kernels of repro/kernels/segmented_gather.py:
// segmented_gather and segmented_gather_shard, which the reference runs once
// per shard inside shard_map on that shard's slice of the block table.  Shard
// z of a launch computes
//
//   out_v[z, s, q] = values[rows[z, s], src3d[z, blks[z, s], q]]
//                                          where src >= 0 and the gathered
//                                          mask != 0,
//                  = fill                  otherwise
//   out_m[z, s, q] = that predicate, as int8
//
// The replicated table is the one-shard case (src2d = src3d[0]).  The payload
// (values, mask) is shared by every shard, as the reference replicates it.
//
// What bounds it on an H100: bytes.  It does no arithmetic; per output element
// it reads one int32 of the block table, one int8 of mask and (on a hit) one
// float of payload, and writes 5 bytes.  At the main path's shape (S = 512
// output rows, W = 128) the whole call moves well under a megabyte, which the
// card's 3.35 TB/s moves in a fraction of a microsecond, so the launch itself
// is what a call costs.
//
// Design: one thread owns one output element (z, s, q).  The shard is the
// grid's y axis, so all the shards a device holds are mapped by ONE launch,
// and a block of shard z reads only rows[z], blks[z] and src3d[z].  A thread
// block covers kRowsPerBlock output rows with kThreadsQ threads along q, so a
// warp reads 32 neighbouring table entries and writes 32 neighbouring outputs
// (coalesced).
// Where the Pallas kernel prefetched rows/blks into SMEM, each thread here
// reads its own rows[s] / blks[s] (one broadcast load per warp).  Where the
// Pallas kernel padded to (8, 128) tiles, this kernel masks the ragged edge
// itself (q < W, s < S), so it takes any shape.  Out-of-range routing or table
// entries are clamped into range instead of faulting; the callers never
// produce them.  The kernel allocates nothing and launches on the caller's
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsQ = 128;    // threads along the output width
constexpr int kRowsPerBlock = 4;  // output rows per thread block

__global__ void __launch_bounds__(kThreadsQ * kRowsPerBlock)
segmented_gather_kernel(const float* __restrict__ values,
                        const int8_t* __restrict__ mask,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ blks,
                        const int32_t* __restrict__ src,
                        float* __restrict__ out_v,
                        int8_t* __restrict__ out_m,
                        int n_rows, int width, int n_events, int n_in,
                        int n_blocks, float fill) {
  const int s = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (s >= n_rows) return;
  const int64_t zs = static_cast<int64_t>(blockIdx.y) * n_rows + s;  // (z, s)
  const int r = min(max(__ldg(rows + zs), 0), n_events - 1);
  const int t = min(max(__ldg(blks + zs), 0), n_blocks - 1);
  const int32_t* src_row =
      src + (static_cast<int64_t>(blockIdx.y) * n_blocks + t) * width;
  const float* v_row = values + static_cast<int64_t>(r) * n_in;
  const int8_t* m_row = mask + static_cast<int64_t>(r) * n_in;
  float* ov = out_v + zs * width;
  int8_t* om = out_m + zs * width;
  for (int q = threadIdx.x; q < width; q += kThreadsQ) {
    const int p = __ldg(src_row + q);
    float v = fill;
    int8_t ok = 0;
    if (p >= 0) {
      const int pc = min(p, n_in - 1);
      if (__ldg(m_row + pc) != 0) {
        v = __ldg(v_row + pc);
        ok = 1;
      }
    }
    ov[q] = v;
    om[q] = ok;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success).  Maps the n_shards shards of one launch:
// values/mask (n_events, n_in), rows/blks (n_shards, n_rows), src3d
// (n_shards, n_blocks, width), out_v/out_m (n_shards, n_rows, width); the
// replicated table is n_shards = 1.  All contiguous, on the current device.
extern "C" int metl_segmented_gather(const void* values, const void* mask,
                                     const void* rows, const void* blks,
                                     const void* src3d, void* out_v,
                                     void* out_m, int n_shards, int n_rows,
                                     int width, int n_events, int n_in,
                                     int n_blocks, float fill, void* stream) {
  if (n_shards <= 0 || n_rows <= 0 || width <= 0) return 0;
  if (n_shards > 65535 || n_events <= 0 || n_in <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsQ, kRowsPerBlock);
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, n_shards);
  segmented_gather_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const int8_t*>(mask),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(blks),
      static_cast<const int32_t*>(src3d), static_cast<float*>(out_v),
      static_cast<int8_t*>(out_m), n_rows, width, n_events, n_in, n_blocks,
      fill);
  return static_cast<int>(cudaGetLastError());
}
