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
// What bounds it on an H100: at the usual 512-event chunk the launch and a
// chain of dependent loads, not bytes.  It does no arithmetic; per output
// element it reads one int32 of the block table, one int8 of mask and one
// float of payload (both through the table entry), and writes 5 bytes: about
// 0.55 MB, 0.17 us at 3.35 TB/s, at 512 events (S 512, W 128).  Each output
// row waits on three loads in a row: its routing, then its table row, then
// the payload that the table names.
//
// Design: one warp owns one output row (z, s) and covers it 128 columns at a
// time, lane l the four columns 4l .. 4l + 3 (warp_rows.cuh): rows[z, s] and
// blks[z, s] are loaded once for the warp, the table row slice with one
// 16-byte load a lane, then each column's value and mask with two independent
// loads at the clamped index min(p, n_in - 1), so both are always in range
// and neither waits on the other; the select follows, and one 16-byte value
// store and one 4-byte mask store end the pass (scalar accesses where W % 4
// != 0 or an address is not aligned).  No shared memory, no barrier: each
// warp's row is its own.  The shard is the grid's y axis, so all the shards a
// device holds are mapped by ONE launch, and a warp of shard z reads only
// rows[z], blks[z] and src3d[z].  Values travel as int32 bit patterns, so NaN
// and inf payloads and the fill are moved bit for bit.  Out-of-range routing
// or table entries are clamped into the shard's slice instead of faulting;
// the callers never produce them.  TMA, wgmma and cp.async are not used:
// there is no arithmetic, and each row's payload is picked by data.
//
// metl_segmented_gather_chunk is the engines' route: from one C call it
// copies the chunk's four operands from a pinned host arena to the device and
// launches the kernel, on the caller's stream.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "warp_rows.cuh"

namespace {

using namespace warp_rows;

constexpr int kRowsPerWarp = 1;  // output rows a warp maps, in one pass each

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
segmented_gather_kernel(const int32_t* __restrict__ val_bits,
                        const int8_t* __restrict__ mask,
                        const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ blks,
                        const int32_t* __restrict__ src,
                        int32_t* __restrict__ out_bits,
                        int8_t* __restrict__ out_m,
                        int n_rows, int width, int n_events, int n_in,
                        int n_blocks, int32_t fill_bits) {
  const int s0 = (blockIdx.x * kWarpsPerBlock + threadIdx.y) * kRowsPerWarp;
  if (s0 >= n_rows) return;  // the whole warp: its rows are past the routing
  const int lane = threadIdx.x;
  const int64_t z = blockIdx.y;  // shard

  int64_t base[kRowsPerWarp];  // the event row's first payload element
  const int32_t* src_row[kRowsPerWarp];
  int64_t o[kRowsPerWarp];  // the output row's first element
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t zs = z * n_rows + min(s0 + i, n_rows - 1);
    const int r = clampi(__ldg(rows + zs), 0, n_events - 1);
    const int t = clampi(__ldg(blks + zs), 0, n_blocks - 1);
    base[i] = static_cast<int64_t>(r) * n_in;
    src_row[i] = src + (z * n_blocks + t) * width;
    o[i] = zs * width;
  }
  for (int q0 = 0; q0 < width; q0 += kSpan) {
    const int q = q0 + 4 * lane;
    int p[kRowsPerWarp][4];
    int32_t v[kRowsPerWarp][4];
    int8_t m[kRowsPerWarp][4];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) load_table(src_row[i], q, width, p[i]);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // value and mask issued together
        const int64_t e = base[i] + clampi(p[i][j], 0, n_in - 1);
        v[i][j] = __ldg(val_bits + e);
        m[i][j] = __ldg(mask + e);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (s0 + i >= n_rows) break;
      int32_t acc[4];
      uint32_t hit = 0;  // byte j: column q + j was hit
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = p[i][j] >= 0 && m[i][j] != 0;
        acc[j] = ok ? v[i][j] : fill_bits;
        hit |= static_cast<uint32_t>(ok) << (8 * j);
      }
      store(out_bits + o[i], out_m + o[i], q, width, acc, hit);
    }
  }
}

// Launch the kernel over n_shards shards; returns cudaGetLastError() after
// the launch (0 on success, and 0 with nothing launched for an empty output).
int launch(const void* values, const void* mask, const void* rows,
           const void* blks, const void* src3d, void* out_v, void* out_m,
           int n_shards, int n_rows, int width, int n_events, int n_in,
           int n_blocks, int32_t fill_bits, cudaStream_t stream,
           bool* launched) {
  *launched = false;
  if (n_shards <= 0 || n_rows <= 0 || width <= 0) return 0;
  if (n_shards > 65535 || n_events <= 0 || n_in <= 0 || n_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kRowsPerBlock = kWarpsPerBlock * kRowsPerWarp;
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, n_shards);
  segmented_gather_kernel<<<grid, block, 0, stream>>>(
      static_cast<const int32_t*>(values), static_cast<const int8_t*>(mask),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(blks),
      static_cast<const int32_t*>(src3d), static_cast<int32_t*>(out_v),
      static_cast<int8_t*>(out_m), n_rows, width, n_events, n_in, n_blocks,
      fill_bits);
  const int err = static_cast<int>(cudaGetLastError());
  *launched = err == 0;
  return err;
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
  int32_t fill_bits;
  static_assert(sizeof(fill_bits) == sizeof(fill), "float is 32 bits");
  std::memcpy(&fill_bits, &fill, sizeof(fill));
  bool launched;
  return launch(values, mask, rows, blks, src3d, out_v, out_m, n_shards,
                n_rows, width, n_events, n_in, n_blocks, fill_bits,
                static_cast<cudaStream_t>(stream), &launched);
}

// The engines' route, for one host-densify chunk on the card of index
// p[kDevice] (made current for the call, and the previous one restored):
//
// `host`, which must be pinned, holds the chunk's four operands at the byte
// offsets p[kValsAt], p[kMaskAt], p[kRowsAt] and p[kBlksAt]: values
// (p[kEvents], p[kIn]) float32, mask of the same shape int8, rows and blks
// (p[kShards], p[kRows]) int32.  metl_segmented_gather_chunk copies each with
// its own cudaMemcpyAsync to the same offset past dev_buf + p[kArenaAt], then
// launches the kernel on them as metl_segmented_gather does, with the table
// stack src3d (p[kShards], p[kBlocks], p[kWidth]), writing the (p[kShards],
// p[kRows], p[kWidth]) values at dev_buf and the mask right after them, all
// on `stream`; it checks cudaGetLastError() after each and stops at the first
// error.  p[kFillBits] is the fill value's float32 bit pattern; p[kCopies] and
// p[kLaunches] return how many copies and launches were issued (an empty
// output launches nothing).  Returns 0, a CUDA error, or kNotPinned.
namespace {

enum Param {
  kDevice, kArenaAt, kValsAt, kMaskAt, kRowsAt, kBlksAt, kShards, kRows,
  kWidth, kEvents, kIn, kBlocks, kFillBits, kCopies, kLaunches
};

}  // namespace

extern "C" int metl_segmented_gather_chunk(const void* host, void* dev_buf,
                                           const void* src3d, void* stream,
                                           int64_t* p) {
  p[kCopies] = 0;
  p[kLaunches] = 0;
  if (!pinned(host)) return kNotPinned;
  DeviceGuard guard(static_cast<int>(p[kDevice]));
  if (guard.err != 0) return guard.err;
  for (int k = kArenaAt; k <= kBlocks; ++k)
    if (p[k] < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_pay = p[kEvents] * p[kIn];
  const int64_t n_route = p[kShards] * p[kRows];
  const int64_t at[4] = {p[kValsAt], p[kMaskAt], p[kRowsAt], p[kBlksAt]};
  const int64_t bytes[4] = {4 * n_pay, n_pay, 4 * n_route, 4 * n_route};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* h = static_cast<const uint8_t*>(host);
  uint8_t* d = static_cast<uint8_t*>(dev_buf) + p[kArenaAt];
  for (int c = 0; c < 4; ++c) {
    int err = static_cast<int>(cudaMemcpyAsync(d + at[c], h + at[c],
                                               static_cast<size_t>(bytes[c]),
                                               cudaMemcpyHostToDevice, s));
    if (err == 0) err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    ++p[kCopies];
  }
  const int64_t n_out = n_route * p[kWidth];
  bool launched;
  const int err = launch(
      d + at[0], d + at[1], d + at[2], d + at[3], src3d, dev_buf,
      static_cast<uint8_t*>(dev_buf) + 4 * n_out, static_cast<int>(p[kShards]),
      static_cast<int>(p[kRows]), static_cast<int>(p[kWidth]),
      static_cast<int>(p[kEvents]), static_cast<int>(p[kIn]),
      static_cast<int>(p[kBlocks]), static_cast<int32_t>(p[kFillBits]), s,
      &launched);
  p[kLaunches] += launched;
  return err;
}
