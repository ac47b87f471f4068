// densify_map: resolve, densify and map one packed event chunk in one launch.
//
// Replaces the Pallas TPU kernels of repro/kernels/densify_map.py, densify_map
// and densify_map_shard (which the reference runs once per shard inside
// shard_map on that shard's slice of the block table), together with the
// resolve step that fed both, repro/kernels/ops.py (_resolve_items).  Input is
// the chunk's one packed int32 buffer
//
//   [ uids(NI) | val_bits(NI) | starts(B) | counts(B) | ev_col(B)
//     | rows(R, S) | blks(R, S) ]
//
// where R is 1 for the replicated table and the mesh's shard count for the
// sharded one (all shards' rows, then all shards' blks), and the plan's
// uid_slot / uid_col tables and block table src3d (one (n_blocks, W) slice per
// shard this launch maps).  Shard z of a launch that starts at global shard lo
// routes by rows[lo + z] / blks[lo + z].  Its output (z, s, q) is the value of
// the LAST item j (ascending) of event r = rows[lo + z, s] whose resolved
// payload slot equals src3d[z, blks[lo + z, s], q] (src >= 0), else fill; the
// mask says whether any item hit.  An item is dropped, exactly as in the reference, when
// it is CSR padding (j >= counts[r]), its uid lies outside [0, len(uid_slot)),
// its slot is -1, or its owning column uid_col[uid] is not ev_col[r].
//
// What bounds it on an H100: at the usual 512-event chunk the launch and a
// chain of dependent loads, not bytes.  There is no arithmetic; per chunk the
// kernel reads the packed buffer (tens of KB), the touched rows of the block
// table and a few uid-table entries per item, and writes S * W * 5 bytes:
// 0.6 MB, 0.18 us at 3.35 TB/s, at 512 events (S 512, W 128), and 6.5 MB,
// 1.9 us, at 8,192.  Each output row waits on the loads that pick its data:
// rows/blks, then the event's starts/counts/ev_col, then each item's uid,
// then its uid_slot/uid_col entries -- four round trips to L2 or memory.
//
// Design (the pieces shared with segmented_gather.cu are in warp_rows.cuh):
// one warp owns one output row (z, s) and covers it 4 * 32 = 128
// columns at a time, lane l the four columns 4l .. 4l + 3: one 16-byte load of
// the block-table row, one 16-byte store of values and one 4-byte store of the
// mask a lane (scalar accesses where W % 4 != 0 or an address is not aligned).
// The table row needs only blks[s], so it is loaded before the item chain
// starts and arrives while the chain runs.  Lane j resolves item j of the
// event into registers, its value loaded beside its uid (both need only the
// item's index); the reference's clip-mode takes become explicit clamps, so no
// index can fault.  Then every lane compares its four table entries against
// items 0 .. count-1 in ascending order, each broadcast from its lane with
// __shfl_sync, and overwrites on a match: last-writer-wins without a scatter,
// atomics, shared memory or a barrier.  Events with more than 32 items are
// resolved 32 at a time.  The shard is the grid's y axis, so all the shards a
// device holds are mapped by ONE launch; every shard re-runs the resolve in
// its own rows (the items are replicated and the results bit-identical).
// Values travel and are stored as bit patterns, so the output is
// bit-identical to the plain version.  TMA, wgmma and cp.async are not used:
// the body has no arithmetic for a tensor core, and each row's operands are a
// few hundred bytes picked by data, so there is no tile to stage.
//
// metl_densify_map_chunk is the engines' route: from one C call it copies the
// chunk's packed bytes from a pinned host arena to the device and launches the
// kernel, on the caller's stream.  The kernel allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "warp_rows.cuh"

namespace {

using namespace warp_rows;

constexpr int kNoSlot = -2;  // a dropped item; no table entry equals it
constexpr unsigned kAllLanes = 0xffffffffu;

// item j of an event whose items start at `start`, of which the first n
// count: its payload slot (kNoSlot when dropped) and value bits
__device__ __forceinline__ void resolve(
    int j, int n, int start, int col, const int32_t* __restrict__ uids,
    const int32_t* __restrict__ val_bits, const int32_t* __restrict__ uid_slot,
    const int32_t* __restrict__ uid_col, int n_items, int n_uid, int& slot,
    int32_t& bits) {
  slot = kNoSlot;
  bits = 0;
  if (j >= n) return;
  // int32 sum with wrap-around, then the clip: the reference's arithmetic
  const int ix = clampi(
      static_cast<int>(static_cast<uint32_t>(start) + static_cast<uint32_t>(j)),
      0, n_items - 1);
  const int uid = __ldg(uids + ix);
  const int32_t v = __ldg(val_bits + ix);  // needs only ix, as the uid does
  if (uid < 0 || uid >= n_uid) return;
  const int sl = __ldg(uid_slot + uid);
  const int c = __ldg(uid_col + uid);
  if (sl >= 0 && c == col) {
    slot = sl;
    bits = v;
  }
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
densify_map_kernel(const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ uid_slot,
                   const int32_t* __restrict__ uid_col,
                   const int32_t* __restrict__ src3d,
                   int32_t* __restrict__ out_bits,
                   int8_t* __restrict__ out_m,
                   int n_items, int n_events, int n_rows, int k, int n_uid,
                   int width, int n_blocks, int n_route, int shard_lo,
                   int32_t fill_bits) {
  const int s = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (s >= n_rows) return;  // the whole warp: its row is past the routing
  const int lane = threadIdx.x;
  const int64_t z = blockIdx.y;  // local shard

  const int32_t* uids = packed;
  const int32_t* val_bits = packed + n_items;
  const int32_t* starts = packed + 2 * static_cast<int64_t>(n_items);
  const int32_t* counts = starts + n_events;
  const int32_t* ev_col = counts + n_events;
  const int32_t* route = ev_col + n_events;
  const int32_t* rows = route + (shard_lo + z) * n_rows;
  const int32_t* blks = route + (n_route + shard_lo + z) * n_rows;

  const int r = clampi(__ldg(rows + s), 0, n_events - 1);
  const int t = clampi(__ldg(blks + s), 0, n_blocks - 1);
  const int32_t* src_row = src3d + (z * n_blocks + t) * width;
  int p[4];
  load_table(src_row, 4 * lane, width, p);  // in flight while items resolve
  const int start = __ldg(starts + r);
  const int n = min(__ldg(counts + r), k);
  const int col = __ldg(ev_col + r);

  int slot;
  int32_t bits;
  resolve(lane, n, start, col, uids, val_bits, uid_slot, uid_col, n_items,
          n_uid, slot, bits);
  int resolved = 0;  // the first item the lanes hold

  const int64_t o = (z * n_rows + s) * width;
  for (int q0 = 0; q0 < width; q0 += kSpan) {
    const int q = q0 + 4 * lane;
    if (q0 > 0) load_table(src_row, q, width, p);
    int32_t acc[4] = {fill_bits, fill_bits, fill_bits, fill_bits};
    uint32_t hit = 0;  // byte i: column q + i was hit
    // n and every bound below are the same across the warp: each shuffle
    // has all 32 lanes
    for (int j0 = 0; j0 < n; j0 += kWarp) {
      if (j0 != resolved) {
        resolve(j0 + lane, n, start, col, uids, val_bits, uid_slot, uid_col,
                n_items, n_uid, slot, bits);
        resolved = j0;
      }
      const int tile = min(kWarp, n - j0);
      for (int jj = 0; jj < tile; ++jj) {  // ascending: the last writer wins
        const int sj = __shfl_sync(kAllLanes, slot, jj);
        const int32_t bj = __shfl_sync(kAllLanes, bits, jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (p[i] == sj) {
            acc[i] = bj;
            hit |= 1u << (8 * i);
          }
        }
      }
    }
    store(out_bits + o, out_m + o, q, width, acc, hit);
  }
}

// Launch the kernel over shards [shard_lo, shard_lo + n_shards); returns
// cudaGetLastError() after the launch (0 on success, and 0 with nothing
// launched for an empty output).
int launch(const void* packed, const void* uid_slot, const void* uid_col,
           const void* src3d, void* out_v, void* out_m, int n_items,
           int n_events, int n_rows, int k, int n_uid, int width, int n_blocks,
           int n_route, int shard_lo, int n_shards, float fill,
           cudaStream_t stream, bool* launched) {
  *launched = false;
  if (n_shards <= 0 || n_rows <= 0 || width <= 0) return 0;
  if (n_items <= 0 || n_events <= 0 || n_blocks <= 0 || k < 0 || n_uid < 0 ||
      n_shards > 65535 || shard_lo < 0 || shard_lo + n_shards > n_route)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t fill_bits;
  static_assert(sizeof(fill_bits) == sizeof(fill), "float is 32 bits");
  std::memcpy(&fill_bits, &fill, sizeof(fill));
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock, n_shards);
  densify_map_kernel<<<grid, block, 0, stream>>>(
      static_cast<const int32_t*>(packed),
      static_cast<const int32_t*>(uid_slot),
      static_cast<const int32_t*>(uid_col),
      static_cast<const int32_t*>(src3d), static_cast<int32_t*>(out_v),
      static_cast<int8_t*>(out_m), n_items, n_events, n_rows, k, n_uid, width,
      n_blocks, n_route, shard_lo, fill_bits);
  const int err = static_cast<int>(cudaGetLastError());
  *launched = err == 0;
  return err;
}

}  // namespace

// C entry point, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 on success).  Maps shards [shard_lo, shard_lo + n_shards) of a
// packed chunk routed over n_route shards: `packed` holds 2*n_items +
// 3*n_events + 2*n_route*n_rows int32 (n_rows routing rows per shard); src3d
// is (n_shards, n_blocks, width), these shards' table slices; out_v (float32)
// and out_m (int8) are (n_shards, n_rows, width).  The replicated table is
// n_route = n_shards = 1, shard_lo = 0.  uid_slot/uid_col hold n_uid int32
// each (n_uid may be 0).  All contiguous, all on the current device.
extern "C" int metl_densify_map(const void* packed, const void* uid_slot,
                                const void* uid_col, const void* src3d,
                                void* out_v, void* out_m, int n_items,
                                int n_events, int n_rows, int k, int n_uid,
                                int width, int n_blocks, int n_route,
                                int shard_lo, int n_shards, float fill,
                                void* stream) {
  bool launched;
  return launch(packed, uid_slot, uid_col, src3d, out_v, out_m, n_items,
                n_events, n_rows, k, n_uid, width, n_blocks, n_route, shard_lo,
                n_shards, fill, static_cast<cudaStream_t>(stream), &launched);
}

// The engines' route, for one device-densify chunk on the card of index
// p[kDevice] (made current for the call, and the previous one restored):
//
// metl_densify_map_chunk copies the p[kBytes] bytes of the packed chunk from
// `host`, which must be pinned, to dev_buf + p[kPackedAt] with one
// cudaMemcpyAsync, then launches the kernel on them as metl_densify_map
// does, writing the (n_shards, n_rows, width) values at dev_buf and the mask
// right after them, both on `stream`; it checks cudaGetLastError() after each
// and stops at the first error.  The sizes are p[kItems] .. p[kFillBits] (the
// fill value as its float32 bit pattern); p[kCopies] and p[kLaunches] return
// how many copies and launches were issued (an empty output launches
// nothing).  Returns 0, a CUDA error, or kNotPinned.
namespace {

enum Param {
  kDevice, kBytes, kPackedAt, kItems, kEvents, kRows, kK, kUid, kWidth,
  kBlocks, kRoute, kShardLo, kShards, kFillBits, kCopies, kLaunches
};

}  // namespace

extern "C" int metl_densify_map_chunk(const void* host, void* dev_buf,
                                      const void* uid_slot, const void* uid_col,
                                      const void* src3d, void* stream,
                                      int64_t* p) {
  p[kCopies] = 0;
  p[kLaunches] = 0;
  if (!pinned(host)) return kNotPinned;
  DeviceGuard guard(static_cast<int>(p[kDevice]));
  if (guard.err != 0) return guard.err;
  if (p[kBytes] < 0 || p[kPackedAt] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* packed = static_cast<uint8_t*>(dev_buf) + p[kPackedAt];
  int err = static_cast<int>(cudaMemcpyAsync(
      packed, host, static_cast<size_t>(p[kBytes]), cudaMemcpyHostToDevice, s));
  if (err == 0) err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ++p[kCopies];
  const int n_shards = static_cast<int>(p[kShards]);
  const int n_rows = static_cast<int>(p[kRows]);
  const int width = static_cast<int>(p[kWidth]);
  const int64_t n_out = static_cast<int64_t>(n_shards) * n_rows * width;
  float fill;
  const int32_t fill_bits = static_cast<int32_t>(p[kFillBits]);
  std::memcpy(&fill, &fill_bits, sizeof(fill));
  bool launched;
  err = launch(packed, uid_slot, uid_col, src3d, dev_buf,
               static_cast<uint8_t*>(dev_buf) + 4 * n_out,
               static_cast<int>(p[kItems]), static_cast<int>(p[kEvents]), n_rows,
               static_cast<int>(p[kK]), static_cast<int>(p[kUid]), width,
               static_cast<int>(p[kBlocks]), static_cast<int>(p[kRoute]),
               static_cast<int>(p[kShardLo]), n_shards, fill, s, &launched);
  p[kLaunches] += launched;
  return err;
}
