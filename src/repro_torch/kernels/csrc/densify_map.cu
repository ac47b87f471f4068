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
// What bounds it on an H100: bytes, and at the main path's shapes the launch.
// There is no arithmetic; per chunk the kernel reads the packed buffer (tens of
// KB), the touched rows of the block table and a few uid-table entries per
// item, and writes S * W * 5 bytes: well under a megabyte, a fraction of a
// microsecond at 3.35 TB/s.
//
// Design: one thread owns one output element (z, s, q); the shard is the
// grid's y axis, so all the shards a device holds are mapped by ONE launch.  A
// thread block covers kRowsPerBlock output rows of one shard with kThreadsQ
// threads along q (coalesced table reads and output writes).  The sharded path
// re-runs the resolve in every shard's rows rather than resolving once per
// device first: the items are replicated, the work per row is the same, and
// the results are bit-identical.  The resolve is fused into a prologue: for a
// tile of kItemTile items, each thread of a row resolves one item (the reference's
// clip-mode takes become explicit clamps, so no index can fault) into shared
// memory, once per row and not once per output element.  Then every thread of
// the row compares its table entry against the tile's slots in ascending item
// order and overwrites on a match, which keeps last-writer-wins without a
// scatter or atomics.  Values travel and are stored as bit patterns, so the
// output is bit-identical to the plain version.  The kernel allocates nothing
// and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kThreadsQ = 128;      // threads along the output width
constexpr int kRowsPerBlock = 4;    // output rows per thread block
constexpr int kItemTile = kThreadsQ;  // items resolved per prologue pass

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__global__ void __launch_bounds__(kThreadsQ * kRowsPerBlock)
densify_map_kernel(const int32_t* __restrict__ packed,
                   const int32_t* __restrict__ uid_slot,
                   const int32_t* __restrict__ uid_col,
                   const int32_t* __restrict__ src3d,
                   int32_t* __restrict__ out_bits,
                   int8_t* __restrict__ out_m,
                   int n_items, int n_events, int n_rows, int k, int n_uid,
                   int width, int n_blocks, int n_route, int shard_lo,
                   int32_t fill_bits) {
  __shared__ int32_t sh_slot[kRowsPerBlock][kItemTile];
  __shared__ int32_t sh_bits[kRowsPerBlock][kItemTile];

  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int s = blockIdx.x * kRowsPerBlock + ty;
  const bool live = s < n_rows;
  const int64_t z = blockIdx.y;  // local shard

  const int32_t* uids = packed;
  const int32_t* val_bits = packed + n_items;
  const int32_t* starts = packed + 2 * static_cast<int64_t>(n_items);
  const int32_t* counts = starts + n_events;
  const int32_t* ev_col = counts + n_events;
  const int32_t* route = ev_col + n_events;
  const int32_t* rows = route + (shard_lo + z) * n_rows;
  const int32_t* blks = route + (n_route + shard_lo + z) * n_rows;
  const int32_t* src2d = src3d + z * n_blocks * width;
  out_bits += z * n_rows * width;
  out_m += z * n_rows * width;

  int t = 0, start = 0, count = 0, col = -1;
  if (live) {
    const int r = clampi(__ldg(rows + s), 0, n_events - 1);
    t = clampi(__ldg(blks + s), 0, n_blocks - 1);
    start = __ldg(starts + r);
    count = __ldg(counts + r);
    col = __ldg(ev_col + r);
  }
  const int32_t* src_row = src2d + static_cast<int64_t>(t) * width;

  // every loop bound below is uniform across the block, so the barriers are
  // reached by all threads, including those of rows past n_rows
  for (int q0 = 0; q0 < width; q0 += kThreadsQ) {
    const int q = q0 + tx;
    const int p = (live && q < width) ? __ldg(src_row + q) : -1;
    int32_t acc = fill_bits;
    int8_t hit = 0;
    for (int j0 = 0; j0 < k; j0 += kItemTile) {
      // prologue: resolve item j0 + tx of this row's event
      const int j = j0 + tx;
      int32_t slot = -1, bits = 0;
      if (live && j < k && j < count) {
        // int32 sum with wrap-around, then the clip: the reference's
        // arithmetic exactly
        const int ix = clampi(
            static_cast<int>(static_cast<uint32_t>(start) +
                             static_cast<uint32_t>(j)),
            0, n_items - 1);
        const int uid = __ldg(uids + ix);
        if (uid >= 0 && uid < n_uid) {
          const int sl = __ldg(uid_slot + uid);
          if (sl >= 0 && __ldg(uid_col + uid) == col) {
            slot = sl;
            bits = __ldg(val_bits + ix);
          }
        }
      }
      __syncthreads();  // the previous tile's compare loop is done
      sh_slot[ty][tx] = slot;
      sh_bits[ty][tx] = bits;
      __syncthreads();
      const int tile = min(kItemTile, k - j0);
      if (p >= 0) {
        for (int jj = 0; jj < tile; ++jj) {
          if (sh_slot[ty][jj] == p) {  // ascending jj: last writer wins
            acc = sh_bits[ty][jj];
            hit = 1;
          }
        }
      }
    }
    if (live && q < width) {
      out_bits[static_cast<int64_t>(s) * width + q] = acc;
      out_m[static_cast<int64_t>(s) * width + q] = hit;
    }
  }
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
  if (n_shards <= 0 || n_rows <= 0 || width <= 0) return 0;
  if (n_items <= 0 || n_events <= 0 || n_blocks <= 0 || k < 0 || n_uid < 0 ||
      n_shards > 65535 || shard_lo < 0 || shard_lo + n_shards > n_route)
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t fill_bits;
  static_assert(sizeof(fill_bits) == sizeof(fill), "float is 32 bits");
  std::memcpy(&fill_bits, &fill, sizeof(fill));
  const dim3 block(kThreadsQ, kRowsPerBlock);
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock, n_shards);
  densify_map_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed),
      static_cast<const int32_t*>(uid_slot),
      static_cast<const int32_t*>(uid_col),
      static_cast<const int32_t*>(src3d), static_cast<int32_t*>(out_v),
      static_cast<int8_t*>(out_m), n_items, n_events, n_rows, k, n_uid, width,
      n_blocks, n_route, shard_lo, fill_bits);
  return static_cast<int>(cudaGetLastError());
}
