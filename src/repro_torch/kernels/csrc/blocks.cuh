// blocks.cuh: the per-block engine's chunk launcher, shared by
// masked_gather.cu and onehot_map.cu.
//
// The per-block engine (etl/engines.py BlocksEngine) maps each (schema,
// version) group of a chunk through each of its compacted blocks: two
// host->device copies a group (values, mask) and one launch a block, the
// counts that the reference's stats fix.  Issued one by one from Python,
// each copy and launch cost ~50 us of host time around a ~2 us launch.
// launch_chunk issues a whole chunk from one C call instead, in the
// reference's order: for each group its two cudaMemcpyAsync copies, pinned
// host arena to device arena, then one launch of the library's kernel for
// each block of the group, all on the caller's stream.  It checks the
// error of every copy and launch, stops at the first and returns it, and
// reports how many copies and launches it issued.
//
// Descriptors, int64, row-major (kernels/blocks.py BlockChunk):
//   groups[g] = {values offset, mask offset, B, N_in}: the group's (B, N_in)
//               float32 values and int8 mask at those byte offsets, the same
//               in the host and in the device arena (16-byte aligned);
//   blocks[k] = {group, src offset, N_out_pad, out offset}, in group order:
//               the block's index vector at src offset in the plan's flat
//               table, its (B, N_out_pad) outputs at out offset (elements).
// A group with no block still makes its two copies; a block with B or
// N_out_pad of 0 has nothing to launch and is not counted.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// launch_one(values, mask, src offset, out offset, B, N_in, N_out_pad)
// launches one block and returns cudaGetLastError() (0 on success).
template <typename LaunchOne>
int launch_chunk(const uint8_t* host, uint8_t* dev, const int64_t* groups,
                 int64_t n_groups, const int64_t* blocks, int64_t n_blocks,
                 cudaStream_t stream, int64_t* n_copies, int64_t* n_launches,
                 LaunchOne&& launch_one) {
  *n_copies = 0;
  *n_launches = 0;
  int64_t k = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t* d = groups + 4 * g;
    const int64_t rows = d[2], n_in = d[3];
    const size_t n = static_cast<size_t>(rows * n_in);
    const size_t bytes[2] = {n * sizeof(float), n};
    for (int c = 0; c < 2; ++c) {
      const cudaError_t err = cudaMemcpyAsync(
          dev + d[c], host + d[c], bytes[c], cudaMemcpyHostToDevice, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
      ++*n_copies;
    }
    for (; k < n_blocks && blocks[4 * k] == g; ++k) {
      const int64_t* b = blocks + 4 * k;
      if (rows == 0 || b[2] == 0) continue;
      const int err = launch_one(reinterpret_cast<const float*>(dev + d[0]),
                                 reinterpret_cast<const int8_t*>(dev + d[1]),
                                 b[1], b[3], static_cast<int>(rows),
                                 static_cast<int>(n_in), static_cast<int>(b[2]));
      if (err != 0) return err;
      ++*n_launches;
    }
  }
  // a block left over names no group, or the blocks are out of group order
  return k == n_blocks ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
