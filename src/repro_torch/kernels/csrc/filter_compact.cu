// Stream compaction: per 1024-value block, pack the values whose mask is set
// to the front, in order, fill the rest of the block with zeros, and count
// them. (nblk, 1024) 32-bit values + (nblk, 1024) bool
// -> (nblk, 1024) values, (nblk,) int32 counts.
//
// Replaces: filter_compact_pallas, repro/kernels/filter_compact.py:52, with
// the semantics of repro/kernels/ref.py filter_compact. The TPU kernel builds
// a permutation one-hot and contracts it on the MXU in f32, so the reference
// splits ints of 2^24 and more into two 16-bit halves and compacts twice.
// Here values move as raw 32-bit words: one launch is exact for any int32 or
// float32 column.
//
// Bound: bytes. Per block it reads 4 KiB of values and 1 KiB of mask and
// writes 4 KiB and a 4-byte count: 9220 * nblk bytes over 3.35 TB/s on an
// H100.
//
// Design: one CTA of 1024 threads per block, one value per thread, all loads
// coalesced. A survivor's slot is the number of survivors before it: within
// its warp, __popc of the warp's __ballot_sync below its lane; across warps,
// an exclusive scan of the 32 warp totals, which one warp does with shuffles
// after the totals pass through shared memory. Each survivor stores to its
// slot (a warp's stores fall in one contiguous run), thread i stores a zero
// to slot i when i >= count, and thread 0 writes the count. Stable by
// construction, deterministic, and no atomics.

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;  // RLE_OUT_BLOCK values per block
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
    filter_compact_kernel(const uint32_t* __restrict__ values,
                          const uint8_t* __restrict__ mask,
                          uint32_t* __restrict__ out,
                          int32_t* __restrict__ counts) {
  __shared__ int32_t warp_offset[kWarps];
  __shared__ int32_t block_count;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlock;

  const bool keep = __ldg(mask + base + t) != 0;
  const uint32_t v = __ldg(values + base + t);
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int before = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_offset[warp] = __popc(ballot);
  __syncthreads();

  if (warp == 0) {
    const int total = warp_offset[lane];
    int inc = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    warp_offset[lane] = inc - total;  // exclusive
    if (lane == 31) block_count = inc;
  }
  __syncthreads();

  const int count = block_count;
  if (keep) out[base + warp_offset[warp] + before] = v;
  if (t >= count) out[base + t] = 0u;
  if (t == 0) counts[blockIdx.x] = count;
}

}  // namespace

extern "C" int rt_filter_compact(const void* values, const void* mask,
                                 void* out, void* counts, int nblocks,
                                 void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  filter_compact_kernel<<<nblocks, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const uint8_t*>(mask),
      static_cast<uint32_t*>(out), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
