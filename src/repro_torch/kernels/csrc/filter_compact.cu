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
// Design: two kernels, chosen by the launch's block count.
// - Under kWalkBlocks blocks (Q19's part scan: 196), one CTA of 1024 threads
//   per block, one value per thread, all loads coalesced. A survivor's slot
//   is the number of survivors before it: within its warp, __popc of the
//   warp's __ballot_sync below its lane; across warps, an exclusive scan of
//   the 32 warp totals, which one warp does with shuffles after the totals
//   pass through shared memory. Each survivor stores to its slot (a warp's
//   stores fall in one contiguous run), thread i stores a zero to slot i
//   when i >= count, and thread 0 writes the count.
// - From kWalkBlocks on, a grid-stride walk: CTAs of 256 threads, as many as
//   fit at once (rt::make_setup, rt::grid_size), each taking every
//   gridDim.x-th block, its first outside the loop. Thread t takes values
//   4t .. 4t + 3 of a block in one 16-byte load and their mask bytes in one
//   4-byte load; the next block's loads are issued before this block's
//   scan. A thread's survivors before its own are an inclusive warp scan of
//   the threads' counts (5 shuffles) plus the totals of the warps before it,
//   which pass through shared memory double-buffered by block parity, so
//   one barrier a block suffices. Slots wholly past the count get 16-byte
//   zero stores, slots that straddle it scalar ones.
// Both are stable, deterministic and free of atomics. On an H100 (PERF.md,
// section 6) the walk took the 5,888-block stack from 35.5 to 27.2 us, but
// 196 blocks from 6.26 to 6.64 us cold and 1.67 to 1.78 us warm; 128 threads
// with 8 values a thread, and the 256-thread code with a CTA per block, were
// slower at the stack. A line through each kernel's 196- and 1,473-block
// times puts their crossing near 430 blocks.

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

constexpr int kWalkBlocks = 512;  // launches from this many blocks on walk
constexpr int kWalkThreads = 256;
constexpr int kWalkValues = kBlock / kWalkThreads;  // 4: one 16-byte load
constexpr int kWalkWarps = kWalkThreads / 32;
static_assert(kWalkValues == 4, "a thread's values are one uint4, its mask bytes one word");

__global__ void __launch_bounds__(kWalkThreads)
    filter_compact_walk(const uint32_t* __restrict__ values,
                        const uint8_t* __restrict__ mask,
                        uint32_t* __restrict__ out,
                        int32_t* __restrict__ counts, int nblocks) {
  __shared__ int32_t warp_total[2][kWalkWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const size_t step = gridDim.x;
  const size_t n = static_cast<size_t>(nblocks);
  uint4 v;
  uint32_t mv;
  auto fetch = [&](size_t b) {
    v = __ldg(reinterpret_cast<const uint4*>(values + b * kBlock) + t);
    mv = __ldg(reinterpret_cast<const uint32_t*>(mask + b * kBlock) + t);
  };
  auto compact = [&](size_t b, int buf) {
    const uint32_t x[kWalkValues] = {v.x, v.y, v.z, v.w};
    uint32_t keep = 0;  // bit i: value 4t + i survives
#pragma unroll
    for (int i = 0; i < kWalkValues; ++i) keep |= (((mv >> (8 * i)) & 0xFFu) != 0 ? 1u : 0u) << i;
    if (b + step < n) fetch(b + step);  // the next block's loads, before this block's scan
    const int c = __popc(keep);
    int inc = c;  // inclusive scan of the counts over the warp's lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    if (lane == 31) warp_total[buf][warp] = inc;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWalkWarps; ++w) {
      const int s = warp_total[buf][w];
      before += w < warp ? s : 0;
      total += s;
    }
    uint32_t* o = out + b * kBlock;
    int slot = before + inc - c;
#pragma unroll
    for (int i = 0; i < kWalkValues; ++i)
      if ((keep >> i) & 1u) o[slot++] = x[i];
    const int first = t * kWalkValues;
    if (first >= total) {
      *reinterpret_cast<uint4*>(o + first) = make_uint4(0u, 0u, 0u, 0u);
    } else if (first + kWalkValues > total) {
#pragma unroll
      for (int i = 0; i < kWalkValues; ++i)
        if (first + i >= total) o[first + i] = 0u;
    }
    if (t == 0) counts[b] = total;
  };
  // The grid is never wider than the blocks, so every CTA has a first block.
  size_t b = blockIdx.x;
  fetch(b);
  compact(b, 0);
  int buf = 1;
  for (b += step; b < n; b += step, buf ^= 1) compact(b, buf);
}

}  // namespace

extern "C" int rt_filter_compact(const void* values, const void* mask,
                                 void* out, void* counts, int nblocks,
                                 void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  const auto v = static_cast<const uint32_t*>(values);
  const auto m = static_cast<const uint8_t*>(mask);
  const auto o = static_cast<uint32_t*>(out);
  const auto c = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (nblocks < kWalkBlocks) {
    filter_compact_kernel<<<nblocks, kBlock, 0, s>>>(v, m, o, c);
    return static_cast<int>(cudaGetLastError());
  }
  // the walk reads and writes 16-byte vectors of values and 4 mask bytes
  if (reinterpret_cast<uintptr_t>(values) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 4)
    return cudaErrorMisalignedAddress;
  static const rt::Setup setup = rt::make_setup(filter_compact_walk, kWalkThreads, false);
  if (setup.err != cudaSuccess) return setup.err;
  filter_compact_walk<<<rt::grid_size(setup, 0, nblocks), kWalkThreads, 0, s>>>(v, m, o, c,
                                                                                   nblocks);
  return static_cast<int>(cudaGetLastError());
}
