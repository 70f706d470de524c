// DELTA decode: unpack k-bit zigzag deltas, un-zigzag, inclusive prefix sum
// over each 4096-value block in value order v = s*128 + l, plus the block's
// base. (nblocks, k, 128) packed + (nblocks,) int32 bases -> (nblocks, 4096).
//
// Replaces: delta_decode_pallas, repro/kernels/delta_decode.py:57. Semantics
// follow repro/kernels/ref.py delta_decode, which wraps mod 2^32: all the
// arithmetic here is uint32_t (signed overflow is undefined in C++), and any
// association of the sum is exact mod 2^32.
//
// Bound: bytes. Per block it reads 512*k + 4 bytes and writes 16 KiB:
// (512*k + 4 + 16384) * nblocks over 3.35 TB/s on an H100.
//
// Design: one CTA of 128 threads per block, one thread per lane, all 32 of
// its values in registers after the unpack (no 16 KiB staging in shared
// memory, so no bank conflicts). Value v = s*128 + l is row s of lane l, so
// the scan is, per row, a scan across the 128 lanes:
//   1. each warp scans its 32 lanes of every row with shuffles;
//   2. the warps' row totals (32 x 4 words) go to shared memory;
//   3. warp 0, one lane per row, adds them up and scans the 32 row totals
//      with shuffles, giving each (row, warp) its exclusive offset + base;
//   4. every thread adds its offset and stores its 32 values, coalesced.
// Two __syncthreads per block and no global atomics.

#include "common.cuh"

namespace {

constexpr int kWarps = rt::kLanes / 32;

template <int K>
__global__ void __launch_bounds__(rt::kLanes)
    delta_decode_kernel(const uint32_t* __restrict__ packed,
                        const int32_t* __restrict__ bases,
                        int32_t* __restrict__ out) {
  __shared__ uint32_t warp_total[rt::kRows][kWarps];
  __shared__ uint32_t offset[rt::kRows][kWarps];
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const size_t b = blockIdx.x;

  uint32_t x[rt::kRows];
  rt::unpack_lane<K>(packed + b * K * rt::kLanes, lane,
                     [&](int s, uint32_t z) { x[s] = (z >> 1) ^ (0u - (z & 1u)); });

#pragma unroll
  for (int s = 0; s < rt::kRows; ++s) {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, x[s], d);
      if (wl >= d) x[s] += y;
    }
    if (wl == 31) warp_total[s][warp] = x[s];
  }
  __syncthreads();

  if (warp == 0) {
    const int s = wl;  // one lane per row
    uint32_t t[kWarps];
    uint32_t row = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t[w] = warp_total[s][w];
      row += t[w];
    }
    uint32_t inc = row;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
      if (wl >= d) inc += y;
    }
    uint32_t acc = inc - row + static_cast<uint32_t>(bases[b]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      offset[s][w] = acc;
      acc += t[w];
    }
  }
  __syncthreads();

  int32_t* o = out + b * rt::kBlock + lane;
#pragma unroll
  for (int s = 0; s < rt::kRows; ++s)
    o[s * rt::kLanes] = static_cast<int32_t>(x[s] + offset[s][warp]);
}

}  // namespace

extern "C" int rt_delta_decode(const void* packed, const void* bases,
                               void* out, int nblocks, int k, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    delta_decode_kernel<K><<<nblocks, rt::kLanes, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed),
        static_cast<const int32_t*>(bases), static_cast<int32_t*>(out));
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}
