// Fused BITPACK decode + range filter: unpack k-bit values and test
// lo <= v <= hi as signed int32, writing only the survivor mask and one count
// per block. (nblocks, k, 128) packed -> (nblocks, 4096) bool, (nblocks,) int32.
//
// Replaces: fused_scan_pallas, repro/kernels/fused_scan.py:99 (its
// dictionary-free arm, which is the one the engine calls: it rewrites a
// DICT predicate onto codes, repro/core/engine.py:458-463).
//
// Bound: bytes. Per block it reads 512*k bytes and writes 4096 mask bytes and
// a 4-byte count: (512*k + 4096 + 4) * nblocks over 3.35 TB/s on an H100. The
// decoded column is never written, which is the point of the fusion.
//
// Design: one CTA of 128 threads per block, one thread per lane. Each thread
// unpacks its 32 rows in registers, stores one mask byte per row (a warp
// stores 32 contiguous bytes per row), and counts its survivors; the count is
// reduced inside the CTA (__reduce_add_sync per warp, then the 4 warp sums in
// shared memory), with no global atomics.

#include "common.cuh"

namespace {

constexpr int kWarps = rt::kLanes / 32;

template <int K>
__global__ void __launch_bounds__(rt::kLanes)
    fused_scan_kernel(const uint32_t* __restrict__ packed, int32_t lo,
                      int32_t hi, uint8_t* __restrict__ mask,
                      int32_t* __restrict__ counts) {
  __shared__ int32_t warp_count[kWarps];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  uint8_t* m = mask + b * rt::kBlock + lane;
  int32_t n = 0;
  rt::unpack_lane<K>(packed + b * K * rt::kLanes, lane, [&](int s, uint32_t v) {
    const int32_t x = static_cast<int32_t>(v);
    const bool keep = (x >= lo) & (x <= hi);
    m[s * rt::kLanes] = keep;
    n += keep;
  });
  n = __reduce_add_sync(0xffffffffu, n);
  if ((lane & 31) == 0) warp_count[lane >> 5] = n;
  __syncthreads();
  if (lane == 0) {
    int32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_count[w];
    counts[b] = total;
  }
}

}  // namespace

extern "C" int rt_fused_scan(const void* packed, int lo, int hi, void* mask,
                             void* counts, int nblocks, int k, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fused_scan_kernel<K><<<nblocks, rt::kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), lo, hi,
        static_cast<uint8_t*>(mask), static_cast<int32_t*>(counts));
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}
