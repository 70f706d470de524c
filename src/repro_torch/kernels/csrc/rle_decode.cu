// RLE decode: block-aligned run expansion by rank lookup.
// (nblk, 128) run values + (nblk, 128) exclusive cumulative ends
// -> (nblk, 1024) values.
//
// Replaces: rle_decode_pallas, repro/kernels/rle_decode.py:48. Semantics
// follow repro/kernels/ref.py rle_decode: out[j] = values[min(rank(j), 127)]
// with rank(j) = |{r : ends[r] <= j}| over the block's nondecreasing ends.
// The writer pads each block's window with end = 1024 runs that repeat its
// final value (lakeformat/encodings.py rle_encode); the clip re-reads it.
//
// Bound: bytes. Per block it reads 512 B of values and 512 B of ends and
// writes 4 KiB: 5120 * nblk bytes over 3.35 TB/s on an H100. Per value it
// spends 7 search steps of 3 integer issue slots and one for the gather's
// address, which keeps the operations bound just under the bytes bound.
//
// Design: one CTA of 256 threads per block. Threads 0-127 stage the ends and
// threads 128-255 the values in shared memory (coalesced 4-byte loads). Each
// thread then owns 4 contiguous outputs. For each it runs a branchless
// upper-bound search over the 128 shared ends in steps of 64, 32, ..., 1:
// the position it reaches is min(rank, 127), because the steps sum to 127,
// so the clip costs nothing. It then reads the run's value from shared
// memory. The 4 values leave as one 16-byte store, so a warp writes 512
// contiguous bytes. Values move as raw 32-bit words: one kernel serves int32
// and float32 runs alike.

#include "common.cuh"

namespace {

constexpr int kOut = 1024;   // RLE_OUT_BLOCK
constexpr int kWindow = 128; // RLE_WINDOW
constexpr int kPer = 4;      // outputs per thread
constexpr int kThreads = kOut / kPer;
static_assert(kThreads == 2 * kWindow, "one staging load per thread");

__global__ void __launch_bounds__(kThreads)
    rle_decode_kernel(const uint32_t* __restrict__ values,
                      const int32_t* __restrict__ ends,
                      uint4* __restrict__ out) {
  __shared__ int32_t s_end[kWindow];
  __shared__ uint32_t s_val[kWindow];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  if (t < kWindow)
    s_end[t] = __ldg(ends + b * kWindow + t);
  else
    s_val[t - kWindow] = __ldg(values + b * kWindow + (t - kWindow));
  __syncthreads();

  uint32_t v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = t * kPer + i;
    int pos = 0;
#pragma unroll
    for (int step = kWindow / 2; step > 0; step >>= 1)
      if (s_end[pos + step - 1] <= j) pos += step;
    v[i] = s_val[pos];
  }
  out[b * kThreads + t] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" int rt_rle_decode(const void* values, const void* ends, void* out,
                             int nblocks, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  rle_decode_kernel<<<nblocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(values), static_cast<const int32_t*>(ends),
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
