// BITPACK decode: (nblocks, k, 128) packed words -> (nblocks, 32, 128) int32.
//
// Replaces: bitunpack_pallas, repro/kernels/bitunpack.py:52 (its core is
// `_ladder`, :32, here rt::unpack_lane in common.cuh).
//
// Bound: bytes. Per block it reads 512*k bytes and writes 16 KiB, and does a
// few integer operations per value, so on an H100 (3.35 TB/s) the least time
// is (512*k + 16384) * nblocks / 3.35e12 s.
//
// Design: one CTA of 128 threads per 4096-value block, one thread per lane.
// Each thread's k word loads and each of its 32 row stores are coalesced
// across the warp (128 contiguous bytes), no shared memory is used, and the
// shifts are compile-time constants (k is a template parameter, dispatched
// from the runtime k by rt::with_k). k = 32 copies the words bit for bit, so
// a word >= 2^31 comes out negative, as astype(int32) does in the reference.

#include "common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(rt::kLanes)
    bitunpack_kernel(const uint32_t* __restrict__ packed,
                     int32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const uint32_t* block = packed + b * K * rt::kLanes;
  int32_t* o = out + b * rt::kBlock + lane;
  rt::unpack_lane<K>(block, lane, [&](int s, uint32_t v) {
    o[s * rt::kLanes] = static_cast<int32_t>(v);
  });
}

}  // namespace

extern "C" int rt_bitunpack(const void* packed, void* out, int nblocks, int k,
                            void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    bitunpack_kernel<K><<<nblocks, rt::kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), static_cast<int32_t*>(out));
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
