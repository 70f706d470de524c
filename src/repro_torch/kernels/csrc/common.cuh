// Shared core of the port's decode kernels: the lane-transposed k-bit unpack.
//
// Hopper counterpart of `_ladder` in repro/kernels/bitunpack.py. A packed
// block is (k, 128) 32-bit words holding 4096 values as a (32, 128) matrix
// (lakeformat/encodings.py): lane l's 32 values sit vertically in its k words,
// row s in bits [s*k, s*k + k). One thread owns one lane. It loads its k words
// (coalesced across the warp: word j of lanes l..l+31 is 128 contiguous bytes)
// into registers, then emits the 32 rows with shifts that are compile-time
// constants, because k is a template parameter and both loops unroll fully.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace rt {

constexpr int kLanes = 128;               // LANES
constexpr int kRows = 32;                 // SUBLANES
constexpr int kBlock = kLanes * kRows;    // PACK_BLOCK = 4096 values

// Calls emit(s, v) for s = 0..31, where v is row s of lane `lane` of the
// packed block at `block` (K words of 128 lanes), as an unsigned K-bit value.
// For K == 32 the words pass through unchanged.
template <int K, typename Emit>
__device__ __forceinline__ void unpack_lane(const uint32_t* __restrict__ block,
                                            int lane, Emit&& emit) {
  static_assert(K >= 1 && K <= 32, "bit width out of range");
  uint32_t w[K];
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = __ldg(block + j * kLanes + lane);
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    if constexpr (K == 32) {
      emit(s, w[s]);
    } else {
      const int off = s * K;
      const int w0 = off >> 5;
      const int sh = off & 31;
      uint32_t v = w[w0] >> sh;
      // a row that straddles two words: w0 + 1 < K always holds here; the
      // clamp only keeps the (dead) index in range for the unrolled code
      if (sh + K > 32) v |= w[w0 + 1 < K ? w0 + 1 : K - 1] << (32 - sh);
      emit(s, v & ((1u << K) - 1u));
    }
  }
}

// Runs f(std::integral_constant<int, K>{}) for the runtime bit width k, so a
// launcher instantiates its kernel template once per K = 1..32.
template <typename F>
cudaError_t with_k(int k, F&& f) {
#define RT_K_CASE(K) \
  case K:            \
    return f(std::integral_constant<int, K>{});
  switch (k) {
    RT_K_CASE(1) RT_K_CASE(2) RT_K_CASE(3) RT_K_CASE(4)
    RT_K_CASE(5) RT_K_CASE(6) RT_K_CASE(7) RT_K_CASE(8)
    RT_K_CASE(9) RT_K_CASE(10) RT_K_CASE(11) RT_K_CASE(12)
    RT_K_CASE(13) RT_K_CASE(14) RT_K_CASE(15) RT_K_CASE(16)
    RT_K_CASE(17) RT_K_CASE(18) RT_K_CASE(19) RT_K_CASE(20)
    RT_K_CASE(21) RT_K_CASE(22) RT_K_CASE(23) RT_K_CASE(24)
    RT_K_CASE(25) RT_K_CASE(26) RT_K_CASE(27) RT_K_CASE(28)
    RT_K_CASE(29) RT_K_CASE(30) RT_K_CASE(31) RT_K_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_K_CASE
}

}  // namespace rt
