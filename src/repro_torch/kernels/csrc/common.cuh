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

// One thread's words of a packed block when a block's 32 rows are spread over
// several threads of one lane: the words that hold rows R0 .. R0 + N - 1 of
// lane `lane` and no others, loaded coalesced across the warp.
template <int K, int R0, int N>
struct Words {
  static_assert(K >= 1 && K <= 32, "bit width out of range");
  static_assert(R0 >= 0 && N >= 1 && R0 + N <= kRows, "rows out of range");
  static constexpr int kFirst = (R0 * K) >> 5;
  static constexpr int kCount = (((R0 + N) * K - 1) >> 5) - kFirst + 1;
  uint32_t w[kCount];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ block, int lane) {
#pragma unroll
    for (int j = 0; j < kCount; ++j) w[j] = __ldg(block + (kFirst + j) * kLanes + lane);
  }

  // Row R0 + i as an unsigned K-bit value, for i = 0..N-1.
  __device__ __forceinline__ void values(uint32_t (&v)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (K == 32) {
        v[i] = w[i];
      } else {
        const int off = (R0 + i) * K - kFirst * 32;
        const int w0 = off >> 5;
        const int sh = off & 31;
        uint32_t x = w[w0] >> sh;
        if (sh + K > 32) x |= w[w0 + 1 < kCount ? w0 + 1 : kCount - 1] << (32 - sh);
        v[i] = x & ((1u << K) - 1u);
      }
    }
  }
};

// The barrier of all the CTA's threads, met from any instruction: a CTA whose
// warps run different instantiations of one walk meets at a barrier that is
// not the same instruction for every warp (barrier.sync, not
// __syncthreads' aligned form).
__device__ __forceinline__ void cta_barrier() { asm volatile("barrier.sync 0;" ::: "memory"); }

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

// What a grid-stride launch needs to know of the card and of one kernel
// instantiation. None of it changes between launches, so a launcher works it
// out on its first launch (the port drives one card per process) and never
// again: a launch then makes no runtime query, which matters on the
// host-bound query path.
struct Setup {
  cudaError_t err = cudaSuccess;
  int sms = 0;             // multiprocessors
  int per_sm = 1;          // CTAs per SM that registers and threads allow
  size_t smem_per_sm = 0;  // shared memory per SM
  size_t reserved = 0;     // shared memory the runtime reserves per CTA
};

// Reads the card's limits and `kernel`'s occupancy at `threads` per CTA. With
// `shared`, it also lets every launch of the kernel use dynamic shared memory
// up to the opt-in maximum (227 KiB on an H100); callers never ask for more.
template <typename Kernel>
Setup make_setup(Kernel kernel, int threads, bool shared) {
  Setup s;
  int device = 0, optin = 0, per_sm_smem = 0, reserved = 0;
  if ((s.err = cudaGetDevice(&device)) != cudaSuccess) return s;
  if ((s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
      (s.err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess ||
      (s.err = cudaDeviceGetAttribute(
           &per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
           device)) != cudaSuccess ||
      (s.err = cudaDeviceGetAttribute(
           &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device)) !=
          cudaSuccess)
    return s;
  s.smem_per_sm = static_cast<size_t>(per_sm_smem);
  s.reserved = static_cast<size_t>(reserved);
  if (shared &&
      (s.err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess)
    return s;
  s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel,
                                                        threads, 0);
  if (s.per_sm < 1) s.per_sm = 1;
  return s;
}

// CTAs for a grid-stride walk over `nblocks` blocks: as many as fit on the
// card at once, given what registers and threads allow and `smem` bytes of
// dynamic shared memory per CTA, and no more than there are blocks.
inline int grid_size(const Setup& s, size_t smem, int nblocks) {
  int per_sm = s.per_sm;
  if (smem > 0) {
    const size_t fit = s.smem_per_sm / (smem + s.reserved);
    if (fit < static_cast<size_t>(per_sm))
      per_sm = fit > 0 ? static_cast<int>(fit) : 1;
  }
  const long long ctas = static_cast<long long>(s.sms) * per_sm;
  return static_cast<int>(ctas < nblocks ? ctas : nblocks);
}

}  // namespace rt
