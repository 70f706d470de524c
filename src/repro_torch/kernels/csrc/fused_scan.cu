// Fused decode + range filter: unpack k-bit values (or k-bit dictionary
// codes and look them up) and test lo <= v <= hi, writing only the survivor
// mask and one count per block.
// (nblocks, k, 128) packed [+ (D,) dictionary] -> (nblocks, 4096) bool,
// (nblocks,) int32.
//
// Replaces: fused_scan_pallas, repro/kernels/fused_scan.py:99. Semantics
// follow repro/kernels/ref.py fused_scan: without a dictionary the values
// are the unpacked words read as int32; with one, each code is clipped to
// the dictionary's TRUE length [0, D-1] and the entry compared in the
// dictionary's dtype, with the int32 bounds converted to it (round to
// nearest for a float32 dictionary, as astype does). The engine calls the
// dictionary-free arm only: it rewrites a DICT predicate onto codes
// (repro/core/engine.py:458-463).
//
// Bound: bytes. Per block it reads 512*k bytes and writes 4096 mask bytes and
// a 4-byte count: (512*k + 4096 + 4) * nblocks over 3.35 TB/s on an H100,
// plus the D*4-byte dictionary once. The decoded column is never written,
// which is the point of the fusion.
//
// Design: one CTA of 128 threads per block, one thread per lane. Each thread
// unpacks its 32 rows in registers, reads each row's dictionary entry (if
// any) through the read-only cache (__ldg; a simple arm, since the engine
// does not call it), stores one mask byte per row (a warp stores 32
// contiguous bytes per row), and counts its survivors; the count is reduced
// inside the CTA (__reduce_add_sync per warp, then the 4 warp sums in shared
// memory), with no global atomics.

#include "common.cuh"

namespace {

constexpr int kWarps = rt::kLanes / 32;

// What the unpacked words are: the values themselves, or codes into an
// int32 or a float32 dictionary.
enum Kind { kWords = 0, kIntDict = 1, kFloatDict = 2 };

template <int K, int kKind>
__global__ void __launch_bounds__(rt::kLanes)
    fused_scan_kernel(const uint32_t* __restrict__ packed,
                      const uint32_t* __restrict__ dict, int32_t dict_len,
                      int32_t lo, int32_t hi, uint8_t* __restrict__ mask,
                      int32_t* __restrict__ counts) {
  __shared__ int32_t warp_count[kWarps];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const int32_t last = dict_len - 1;
  const float flo = static_cast<float>(lo);
  const float fhi = static_cast<float>(hi);
  uint8_t* m = mask + b * rt::kBlock + lane;
  int32_t n = 0;
  rt::unpack_lane<K>(packed + b * K * rt::kLanes, lane, [&](int s, uint32_t v) {
    bool keep;
    if constexpr (kKind == kWords) {
      const int32_t x = static_cast<int32_t>(v);
      keep = (x >= lo) & (x <= hi);
    } else {
      int32_t c = static_cast<int32_t>(v);
      c = c < 0 ? 0 : (c > last ? last : c);
      const uint32_t w = __ldg(dict + c);
      if constexpr (kKind == kIntDict) {
        const int32_t x = static_cast<int32_t>(w);
        keep = (x >= lo) & (x <= hi);
      } else {
        const float x = __uint_as_float(w);
        keep = (x >= flo) & (x <= fhi);
      }
    }
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

template <int K, int kKind>
cudaError_t launch(const void* packed, const void* dict, int dict_len, int lo,
                   int hi, void* mask, void* counts, int nblocks,
                   cudaStream_t stream) {
  fused_scan_kernel<K, kKind><<<nblocks, rt::kLanes, 0, stream>>>(
      static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dict),
      dict_len, lo, hi, static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(counts));
  return cudaGetLastError();
}

}  // namespace

// dict_kind: 0 without a dictionary (dict may be null), 1 int32, 2 float32.
extern "C" int rt_fused_scan(const void* packed, const void* dict,
                             int dict_len, int dict_kind, int lo, int hi,
                             void* mask, void* counts, int nblocks, int k,
                             void* stream) {
  if (nblocks <= 0 || dict_kind < kWords || dict_kind > kFloatDict ||
      (dict_kind != kWords && dict_len <= 0))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    switch (dict_kind) {
      case kIntDict:
        return launch<K, kIntDict>(packed, dict, dict_len, lo, hi, mask, counts, nblocks, s);
      case kFloatDict:
        return launch<K, kFloatDict>(packed, dict, dict_len, lo, hi, mask, counts, nblocks, s);
      default:
        return launch<K, kWords>(packed, dict, dict_len, lo, hi, mask, counts, nblocks, s);
    }
  });
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Batched fused decode + range filter: many pages' BITPACK blocks stacked
// along the block axis, block b testing its own bounds lo[b] <= v <= hi[b].
// (nblocks, k, 128) packed + (nblocks,) lo, hi -> (nblocks, 4096) bool.
//
// Replaces: fused_scan_batch_pallas, repro/kernels/fused_scan.py:61.
// Semantics follow the reference's _ref_fused_scan_batch
// (repro/kernels/ops.py:284-289): the unpacked words read as int32 against
// the block's int32 bounds. A block given the empty range (1, 0), as the
// reference pads its stacks, matches nothing. Mask only, no counts.
//
// Bound: bytes. Per block 512*k bytes in, 4096 mask bytes out and 8 bytes of
// bounds: (512*k + 4096 + 8) * nblocks over 3.35 TB/s on an H100.
//
// Design: the sequential kernel's words arm with the bounds read per CTA:
// one CTA of 128 threads per block, one thread per lane, the 32 values
// unpacked in registers and compared there; the decoded column is never
// written. A warp stores 32 contiguous mask bytes per row.
// ---------------------------------------------------------------------------

namespace {

template <int K>
__global__ void __launch_bounds__(rt::kLanes)
    fused_scan_batch_kernel(const uint32_t* __restrict__ packed,
                            const int32_t* __restrict__ lo,
                            const int32_t* __restrict__ hi,
                            uint8_t* __restrict__ mask) {
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const int32_t l = __ldg(lo + b);
  const int32_t h = __ldg(hi + b);
  uint8_t* m = mask + b * rt::kBlock + lane;
  rt::unpack_lane<K>(packed + b * K * rt::kLanes, lane, [&](int s, uint32_t v) {
    const int32_t x = static_cast<int32_t>(v);
    m[s * rt::kLanes] = (x >= l) & (x <= h);
  });
}

}  // namespace

extern "C" int rt_fused_scan_batch(const void* packed, const void* lo,
                                   const void* hi, void* mask, int nblocks,
                                   int k, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    fused_scan_batch_kernel<K><<<nblocks, rt::kLanes, 0, s>>>(
        static_cast<const uint32_t*>(packed), static_cast<const int32_t*>(lo),
        static_cast<const int32_t*>(hi), static_cast<uint8_t*>(mask));
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}
