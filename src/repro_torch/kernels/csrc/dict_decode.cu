// DICT decode: unpack k-bit codes, clip to [0, D-1], look up the dictionary.
// (nblocks, k, 128) packed codes + (D,) dictionary -> (nblocks, 32, 128).
//
// Replaces: dict_decode_pallas, repro/kernels/dict_decode.py:146. Semantics
// follow repro/kernels/ref.py dict_decode: jnp.take(dict, codes, mode="clip")
// with D the TRUE dictionary length (a code >= D reads entry D-1; with k = 32
// a negative code reads entry 0).
//
// Bound: bytes. Per block it reads 512*k bytes of codes and writes 16 KiB, and
// the D*4-byte dictionary is read once: (512*k + 16384) * nblocks + 4*D bytes
// over 3.35 TB/s on an H100.
//
// Design: dictionary entries are moved as raw 32-bit words, so one kernel is
// exact for int32 and float32 dictionaries alike. The dictionary goes into
// dynamic shared memory when it fits a block (the wrapper decides, up to the
// 227 KiB opt-in limit; on its first launch the launcher raises the kernel's
// cudaFuncAttributeMaxDynamicSharedMemorySize to that limit), else it is read
// from global memory through the read-only cache (__ldg). Each CTA loads the
// dictionary once and walks a grid-stride loop over blocks, so the fill is
// amortised; the grid is sized by the occupancy the shared-memory footprint
// allows, from card and kernel limits read once per instantiation.
// One thread per lane; code loads and value stores are coalesced.

#include "common.cuh"

namespace {

template <int K, bool kShared>
__global__ void __launch_bounds__(rt::kLanes)
    dict_decode_kernel(const uint32_t* __restrict__ packed,
                       const uint32_t* __restrict__ dict, int dict_len,
                       uint32_t* __restrict__ out, int nblocks) {
  extern __shared__ uint32_t sdict[];
  if constexpr (kShared) {
    // kFill independent loads in flight per thread: a one-load-at-a-time
    // loop waits a full memory latency per 128 entries
    constexpr int kFill = 16;
    const int step = blockDim.x;
    int i = threadIdx.x;
    for (; i + (kFill - 1) * step < dict_len; i += kFill * step) {
      uint32_t v[kFill];
#pragma unroll
      for (int u = 0; u < kFill; ++u) v[u] = __ldg(dict + i + u * step);
#pragma unroll
      for (int u = 0; u < kFill; ++u) sdict[i + u * step] = v[u];
    }
    for (; i < dict_len; i += step) sdict[i] = __ldg(dict + i);
    __syncthreads();
  }
  const int lane = threadIdx.x;
  const int32_t last = dict_len - 1;
  for (size_t b = blockIdx.x; b < static_cast<size_t>(nblocks);
       b += gridDim.x) {
    const uint32_t* block = packed + b * K * rt::kLanes;
    uint32_t* o = out + b * rt::kBlock + lane;
    rt::unpack_lane<K>(block, lane, [&](int s, uint32_t v) {
      int32_t c = static_cast<int32_t>(v);
      c = c < 0 ? 0 : (c > last ? last : c);
      if constexpr (kShared) {
        o[s * rt::kLanes] = sdict[c];
      } else {
        o[s * rt::kLanes] = __ldg(dict + c);
      }
    });
  }
}

template <int K, bool kShared>
cudaError_t launch(const void* packed, const void* dict, int dict_len,
                   void* out, int nblocks, cudaStream_t stream) {
  auto kernel = dict_decode_kernel<K, kShared>;
  static const rt::Setup setup = rt::make_setup(kernel, rt::kLanes, kShared);
  if (setup.err != cudaSuccess) return setup.err;
  // the shared branch fits as many CTAs per SM as this dictionary leaves room for
  const size_t smem = kShared ? static_cast<size_t>(dict_len) * 4 : 0;
  const int grid = rt::grid_size(setup, smem, nblocks);
  kernel<<<grid, rt::kLanes, smem, stream>>>(
      static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dict),
      dict_len, static_cast<uint32_t*>(out), nblocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_dict_decode(const void* packed, const void* dict,
                              int dict_len, void* out, int nblocks, int k,
                              int use_shared, void* stream) {
  if (nblocks <= 0 || dict_len <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return use_shared ? launch<K, true>(packed, dict, dict_len, out, nblocks, s)
                      : launch<K, false>(packed, dict, dict_len, out, nblocks, s);
  });
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// Batched DICT decode: many pages' code blocks stacked along the block axis,
// each block looking up its own page's dictionary.
// (nblocks, k, 128) codes + (P, Dmax) dictionaries + (P,) true sizes +
// (nblocks,) page index -> (nblocks, 32, 128).
//
// Replaces: dict_decode_batch_pallas, repro/kernels/dict_decode.py:97, whose
// caller gathers a whole dictionary row per block on the host
// (repro/kernels/ops.py:351). Semantics follow the reference's
// _ref_dict_decode_batch (ops.py:265-271): block b clips each code to
// [0, max(size[page[b]], 1) - 1] of its own page, then reads that entry as
// a 32-bit word. Sizes are also capped at Dmax and a page index is clamped
// into [0, P), so no input can read outside the dictionaries.
//
// Bound: bytes. Per block 512*k bytes of codes in and 16 KiB out, plus each
// page's true dictionary (4*size bytes) and the 4-byte page index and size
// read once: (512*k + 16384 + 4) * nblocks + 4 * (sum of sizes + P) bytes
// over 3.35 TB/s on an H100.
//
// Design: the dictionaries stay where they are, one row per page; nothing
// is gathered per block on the host. One CTA of 128 threads per block, one
// thread per lane: the thread reads the block's page and size once, unpacks
// its 32 codes in registers (rt::unpack_lane) and gathers each entry through
// the read-only cache (__ldg). A page's dictionary serves all of its blocks
// (16 per 65,536-row row group), and a 92-row-group stack of 16,384-entry
// dictionaries is 6 MB, so the gathers are served from L2 after the first
// touch. Code loads and value stores are coalesced.
// ---------------------------------------------------------------------------

namespace {

template <int K>
__global__ void __launch_bounds__(rt::kLanes)
    dict_decode_batch_kernel(const uint32_t* __restrict__ packed,
                             const uint32_t* __restrict__ dicts, int dmax,
                             int n_pages, const int32_t* __restrict__ sizes,
                             const int32_t* __restrict__ page,
                             uint32_t* __restrict__ out) {
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  int p = __ldg(page + b);
  p = p < 0 ? 0 : (p >= n_pages ? n_pages - 1 : p);
  int size = __ldg(sizes + p);
  size = size < 1 ? 1 : (size > dmax ? dmax : size);
  const int32_t last = size - 1;
  const uint32_t* dict = dicts + static_cast<size_t>(p) * dmax;
  uint32_t* o = out + b * rt::kBlock + lane;
  rt::unpack_lane<K>(packed + b * K * rt::kLanes, lane, [&](int s, uint32_t v) {
    int32_t c = static_cast<int32_t>(v);
    c = c < 0 ? 0 : (c > last ? last : c);
    o[s * rt::kLanes] = __ldg(dict + c);
  });
}

}  // namespace

extern "C" int rt_dict_decode_batch(const void* packed, const void* dicts,
                                    int dmax, int n_pages, const void* sizes,
                                    const void* page, void* out, int nblocks,
                                    int k, void* stream) {
  if (nblocks <= 0 || dmax <= 0 || n_pages <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    dict_decode_batch_kernel<K><<<nblocks, rt::kLanes, 0, s>>>(
        static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dicts),
        dmax, n_pages, static_cast<const int32_t*>(sizes),
        static_cast<const int32_t*>(page), static_cast<uint32_t*>(out));
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}
