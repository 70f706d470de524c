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
// Design: dictionary entries move as raw 32-bit words, so one kernel is exact
// for int32 and float32 dictionaries alike. Lookups read the dictionary in
// place through the read-only cache (__ldg): there is no fill. A CTA of
// kGroups * 128 = 512 threads decodes one block at a time in a grid-stride
// walk: thread (g, l) owns rows 8g .. 8g + 7 of lane l and loads only the
// code words that hold them (coalesced across the warp), so a one-row-group
// launch of 16 blocks keeps 16 warps of lookups in flight on each of 16 SMs,
// and the next block's words load before this block's lookups. The grid is
// as many CTAs as fit at once, up to one per block.
// Timed on an H100 (PERF.md, section 6): staging the dictionary in
// shared memory, by threads or by 1-D bulk copies (alone or multicast over
// clusters of 2 to 16 CTAs), lost to __ldg at one row group for every D and
// at the stack for D up to 45,000, tied it at 50,000 and won only above
// that over 184 blocks or more: launches and dictionaries larger than the
// writer's row groups make (16 blocks; its automatic DICT choice stops at
// 16,384 entries). Splitting a 65,536-entry dictionary over a cluster's
// shared memory (mapa lookups) took 1.5-2.4 times as long as __ldg.

#include "common.cuh"

namespace {

constexpr int kGroups = 4;                           // row groups per block
constexpr int kThreads = kGroups * rt::kLanes;       // threads per CTA
constexpr int kRowsPer = rt::kRows / kGroups;        // rows a thread decodes
static_assert(rt::kRows % kGroups == 0, "row groups must split a block's rows");

// The grid-stride walk of the threads of row group G: rows G * kRowsPer ..
// of every block this CTA takes. The next block's words load before this
// block's lookups.
template <int K, int G>
__device__ __forceinline__ void walk(const uint32_t* __restrict__ packed,
                                     const uint32_t* __restrict__ dict, int dict_len,
                                     uint32_t* __restrict__ out, int nblocks) {
  const int lane = threadIdx.x % rt::kLanes;
  const int32_t last = dict_len - 1;
  const size_t step = gridDim.x;
  rt::Words<K, G * kRowsPer, kRowsPer> words;
  size_t b = blockIdx.x;
  if (b < static_cast<size_t>(nblocks)) words.load(packed + b * K * rt::kLanes, lane);
  for (; b < static_cast<size_t>(nblocks); b += step) {
    uint32_t code[kRowsPer];
    words.values(code);
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {  // clip to [0, last]
      const int32_t c = static_cast<int32_t>(code[i]);
      code[i] = static_cast<uint32_t>(c < 0 ? 0 : (c > last ? last : c));
    }
    if (b + step < static_cast<size_t>(nblocks))
      words.load(packed + (b + step) * K * rt::kLanes, lane);
    uint32_t* o = out + b * rt::kBlock + G * kRowsPer * rt::kLanes + lane;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) o[i * rt::kLanes] = __ldg(dict + code[i]);
  }
}

// walk<K, group> for the runtime `group` (uniform across each warp).
template <int K, int G = 0>
__device__ __forceinline__ void walk_group(int group, const uint32_t* __restrict__ packed,
                                           const uint32_t* __restrict__ dict, int dict_len,
                                           uint32_t* __restrict__ out, int nblocks) {
  if constexpr (G + 1 < kGroups) {
    if (group != G) {
      walk_group<K, G + 1>(group, packed, dict, dict_len, out, nblocks);
      return;
    }
  }
  walk<K, G>(packed, dict, dict_len, out, nblocks);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    dict_decode_kernel(const uint32_t* __restrict__ packed,
                       const uint32_t* __restrict__ dict, int dict_len,
                       uint32_t* __restrict__ out, int nblocks) {
  walk_group<K>(threadIdx.x / rt::kLanes, packed, dict, dict_len, out, nblocks);
}

template <int K>
cudaError_t launch(const void* packed, const void* dict, int dict_len, void* out, int nblocks,
                   cudaStream_t stream) {
  auto kernel = dict_decode_kernel<K>;
  static const rt::Setup setup = rt::make_setup(kernel, kThreads, false);
  if (setup.err != cudaSuccess) return setup.err;
  kernel<<<rt::grid_size(setup, 0, nblocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dict), dict_len,
      static_cast<uint32_t*>(out), nblocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_dict_decode(const void* packed, const void* dict, int dict_len, void* out,
                              int nblocks, int k, void* stream) {
  if (nblocks <= 0 || dict_len <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return launch<K>(packed, dict, dict_len, out, nblocks, s);
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
