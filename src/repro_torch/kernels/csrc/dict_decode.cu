// DICT decode: unpack k-bit codes, clip each to its dictionary's true length
// and look it up.  One walk serves both kernels of this file.
//
// dict_decode: (nblocks, k, 128) packed codes + (D,) dictionary ->
// (nblocks, 32, 128).  Replaces dict_decode_pallas,
// repro/kernels/dict_decode.py:146.  Semantics follow repro/kernels/ref.py
// dict_decode: jnp.take(dict, codes, mode="clip") with D the TRUE dictionary
// length (a code >= D reads entry D-1; with k = 32 a negative code reads
// entry 0).
//
// dict_decode_batch: many pages' code blocks stacked along the block axis,
// each block looking up its own page's dictionary.  (nblocks, k, 128) codes +
// (P, Dmax) dictionaries + (P,) true sizes + (nblocks,) page index ->
// (nblocks, 32, 128).  Replaces dict_decode_batch_pallas,
// repro/kernels/dict_decode.py:97, whose caller gathers a whole dictionary
// row per block on the host (repro/kernels/ops.py:351).  Semantics follow
// the reference's _ref_dict_decode_batch (ops.py:265-271): block b clips each
// code to [0, max(size[page[b]], 1) - 1] of its own page, then reads that
// entry.  Sizes are also capped at Dmax and a page index is clamped into
// [0, P), so no input can read outside the dictionaries.
//
// Bound: bytes.  Per block 512*k bytes of codes in and 16 KiB out; the
// dictionary (4*D bytes) read once, or each page's true dictionary (4*size
// bytes) and the 4-byte page index and size: (512*k + 16384) * nblocks +
// 4*D, or (512*k + 16384 + 4) * nblocks + 4 * (sum of sizes + P) bytes,
// over 3.35 TB/s on an H100.
//
// Design: dictionary entries move as raw 32-bit words, so one kernel is exact
// for int32 and float32 dictionaries alike.  Lookups read the dictionaries in
// place through the read-only cache (__ldg), with no fill; the batch's stay
// one row a page, and nothing is gathered per block.  A CTA of 512 threads
// decodes one block at a time: thread (g, l) owns rows 8g .. 8g + 7 of lane
// l and loads only the code words that hold them (rt::Words, coalesced
// across the warp), and the next block's words load before this block's
// lookups.  The grid is as many CTAs as fit at once, up to one per block.
// Three arms, by template parameter:
// - dict_decode: each CTA takes every gridDim.x-th block;
// - dict_decode_batch: each CTA takes an equal run of consecutive blocks, so
//   a page's blocks (16 a row group) pass through one SM, whose L1 cache
//   holds the page's dictionary after the first of them (taking every
//   gridDim.x-th block sent each block of a 92-page stack to another SM and
//   its lookups to L2).  A block's header (its page, clamped, and that
//   page's size) is a chain of two dependent loads: the page index loads two
//   blocks ahead and the size one block ahead, beside the next block's words;
// - dict_decode_batch with Dmax <= 32 (flags, modes, discounts): the same
//   runs on CTAs of 128 threads, a thread a lane decoding all 32 rows, so
//   that each thread keeps 32 lookups and stores in flight and loads a
//   block's header once for 32 values.
// Timed on an H100 against this design, all bit-exact (PERF.md, section 6; cold
// us, k = 14 over 92 pages of ~16.1K entries / k = 4 over 184 pages of 11 and
// 9): each CTA taking every gridDim.x-th block, 32.1 / 25.7, and with 128 or
// 256 threads (and the page index one block ahead) 35.1 / 25.2 or 32.2 / 25.1;
// runs of blocks on 512 threads for Dmax <= 32, 27.8 at k = 4, and on 128
// threads above it, 44.9 at k = 14; the small dictionaries in registers, lane j
// of each warp holding entry j, looked up by warp shuffles (__shfl_sync): 25.4
// against 23.7 at k = 4 (and 0.2-0.5 slower over 512-thread runs of blocks), so
// the lookups stay loads; an L2 prefetch of the next page's dictionary by the
// copy engine (cp.async.bulk.prefetch.L2) when a CTA's next block starts a
// page: 25.0 against 24.9 at k = 14 and 0.9 slower at k = 12 (over the strided
// walk it saved 5.0 where registers budgeted for 4 CTAs an SM had left the
// lookups waiting on L2, and cost 4.7 without that budget); the page index one
// block ahead, not two: 29.3 against 24.9; registers budgeted for 3 CTAs an SM:
// 24.7-24.8 against 24.6-24.9 at k = 14, spilling from k = 31; for 4, 44.2 over
// the strided walk.  For dict_decode, staging the dictionary in shared memory,
// by threads or by 1-D bulk copies (alone or multicast over clusters of 2 to 16
// CTAs), lost to __ldg at one row group for every D and at the stack for D up
// to 45,000, tied it at 50,000 and won only above that over 184 blocks or more:
// launches and dictionaries larger than the writer's row groups make (16
// blocks; its automatic DICT choice stops at 16,384 entries).  Splitting a
// 65,536-entry dictionary over a cluster's shared memory (mapa lookups) took
// 1.5-2.4 times as long as __ldg.

#include "common.cuh"

namespace {

// The arms of the walk.
constexpr int kOne = 0;    // dict_decode: one dictionary
constexpr int kPages = 1;  // dict_decode_batch: a page row a block
constexpr int kSmall = 2;  // dict_decode_batch with Dmax <= kSmallMax
constexpr int kSmallMax = 32;

// Row groups a block's 32 rows split into, one 128-thread group of a CTA
// each: 4 (8 rows a thread), but 1 for kSmall (a thread a lane, 32 rows).
__host__ __device__ constexpr int groups(int arm) { return arm == kSmall ? 1 : 4; }
__host__ __device__ constexpr int threads(int arm) { return groups(arm) * rt::kLanes; }

struct Args {
  const uint32_t* packed;
  const uint32_t* dict;   // kOne: (D,); else (P, Dmax), a row a page
  int32_t dict_len;       // kOne: D; else Dmax
  int32_t n_pages;        // else: P
  const int32_t* sizes;   // else: (P,) true sizes
  const int32_t* page;    // else: (nblocks,) the page of each block
  uint32_t* out;
  int nblocks;
  int chunk;              // else: consecutive blocks a CTA takes
};

// One block's dictionary as its lookups see it: the row and the last index
// a code clips to.
struct Dict {
  const uint32_t* row;
  int32_t last;
};

__device__ __forceinline__ int page_of(const Args& a, size_t b) {
  const int p = __ldg(a.page + b);
  return p < 0 ? 0 : (p >= a.n_pages ? a.n_pages - 1 : p);
}

__device__ __forceinline__ Dict page_dict(const Args& a, int p) {
  const int size = __ldg(a.sizes + p);
  return {a.dict + static_cast<size_t>(p) * a.dict_len,
          (size < 1 ? 1 : (size > a.dict_len ? a.dict_len : size)) - 1};
}

// The walk of the threads of row group G: rows G * kRowsPer .. of every
// block this CTA takes.  kOne takes every gridDim.x-th block from
// blockIdx.x; the batch arms take a.chunk consecutive blocks, so that the
// blocks of one page (16 a row group) follow each other through one CTA and
// its SM's L1 cache.  The next block's words (and dictionary header) load
// before this block's lookups.
template <int K, int G, int kArm>
__device__ __forceinline__ void walk(const Args& a) {
  constexpr int kRowsPer = rt::kRows / groups(kArm);  // rows a thread decodes
  const int lane = threadIdx.x % rt::kLanes;
  size_t b, end, step;
  if constexpr (kArm == kOne) {
    b = blockIdx.x, end = static_cast<size_t>(a.nblocks), step = gridDim.x;
  } else {
    b = static_cast<size_t>(blockIdx.x) * a.chunk, step = 1;
    end = b + a.chunk < static_cast<size_t>(a.nblocks) ? b + a.chunk
                                                       : static_cast<size_t>(a.nblocks);
  }
  rt::Words<K, G * kRowsPer, kRowsPer> words;
  Dict d{a.dict, a.dict_len - 1};  // kOne: every block's
  int next_page = 0;               // the page of the block after this one
  if (b < end) {
    words.load(a.packed + b * K * rt::kLanes, lane);
    if constexpr (kArm != kOne) {
      d = page_dict(a, page_of(a, b));
      if (b + step < end) next_page = page_of(a, b + step);
    }
  }
  for (; b < end; b += step) {
    uint32_t code[kRowsPer];
    words.values(code);
    const Dict cur = d;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {  // clip to [0, last]
      const int32_t c = static_cast<int32_t>(code[i]);
      code[i] = static_cast<uint32_t>(c < 0 ? 0 : (c > cur.last ? cur.last : c));
    }
    if (b + step < end) {
      words.load(a.packed + (b + step) * K * rt::kLanes, lane);
      if constexpr (kArm != kOne) {
        d = page_dict(a, next_page);
        if (b + 2 * step < end) next_page = page_of(a, b + 2 * step);
      }
    }
    uint32_t* o = a.out + b * rt::kBlock + G * kRowsPer * rt::kLanes + lane;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) o[i * rt::kLanes] = __ldg(cur.row + code[i]);
  }
}

// walk<K, group, kArm> for the runtime `group` (uniform across each warp).
template <int K, int kArm, int G = 0>
__device__ __forceinline__ void walk_group(int group, const Args& a) {
  if constexpr (G + 1 < groups(kArm)) {
    if (group != G) {
      walk_group<K, kArm, G + 1>(group, a);
      return;
    }
  }
  walk<K, G, kArm>(a);
}

template <int K>
__global__ void __launch_bounds__(threads(kOne)) dict_decode_kernel(const Args a) {
  walk_group<K, kOne>(threadIdx.x / rt::kLanes, a);
}

template <int K, int kArm>
__global__ void __launch_bounds__(threads(kArm)) dict_decode_batch_kernel(const Args a) {
  walk_group<K, kArm>(threadIdx.x / rt::kLanes, a);
}

template <int K, int kArm>
cudaError_t launch_batch(Args a, cudaStream_t stream) {
  auto kernel = dict_decode_batch_kernel<K, kArm>;
  static const rt::Setup setup = rt::make_setup(kernel, threads(kArm), false);
  if (setup.err != cudaSuccess) return setup.err;
  // as many CTAs as fit, each taking an equal run of blocks (the last one
  // fewer), and no CTA without a block
  const int fit = rt::grid_size(setup, 0, a.nblocks);
  a.chunk = (a.nblocks + fit - 1) / fit;
  kernel<<<(a.nblocks + a.chunk - 1) / a.chunk, threads(kArm), 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_dict_decode(const void* packed, const void* dict, int dict_len, void* out,
                              int nblocks, int k, void* stream) {
  if (nblocks <= 0 || dict_len <= 0) return cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dict),
               dict_len, 0, nullptr, nullptr, static_cast<uint32_t*>(out), nblocks, 0};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    auto kernel = dict_decode_kernel<K>;
    static const rt::Setup setup = rt::make_setup(kernel, threads(kOne), false);
    if (setup.err != cudaSuccess) return setup.err;
    kernel<<<rt::grid_size(setup, 0, nblocks), threads(kOne), 0, s>>>(a);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// The arm follows Dmax: a thread a lane for the small dictionaries of flags
// and modes, 8 rows a thread above.
extern "C" int rt_dict_decode_batch(const void* packed, const void* dicts,
                                    int dmax, int n_pages, const void* sizes,
                                    const void* page, void* out, int nblocks,
                                    int k, void* stream) {
  if (nblocks <= 0 || dmax <= 0 || n_pages <= 0) return cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dicts),
               dmax, n_pages, static_cast<const int32_t*>(sizes),
               static_cast<const int32_t*>(page), static_cast<uint32_t*>(out), nblocks, 0};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return dmax <= kSmallMax ? launch_batch<K, kSmall>(a, s) : launch_batch<K, kPages>(a, s);
  });
  return static_cast<int>(err);
}
