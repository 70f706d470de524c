// Fused decode + range filter: unpack k-bit values (or k-bit dictionary
// codes and look them up) and test lo <= v <= hi, writing only the survivor
// mask, with one count per block or per-block bounds.
//
// fused_scan: (nblocks, k, 128) packed [+ (D,) dictionary], int32 lo, hi ->
// (nblocks, 4096) bool, (nblocks,) int32.  Replaces fused_scan_pallas,
// repro/kernels/fused_scan.py:99.  Semantics follow repro/kernels/ref.py
// fused_scan: without a dictionary the values are the unpacked words read as
// int32; with one, each code is clipped to the dictionary's TRUE length
// [0, D-1] and the entry compared in the dictionary's dtype, with the int32
// bounds converted to it (round to nearest for a float32 dictionary, as
// astype does).  The engine calls the dictionary-free arm only: it rewrites a
// DICT predicate onto codes (repro/core/engine.py:458-463).
//
// fused_scan_batch: (nblocks, k, 128) packed + (nblocks,) int32 lo, hi ->
// (nblocks, 4096) bool, block b testing its own lo[b] <= v <= hi[b].
// Replaces fused_scan_batch_pallas, repro/kernels/fused_scan.py:61, with the
// semantics of the reference's _ref_fused_scan_batch
// (repro/kernels/ops.py:284-289).  A block given the empty range (1, 0), as
// the reference pads its stacks, matches nothing.  Mask only, no counts.
//
// Bound: bytes.  Per block 512*k bytes in and 4096 mask bytes out, plus a
// 4-byte count (fused_scan; and the D*4-byte dictionary once) or 8 bytes of
// bounds (fused_scan_batch), over 3.35 TB/s on an H100.  The decoded column
// is never written, which is the point of the fusion.
//
// Design: one walk, three arms (a template parameter): the word arm with one
// (lo, hi) and a count, the dictionary arm (int32 or float32 entries read in
// place through the read-only cache, __ldg, as dict_decode does), and the
// batch arm with per-block bounds and no count.
// - The walk is dict_decode's: CTAs of kGroups * 128 = 512 threads, thread
//   (g, l) owning rows 8g .. 8g + 7 of lane l and loading only the words
//   that hold them (rt::Words); as many CTAs as fit at once, up to one per
//   block, each taking every gridDim.x-th block, its first outside the
//   loop; the next block's words (and bounds) load before this block's
//   compares and stores.  Registers are budgeted for 4 CTAs an SM where
//   that spills nothing (min_ctas).
// - The mask: each thread stages its 8 bytes in shared memory (a warp fills
//   32 contiguous bytes of a row); after one barrier every thread writes 8
//   contiguous bytes of the block's 4 KiB, so a warp stores 256 contiguous
//   bytes, not 32 bytes of each of 8 rows.  Two staging buffers alternate,
//   so that one barrier a block suffices.
// - The count: each warp reduces its rows with __reduce_add_sync into one
//   word of shared memory; the barrier that publishes the staged mask
//   publishes those too, and one thread adds the 16 words.
// The four row groups of a CTA run different instantiations of the walk, so
// the CTA meets at a barrier that is not the same instruction for every warp
// (barrier.sync, not __syncthreads' aligned form); every thread of a CTA
// takes the same blocks, so each meets it equally often.
//
// Timed on an H100 against this design, all bit-exact (PERF.md, section
// 6): one-byte stores straight from registers, 16-byte stores by half
// the threads, one 4 KiB bulk copy a block by the copy engine
// (cp.async.bulk, double-buffered), ballots with 8-byte stores from
// registers, two blocks of words loaded ahead, CTAs of 256 threads (16
// rows a thread) or 128 (a thread a lane, 32 rows), and an unbudgeted
// register count.  Each was slower or tied at the stack: the 16-byte stores
// tied; the bulk copy tied on the word arm and lost 2 us on the dictionary
// arm, so it went with its PTX helpers; the 128-thread walk won only at
// 5,000 blocks and lost the dictionary arm and the one-row-group launch.  At 1,472 blocks
// the kernel streams at ~2.8 TB/s above the ~5.8 us that a one-row-group
// launch takes after an L2 flush; torch's copy of the same bytes took longer.

#include "common.cuh"

namespace {

constexpr int kGroups = 4;                      // row groups per block
constexpr int kThreads = kGroups * rt::kLanes;  // threads per CTA
constexpr int kRowsPer = rt::kRows / kGroups;   // rows a thread tests
constexpr int kWarps = kThreads / 32;
static_assert(rt::kRows % kGroups == 0, "row groups must split a block's rows");

// The arms.  kWords, kIntDict and kFloatDict are the values of the C
// interface's dict_kind.
constexpr int kWords = 0, kIntDict = 1, kFloatDict = 2, kBatch = 3;

// CTAs per SM that each instantiation's registers are budgeted for: 4 (the
// 2,048 threads an SM holds, 32 registers a thread) where that spills
// nothing, else 3 or 2 (ptxas for sm_90a; wider words and the dictionary
// arms' lookups hold more registers).
constexpr int min_ctas(int K, int arm) {
  return arm == kIntDict || arm == kFloatDict ? (K <= 9 ? 4 : K <= 20 ? 3 : 2)
                                              : (K <= 16 ? 4 : K <= 26 ? 3 : 2);
}

struct Args {
  const uint32_t* packed;
  const uint32_t* dict;  // kIntDict, kFloatDict
  int32_t dict_len;
  int32_t lo, hi;        // every arm but kBatch
  const int32_t* lo_b;   // kBatch: per block
  const int32_t* hi_b;
  uint8_t* mask;
  int32_t* counts;       // every arm but kBatch
  int nblocks;
};

// A CTA's shared memory: two blocks' staged masks and warp counts, so that
// staging block i + 1 never waits for block i's mask to be read out.
struct Stage {
  alignas(16) uint8_t mask[2][rt::kBlock];
  int32_t count[2][kWarps];
};

// The grid-stride walk of the threads of row group G: rows G * kRowsPer ..
// of every block this CTA takes.
template <int K, int G, int kArm>
__device__ __forceinline__ void walk(const Args& a, Stage& st) {
  const int lane = threadIdx.x % rt::kLanes;
  const size_t nblocks = static_cast<size_t>(a.nblocks);
  const size_t step = gridDim.x;
  const int32_t last = a.dict_len - 1;
  const float flo = static_cast<float>(a.lo);
  const float fhi = static_cast<float>(a.hi);
  rt::Words<K, G * kRowsPer, kRowsPer> words;
  int32_t lo = a.lo, hi = a.hi;
  auto fetch = [&](size_t b) {
    words.load(a.packed + b * K * rt::kLanes, lane);
    if constexpr (kArm == kBatch) lo = __ldg(a.lo_b + b), hi = __ldg(a.hi_b + b);
  };
  auto test = [&](size_t b, int buf) {
    uint32_t v[kRowsPer];
    words.values(v);
    const int32_t l = lo, h = hi;
    if (b + step < nblocks) fetch(b + step);  // the next block's words, before this block's work
    uint8_t* m = st.mask[buf] + G * kRowsPer * rt::kLanes + lane;
    int32_t n = 0;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      bool keep;
      if constexpr (kArm == kWords || kArm == kBatch) {
        const int32_t x = static_cast<int32_t>(v[i]);
        keep = (x >= l) & (x <= h);
      } else {
        int32_t c = static_cast<int32_t>(v[i]);
        c = c < 0 ? 0 : (c > last ? last : c);
        const uint32_t e = __ldg(a.dict + c);
        if constexpr (kArm == kIntDict) {
          const int32_t x = static_cast<int32_t>(e);
          keep = (x >= l) & (x <= h);
        } else {
          const float x = __uint_as_float(e);
          keep = (x >= flo) & (x <= fhi);
        }
      }
      m[i * rt::kLanes] = keep;
      n += keep;
    }
    if constexpr (kArm != kBatch) {
      n = __reduce_add_sync(0xffffffffu, n);
      if ((threadIdx.x & 31) == 0) st.count[buf][threadIdx.x >> 5] = n;
    }
    rt::cta_barrier();  // the staged mask and the warp counts are complete
    static_assert(rt::kBlock == kThreads * sizeof(uint2), "one 8-byte piece a thread");
    reinterpret_cast<uint2*>(a.mask + b * rt::kBlock)[threadIdx.x] =
        reinterpret_cast<const uint2*>(st.mask[buf])[threadIdx.x];
    if constexpr (kArm != kBatch) {
      if (G == 0 && threadIdx.x == 0) {
        int32_t total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += st.count[buf][w];
        a.counts[b] = total;
      }
    }
  };
  // The grid is never wider than the blocks, so every CTA has a first block.
  // It runs outside the loop: at one row group (16 blocks, one a CTA) the
  // loop around it cost ~0.1-0.2 us of kernel time a launch on an H100.
  size_t b = blockIdx.x;
  fetch(b);
  test(b, 0);
  int buf = 1;
  for (b += step; b < nblocks; b += step, buf ^= 1) test(b, buf);
}

// walk<K, group, kArm> for the runtime `group` (uniform across each warp).
template <int K, int kArm, int G = 0>
__device__ __forceinline__ void walk_group(int group, const Args& a, Stage& st) {
  if constexpr (G + 1 < kGroups) {
    if (group != G) {
      walk_group<K, kArm, G + 1>(group, a, st);
      return;
    }
  }
  walk<K, G, kArm>(a, st);
}

template <int K, int kArm>
__global__ void __launch_bounds__(kThreads, min_ctas(K, kArm))
    fused_scan_kernel(const Args a) {
  __shared__ Stage st;
  walk_group<K, kArm>(threadIdx.x / rt::kLanes, a, st);
}

template <int K>
__global__ void __launch_bounds__(kThreads, min_ctas(K, kBatch))
    fused_scan_batch_kernel(const Args a) {
  __shared__ Stage st;
  walk_group<K, kBatch>(threadIdx.x / rt::kLanes, a, st);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const rt::Setup& setup, const Args& a, cudaStream_t stream) {
  if (setup.err != cudaSuccess) return setup.err;
  kernel<<<rt::grid_size(setup, 0, a.nblocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int K, int kArm>
cudaError_t launch_scan(const Args& a, cudaStream_t stream) {
  auto kernel = fused_scan_kernel<K, kArm>;
  static const rt::Setup setup = rt::make_setup(kernel, kThreads, false);
  return launch(kernel, setup, a, stream);
}

}  // namespace

// dict_kind: 0 without a dictionary (dict may be null), 1 int32, 2 float32.
extern "C" int rt_fused_scan(const void* packed, const void* dict, int dict_len, int dict_kind,
                             int lo, int hi, void* mask, void* counts, int nblocks, int k,
                             void* stream) {
  if (nblocks <= 0 || dict_kind < kWords || dict_kind > kFloatDict ||
      (dict_kind != kWords && dict_len <= 0))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(packed), static_cast<const uint32_t*>(dict),
               dict_len, lo, hi, nullptr, nullptr, static_cast<uint8_t*>(mask),
               static_cast<int32_t*>(counts), nblocks};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    switch (dict_kind) {
      case kIntDict:
        return launch_scan<K, kIntDict>(a, s);
      case kFloatDict:
        return launch_scan<K, kFloatDict>(a, s);
      default:
        return launch_scan<K, kWords>(a, s);
    }
  });
  return static_cast<int>(err);
}

extern "C" int rt_fused_scan_batch(const void* packed, const void* lo, const void* hi,
                                   void* mask, int nblocks, int k, void* stream) {
  if (nblocks <= 0) return cudaErrorInvalidValue;
  const Args a{static_cast<const uint32_t*>(packed), nullptr, 0, 0, 0,
               static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
               static_cast<uint8_t*>(mask), nullptr, nblocks};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    auto kernel = fused_scan_batch_kernel<K>;
    static const rt::Setup setup = rt::make_setup(kernel, kThreads, false);
    return launch(kernel, setup, a, s);
  });
  return static_cast<int>(err);
}
