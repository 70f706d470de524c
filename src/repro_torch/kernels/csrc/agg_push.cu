// Aggregate pushdown: per-block partial accumulators of a masked, grouped
// aggregate, and the same fused with the BITPACK unpack.
//
// grouped_agg: (nblocks, 4096) int32|float32 values + (nblocks, 4096) int32
// group ids + (nblocks, 4096) bool|int32 mask -> 5 x (nblocks, G), G <= 128:
// cnt, s0, s1, mn, mx.
// fused_agg: (nblocks, k, 128) packed words + mask -> 5 x (nblocks, 1).
//
// Replaces: grouped_agg_pallas, repro/kernels/agg_push.py:59, and
// fused_agg_pallas, repro/kernels/agg_push.py:105. Semantics follow
// repro/kernels/ref.py grouped_agg (ref.py:230-264): a row counts where
// mask != 0 and 0 <= gid < G; for int values s0 is the sum of v >> 16
// (arithmetic shift) and s1 the sum of v & 0xFFFF, both exact in int32 for a
// 4096-row block; for float values s0 is the float32 sum and s1 zeros; mn and
// mx carry the identity fills (INT32_MAX / INT32_MIN, +inf / -inf) where no
// row counts. The output planes have the reference's dtypes
// (repro/kernels/agg_push.py:44-46).
//
// Bounds: bytes.
//   grouped_agg  (4 + 4 + mask bytes) * 4096 per block in, 5 * 4 * G per
//                block out.
//   fused_agg    512*k + mask bytes * 4096 per block in, 20 bytes out; the
//                decoded value column never reaches device memory.
// Over 3.35 TB/s on an H100.
//
// Design, grouped_agg: one CTA of 256 threads per 4096-row block; thread t
// owns rows t + 256*i, i = 0..15, so each step's loads are coalesced.
//   - Integer planes (cnt, the int sums, the int min/max, and the float
//     min/max taken on the bits' order) are exact in any order. Each step,
//     the warp splits into lanes of equal group id
//     (cooperative_groups::labeled_partition over __match_any_sync), each
//     such set reduces in registers (__reduce_*_sync), and one lane per set
//     adds into the group's shared-memory cell with an integer atomic: at
//     most one shared atomic per (warp, group, plane) per step.
//   - The float sum is not exact in any order, and float atomics would make
//     its order the scheduler's. Its order is fixed instead, and the plain
//     version (kernels/ref.py grouped_agg) performs the same float32 adds:
//     thread t adds its rows in order i = 0..15 into its own slot of the
//     group, slot[g][t] in shared memory (bank t % 32, conflict-free); then
//     the 256 slots of each group fold by a halving tree, slot[j] +=
//     slot[j + s] for s = 128, 64, ..., 1, with a barrier between levels.
//     256 slots x 128 groups x 4 bytes is 128 KiB, so the launcher raises
//     the kernel's dynamic shared-memory limit to the card's opt-in maximum
//     on its first launch.
//   - Float min/max: a NaN member makes the cell NaN (0x7FC00000), as
//     jnp.min/max propagate it (fminf/fmaxf would drop it); other values
//     compare as order-preserving integer keys of their bits, so -0.0 is
//     below +0.0 whatever the order of arrival.
// Design, fused_agg: one CTA of 128 threads per block, one thread per lane.
// Each thread unpacks its 32 values in registers (rt::unpack_lane), reads the
// matching mask entries (coalesced across the warp), and keeps cnt, the two
// partial sums, min and max in registers; a warp reduces each with one
// __reduce_*_sync, and thread 0 combines the four warps' results. Every plane
// is an integer, so the result is exact.

#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                   // grouped_agg CTA
constexpr int kSteps = rt::kBlock / kThreads;   // 16 rows per thread
constexpr int kMaxGroups = 128;                 // MAX_GROUPS
constexpr int kWarps = rt::kLanes / 32;         // fused_agg CTA: 4 warps
constexpr int32_t kIntMinIdent = 0x7FFFFFFF;    // AGG_INT_MIN_IDENT
constexpr int32_t kIntMaxIdent = -0x7FFFFFFF - 1;  // AGG_INT_MAX_IDENT
constexpr int32_t kPosInfKey = 0x7F800000;      // key of +inf (AGG_FLT_MIN_IDENT)
constexpr int32_t kNegInfKey = -0x7F800000 - 1; // key of -inf: 0x807FFFFF
constexpr uint32_t kNaNBits = 0x7FC00000u;

// float bits -> a signed key in the floats' order; its own inverse
__device__ __forceinline__ int32_t float_key(int32_t bits) {
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

template <bool kFloat, typename MaskT>
__global__ void __launch_bounds__(kThreads)
    grouped_agg_kernel(const uint32_t* __restrict__ values,
                       const int32_t* __restrict__ gids,
                       const MaskT* __restrict__ mask, int n_groups,
                       int32_t* __restrict__ cnt, uint32_t* __restrict__ s0,
                       int32_t* __restrict__ s1, uint32_t* __restrict__ mn,
                       uint32_t* __restrict__ mx) {
  extern __shared__ int32_t smem[];
  const int G = n_groups;
  int32_t* s_cnt = smem;
  int32_t* s_hi = s_cnt + G;  // int sum of v >> 16
  int32_t* s_lo = s_hi + G;   // int sum of v & 0xFFFF
  int32_t* s_mn = s_lo + G;   // int min, or the key of the float min
  int32_t* s_mx = s_mn + G;
  int32_t* s_nan = s_mx + G;  // float cells with a NaN member
  float* slots = reinterpret_cast<float*>(s_nan + G);  // [G][kThreads], float only

  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int g = t; g < G; g += kThreads) {
    s_cnt[g] = 0;
    s_hi[g] = 0;
    s_lo[g] = 0;
    s_mn[g] = kFloat ? kPosInfKey : kIntMinIdent;
    s_mx[g] = kFloat ? kNegInfKey : kIntMaxIdent;
    s_nan[g] = 0;
  }
  if constexpr (kFloat) {
    for (int i = t; i < G * kThreads; i += kThreads) slots[i] = 0.0f;
  }
  __syncthreads();

  const auto warp = cg::tiled_partition<32>(cg::this_thread_block());
  const size_t base = b * rt::kBlock;
  for (int i = 0; i < kSteps; ++i) {
    const size_t row = base + i * kThreads + t;
    const uint32_t w = __ldg(values + row);
    const int32_t g = __ldg(gids + row);
    const bool counted = (mask[row] != 0) && g >= 0 && g < G;
    // every lane of the warp takes part; uncounted lanes form one set whose
    // results are dropped
    const int label = counted ? g : -1;
    const auto set = cg::labeled_partition(warp, label);
    const int one = 1;
    const int n = cg::reduce(set, one, cg::plus<int>());
    if constexpr (kFloat) {
      const float x = __uint_as_float(w);
      if (counted) slots[g * kThreads + t] += x;
      const bool nan = x != x;
      const int32_t key = float_key(static_cast<int32_t>(w));
      // a NaN row takes part in neither key; it flags its cell instead
      const int32_t lo_key = nan ? kPosInfKey : key;
      const int32_t hi_key = nan ? kNegInfKey : key;
      const int is_nan = nan ? 1 : 0;
      const int32_t lo = cg::reduce(set, lo_key, cg::less<int>());
      const int32_t hi = cg::reduce(set, hi_key, cg::greater<int>());
      const int any_nan = cg::reduce(set, is_nan, cg::greater<int>());
      if (counted && set.thread_rank() == 0) {
        atomicAdd(&s_cnt[g], n);
        atomicMin(&s_mn[g], lo);
        atomicMax(&s_mx[g], hi);
        if (any_nan) atomicOr(&s_nan[g], 1);
      }
    } else {
      const int32_t v = static_cast<int32_t>(w);
      const int32_t hi16 = v >> 16;
      const int32_t lo16 = v & 0xFFFF;
      const int32_t hs = cg::reduce(set, hi16, cg::plus<int>());
      const int32_t ls = cg::reduce(set, lo16, cg::plus<int>());
      const int32_t lo = cg::reduce(set, v, cg::less<int>());
      const int32_t hi = cg::reduce(set, v, cg::greater<int>());
      if (counted && set.thread_rank() == 0) {
        atomicAdd(&s_cnt[g], n);
        atomicAdd(&s_hi[g], hs);
        atomicAdd(&s_lo[g], ls);
        atomicMin(&s_mn[g], lo);
        atomicMax(&s_mx[g], hi);
      }
    }
  }
  __syncthreads();

  if constexpr (kFloat) {
    // the fixed-order fold of each group's 256 slots
    for (int s = kThreads / 2; s >= 1; s >>= 1) {
      for (int idx = t; idx < G * s; idx += kThreads) {
        const int g = idx / s;
        const int j = idx - g * s;
        slots[g * kThreads + j] += slots[g * kThreads + j + s];
      }
      __syncthreads();
    }
  }

  for (int g = t; g < G; g += kThreads) {
    const size_t o = b * G + g;
    cnt[o] = s_cnt[g];
    if constexpr (kFloat) {
      s0[o] = __float_as_uint(slots[g * kThreads]);
      s1[o] = 0;
      mn[o] = s_nan[g] ? kNaNBits : static_cast<uint32_t>(float_key(s_mn[g]));
      mx[o] = s_nan[g] ? kNaNBits : static_cast<uint32_t>(float_key(s_mx[g]));
    } else {
      s0[o] = static_cast<uint32_t>(s_hi[g]);
      s1[o] = s_lo[g];
      mn[o] = static_cast<uint32_t>(s_mn[g]);
      mx[o] = static_cast<uint32_t>(s_mx[g]);
    }
  }
}

template <int K, typename MaskT>
__global__ void __launch_bounds__(rt::kLanes)
    fused_agg_kernel(const uint32_t* __restrict__ packed,
                     const MaskT* __restrict__ mask, int32_t* __restrict__ cnt,
                     int32_t* __restrict__ s0, int32_t* __restrict__ s1,
                     int32_t* __restrict__ mn, int32_t* __restrict__ mx) {
  __shared__ int32_t part[5][kWarps];
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  const MaskT* m = mask + b * rt::kBlock + lane;
  int32_t n = 0, hs = 0, ls = 0, lo = kIntMinIdent, hi = kIntMaxIdent;
  rt::unpack_lane<K>(packed + b * K * rt::kLanes, lane, [&](int s, uint32_t w) {
    if (m[s * rt::kLanes] != 0) {
      const int32_t v = static_cast<int32_t>(w);
      n += 1;
      hs += v >> 16;
      ls += v & 0xFFFF;
      lo = v < lo ? v : lo;
      hi = v > hi ? v : hi;
    }
  });
  n = __reduce_add_sync(0xffffffffu, n);
  hs = __reduce_add_sync(0xffffffffu, hs);
  ls = __reduce_add_sync(0xffffffffu, ls);
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int w = lane >> 5;
  if ((lane & 31) == 0) {
    part[0][w] = n;
    part[1][w] = hs;
    part[2][w] = ls;
    part[3][w] = lo;
    part[4][w] = hi;
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      n += part[0][i];
      hs += part[1][i];
      ls += part[2][i];
      lo = part[3][i] < lo ? part[3][i] : lo;
      hi = part[4][i] > hi ? part[4][i] : hi;
    }
    cnt[b] = n;
    s0[b] = hs;
    s1[b] = ls;
    mn[b] = lo;
    mx[b] = hi;
  }
}

template <bool kFloat, typename MaskT>
cudaError_t launch_grouped(const void* values, const void* gids,
                           const void* mask, int n_groups, void* cnt, void* s0,
                           void* s1, void* mn, void* mx, int nblocks,
                           cudaStream_t stream) {
  auto kernel = grouped_agg_kernel<kFloat, MaskT>;
  static const rt::Setup setup = rt::make_setup(kernel, kThreads, true);
  if (setup.err != cudaSuccess) return setup.err;
  const size_t smem = (6 * static_cast<size_t>(n_groups) +
                       (kFloat ? static_cast<size_t>(n_groups) * kThreads : 0)) * 4;
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(values), static_cast<const int32_t*>(gids),
      static_cast<const MaskT*>(mask), n_groups, static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(s0), static_cast<int32_t*>(s1),
      static_cast<uint32_t*>(mn), static_cast<uint32_t*>(mx));
  return cudaGetLastError();
}

template <int K, typename MaskT>
cudaError_t launch_fused(const void* packed, const void* mask, void* cnt,
                         void* s0, void* s1, void* mn, void* mx, int nblocks,
                         cudaStream_t stream) {
  fused_agg_kernel<K, MaskT><<<nblocks, rt::kLanes, 0, stream>>>(
      static_cast<const uint32_t*>(packed), static_cast<const MaskT*>(mask),
      static_cast<int32_t*>(cnt), static_cast<int32_t*>(s0),
      static_cast<int32_t*>(s1), static_cast<int32_t*>(mn),
      static_cast<int32_t*>(mx));
  return cudaGetLastError();
}

}  // namespace

// is_float: 0 int32 values, 1 float32. mask_kind: 0 bool (1 byte), 1 int32.
extern "C" int rt_grouped_agg(const void* values, const void* gids,
                              const void* mask, int n_groups, int is_float,
                              int mask_kind, void* cnt, void* s0, void* s1,
                              void* mn, void* mx, int nblocks, void* stream) {
  if (nblocks <= 0 || n_groups < 1 || n_groups > kMaxGroups ||
      (mask_kind != 0 && mask_kind != 1))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_float) {
    err = mask_kind ? launch_grouped<true, int32_t>(values, gids, mask, n_groups, cnt, s0, s1, mn, mx, nblocks, s)
                    : launch_grouped<true, uint8_t>(values, gids, mask, n_groups, cnt, s0, s1, mn, mx, nblocks, s);
  } else {
    err = mask_kind ? launch_grouped<false, int32_t>(values, gids, mask, n_groups, cnt, s0, s1, mn, mx, nblocks, s)
                    : launch_grouped<false, uint8_t>(values, gids, mask, n_groups, cnt, s0, s1, mn, mx, nblocks, s);
  }
  return static_cast<int>(err);
}

extern "C" int rt_fused_agg(const void* packed, const void* mask, int mask_kind,
                            void* cnt, void* s0, void* s1, void* mn, void* mx,
                            int nblocks, int k, void* stream) {
  if (nblocks <= 0 || (mask_kind != 0 && mask_kind != 1))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return mask_kind
               ? launch_fused<K, int32_t>(packed, mask, cnt, s0, s1, mn, mx, nblocks, s)
               : launch_fused<K, uint8_t>(packed, mask, cnt, s0, s1, mn, mx, nblocks, s);
  });
  return static_cast<int>(err);
}
