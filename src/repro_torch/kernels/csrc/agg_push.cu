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
//                decoded value column never reaches device memory. At k <= 6
//                with a bool mask its integer operations (chip_smoke.py's
//                count) bound it instead.
// Over 3.35 TB/s on an H100.
//
// Design, grouped_agg: one warp per 4096-row block; a CTA holds kRegWarps
// blocks on the register path (the last CTA may hold fewer: a warp past the
// last block returns, and no barrier spans warps) and one on the
// shared-memory path, so that a CTA's shared memory is one block's and up to
// 12 fit an SM at G = 128. Lane l owns the rows
// 128 i + 4 l + j (i = 0..31, j = 0..3): each pass i the warp reads 512
// contiguous bytes of values and of ids, one 16-byte vector a lane, and the
// lane's 4 mask entries in one load; the loads of the next kDepth passes are
// issued before the arithmetic of the current kDepth, so a lone warp (a
// 16-block launch) keeps 8 passes in flight. A row counts where mask != 0
// and 0 <= gid < G; a warp
// none of whose 128 rows of a pass counts skips that pass's arithmetic, so
// an uncounted row costs its loads and one test.
//   - The float sum's order is a function of row positions alone (the plain
//     version, kernels/ref.py grouped_agg, performs the same float32 adds):
//     lane l adds its counted rows in row order into its own slot of their
//     group, zero-started; the 32 slots of a group then fold by a halving
//     tree, slot[l] += slot[l + s] for s = 16, 8, ..., 1, which is the
//     warp's shuffle-down tree. A cell with no counted row, or only -0.0
//     rows, stays +0.0. No float atomics, and nothing depends on G, the
//     window's shift or the launch shape.
//   - Integer planes (cnt, the hi/lo int sums, the int min/max, and the
//     float min/max on the bits' order) are exact in any order.
//   - G <= kRegGroups (the ungrouped count or sum, l_returnflag's 3 groups):
//     each lane keeps every group's accumulators in registers, float slots
//     included, and the warp reduces each once at the end with the hardware
//     __reduce_{add,min,max}_sync and the shuffle tree. No shared memory.
//   - Larger G (up to 128): the warp's slots, [G][32] floats (16 KiB at G =
//     128), and its integer cells live in shared memory; lane l touches only
//     column l of the slots (bank l, conflict-free). Per pass, two warp
//     reductions find the smallest and largest counted id: when they agree
//     (a sorted column, a narrow window) the lanes combine their 4 rows in
//     registers, the warp reduces each plane and one lane updates the cell;
//     otherwise each counted row updates its cell with integer shared
//     atomics. The fold takes 32 groups at a time through the halving tree
//     as a transpose (31 shuffles, 5 deep; fold_level), and skips 32 groups
//     none of whose rows counted.
//   - Float min/max: the keys are the bits' order-preserving integer map, so
//     -0.0 is below +0.0 whatever the order of arrival. A NaN row enters the
//     min plane as +inf's key and the max plane as 0x7FFFFFFF, above +inf's
//     key: a cell whose max key passes +inf's has a NaN member and gives NaN
//     (0x7FC00000) in both planes, as jnp.min/max propagate it (fminf/fmaxf
//     would drop it).
// Design, fused_agg: a grid-stride walk of 128-thread CTAs, as many as fit
// at once (rt::make_setup, rt::grid_size), up to one per block. Warp q of a
// CTA owns rows 8q .. 8q + 7 of each block it takes, and lane l packed lanes
// 4l .. 4l + 3, so that row s of its lanes is the 4 block rows whose mask
// grouped_agg's Rows reads in one 4-byte (bool) or 16-byte (int32) load.
// The lane loads only the words that hold its 8 rows, as 16-byte vectors
// (QuadWords), and unpacks its 32 values in registers. Each warp reduces its
// planes with __reduce_*_sync into double-buffered shared words; after the
// block's one barrier, warp 0 reduces the 4 warps' planes the same way.
// Registers are budgeted for 12 CTAs an SM with a bool mask up to k = 12, so
// that the 1,472-block stack runs in one wave.
// Every plane is an integer, so the result is exact in any order.
// Timed on an H100 and dropped (PERF.md, section 6): one warp a block
// (grouped_agg's register path at G = 1), slower at every shape but 5,000
// blocks; fused_scan's 512-thread walk (8 rows of one lane a thread),
// slower at the stack; and this walk with the next block's words and mask
// loaded ahead, which spilled under the budget (k = 3 and 5-12) and lost
// 0.9 us at the stack.

#include "common.cuh"

namespace {

constexpr int kChunk = 4;                       // AGG_CHUNK: rows per lane per pass
constexpr int kPassRows = 32 * kChunk;          // 128 rows per pass (AGG_OWNERS = 32)
constexpr int kPasses = rt::kBlock / kPassRows; // 32 passes per block
constexpr int kDepth = 4;                       // passes loaded ahead
constexpr int kRegGroups = 4;                   // G up to this: register accumulators
constexpr int kRegWarps = 4;                    // blocks per CTA, register path
constexpr int kMaxGroups = 128;                 // MAX_GROUPS
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoGroup = 0xffffffffu;      // above every counted id
constexpr int32_t kIntMinIdent = 0x7FFFFFFF;    // AGG_INT_MIN_IDENT
constexpr int32_t kIntMaxIdent = -0x7FFFFFFF - 1;  // AGG_INT_MAX_IDENT
constexpr int32_t kPosInfKey = 0x7F800000;      // key of +inf (AGG_FLT_MIN_IDENT)
constexpr int32_t kNegInfKey = -0x7F800000 - 1; // key of -inf: 0x807FFFFF
constexpr int32_t kNaNKey = 0x7FFFFFFF;         // a NaN row in the max plane
constexpr uint32_t kNaNBits = 0x7FC00000u;

static_assert(rt::kBlock % (kPassRows * kDepth) == 0, "passes must fill whole batches");
static_assert((32 * kMaxGroups + 3 * kMaxGroups) * 4 <= 48 * 1024,
              "the shared path's dynamic shared memory needs no opt-in");

// float bits -> a signed key in the floats' order; its own inverse
__device__ __forceinline__ int32_t float_key(int32_t bits) {
  return bits ^ ((bits >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(const int4& v, int j) {
  return static_cast<uint32_t>(j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w);
}
__device__ __forceinline__ uint32_t word(uint32_t bytes, int j) {
  return (bytes >> (8 * j)) & 0xFFu;
}

// One lane's 4 rows of one pass: values, ids, mask entries (4 bytes of a
// bool mask, or 4 int32).
template <typename MaskT>
struct Rows {
  using MaskVec = std::conditional_t<sizeof(MaskT) == 1, uint32_t, int4>;
  uint4 v;
  int4 g;
  MaskVec m;
};

// The 4 rows decoded: value bits, id (unsigned, so a negative id is out of
// range), and whether the row counts.
struct Quad {
  uint32_t w[kChunk];
  uint32_t g[kChunk];
  bool c[kChunk];
};

template <typename MaskT>
__device__ __forceinline__ Quad decode(const Rows<MaskT>& r, uint32_t G) {
  Quad q;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    q.w[j] = word(r.v, j);
    q.g[j] = word(r.g, j);
    q.c[j] = word(r.m, j) != 0 && q.g[j] < G;
  }
  return q;
}

// Walks block `b`'s 32 passes for this lane, calling step(quad) on each in
// pass order; the loads of passes p + kDepth .. p + 2 kDepth - 1 are issued
// before the arithmetic of passes p .. p + kDepth - 1.
template <typename MaskT, typename Step>
__device__ __forceinline__ void for_each_pass(const uint32_t* __restrict__ values,
                                              const int32_t* __restrict__ gids,
                                              const MaskT* __restrict__ mask,
                                              size_t b, int lane, uint32_t G,
                                              Step&& step) {
  using MaskVec = typename Rows<MaskT>::MaskVec;
  const size_t base = b * rt::kBlock + lane * kChunk;
  auto load = [&](Rows<MaskT>& r, int p) {
    const size_t row = base + static_cast<size_t>(p) * kPassRows;
    r.v = __ldg(reinterpret_cast<const uint4*>(values + row));
    r.g = __ldg(reinterpret_cast<const int4*>(gids + row));
    r.m = __ldg(reinterpret_cast<const MaskVec*>(mask + row));
  };
  Rows<MaskT> cur[kDepth], nxt[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) load(cur[d], d);
#pragma unroll 1
  for (int p = 0; p < kPasses; p += kDepth) {
    if (p + kDepth < kPasses) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) load(nxt[d], p + kDepth + d);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) step(decode(cur[d], G));
#pragma unroll
    for (int d = 0; d < kDepth; ++d) cur[d] = nxt[d];
  }
}

// G <= kG: every group's accumulators in registers.
template <bool kFloat, typename MaskT, int kG>
__global__ void __launch_bounds__(kRegWarps * 32)
    grouped_agg_regs(const uint32_t* __restrict__ values,
                     const int32_t* __restrict__ gids,
                     const MaskT* __restrict__ mask, int n_groups, int nblocks,
                     int32_t* __restrict__ cnt, uint32_t* __restrict__ s0,
                     int32_t* __restrict__ s1, uint32_t* __restrict__ mn,
                     uint32_t* __restrict__ mx) {
  const int lane = threadIdx.x & 31;
  const size_t b = static_cast<size_t>(blockIdx.x) * kRegWarps + (threadIdx.x >> 5);
  if (b >= static_cast<size_t>(nblocks)) return;
  const uint32_t G = static_cast<uint32_t>(n_groups);
  int32_t n[kG], hs[kG], ls[kG], lo[kG], hi[kG];
  float sum[kG];
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    n[q] = hs[q] = ls[q] = 0;
    sum[q] = 0.0f;
    lo[q] = kFloat ? kPosInfKey : kIntMinIdent;
    hi[q] = kFloat ? kNegInfKey : kIntMaxIdent;
  }
  for_each_pass(values, gids, mask, b, lane, G, [&](const Quad& r) {
    if (!__any_sync(kFull, r.c[0] | r.c[1] | r.c[2] | r.c[3])) return;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        // with kG == 1 a counted row's id is 0
        const bool h = r.c[j] && (kG == 1 || r.g[j] == static_cast<uint32_t>(q));
        n[q] += h ? 1 : 0;
        if constexpr (kFloat) {
          const float x = __uint_as_float(r.w[j]);
          const bool nan = x != x;
          const int32_t key = float_key(static_cast<int32_t>(r.w[j]));
          sum[q] = h ? sum[q] + x : sum[q];
          lo[q] = min(lo[q], h && !nan ? key : kPosInfKey);
          hi[q] = max(hi[q], h ? (nan ? kNaNKey : key) : kNegInfKey);
        } else {
          const int32_t v = static_cast<int32_t>(r.w[j]);
          hs[q] += h ? v >> 16 : 0;
          ls[q] += h ? v & 0xFFFF : 0;
          lo[q] = min(lo[q], h ? v : kIntMinIdent);
          hi[q] = max(hi[q], h ? v : kIntMaxIdent);
        }
      }
    }
  });
#pragma unroll
  for (int q = 0; q < kG; ++q) {
    if (q >= n_groups) break;
    const int32_t nq = __reduce_add_sync(kFull, n[q]);
    const int32_t lq = __reduce_min_sync(kFull, lo[q]);
    const int32_t hq = __reduce_max_sync(kFull, hi[q]);
    const size_t o = b * n_groups + q;
    if constexpr (kFloat) {
      float v = sum[q];
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) v = v + __shfl_down_sync(kFull, v, s);
      if (lane == 0) {
        const bool nan = hq > kPosInfKey;
        cnt[o] = nq;
        s0[o] = __float_as_uint(v);
        s1[o] = 0;
        mn[o] = nan ? kNaNBits : static_cast<uint32_t>(float_key(lq));
        mx[o] = nan ? kNaNBits : static_cast<uint32_t>(float_key(hq));
      }
    } else {
      const int32_t hsq = __reduce_add_sync(kFull, hs[q]);
      const int32_t lsq = __reduce_add_sync(kFull, ls[q]);
      if (lane == 0) {
        cnt[o] = nq;
        s0[o] = static_cast<uint32_t>(hsq);
        s1[o] = lsq;
        mn[o] = static_cast<uint32_t>(lq);
        mx[o] = static_cast<uint32_t>(hq);
      }
    }
  }
}

// The halving tree of 32 groups at once. Lane l holds its own slot of
// groups g0 .. g0 + 31 (+0.0 past G) in v[0..31]; at the level of stride S a
// lane keeps half its groups (the upper half where lane & S) and adds its
// partner's (lane ^ S) slot of each, so tree position j meets position j + S
// as the plain version's slot[j] += slot[j + S] does. The upper lane adds
// the two in the other order: float addition commutes bit for bit (a NaN
// comes out as the card's one NaN either way). After S = 1, v[0] of lane l
// is group g0 + l's root: 31 shuffles for 32 groups, 5 deep.
template <int S>
__device__ __forceinline__ void fold_level(float (&v)[32], int lane) {
  const bool up = (lane & S) != 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float keep = up ? v[k + S] : v[k];
    const float give = up ? v[k] : v[k + S];
    v[k] = keep + __shfl_xor_sync(kFull, give, S);
  }
  if constexpr (S > 1) fold_level<S / 2>(v, lane);
}

// 32-bit words of shared memory a block takes on the shared path
__host__ __device__ constexpr int smem_words(bool is_float, int G) {
  return is_float ? 32 * G + 3 * G : 5 * G;
}

// G > kRegGroups: one warp, one block; its slots and cells in shared memory.
template <bool kFloat, typename MaskT>
__global__ void __launch_bounds__(32)
    grouped_agg_smem(const uint32_t* __restrict__ values,
                     const int32_t* __restrict__ gids,
                     const MaskT* __restrict__ mask, int n_groups,
                     int32_t* __restrict__ cnt, uint32_t* __restrict__ s0,
                     int32_t* __restrict__ s1, uint32_t* __restrict__ mn,
                     uint32_t* __restrict__ mx) {
  extern __shared__ __align__(16) int32_t smem[];
  const int G = n_groups;
  const int lane = threadIdx.x;
  const size_t b = blockIdx.x;
  float* slot = reinterpret_cast<float*>(smem);  // [G][32], float only
  int32_t* s_cnt = smem + (kFloat ? 32 * G : 0);
  int32_t* s_hi = s_cnt + G;                    // int only
  int32_t* s_lo = s_hi + G;                     // int only
  int32_t* s_mn = kFloat ? s_cnt + G : s_lo + G;
  int32_t* s_mx = s_mn + G;
  for (int g = lane; g < G; g += 32) {
    s_cnt[g] = 0;
    if constexpr (!kFloat) {
      s_hi[g] = 0;
      s_lo[g] = 0;
    }
    s_mn[g] = kFloat ? kPosInfKey : kIntMinIdent;
    s_mx[g] = kFloat ? kNegInfKey : kIntMaxIdent;
  }
  if constexpr (kFloat) {
    for (int i = lane; i < G * 8; i += 32)
      reinterpret_cast<float4*>(slot)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncwarp();

  for_each_pass(values, gids, mask, b, lane, static_cast<uint32_t>(G), [&](const Quad& r) {
    if (!__any_sync(kFull, r.c[0] | r.c[1] | r.c[2] | r.c[3])) return;
    uint32_t glo = kNoGroup, ghi = 0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (r.c[j]) {
        glo = min(glo, r.g[j]);
        ghi = max(ghi, r.g[j]);
      }
    }
    const uint32_t g0 = __reduce_min_sync(kFull, glo);
    if (g0 == __reduce_max_sync(kFull, ghi)) {
      // every counted row of the pass is in group g0
      int32_t n = 0;
      if constexpr (kFloat) {
        float t = slot[g0 * 32 + lane];
        int32_t lo = kPosInfKey, hi = kNegInfKey;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (r.c[j]) {
            const float x = __uint_as_float(r.w[j]);
            const int32_t key = float_key(static_cast<int32_t>(r.w[j]));
            const bool nan = x != x;
            t = t + x;
            n += 1;
            lo = nan ? lo : min(lo, key);
            hi = max(hi, nan ? kNaNKey : key);
          }
        }
        slot[g0 * 32 + lane] = t;
        n = __reduce_add_sync(kFull, n);
        lo = __reduce_min_sync(kFull, lo);
        hi = __reduce_max_sync(kFull, hi);
        if (lane == 0) {
          atomicAdd(&s_cnt[g0], n);
          atomicMin(&s_mn[g0], lo);
          atomicMax(&s_mx[g0], hi);
        }
      } else {
        int32_t hs = 0, ls = 0, lo = kIntMinIdent, hi = kIntMaxIdent;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (r.c[j]) {
            const int32_t v = static_cast<int32_t>(r.w[j]);
            n += 1;
            hs += v >> 16;
            ls += v & 0xFFFF;
            lo = min(lo, v);
            hi = max(hi, v);
          }
        }
        n = __reduce_add_sync(kFull, n);
        hs = __reduce_add_sync(kFull, hs);
        ls = __reduce_add_sync(kFull, ls);
        lo = __reduce_min_sync(kFull, lo);
        hi = __reduce_max_sync(kFull, hi);
        if (lane == 0) {
          atomicAdd(&s_cnt[g0], n);
          atomicAdd(&s_hi[g0], hs);
          atomicAdd(&s_lo[g0], ls);
          atomicMin(&s_mn[g0], lo);
          atomicMax(&s_mx[g0], hi);
        }
      }
      return;
    }
    // the float slots first (a lane's 4 rows may share a slot, so they
    // chain), then the integer atomics, which return nothing to wait for
    if constexpr (kFloat) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (r.c[j]) slot[r.g[j] * 32 + lane] += __uint_as_float(r.w[j]);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (!r.c[j]) continue;
      const uint32_t g = r.g[j];
      atomicAdd(&s_cnt[g], 1);
      if constexpr (kFloat) {
        const float x = __uint_as_float(r.w[j]);
        const int32_t key = float_key(static_cast<int32_t>(r.w[j]));
        const bool nan = x != x;
        if (!nan) atomicMin(&s_mn[g], key);
        atomicMax(&s_mx[g], nan ? kNaNKey : key);
      } else {
        const int32_t v = static_cast<int32_t>(r.w[j]);
        atomicAdd(&s_hi[g], v >> 16);
        atomicAdd(&s_lo[g], v & 0xFFFF);
        atomicMin(&s_mn[g], v);
        atomicMax(&s_mx[g], v);
      }
    }
  });
  __syncwarp();

  for (int g = lane; g < G; g += 32) {
    const size_t o = b * G + g;
    cnt[o] = s_cnt[g];
    if constexpr (kFloat) {
      const bool nan = s_mx[g] > kPosInfKey;
      s1[o] = 0;
      mn[o] = nan ? kNaNBits : static_cast<uint32_t>(float_key(s_mn[g]));
      mx[o] = nan ? kNaNBits : static_cast<uint32_t>(float_key(s_mx[g]));
    } else {
      s0[o] = static_cast<uint32_t>(s_hi[g]);
      s1[o] = s_lo[g];
      mn[o] = static_cast<uint32_t>(s_mn[g]);
      mx[o] = static_cast<uint32_t>(s_mx[g]);
    }
  }
  if constexpr (kFloat) {
    for (int g0 = 0; g0 < G; g0 += 32) {
      float v[32];
      // 32 groups none of whose rows counted have +0.0 roots: no fold
      if (__any_sync(kFull, g0 + lane < G && s_cnt[g0 + lane] != 0)) {
#pragma unroll
        for (int k = 0; k < 32; ++k) v[k] = g0 + k < G ? slot[(g0 + k) * 32 + lane] : 0.0f;
        fold_level<16>(v, lane);
      } else {
        v[0] = 0.0f;
      }
      if (g0 + lane < G) s0[b * G + g0 + lane] = __float_as_uint(v[0]);
    }
  }
}

// fused_agg: a CTA of kFusedWarps warps takes one block at a time; warp q
// owns rows kFusedRows * q .. + kFusedRows - 1 of the block's 32 and lane l
// packed lanes 4 l .. 4 l + 3, so that row s of the lane's four packed lanes
// is block rows 128 s + 4 l + j, whose mask entries Rows reads in one load.
constexpr int kFusedWarps = 4;
constexpr int kFusedRows = rt::kRows / kFusedWarps;  // 8
static_assert(rt::kLanes == 32 * kChunk, "a lane owns kChunk packed lanes");

// CTAs per SM that registers are budgeted for: 12 (40 registers a thread)
// puts the 1,472-block stack in one wave; a wider mask or wider words hold
// more registers than that budget leaves without spilling.
constexpr int fused_min_ctas(int K, int mask_bytes) {
  return mask_bytes == 1 && K <= 12 ? 12 : 1;
}

// The 16-byte words of packed lanes 4 l .. 4 l + 3 that hold their rows
// R0 .. R0 + N - 1 and no others (rt::Words, four lanes at a time).
template <int K, int R0, int N>
struct QuadWords {
  static_assert(K >= 1 && K <= 32, "bit width out of range");
  static constexpr int kFirst = (R0 * K) >> 5;
  static constexpr int kCount = (((R0 + N) * K - 1) >> 5) - kFirst + 1;
  uint4 w[kCount];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ block, int lane) {
#pragma unroll
    for (int j = 0; j < kCount; ++j)
      w[j] = __ldg(reinterpret_cast<const uint4*>(block + (kFirst + j) * rt::kLanes) + lane);
  }

  // Row R0 + i of packed lane 4 l + j as an unsigned K-bit value.
  __device__ __forceinline__ uint32_t value(int i, int j) const {
    if constexpr (K == 32) {
      return word(w[i], j);
    } else {
      const int off = (R0 + i) * K - kFirst * 32;
      const int w0 = off >> 5;
      const int sh = off & 31;
      uint32_t x = word(w[w0], j) >> sh;
      if (sh + K > 32) x |= word(w[w0 + 1 < kCount ? w0 + 1 : kCount - 1], j) << (32 - sh);
      return x & ((1u << K) - 1u);
    }
  }
};

// The five integer planes of one thread, warp or block.
struct Planes {
  int32_t n = 0, hs = 0, ls = 0, lo = kIntMinIdent, hi = kIntMaxIdent;

  __device__ __forceinline__ void add(uint32_t w, bool counted) {
    const int32_t v = static_cast<int32_t>(w);
    n += counted ? 1 : 0;
    hs += counted ? v >> 16 : 0;
    ls += counted ? v & 0xFFFF : 0;
    lo = min(lo, counted ? v : kIntMinIdent);
    hi = max(hi, counted ? v : kIntMaxIdent);
  }

  __device__ __forceinline__ void reduce() {
    n = __reduce_add_sync(kFull, n);
    hs = __reduce_add_sync(kFull, hs);
    ls = __reduce_add_sync(kFull, ls);
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
  }
};

// The warps' planes of two consecutive blocks of a CTA (by block parity), so
// that one barrier a block suffices.
struct FusedStage {
  int32_t v[2][5][kFusedWarps];
};

template <typename MaskT>
struct FusedArgs {
  const uint32_t* packed;
  const MaskT* mask;
  int32_t *cnt, *s0, *s1, *mn, *mx;
  int nblocks;
};

// The grid-stride walk of warp Q: rows Q * kFusedRows .. of every block this
// CTA takes.  Each warp reduces its planes into shared memory; after the
// block's barrier warp 0 reduces the kFusedWarps of them and writes them.
// Nothing of the next block is loaded ahead: the registers that would hold
// it do not fit the budget that puts the stack in one wave.
template <int K, typename MaskT, int Q>
__device__ __forceinline__ void fused_walk(const FusedArgs<MaskT>& a, FusedStage& st) {
  using MaskVec = typename Rows<MaskT>::MaskVec;
  const int lane = threadIdx.x & 31;
  auto fold = [&](size_t b, int buf) {
    QuadWords<K, Q * kFusedRows, kFusedRows> words;
    words.load(a.packed + b * K * rt::kLanes, lane);
    const MaskT* mb = a.mask + b * rt::kBlock + Q * kFusedRows * rt::kLanes + kChunk * lane;
    MaskVec m[kFusedRows];
#pragma unroll
    for (int i = 0; i < kFusedRows; ++i)
      m[i] = __ldg(reinterpret_cast<const MaskVec*>(mb + i * rt::kLanes));
    Planes p;
#pragma unroll
    for (int i = 0; i < kFusedRows; ++i) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) p.add(words.value(i, j), word(m[i], j) != 0);
    }
    p.reduce();
    int32_t (&part)[5][kFusedWarps] = st.v[buf];
    if (lane == 0) {
      part[0][Q] = p.n;
      part[1][Q] = p.hs;
      part[2][Q] = p.ls;
      part[3][Q] = p.lo;
      part[4][Q] = p.hi;
    }
    rt::cta_barrier();  // every warp's planes of block b are in
    if constexpr (Q == 0) {
      Planes t;
      if (lane < kFusedWarps) {
        t.n = part[0][lane];
        t.hs = part[1][lane];
        t.ls = part[2][lane];
        t.lo = part[3][lane];
        t.hi = part[4][lane];
      }
      t.reduce();
      if (lane == 0) {
        a.cnt[b] = t.n;
        a.s0[b] = t.hs;
        a.s1[b] = t.ls;
        a.mn[b] = t.lo;
        a.mx[b] = t.hi;
      }
    }
  };
  // The grid is never wider than the blocks, so every CTA has a first block;
  // it runs outside the loop, as in fused_scan's walk.
  size_t b = blockIdx.x;
  fold(b, 0);
  int buf = 1;
  for (b += gridDim.x; b < static_cast<size_t>(a.nblocks); b += gridDim.x, buf ^= 1) fold(b, buf);
}

// fused_walk<K, MaskT, q> for the runtime warp index q.
template <int K, typename MaskT, int Q = 0>
__device__ __forceinline__ void fused_walk_warp(int q, const FusedArgs<MaskT>& a,
                                                FusedStage& st) {
  if constexpr (Q + 1 < kFusedWarps) {
    if (q != Q) {
      fused_walk_warp<K, MaskT, Q + 1>(q, a, st);
      return;
    }
  }
  fused_walk<K, MaskT, Q>(a, st);
}

template <int K, typename MaskT>
__global__ void __launch_bounds__(kFusedWarps * 32, fused_min_ctas(K, sizeof(MaskT)))
    fused_agg_kernel(const FusedArgs<MaskT> a) {
  __shared__ FusedStage st;
  fused_walk_warp<K, MaskT>(threadIdx.x >> 5, a, st);
}

template <bool kFloat, typename MaskT>
cudaError_t launch_grouped(const void* values, const void* gids,
                           const void* mask, int n_groups, void* cnt, void* s0,
                           void* s1, void* mn, void* mx, int nblocks,
                           cudaStream_t stream) {
  const auto v = static_cast<const uint32_t*>(values);
  const auto g = static_cast<const int32_t*>(gids);
  const auto m = static_cast<const MaskT*>(mask);
  const auto c = static_cast<int32_t*>(cnt);
  const auto a = static_cast<uint32_t*>(s0);
  const auto l = static_cast<int32_t*>(s1);
  const auto lo = static_cast<uint32_t*>(mn);
  const auto hi = static_cast<uint32_t*>(mx);
  if (n_groups <= kRegGroups) {
    const int ctas = (nblocks + kRegWarps - 1) / kRegWarps;
    if (n_groups == 1)
      grouped_agg_regs<kFloat, MaskT, 1><<<ctas, kRegWarps * 32, 0, stream>>>(
          v, g, m, n_groups, nblocks, c, a, l, lo, hi);
    else
      grouped_agg_regs<kFloat, MaskT, kRegGroups><<<ctas, kRegWarps * 32, 0, stream>>>(
          v, g, m, n_groups, nblocks, c, a, l, lo, hi);
    return cudaGetLastError();
  }
  auto kernel = grouped_agg_smem<kFloat, MaskT>;
  // shared memory before L1, so that as many warps fit per SM as the slots
  // allow (12 at G = 128: the 1,472-block stack in one wave)
  static const cudaError_t setup = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (setup != cudaSuccess) return setup;
  const size_t smem = static_cast<size_t>(smem_words(kFloat, n_groups)) * 4;
  kernel<<<nblocks, 32, smem, stream>>>(v, g, m, n_groups, c, a, l, lo, hi);
  return cudaGetLastError();
}

template <int K, typename MaskT>
cudaError_t launch_fused(const void* packed, const void* mask, void* cnt,
                         void* s0, void* s1, void* mn, void* mx, int nblocks,
                         cudaStream_t stream) {
  auto kernel = fused_agg_kernel<K, MaskT>;
  static const rt::Setup setup = rt::make_setup(kernel, kFusedWarps * 32, false);
  if (setup.err != cudaSuccess) return setup.err;
  const FusedArgs<MaskT> a{static_cast<const uint32_t*>(packed), static_cast<const MaskT*>(mask),
                           static_cast<int32_t*>(cnt), static_cast<int32_t*>(s0),
                           static_cast<int32_t*>(s1), static_cast<int32_t*>(mn),
                           static_cast<int32_t*>(mx), nblocks};
  kernel<<<rt::grid_size(setup, 0, nblocks), kFusedWarps * 32, 0, stream>>>(a);
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
  // each lane reads 16-byte vectors of values and ids and 4 or 16 bytes of mask
  if (reinterpret_cast<uintptr_t>(values) % 16 || reinterpret_cast<uintptr_t>(gids) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % (mask_kind ? 16 : 4))
    return cudaErrorMisalignedAddress;
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
  // each lane reads 16-byte vectors of words and 4 or 16 bytes of mask
  if (reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % (mask_kind ? 16 : 4))
    return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rt::with_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    return mask_kind
               ? launch_fused<K, int32_t>(packed, mask, cnt, s0, s1, mn, mx, nblocks, s)
               : launch_fused<K, uint8_t>(packed, mask, cnt, s0, s1, mn, mx, nblocks, s);
  });
  return static_cast<int>(err);
}
