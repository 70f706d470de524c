// Causal / GQA / sliding-window attention on Hopper's tensor cores, for
// bfloat16 operands with a head dim of 64, 128 or 256:
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D) -> out (B, H, Sq, D), bfloat16.
//
// Replaces: flash_attention_pallas, repro/kernels/flash_attention.py:82 (its
// pallas_call at :102), for the operands that csrc/flash_attention.cu would
// otherwise compute on the CUDA cores, with the same semantics (ref.mha's):
// q head h reads kv head h / (H / Hkv); logits in float32, times `scale`;
// query row i sits at position i + Sk - Sq; key j is visible to it when
// j <= pos under `causal` and j > pos - window under a window; a masked
// logit is -1e30 and a key past Sk is -inf, against a running max that
// starts at -1e30, so a row that sees no key averages V over all Sk keys;
// the output is rounded once to bf16.  One difference in arithmetic: the
// probabilities P are rounded to bf16 before P V (the tensor cores take bf16
// operands), while the row sum l adds them in float32.  That stays within one
// bf16 step of the float32 oracle (tests/test_torch_attention.py models it
// on the CPU).
//
// Bound: operations.  The two products take 4 * B * H * D * (sum over rows of
// the keys each row sees) operations; for one qwen3-1.7b layer at S = 4096
// (B = 1, H = 16, D = 128, causal) that is 68.7 GFLOP, about 69 us at the
// H100's 989 TFLOP/s in bf16, against about 15 us for the 50 MB it moves.
//
// Design: one CTA per (128-row query tile, head, batch), launched heaviest
// causal tile first, of three warpgroups.  The producer warpgroup gives its
// registers away (setmaxnreg) and one of its threads issues every TMA load:
// Q once, then 64-key K and V tiles into two rings of kStages shared-memory
// slots (3 at D <= 128, 2 at D = 256), K's and V's, each slot guarded by a
// `full` mbarrier (complete_tx) and an `empty` one that the 256 consumer
// threads arrive on once their products have read it.  The tensor maps are
// 3-D, (D, S, B * heads), with 128-byte swizzle and boxes of 64 columns (one
// swizzle atom; a D-wide row is D / 64 boxes), so a ragged last tile reads
// zeros past S and never the next head's rows.
// Each of the two consumer warpgroups owns 64 query rows.  Per tile j it
// issues S_j = Q K_j^T (wgmma m64n64k16, both operands K-major in shared
// memory, D / 16 steps) and then O += P_{j-1} V_{j-1} (wgmma m64n64k16 per 64
// output columns and 16 keys, P from registers as the A operand, V MN-major
// from shared memory, i.e. transposed B), waits for S_j alone, and runs the
// online softmax of tile j on float32 registers (scale, mask, the row max
// over the 4 threads of a quad by two shuffles) while the tensor cores still
// work on P_{j-1} V_{j-1}; then it waits for that product, rescales O and
// rounds P_j to bf16 in registers: the f32 accumulator layout of the first
// product is the bf16 A-fragment layout of the second.  The two warpgroups
// do not take turns (a ping-pong on named barriers was 2% slower at D = 128
// and 3% faster at D = 256).  The mask is applied per key only on tiles
// that some row does not wholly see (the diagonal, the window's edge, a
// ragged end): the per-key checks cost about a third of the time when every
// tile paid them.  The key loop covers the union of the tile's rows'
// visible ranges, or all Sk keys when a row sees none; a tile that some rows
// do not see is computed for all of them and masked (it adds exactly
// nothing: P = 0 against a real running max, or weights that the first real
// max multiplies by 2^-1e30 = 0).
// Not yet done: 128-key tiles (slower here: they double the softmax's
// registers and latency chains per tile), Q in registers, a persistent grid.
//
// The host side builds the three tensor maps per call with
// cuTensorMapEncodeTiled, which libcuda holds and the runtime does not,
// reached through cudaGetDriverEntryPoint so that the library links only the
// runtime.  A launch the card refuses is reported by cudaGetLastError(),
// which rt_flash_attention_wgmma returns.

#include <cmath>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kConsumers = 2;                    // consumer warpgroups per CTA
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer warpgroup
constexpr int kRows = 64 * kConsumers;           // query rows per CTA
constexpr int kAtom = 64;                        // bf16 columns in one 128-byte swizzle atom
constexpr uint32_t kRowBytes = 128;              // a swizzled row of one box
constexpr float kMasked = -1e30f;                // ref.mha's masked logit
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static_assert(D % kAtom == 0 && D <= 256, "head dim");
  static constexpr int kBoxes = D / kAtom;                // boxes across a row
  static constexpr int kKeys = 64;                        // keys per K/V tile
  static constexpr int kStages = D == 256 ? 2 : 3;        // slots of each ring
  static constexpr uint32_t kQBox = kRows * kRowBytes;    // one Q box, bytes
  static constexpr uint32_t kKVBox = kKeys * kRowBytes;   // one K or V box
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kTileBytes = kBoxes * kKVBox;  // a K (or V) tile
  // 1024 for aligning the base to the swizzle pattern, then Q, the K ring,
  // the V ring and 1 + 4 * kStages mbarriers
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * static_cast<size_t>(kStages) * kTileBytes + 8 * (1 + 4 * kStages);
};

using rt::mbar_arrive;
using rt::mbar_expect_tx;
using rt::mbar_init;
using rt::mbar_wait;
using rt::smem_u32;

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// A wgmma shared-memory descriptor with 128-byte swizzle: the start address,
// the leading and stride byte offsets (all in 16-byte units) and the layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across a
// wait (the asm statement is volatile, so it stays where it is).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B for a 64 x 64 x 16 step, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for a 64 x 64 x 16 step, A (bf16 pairs) in registers and B
// MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The keys row `pos` sees: [key_lo, key_hi), none when key_lo >= key_hi.
__device__ __forceinline__ long long key_lo(long long pos, int has_window, int window) {
  return has_window ? max(0LL, pos - window + 1) : 0LL;
}
__device__ __forceinline__ long long key_hi(long long pos, int causal, int Sk) {
  return causal ? min(static_cast<long long>(Sk), pos + 1) : static_cast<long long>(Sk);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 __nv_bfloat16* __restrict__ out, int H, int Hkv, int Sq,
                                 int Sk, int causal, int has_window, int window,
                                 float scale_log2) {
  using S = Shape<D>;
  constexpr int kKeys = S::kKeys, kStages = S::kStages;
  constexpr int kSteps = D / 16;           // k-steps of Q K^T
  constexpr int kChunks = D / 64;          // 64-column slices of O
  constexpr int kCols = kKeys / 8;         // 8-column groups of S per thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + S::kQBytes;              // slot s at k_s + s * kTileBytes
  const uint32_t v_s = k_s + kStages * S::kTileBytes;  // likewise
  const uint32_t bars = v_s + kStages * S::kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int tid = threadIdx.x;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const long long off = static_cast<long long>(Sk) - Sq;  // row i sits at i + off

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kConsumers * 128);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // does a row of the tile see no key?  (this barrier also publishes the
  // mbarriers)  The keys [lo, hi) that the tile's rows see, together: both
  // ends grow with the row, or all Sk when one row sees none.
  const int r = tid % kRows;
  const long long pos_r = i0 + r + off;
  const bool row_empty =
      i0 + r < Sq && key_lo(pos_r, has_window, window) >= key_hi(pos_r, causal, Sk);
  const bool any_empty = __syncthreads_or(row_empty) != 0;
  const int last = min(i0 + kRows, Sq) - 1;
  const long long lo = any_empty ? 0 : key_lo(i0 + off, has_window, window);
  const long long hi = any_empty ? Sk : key_hi(last + off, causal, Sk);
  const int t_lo = static_cast<int>(lo / kKeys);
  const int n_tiles = static_cast<int>((hi + kKeys - 1) / kKeys) - t_lo;

  if (tid < 128) {
    // the producer warpgroup: one thread issues the loads, in the order the
    // consumers use them; a slot is refilled once all 256 consumers are done
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 0) {
      const int kv_plane = b * Hkv + h / (H / Hkv);
      mbar_expect_tx(q_full, S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c)
        tma_load(q_s + c * S::kQBox, &q_map, q_full, c * kAtom, i0, b * H + h);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages, k0 = (t_lo + j) * kKeys;
        const uint32_t used = (j / kStages - 1) & 1;  // the phase its last user ended
        if (j >= kStages) mbar_wait(k_empty(s), used);
        mbar_expect_tx(k_full(s), S::kTileBytes);
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c)
          tma_load(k_s + s * S::kTileBytes + c * S::kKVBox, &k_map, k_full(s), c * kAtom, k0,
                   kv_plane);
        if (j >= kStages) mbar_wait(v_empty(s), used);
        mbar_expect_tx(v_full(s), S::kTileBytes);
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c)
          tma_load(v_s + s * S::kTileBytes + c * S::kKVBox, &v_map, v_full(s), c * kAtom, k0,
                   kv_plane);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");

  // a consumer: warpgroup wg's rows r0 and r0 + 8 of its 64, and its columns
  // 8 n + 2 (lane % 4) + {0, 1} of every product
  const int ctid = tid - 128;
  const int wg = ctid / 128, warp = (ctid % 128) / 32, lane = ctid % 32;
  const int row0 = i0 + 64 * wg + warp * 16 + lane / 4;
  const int pos[2] = {row0 + static_cast<int>(off), row0 + 8 + static_cast<int>(off)};
  // positions of the tile's first and last rows, for the tiles they all see
  const int first_pos = i0 + static_cast<int>(off), last_pos = last + static_cast<int>(off);
  const int col = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float sc[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sc[i] = 0.f;
  uint32_t pa[kKeys / 16][4];  // P_j as the A operand of its k-steps of 16 keys
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  // S_j = Q K_j^T, issued and committed, not waited for
  auto issue_s = [&](int j) {
    const int s = j % kStages;
    mbar_wait(k_full(s), (j / kStages) & 1);
    const uint32_t k_st = k_s + s * S::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t at = (kk % 4) * 32;  // 16 columns are 32 bytes of an atom
      wgmma_ss(sc, smem_desc(q_wg + (kk / 4) * S::kQBox + at, 16, 1024),
               smem_desc(k_st + (kk / 4) * S::kKVBox + at, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P_j V_j, likewise; V's 64-column box is one MN-major atom, so the
  // only stride the descriptor uses is the 1024 bytes between 8-key groups
  auto issue_pv = [&](int j) {
    const int s = j % kStages;
    mbar_wait(v_full(s), (j / kStages) & 1);
    const uint32_t v_st = v_s + s * S::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_rs(o[c], pa[kk], smem_desc(v_st + c * S::kKVBox + kk * 16 * kRowBytes, 1024, 1024));
    wgmma_commit();
  };
  // scale and mask S_j (log2 domain), update m and l; sc becomes the float
  // P_j; returns each row's rescale factor for O
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = (t_lo + j) * kKeys;
    // uniform over the CTA: every row of the tile sees every key of the tile
    // (the checks per key, even predicated, cost about a third of the time)
    const bool all_seen = k0 + kKeys <= Sk && (!causal || k0 + kKeys - 1 <= first_pos) &&
                          (!has_window || last_pos - k0 < window);
    if (all_seen) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) sc[i] *= scale_log2;
    } else {
#pragma unroll
      for (int n = 0; n < kCols; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * n + col + (e & 1), p = pos[e >> 1];
          float& x = sc[4 * n + e];
          if (key >= Sk)
            x = -INFINITY;  // past the end: no weight, not even in an empty row
          else if ((causal && key > p) || (has_window && p - key >= window))
            x = kMasked;
          else
            x *= scale_log2;
        }
    }
    float mx[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int t = 0; t < 4; ++t) mx[rr][t] = m[rr];
#pragma unroll
    for (int n = 0; n < kCols; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1][(n % 2) * 2 + (e & 1)] =
            fmaxf(mx[e >> 1][(n % 2) * 2 + (e & 1)], sc[4 * n + e]);
    float ls[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x = fmaxf(fmaxf(mx[rr][0], mx[rr][1]), fmaxf(mx[rr][2], mx[rr][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      alpha[rr] = exp2f(m[rr] - x);
      m[rr] = x;
#pragma unroll
      for (int t = 0; t < 4; ++t) ls[rr][t] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < kCols; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * n + e] - m[e >> 1]);
        sc[4 * n + e] = p;
        ls[e >> 1][(n % 2) * 2 + (e & 1)] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      l[rr] = l[rr] * alpha[rr] + ((ls[rr][0] + ls[rr][1]) + (ls[rr][2] + ls[rr][3]));
  };
  // P_j rounded to bf16 into the A fragments: k-step kk takes columns
  // 16 kk .. 16 kk + 15, i.e. 8-column groups 2 kk and 2 kk + 1
  auto to_fragments = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 4 * (2 * kk + h2) + 2 * rr;
          pa[kk][2 * h2 + rr] = pack_bf16(sc[i], sc[i + 1]);
        }
  };

  mbar_wait(q_full, 0);
  float alpha[2];
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(k_empty(0));
  softmax(0, alpha);
  to_fragments();
  for (int j = 1; j < n_tiles; ++j) {
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j is ready; P_{j-1} V_{j-1} may still run
    fence_regs(sc);
    mbar_arrive(k_empty(j % kStages));
    softmax(j, alpha);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
    mbar_arrive(v_empty((j - 1) % kStages));
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
    to_fragments();
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kChunks; ++c) fence_regs(o[c]);
  mbar_arrive(v_empty((n_tiles - 1) % kStages));

  // O / l, rounded once to bf16
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * H + h) * Sq * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row0 + 8 * rr;
    if (i >= Sq) continue;
    __nv_bfloat16* orow = ob + static_cast<size_t>(i) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * c + 8 * n + col) =
            __floats2bfloat162_rn(o[c][4 * n + 2 * rr] / l[rr], o[c][4 * n + 2 * rr + 1] / l[rr]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over (D, rows, planes) of bf16 with boxes of 64 columns x
// `box_rows` rows x 1 plane, 128-byte swizzled; out-of-range rows read zeros.
bool make_map(CUtensorMap* map, const void* base, int D, int rows, long long planes,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kAtom), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int Hkv, int Sq, int Sk, int causal, int has_window, int window,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_attention_wgmma_kernel<D>;
  constexpr size_t smem = Shape<D>::kSmem;
  // once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, D, Sq, static_cast<long long>(B) * H, kRows) ||
      !make_map(&k_map, k, D, Sk, static_cast<long long>(B) * Hkv, Shape<D>::kKeys) ||
      !make_map(&v_map, v, D, Sk, static_cast<long long>(B) * Hkv, Shape<D>::kKeys))
    return cudaErrorInvalidValue;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map,
                                           static_cast<__nv_bfloat16*>(out), H, Hkv, Sq, Sk,
                                           causal, has_window, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// bf16 operands only; D in {64, 128, 256}; q, k, v 16-byte aligned and
// contiguous (the wrapper checks both).
extern "C" int rt_flash_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                        int B, int H, int Hkv, int Sq, int Sk, int D,
                                        int causal, int has_window, int window, float scale,
                                        void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      H > 65535 || Sq > (1 << 30) || Sk > (1 << 30))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch<64>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, has_window, window, scale, s);
      break;
    case 128:
      err = launch<128>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, has_window, window, scale, s);
      break;
    case 256:
      err = launch<256>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, has_window, window, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
