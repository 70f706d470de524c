// Causal / GQA / sliding-window attention with an online softmax:
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D) -> out (B, H, Sq, D) in q's dtype:
// float32 with D in {16, 32, 64, 128, 256}, or bfloat16 with D in {16, 32}
// (bfloat16 at 64, 128 and 256 is csrc/flash_attention_wgmma.cu's).
//
// Replaces: flash_attention_pallas, repro/kernels/flash_attention.py:82 (its
// pallas_call at :102), with the semantics of its oracle, repro/kernels/ref.py
// mha: q head h reads kv head h / (H / Hkv); logits in float32, times
// `scale`; query row i sits at position i + Sk - Sq (the ends are aligned, so
// Sq may differ from Sk, unlike the Pallas kernel); key j is visible to it
// when j <= pos under `causal` and j > pos - window under a window; a masked
// logit is -1e30, never -inf, so a row that sees no key averages V over all
// Sk keys, as softmax over Sk equal logits does; the output is rounded once
// from float32 to q's dtype.
//
// Bound: operations.  The two products take 4 * B * H * D * (sum over rows
// of the keys each row sees) operations: 68.7 GFLOP for one qwen3-1.7b layer
// at S = 4096 (B = 1, H = 16, D = 128, causal), against 50 MB to move.  Done
// at float32 accuracy they cannot run faster than three TF32 passes on the
// tensor cores, 495 / 3 = 165 TFLOP/s on an H100 SXM: about 417 us.
//
// Design: both products on the tensor cores in 3xTF32, FlashAttention-2's
// split of the work, K and V by cp.async in two stages.
// - Arithmetic.  mma.sync m16n8k8 with TF32 operands and float32 sums.  Each
//   float32 operand x is split into hi, x rounded to TF32 (to nearest, ties
//   away from zero), and lo = x - hi, which the tensor cores read as TF32 by
//   ignoring its 13 low bits; a product is hi*hi plus lo*hi + hi*lo, which
//   drops ~2^-21 of it.  The rounding is two integer operations (add half a
//   TF32 step to the bits, clear the 13 low ones; operands are finite):
//   cvt.rna.tf32.f32, which also handles inf and NaN, compiles to four on
//   sm_90a, and the splits outnumber the products, so they set much of the
//   kernel's time.  One TF32 pass would be ~1e-3 off at S 1,024 (tests/
//   test_torch_attention.py pins both).  A bf16 operand widened to float32
//   is exact in TF32: its lo is 0 and the passes that read it are skipped
//   (Q K takes one pass, P V two).
// - Sums.  The tensor cores truncate each sum, so an accumulator that takes
//   many products drifts toward zero: one accumulator for all three passes
//   over D put the logits several times further from float64 than cuBLAS's
//   float32 ones on an H100, at inputs of standard deviation 2 and 3, and
//   broke the float32 tolerance at D 256.  So every sum is short: the scores
//   start at 0 for each key tile, the hi*hi products alternate between two
//   accumulators by k-step and the small products go to a third, and each
//   tile's P V goes to fresh hi*hi and small accumulators, 4 n8 tiles at a
//   time, added to the running output on the CUDA cores.  The logits then
//   sit as close to float64 as cuBLAS's float32 ones.
// - Work split.  One CTA of 4 warps per (64-row query tile, head, batch);
//   warp w owns rows 16w..16w+15, the instruction's m16.  Its 16 x 32
//   scores stay in accumulator fragments (lane l holds rows g = l/4 and
//   g + 8, keys 2t and 2t + 1 of each n8 tile, t = l%4); the row max and sum
//   take two quad shuffles (the sum only once, at the end: each lane keeps
//   its partial sum, rescaled with the row).  P goes from the score fragment
//   straight into P V's A fragment: the accumulator's columns {2t, 2t + 1} of
//   an n8 tile serve as the A fragment's columns {t, t + 4}, and V's B
//   fragment reads rows 2t and 2t + 1 to match, which is exact, since P V
//   sums over keys.  Heavy tiles go first: row tile gridDim.x - 1 - blockIdx.x
//   takes the most keys under `causal`.
// - Copies.  Q (once) and each 32-key tile of K and V go to dynamic shared
//   memory by cp.async, 4 elements a copy (16 bytes of float32, 8 of bf16;
//   rows past Sq or Sk are zero-filled), with the next tile's copies in
//   flight while the current one is multiplied (two stages).  Rows are padded
//   by 16 bytes, which makes the fragment reads conflict-free: bank 4g + t
//   for Q and K, 8t + g for V's rows 2t, 2t + 1.  32 keys, not 64: at D 128 a
//   CTA then takes 99 KiB and two fit an SM (64 keys, 165 KiB and one CTA
//   an SM, ran slower at the float32 path's shape); D 256 takes 195 KiB.
// - Q's fragments.  For D <= 64 a lane splits its Q fragments once into
//   registers (D / 8 steps x 8 registers, 64 at D = 64).  At D 128 and 256
//   that would take 128 and 256 registers beside the output's 64 and 128, so
//   they are read from shared memory and split again at each key tile (4
//   loads and 4 splits a k-step, shared by 4 n8 tiles of keys).
// - Semantics as above: masked logits -1e30, keys past Sk -inf (no weight
//   against a running max that starts at -1e30), the key loop trimmed to the
//   union of the tile's rows' visible ranges unless a row sees no key (then
//   all Sk keys), masks skipped on a tile that every row of the warp sees
//   whole.  exp is 2^x by ex2.approx.ftz on logits scaled by scale *
//   log2(e) (the max, the mask value and the sums are taken on those): it
//   holds the float32 tolerance on the card, and ran faster than expf and
//   exp2f at the float32 path's shape.
//
// A launch the card refuses (too much shared memory, a grid too large) is
// reported by cudaGetLastError(), which rt_flash_attention returns.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kRows = 64;                  // query rows per CTA
constexpr int kWarps = 4;                  // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;                  // keys per stage
constexpr int kGroup = 4;                  // n8 tiles of P V summed apart
constexpr float kMasked = -1e30f;          // ref.mha's masked logit
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Tiles {
  static_assert(D % 16 == 0 && D <= 256, "head dim");
  static constexpr int kStride = D + 16 / int(sizeof(T));    // padded row, elements
  static constexpr int kTile = kKeys * kStride;              // one K or V stage
  // Q, then stages 0 and 1 of K and V
  static constexpr size_t kSmem = size_t(kRows * kStride + 4 * kTile) * sizeof(T);
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  // round to nearest even, as torch's .to()
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 4 elements from global to shared memory, or 4 zeros where !ok.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(rt::smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(rt::smem_u32(smem)),
               "l"(gmem), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Returns once at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [0, ROWS) of a (rows, D) array into a tile of padded rows; the rows
// from `valid` on are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void copy_rows(T* tile, const T* src, int valid, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int idx = tid; idx < ROWS * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks * 4;
    const bool ok = r < valid;
    cp_async4(tile + r * Tiles<T, D>::kStride + c, ok ? src + size_t(r) * D + c : src, ok);
  }
}

// x = hi + lo, hi the TF32 nearest x (ties away from zero) and lo = x - hi,
// read as TF32 by the tensor cores; an EXACT operand (a widened bf16) is its
// own hi.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x by the SFU's approximation (~2 ulp), with results below 2^-126, which
// weigh nothing against a row's largest term, flushed to zero.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int H,
                           int Hkv, int Sq, int Sk, int causal, int has_window,
                           int window, float scale) {
  using Tl = Tiles<T, D>;
  constexpr int KEYS = kKeys, RS = Tl::kStride;
  constexpr int NT = KEYS / 8;              // n8 tiles of scores, k8 steps of P V
  constexpr int DK = D / 8;                 // k8 steps of Q K, n8 tiles of the output
  constexpr int NG = DK < kGroup ? DK : kGroup;
  constexpr bool kExact = std::is_same_v<T, __nv_bfloat16>;
  constexpr bool kQRegs = D <= 64;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  // stage s: K at kv(s), V at kv(s) + kTile
  auto kv = [Qs](int s) { return Qs + kRows * RS + s * 2 * Tl::kTile; };
  __shared__ int key_range[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long long off = static_cast<long long>(Sk) - Sq;  // row i sits at i + off
  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  copy_rows<T, D, kRows>(Qs, qb + static_cast<size_t>(i0) * D, Sq - i0, tid);
  if (tid == 0) {
    // the keys the tile's rows see: [lo, hi), or all Sk when one sees none
    long long lo = Sk, hi = 0;
    bool empty = false;
    const int rows = min(kRows, Sq - i0);
    for (int r = 0; r < rows && !empty; ++r) {
      const long long pos = i0 + r + off;
      const long long klo = has_window ? max(0LL, pos - window + 1) : 0LL;
      const long long khi = causal ? min(static_cast<long long>(Sk), pos + 1) : Sk;
      empty = klo >= khi;
      lo = min(lo, klo);
      hi = max(hi, khi);
    }
    key_range[0] = empty ? 0 : static_cast<int>(lo);
    key_range[1] = empty ? Sk : static_cast<int>(hi);
  }
  __syncthreads();
  const int kbeg = key_range[0] / KEYS * KEYS;
  const int ntiles = (key_range[1] - kbeg + KEYS - 1) / KEYS;
  // copy group i holds key tile i (group 0 Q too); one group is committed a
  // tile, empty or not, so that waiting for all but the newest is exact
  for (int s = 0; s < 2; ++s) {
    const int k0 = kbeg + s * KEYS;
    if (s < ntiles) {
      copy_rows<T, D, KEYS>(kv(s), kb + static_cast<size_t>(k0) * D, Sk - k0, tid);
      copy_rows<T, D, KEYS>(kv(s) + Tl::kTile, vb + static_cast<size_t>(k0) * D, Sk - k0, tid);
    }
    cp_async_commit();
  }

  const int r0 = warp * 16 + g;                      // this lane's rows r0, r0 + 8
  const long long pos[2] = {i0 + r0 + off, i0 + r0 + 8 + off};
  const long long wlo = i0 + warp * 16 + off;        // the warp's first and last rows
  const long long whi = wlo + 15;
  const float scale2 = scale * kLog2e;
  float o[DK][4];
#pragma unroll
  for (int n = 0; n < DK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  uint32_t qh[kQRegs ? DK : 1][4], ql[kQRegs ? DK : 1][4];

  // the A fragment of Q K's k-step kk: rows r0, r0 + 8 by columns t, t + 4
  auto q_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    const T* p = Qs + r0 * RS + kk * 8 + t;
    split<kExact>(widen(p[0]), ah[0], al[0]);
    split<kExact>(widen(p[8 * RS]), ah[1], al[1]);
    split<kExact>(widen(p[4]), ah[2], al[2]);
    split<kExact>(widen(p[8 * RS + 4]), ah[3], al[3]);
  };

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * KEYS;
    const T* Kt = kv(it & 1);
    const T* Vt = Kt + Tl::kTile;
    cp_async_wait<1>();
    __syncthreads();  // tile `it` (and Q) landed for every thread's copies
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) q_frag(kk, qh[kk], ql[kk]);
      }
    }

    // S = Q K^T over the tile: hi*hi by k-step parity, the small products
    // apart, each from zero
    float sb[2][NT][4], sl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sb[0][j][e] = sb[1][j][e] = sl[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ah[e] = qh[kk][e], al[e] = ql[kk][e];
      } else {
        q_frag(kk, ah, al);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // B = K^T: column g is key 8j + g, rows t and t + 4 its dims
        const T* p = Kt + (j * 8 + g) * RS + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split<kExact>(widen(p[0]), bh[0], bl[0]);
        split<kExact>(widen(p[4]), bh[1], bl[1]);
        if constexpr (!kExact) {
          mma(sl[j], al, bh);
          mma(sl[j], ah, bl);
        }
        mma(sb[kk & 1][j], ah, bh);
      }
    }

    // scale into log2's domain, mask, then the online softmax of rows r0
    // and r0 + 8
    const bool whole = k0 + KEYS <= Sk && (!causal || k0 + KEYS - 1 <= wlo) &&
                       (!has_window || k0 > whi - window);
    float s[NT][4], mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (sb[0][j][e] + sb[1][j][e] + sl[j][e]) * scale2;
        if (!whole) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const long long p = pos[e >> 1];
          if (key >= Sk) {
            x = -INFINITY;  // past the end: no weight, not even in an empty row
          } else if ((causal && key > p) || (has_window && key <= p - window)) {
            x = kMasked;
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
    }
    // P as P V's A fragments: a0 = (r0, key 2t), a1 = (r0 + 8, 2t),
    // a2 = (r0, 2t + 1), a3 = (r0 + 8, 2t + 1) of each k8 step j
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2_approx(s[j][0] - mx[0]), p1 = exp2_approx(s[j][1] - mx[0]);
      const float p2 = exp2_approx(s[j][2] - mx[1]), p3 = exp2_approx(s[j][3] - mx[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      split<false>(p0, ph[j][0], pl[j][0]);
      split<false>(p2, ph[j][1], pl[j][1]);
      split<false>(p1, ph[j][2], pl[j][2]);
      split<false>(p3, ph[j][3], pl[j][3]);
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];

    // O = O alpha + P V: the tile's P V from zero, kGroup n8 tiles at a
    // time, hi*hi and the small products apart
#pragma unroll
    for (int n0 = 0; n0 < DK; n0 += NG) {
      float cb[NG][4], cs[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[n][e] = cs[n][e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          // B = V: column g is dim 8(n0 + n) + g, rows t and t + 4 keys
          // 8j + 2t and 8j + 2t + 1
          const T* p = Vt + (j * 8 + 2 * t) * RS + (n0 + n) * 8 + g;
          uint32_t bh[2], bl[2];
          split<kExact>(widen(p[0]), bh[0], bl[0]);
          split<kExact>(widen(p[RS]), bh[1], bl[1]);
          mma(cs[n], pl[j], bh);
          if constexpr (!kExact) mma(cs[n], ph[j], bl);
          mma(cb[n], ph[j], bh);
        }
      }
#pragma unroll
      for (int n = 0; n < NG; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], cb[n][e] + cs[n][e]);
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (it + 2 < ntiles) {
      const int kn = k0 + 2 * KEYS;
      copy_rows<T, D, KEYS>(kv(it & 1), kb + static_cast<size_t>(kn) * D, Sk - kn, tid);
      copy_rows<T, D, KEYS>(kv(it & 1) + Tl::kTile, vb + static_cast<size_t>(kn) * D, Sk - kn,
                            tid);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int i = i0 + r0 + 8 * r;
    if (i >= Sq) continue;
    T* dst = out + ((static_cast<size_t>(b) * H + h) * Sq + i) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < DK; ++n) store2(dst + n * 8, o[n][2 * r] / lr, o[n][2 * r + 1] / lr);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int H, int Hkv, int Sq, int Sk, int causal, int has_window,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = Tiles<T, D>::kSmem;
  // once per instantiation: the port drives one card per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Sq, Sk, causal, has_window, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Sk, int causal, int has_window,
                     int window, float scale, cudaStream_t stream) {
#define RT_D_CASE(DD)                                                              \
  case DD:                                                                         \
    return launch<T, DD>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, has_window,      \
                         window, scale, stream);
  switch (D) { RT_D_CASE(16) RT_D_CASE(32) }
  if constexpr (std::is_same_v<T, float>) {
    switch (D) { RT_D_CASE(64) RT_D_CASE(128) RT_D_CASE(256) }
  }
#undef RT_D_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16: 0 for float32 operands, 1 for bfloat16 (D 16 or 32 only).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  int B, int H, int Hkv, int Sq, int Sk, int D,
                                  int causal, int has_window, int window, float scale,
                                  int bf16, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, Hkv, Sq, Sk, causal,
                                     has_window, window, scale, s)
           : launch_d<float>(D, q, k, v, out, B, H, Hkv, Sq, Sk, causal, has_window,
                             window, scale, s);
  return static_cast<int>(err);
}
