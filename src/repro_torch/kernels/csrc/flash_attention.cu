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
// Bound: operations at the model's shape. The two products take
// 4 * B * H * D * (sum over rows of the keys each row sees) operations; for
// one qwen3-1.7b layer at S = 4096 (B = 1, H = 16, D = 128, causal) that is
// 68.7 GFLOP, about 69 us at the H100's 989 TFLOP/s in bf16 on tensor cores,
// against about 15 us for the 50 MB it must move at 3.35 TB/s.
//
// Design (simple and right first; this version runs far from that bound):
// one CTA of 8 warps per (64-row query tile, head, batch). The q tile and, in
// turn, each 64-key tile of K and V are staged in dynamic shared memory as
// float32 (209 KiB at D = 256; the launcher raises the CTA's opt-in limit).
// Each warp owns 8 query rows; lane t scores keys t and t + 32 of the tile
// against them with float32 FMAs on the CUDA cores (float4 reads: the q row
// is a broadcast, the K rows are padded by 4 floats so 8 lanes hit 8
// distinct bank groups), takes the tile's row maximum and sum by warp
// shuffles, and rescales its running max, sum and accumulator (kept in
// registers, float32) as the online softmax does. The probabilities go
// through a per-warp slice of shared memory into P V, where lane t owns
// output columns t, t + 32, ... so the V reads and the final stores are
// coalesced. The key loop is trimmed to the union of the tile's rows'
// visible ranges, unless a row of the tile sees no key: that row needs all
// Sk keys (at -1e30 each), so the loop then runs over all of them. Keys past
// Sk (the ragged last tile) get -inf, which gives them exactly zero weight
// against a running max that is always finite (it starts at -1e30). exp is
// expf, the accurate one, so float32 inputs agree with mha to ~1e-6.
// No tensor cores: TF32 would not reach the float32 tolerance of the tests
// (3e-5).  bfloat16 at D 64, 128 and 256 runs on them instead, in
// csrc/flash_attention_wgmma.cu (wgmma fed by TMA).
//
// A launch the card refuses (too much shared memory, a grid too large) is
// reported by cudaGetLastError(), which rt_flash_attention returns.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                  // query rows per CTA
constexpr int kKeys = 64;                  // keys per shared-memory tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr float kMasked = -1e30f;          // ref.mha's masked logit

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's .to()
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of one CTA, in floats: the q tile, the K tile (rows padded
// by 4), the V tile and the probabilities of the 64 rows.
template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kRows) * D + static_cast<size_t>(kKeys) * (D + 4) +
         static_cast<size_t>(kKeys) * D + static_cast<size_t>(kRows) * kKeys;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int H,
                           int Hkv, int Sq, int Sk, int causal, int has_window,
                           int window, float scale) {
  static_assert(D % 4 == 0 && D <= 256, "head dim");
  constexpr int KS = D + 4;               // padded K row
  constexpr int NJ = (D + 31) / 32;       // output columns per lane
  constexpr int Q4 = D / 4;               // float4 per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * D;
  float* Vs = Ks + kKeys * KS;
  float* Ps = Vs + kKeys * D;
  __shared__ int key_range[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long long off = static_cast<long long>(Sk) - Sq;  // row i sits at i + off
  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;
  const T* vb = v + (static_cast<size_t>(b) * Hkv + hk) * Sk * D;

  for (int idx = tid; idx < kRows * Q4; idx += kThreads) {
    const int r = idx / Q4, c = (idx % Q4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i0 + r < Sq) x = Io<T>::load4(qb + static_cast<size_t>(i0 + r) * D + c);
    *reinterpret_cast<float4*>(Qs + r * D + c) = x;
  }
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
  const int lo = key_range[0], hi = key_range[1];

  const int row0 = warp * kRowsPerWarp;   // this warp's first row in the tile
  float acc[kRowsPerWarp][NJ];
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = lo / kKeys * kKeys; k0 < hi; k0 += kKeys) {
    __syncthreads();  // every warp is done with the previous K, V tile
    for (int idx = tid; idx < kKeys * Q4; idx += kThreads) {
      const int r = idx / Q4, c = (idx % Q4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < Sk) {
        const size_t at = static_cast<size_t>(k0 + r) * D + c;
        kx = Io<T>::load4(kb + at);
        vx = Io<T>::load4(vb + at);
      }
      *reinterpret_cast<float4*>(Ks + r * KS + c) = kx;
      *reinterpret_cast<float4*>(Vs + r * D + c) = vx;
    }
    __syncthreads();

    // scores of the warp's rows against keys k0 + lane and k0 + lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* ka = Ks + lane * KS;
    const float* kc = Ks + (lane + 32) * KS;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(ka + d);
      const float4 x1 = *reinterpret_cast<const float4*>(kc + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (row0 + r) * D + d);
        s[r][0] = fmaf(qv.x, x0.x, s[r][0]);
        s[r][0] = fmaf(qv.y, x0.y, s[r][0]);
        s[r][0] = fmaf(qv.z, x0.z, s[r][0]);
        s[r][0] = fmaf(qv.w, x0.w, s[r][0]);
        s[r][1] = fmaf(qv.x, x1.x, s[r][1]);
        s[r][1] = fmaf(qv.y, x1.y, s[r][1]);
        s[r][1] = fmaf(qv.z, x1.z, s[r][1]);
        s[r][1] = fmaf(qv.w, x1.w, s[r][1]);
      }
    }

    // mask, then the online softmax of each row
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long pos = i0 + row0 + r + off;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + lane + 32 * c;
        if (key >= Sk) {
          x[c] = -INFINITY;  // past the end: no weight, not even in an empty row
        } else {
          const bool seen = (!causal || key <= pos) && (!has_window || key > pos - window);
          x[c] = seen ? s[r][c] * scale : kMasked;
        }
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= alpha;
      Ps[(row0 + r) * kKeys + lane] = p0;
      Ps[(row0 + r) * kKeys + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over the tile's keys
    for (int c = 0; c < kKeys; c += 4) {
      float4 pr[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        pr[r] = *reinterpret_cast<const float4*>(Ps + (row0 + r) * kKeys + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          const float vj = (D % 32 == 0 || d < D) ? vrow[d] : 0.f;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float p = cc == 0 ? pr[r].x : cc == 1 ? pr[r].y : cc == 2 ? pr[r].z : pr[r].w;
            acc[r][j] = fmaf(p, vj, acc[r][j]);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = i0 + row0 + r;
    if (i >= Sq) continue;
    T* o = out + (static_cast<size_t>(b) * H + h) * Sq * D + static_cast<size_t>(i) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (D % 32 == 0 || d < D) o[d] = Io<T>::store(acc[r][j] / l[r]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int H, int Hkv, int Sq, int Sk, int causal, int has_window,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
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
