// Bloom-filter probe (the pushed-down semijoin): hash each int32 key with a
// murmur-style double hash and test n_hashes bytes of a byte-per-bit filter.
// (nblk, 1024) int32 keys + (n_bits,) uint8 filter -> (nblk, 1024) bool.
//
// Replaces: bloom_probe_pallas, repro/kernels/bloom_probe.py:44, with the
// semantics of repro/kernels/ref.py bloom_probe: h1 = mix(k * 0xCC9E2D51),
// h2 = mix(k * 0x1B873593) | 1, probe i reads byte (h1 + i * h2) & (n_bits-1),
// all in uint32 arithmetic, which wraps mod 2^32 as the reference's does.
//
// Bound: operations. Per key it reads 4 bytes and writes 1 (5 * nblk * 1024
// bytes, plus the filter once, over 3.35 TB/s on an H100), but it spends
// 21 + 5 * n_hashes integer issue slots: 9 per hash mix with its multiply
// (three shifts, three xors, three multiplies), the or, and per probe an
// and, an address add, a compare, an and into the result and the step to
// the next index, plus packing the output byte. At 4 hashes that is 41 per
// key against 16.75e12 32-bit integer operations per second.
//
// Design: the filter (n_bits <= 2^17 bytes, 128 KiB) is staged once per CTA
// in dynamic shared memory (16-byte loads when it is aligned), where the
// probes' random byte reads stay on chip. The grid is sized by the occupancy
// that footprint allows and walks the key blocks in a grid-stride loop, so a
// stack of thousands of blocks fills the filter once per CTA, not once per
// block. 256 threads each load 4 keys as one 16-byte load and store their 4
// result bytes as one 4-byte store, both coalesced across the warp.

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;  // keys per block
constexpr int kPer = 4;       // keys per thread
constexpr int kThreads = kBlock / kPer;

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t probe(const uint8_t* bits, uint32_t key,
                                          uint32_t mod, int n_hashes) {
  const uint32_t h2 = mix(key * 0x1B873593u) | 1u;
  uint32_t h = mix(key * 0xCC9E2D51u);
  uint32_t ok = 1u;
  for (int i = 0; i < n_hashes; ++i) {
    ok &= bits[h & mod] != 0;
    h += h2;  // h1 + (i + 1) * h2 mod 2^32
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads)
    bloom_probe_kernel(const int4* __restrict__ keys,
                       const uint8_t* __restrict__ bits, int n_bits,
                       int n_hashes, uint32_t* __restrict__ out,
                       int nblocks) {
  extern __shared__ __align__(16) uint8_t sbits[];
  if ((reinterpret_cast<uintptr_t>(bits) & 15u) == 0 && (n_bits & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(bits);
    uint4* dst = reinterpret_cast<uint4*>(sbits);
    for (int i = threadIdx.x; i < n_bits / 16; i += kThreads) dst[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < n_bits; i += kThreads) sbits[i] = __ldg(bits + i);
  }
  __syncthreads();

  const uint32_t mod = static_cast<uint32_t>(n_bits - 1);
  for (size_t b = blockIdx.x; b < static_cast<size_t>(nblocks); b += gridDim.x) {
    const size_t i = b * kThreads + threadIdx.x;
    const int4 k = __ldg(keys + i);
    out[i] = probe(sbits, static_cast<uint32_t>(k.x), mod, n_hashes) |
             probe(sbits, static_cast<uint32_t>(k.y), mod, n_hashes) << 8 |
             probe(sbits, static_cast<uint32_t>(k.z), mod, n_hashes) << 16 |
             probe(sbits, static_cast<uint32_t>(k.w), mod, n_hashes) << 24;
  }
}

}  // namespace

extern "C" int rt_bloom_probe(const void* keys, const void* bits, int n_bits,
                              int n_hashes, void* out, int nblocks,
                              void* stream) {
  if (nblocks <= 0 || n_bits <= 0 || (n_bits & (n_bits - 1)) != 0 || n_hashes < 0)
    return cudaErrorInvalidValue;
  static const rt::Setup setup =
      rt::make_setup(bloom_probe_kernel, kThreads, true);
  if (setup.err != cudaSuccess) return setup.err;
  const size_t smem = static_cast<size_t>(n_bits);
  bloom_probe_kernel<<<rt::grid_size(setup, smem, nblocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(keys), static_cast<const uint8_t*>(bits),
      n_bits, n_hashes, static_cast<uint32_t*>(out), nblocks);
  return static_cast<int>(cudaGetLastError());
}
