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

// What a launch needs to know of the card and of one kernel instantiation.
// None of it changes between launches, so it is worked out on the first one
// (the port drives one card per process) and never again: a launch then
// makes no runtime query, which matters on the host-bound query path.
struct Setup {
  cudaError_t err = cudaSuccess;
  int sms = 0;            // multiprocessors
  int per_sm = 1;         // CTAs per SM that registers and threads allow
  size_t smem_per_sm = 0; // shared memory per SM
  size_t reserved = 0;    // shared memory the runtime reserves per CTA
};

template <typename Kernel>
Setup make_setup(Kernel kernel, bool shared) {
  Setup s;
  int device = 0, optin = 0, per_sm_smem = 0, reserved = 0;
  if ((s.err = cudaGetDevice(&device)) != cudaSuccess) return s;
  if ((s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
      (s.err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess ||
      (s.err = cudaDeviceGetAttribute(
           &per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
           device)) != cudaSuccess ||
      (s.err = cudaDeviceGetAttribute(
           &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device)) !=
          cudaSuccess)
    return s;
  s.smem_per_sm = static_cast<size_t>(per_sm_smem);
  s.reserved = static_cast<size_t>(reserved);
  // allow every launch of this instantiation up to the opt-in maximum
  // (227 KiB on an H100); the wrapper never asks for more
  if (shared &&
      (s.err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess)
    return s;
  s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel,
                                                        rt::kLanes, 0);
  if (s.per_sm < 1) s.per_sm = 1;
  return s;
}

template <int K, bool kShared>
cudaError_t launch(const void* packed, const void* dict, int dict_len,
                   void* out, int nblocks, cudaStream_t stream) {
  auto kernel = dict_decode_kernel<K, kShared>;
  static const Setup setup = make_setup(kernel, kShared);
  if (setup.err != cudaSuccess) return setup.err;
  const size_t smem = kShared ? static_cast<size_t>(dict_len) * 4 : 0;
  // CTAs per SM: what registers and threads allow, and, for the shared
  // branch, what this dictionary's footprint leaves room for
  int per_sm = setup.per_sm;
  if (kShared) {
    const size_t fit = setup.smem_per_sm / (smem + setup.reserved);
    if (fit < static_cast<size_t>(per_sm))
      per_sm = fit > 0 ? static_cast<int>(fit) : 1;
  }
  const long long ctas = static_cast<long long>(setup.sms) * per_sm;
  const int grid = static_cast<int>(ctas < nblocks ? ctas : nblocks);
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
