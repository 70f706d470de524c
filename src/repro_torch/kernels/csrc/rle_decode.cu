// RLE decode: block-aligned run expansion by a rank table or a search.
// (nblk, 128) run values + (nblk, 128) exclusive cumulative ends
// -> (nblk, 1024) values.
//
// Replaces: rle_decode_pallas, repro/kernels/rle_decode.py:48. Semantics
// follow repro/kernels/ref.py rle_decode: out[j] = values[min(rank(j), 127)]
// with rank(j) = |{r : ends[r] <= j}| over the block's nondecreasing ends.
// The writer pads each block's window with end = 1024 runs that repeat its
// final value (lakeformat/encodings.py rle_encode); the clip re-reads it.
//
// Bound: bytes. Per block it reads 512 B of values and 512 B of ends and
// writes 4 KiB: 5120 * nblk bytes over 3.35 TB/s on an H100 (9.00 us at the
// 5,888-block stack of 92 row groups).
//
// Design: a block goes to one warp, through a rank table, or to one CTA,
// by a search; the wrapper picks the table from 528 blocks on an H100 (half
// a CTA's warps an SM), where it is no slower than the search (PERF.md).
//
// Table (a warp a block): the CTAs of 8 warps walk the blocks grid-stride,
// the grid at most 2 CTAs an SM (a large stack walks 2-3 blocks a warp);
// each warp walks its own blocks, u, u + 8 grid, ..., with no CTA barrier,
// keeping a ring of 3 windows (512 B of ends, then 512 B of values) in
// shared memory and fetching the window of the block 2 ahead with 16-byte
// cp.async.cg copies (2 a lane) while it expands the current one through a
// rank table of 1,024 bytes in 256 words:
//   1. each lane zeroes 8 words; each of runs 0..126 adds 1 to the byte of
//      position max(end, 0) when that is below 1,024 (shared atomics; ends
//      before the block count at its first position). Over nondecreasing
//      ends min(rank(j), 127) = |{r <= 126 : ends[r] <= j}|, so leaving run
//      127 out is the clip;
//   2. lane l owns the 32 positions from 32 l on (8 words of 4 bytes): it
//      sums its words byte-wise (no byte can carry: all counts together are
//      at most 127), a multiply by 0x01010101 gives its total, a 5-step
//      shuffle scan the ranks before its first position, and per word
//      (w + carry) * 0x01010101 the inclusive byte-wise prefix, so each byte
//      becomes min(rank, 127) of its position;
//   3. store s: lane l reads the word of outputs 128 s + 4 l .. + 3, takes
//      each byte as a run index (a byte permute) into the window's values,
//      and writes the 4 values as one 16-byte store, a warp 512 contiguous
//      bytes.
// The table's word w lives at w ^ ((w >> 3) & 4): a lane's 16-byte vectors
// in step 2 fall on 8 distinct bank quads per 8 lanes, and step 3's word
// reads stay one row of 32 banks.
//
// Search (a CTA a block, under 528 blocks: the 64-block path): thread t
// loads one word of the window, end t or value t - 128, and finds each of
// its 4 outputs' run by the 7-step branchless upper-bound search over the
// ends, written as one 16-byte store. A small launch is latency-bound, and
// the search's chain is shorter than the table's (zero, atomics, scan).
// Each alternative measured slower on the 64-block path in situ: the table,
// the ends padded against bank conflicts, the first steps' probes loaded
// once, a window a warp, a grid-stride loop (even one that never runs a
// second block). The path's windows (sorted dates, 1-2 runs a block) send a
// warp's probes to one address: no bank conflict.
//
// Integer issue slots (64 a clock an SM; a shuffle 2), counted from this
// source. Table, per lane and block: the walk, the fetch and the addresses
// 25; the table's scatter, 4 ends at 10 each, and its total and 5-step scan
// 18, 58; 4 a table word (the byte-wise sum, the carry's add, the multiply,
// the carry's shift) and 2 a value (the byte permute, the value's address):
// a value 2 + (83 + 4 * 8) / 32 = 5.59. Search, per thread: the block's and
// the thread's addresses 6, and 22 a value (7 steps of an add, a compare
// and a conditional add; the value's address): 23.5 a value.
// Values move as raw 32-bit words: one kernel serves int32 and float32 runs
// alike, -0.0 and NaN payloads bit for bit.

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int kOut = 1024;    // RLE_OUT_BLOCK
constexpr int kWindow = 128;  // RLE_WINDOW
constexpr int kWarps = 8;     // warps a CTA
constexpr int kStages = 3;    // windows in a warp's ring: the current, 2 ahead
constexpr int kPer = kOut / 128;  // table words a lane scans = its 16-byte stores
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(rt::smem_u32(smem)),
               "l"(gmem)
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

// Where word w of a block's rank table lives (see the note above).
__device__ __forceinline__ int swz(int w) { return w ^ ((w >> 3) & 4); }

// The kPer table words from word w0 (a multiple of 4) in registers, in
// order, and back, as 16-byte vectors.
__device__ __forceinline__ void load_words(const uint32_t* t, int w0, uint32_t (&w)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; i += 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(t + swz(w0 + i));
    w[i] = q.x, w[i + 1] = q.y, w[i + 2] = q.z, w[i + 3] = q.w;
  }
}

__device__ __forceinline__ void store_words(uint32_t* t, int w0, const uint32_t (&w)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; i += 4)
    *reinterpret_cast<uint4*>(t + swz(w0 + i)) = make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
}

// A block's 1,024 outputs expanded through the rank table (steps 1-3 of the
// note) from the window at `win` into `o`.
__device__ __forceinline__ void expand_by_table(const uint32_t* win, uint32_t* rank, int lane,
                                                uint4* o) {
  const int32_t* e = reinterpret_cast<const int32_t*>(win);
#pragma unroll
  for (int g = 0; g < kWindow / 32; ++g) {
    const int r = 32 * g + lane;
    const int p = max(e[r], 0);
    if (p < kOut && r < kWindow - 1) atomicAdd(rank + swz(p >> 2), 1u << ((p & 3) << 3));
  }
  __syncwarp();

  uint32_t w[kPer];
  load_words(rank, kPer * lane, w);
  uint32_t sum = w[0];
#pragma unroll
  for (int i = 1; i < kPer; ++i) sum += w[i];
  const uint32_t total = (sum * 0x01010101u) >> 24;
  uint32_t incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  uint32_t carry = incl - total;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    w[i] = (w[i] + carry) * 0x01010101u;
    carry = w[i] >> 24;
  }
  store_words(rank, kPer * lane, w);
  __syncwarp();

  const uint32_t* v = win + kWindow;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const uint32_t k = rank[swz(32 * s + lane)];
    o[32 * s + lane] = make_uint4(v[__byte_perm(k, 0, 0x4440)], v[__byte_perm(k, 0, 0x4441)],
                                  v[__byte_perm(k, 0, 0x4442)], v[k >> 24]);
  }
}

// The table's walk: each warp on its own blocks, u, u + 8 grid, ..., with
// its own ring of windows.
__device__ __forceinline__ void table_walk(const uint32_t* __restrict__ values,
                                           const int32_t* __restrict__ ends,
                                           uint4* __restrict__ out, int nblocks) {
  __shared__ __align__(16) uint32_t s_win[kWarps][kStages][2 * kWindow];
  __shared__ __align__(16) uint32_t s_rank[kWarps][kOut / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t(*win)[2 * kWindow] = s_win[warp];
  uint32_t* rank = s_rank[warp];
  const size_t blocks = static_cast<size_t>(nblocks);
  const size_t step = static_cast<size_t>(gridDim.x) * kWarps;
  size_t u = static_cast<size_t>(blockIdx.x) * kWarps + warp;

  // Block b's window into ring slot `slot`. Every lane commits a group,
  // empty past the last block, so the groups count the same on every lane
  // and in every iteration.
  auto fetch = [&](size_t b, int slot) {
    if (b < blocks) {
      cp_async16(&win[slot][4 * lane], ends + b * kWindow + 4 * lane);
      cp_async16(&win[slot][kWindow + 4 * lane], values + b * kWindow + 4 * lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(u + i * step, i);

  for (int slot = 0; u < blocks; u += step, slot = slot + 1 == kStages ? 0 : slot + 1) {
    // the slot the previous block freed takes the window kStages - 1 ahead
    fetch(u + (kStages - 1) * step, slot == 0 ? kStages - 1 : slot - 1);
    uint32_t z[kPer] = {};
    store_words(rank, kPer * lane, z);
    cp_async_wait<kStages - 1>();  // this block's window has landed
    __syncwarp();                  // ... for every lane, and the table is zero
    expand_by_table(win[slot], rank, lane, out + u * (kOut / 4));
    __syncwarp();  // the slot and the table are free for the next block
  }
}

// Thread t's 4 outputs 4 t .. 4 t + 3 of a block: the
// 7-step branchless upper-bound search over the block's ends in steps of 64,
// 32, ..., 1. The steps sum to 127, so the position reached is
// min(rank, 127): the clip costs nothing.
__device__ __forceinline__ void expand_by_search(const int32_t* s_end, const uint32_t* s_val,
                                                 int t, uint4* o) {
  uint32_t x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * t + i;
    int pos = 0;
#pragma unroll
    for (int step = kWindow / 2; step > 0; step >>= 1)
      if (s_end[pos + step - 1] <= j) pos += step;
    x[i] = s_val[pos];
  }
  o[t] = make_uint4(x[0], x[1], x[2], x[3]);
}

// The search: CTA b takes block b. Thread t loads one word of its
// window, end t or value t - 128, and searches its 4 outputs.
__device__ __forceinline__ void search_block(const uint32_t* __restrict__ values,
                                             const int32_t* __restrict__ ends,
                                             uint4* __restrict__ out) {
  __shared__ int32_t s_end[kWindow];
  __shared__ uint32_t s_val[kWindow];
  const int t = threadIdx.x;
  const size_t b = blockIdx.x;
  if (t < kWindow)
    s_end[t] = __ldg(ends + b * kWindow + t);
  else
    s_val[t - kWindow] = __ldg(values + b * kWindow + (t - kWindow));
  __syncthreads();
  expand_by_search(s_end, s_val, t, out + b * (kOut / 4));
}

// kSplit: tiles a block, 1 (the table's walk) or 8 (the search).
template <int kSplit>
__global__ void __launch_bounds__(kThreads)
    rle_decode_kernel(const uint32_t* __restrict__ values,
                      const int32_t* __restrict__ ends,
                      uint4* __restrict__ out, int nblocks) {
  if constexpr (kSplit == 8)
    search_block(values, ends, out);
  else
    table_walk(values, ends, out, nblocks);
}

template <int kSplit>
cudaError_t launch(const void* values, const void* ends, void* out, int nblocks, int ctas,
                   cudaStream_t stream) {
  rle_decode_kernel<kSplit><<<ctas, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(values), static_cast<const int32_t*>(ends),
      static_cast<uint4*>(out), nblocks);
  return cudaGetLastError();
}

}  // namespace

// split: tiles a block, 1 (the table's walk, on any grid of at least 1 CTA)
// or 8 (the search, a CTA a block); ctas: the grid.
extern "C" int rt_rle_decode(const void* values, const void* ends, void* out,
                             int nblocks, int split, int ctas, void* stream) {
  if (nblocks <= 0 || ctas <= 0 || (split != 1 && split != 8) ||
      (split == 8 && ctas != nblocks))
    return cudaErrorInvalidValue;
  // the window copies and the stores move 16-byte vectors
  if (reinterpret_cast<uintptr_t>(values) % 16 || reinterpret_cast<uintptr_t>(ends) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(split == 1 ? launch<1>(values, ends, out, nblocks, ctas, s)
                                     : launch<8>(values, ends, out, nblocks, ctas, s));
}
