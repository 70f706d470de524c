#!/usr/bin/env python3
"""The card's rate for warp-level `mma.sync` products: the ceiling of the
flash_attention kernel that runs its products that way (csrc/flash_attention.cu).

    python3 scripts/mma_sync_peak.py

Each warp issues NACC independent m16n8k8 TF32 products (or m16n8k16 bf16
ones) from registers, again and again, with no loads: 2 CTAs an SM of 4, 8 or
16 warps.  It prints the FLOP/s of each setting, with the card's name, power
limit and highest SM clock first.  The kernel is built with nvcc into
build/mma_sync_peak/ at the repository root; run it on a machine with a CUDA
card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <bool TF32, int NACC>
__global__ void peak(float* out, int iters) {
  const uint32_t t = threadIdx.x;
  uint32_t a[4] = {0x3f800000u + (t << 13), 0x3f000000u, 0x3e800000u, 0x3f400000u};
  uint32_t b[2] = {0x3f800000u, 0x3f000000u + (t << 13)};
  float c[NACC][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < NACC; ++u) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(c[u][0]), "+f"(c[u][1]), "+f"(c[u][2]), "+f"(c[u][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(c[u][0]), "+f"(c[u][1]), "+f"(c[u][2]), "+f"(c[u][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int u = 0; u < NACC; ++u) s += c[u][0] + c[u][1] + c[u][2] + c[u][3];
  out[blockIdx.x * blockDim.x + t] = s;  // keeps the products live
}
template <bool TF32>
cudaError_t run(int nacc, float* out, int blocks, int threads, int iters) {
  switch (nacc) {
    case 4: peak<TF32, 4><<<blocks, threads>>>(out, iters); break;
    case 8: peak<TF32, 8><<<blocks, threads>>>(out, iters); break;
    default: peak<TF32, 16><<<blocks, threads>>>(out, iters);
  }
  return cudaGetLastError();
}
extern "C" int mma_peak(int tf32, int nacc, float* out, int blocks, int threads, int iters) {
  return tf32 ? run<true>(nacc, out, blocks, threads, iters)
              : run<false>(nacc, out, blocks, threads, iters);
}
"""
ITERS = 20_000


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    out_dir = os.path.join(ROOT, "build", "mma_sync_peak")
    os.makedirs(out_dir, exist_ok=True)
    src, lib_path = os.path.join(out_dir, "peak.cu"), os.path.join(out_dir, "peak.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib_path, src],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.mma_peak.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 16 * 32, device="cuda")
    for tf32, name, flop in ((1, "tf32 m16n8k8", 2 * 16 * 8 * 8), (0, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for nacc in (4, 8, 16):
            for warps in (4, 8, 16):  # warps a CTA, two CTAs an SM
                blocks, threads = 2 * sms, 32 * warps
                if lib.mma_peak(tf32, nacc, out.data_ptr(), blocks, threads, 100):
                    raise RuntimeError("the probe did not launch")
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                lib.mma_peak(tf32, nacc, out.data_ptr(), blocks, threads, ITERS)
                end.record()
                torch.cuda.synchronize()
                products = blocks * warps * ITERS * nacc
                print(f"  {name}: {nacc:2d} accumulators a warp, {2 * warps:2d} warps an SM: "
                      f"{products * flop / start.elapsed_time(end) / 1e9:.1f} TFLOP/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
