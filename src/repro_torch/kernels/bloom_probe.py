"""Hopper kernel: bloom-filter probe, the pushed-down semijoin (csrc/bloom_probe.cu).

Port of `bloom_probe_pallas` (repro/kernels/bloom_probe.py:44), with the
semantics of `repro/kernels/ref.py` bloom_probe: the murmur-style double
hash of each int32 key (read as uint32) and `n_hashes` probes of a
byte-per-bit filter of a power-of-two size.  The filter is staged in shared
memory, so it may hold at most `MAX_BITS` bytes, the reference kernel's
VMEM-resident limit too.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import RLE_OUT_BLOCK

KERNEL = build.Kernel("bloom_probe", "src/repro_torch/kernels/csrc/bloom_probe.cu",
                      "src/repro/kernels/bloom_probe.py:44")

MAX_BITS = 1 << 17  # 128 KiB of shared memory


def bloom_probe(keys: torch.Tensor, bits: torch.Tensor, n_hashes: int = 4) -> torch.Tensor:
    """(nblk, 1024) int32 keys + (n_bits,) uint8 filter on the card ->
    membership (nblk, 1024) bool."""
    build.check_operand(keys, "keys", (torch.int32,), (None, RLE_OUT_BLOCK))
    build.check_operand(bits, "bits", (torch.uint8,), (None,), keys.device)
    n_bits = int(bits.shape[0])
    if n_bits < 1 or n_bits & (n_bits - 1) or n_bits > MAX_BITS:
        raise ValueError(f"n_bits={n_bits} must be a power of two <= {MAX_BITS}")
    if n_hashes < 0:
        raise ValueError(f"n_hashes={n_hashes} must be >= 0")
    if keys.data_ptr() % 16:
        raise ValueError("keys must be 16-byte aligned (the kernel loads 4 keys at a time)")
    nblk = int(keys.shape[0])
    out = torch.empty((nblk, RLE_OUT_BLOCK), dtype=torch.bool, device=keys.device)
    if nblk:
        build.launch("rt_bloom_probe", keys.device, keys, bits, n_bits, int(n_hashes),
                     out, nblk)
        KERNEL.launches += 1
    return out
