"""Hopper kernel: fused k-bit unpack + range filter (csrc/fused_scan.cu).

Port of `fused_scan_pallas` (repro/kernels/fused_scan.py:99) for packed
BITPACK words and DICT codes, the form the engine calls: it rewrites a DICT
predicate onto codes and never passes a dictionary.  The dictionary arm of
`ref.fused_scan` is not ported to the card yet (ROADMAP.md); on a CUDA
tensor it raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import PACK_BLOCK

SOURCE = "src/repro_torch/kernels/csrc/fused_scan.cu"
REPLACES = "src/repro/kernels/fused_scan.py:99"

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> int:
    """Zero the launch count; returns the value it had."""
    global launches
    n, launches = launches, 0
    return n


def fused_scan(
    packed: torch.Tensor, k: int, lo: int, hi: int,
    dictionary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nblocks, k, 128) int32 words on the card and int32 bounds ->
    (mask (nblocks, 4096) bool: lo <= v <= hi, counts (nblocks,) int32)."""
    global launches
    if dictionary is not None:
        raise NotImplementedError(
            "fused_scan with a dictionary has no CUDA kernel yet "
            "(ROADMAP.md B: fused_scan dictionary arm)")
    nb = build.check_packed(packed, k)
    lo, hi = int(lo), int(hi)
    if not (INT32_MIN <= lo <= INT32_MAX and INT32_MIN <= hi <= INT32_MAX):
        raise ValueError(f"bounds ({lo}, {hi}) outside int32")
    mask = torch.empty((nb, PACK_BLOCK), dtype=torch.bool, device=packed.device)
    counts = torch.empty((nb,), dtype=torch.int32, device=packed.device)
    if nb:
        build.launch("rt_fused_scan", packed.device, packed, lo, hi, mask, counts, nb, k)
        launches += 1
    return mask, counts
