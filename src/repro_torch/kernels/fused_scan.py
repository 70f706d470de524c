"""Hopper kernels: fused k-bit unpack + range filter (csrc/fused_scan.cu).

`fused_scan` ports `fused_scan_pallas` (repro/kernels/fused_scan.py:99), with the
semantics of `repro/kernels/ref.py` fused_scan: packed BITPACK words, or
DICT codes with their dictionary (int32 or float32; codes clip to its true
length and the int32 bounds compare in its dtype).  The engine calls the
dictionary-free arm only: it rewrites a DICT predicate onto codes.
`fused_scan_batch` ports `fused_scan_batch_pallas`
(repro/kernels/fused_scan.py:61): stacked BITPACK blocks, each with its own
bounds, mask only.

Both launch one grid-stride walk (512-thread CTAs, 8 rows a thread, the next
block's words loaded ahead, the mask staged in shared memory and written 8
contiguous bytes a thread), as many CTAs as fit on the card at once; the
source's header has the design and the variants that were timed against
it.  The kernel stores the mask 8 bytes at a time, so it writes only into a
mask that the wrapper has just allocated (aligned by the allocator).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import PACK_BLOCK

SOURCE = "src/repro_torch/kernels/csrc/fused_scan.cu"
KERNEL = build.Kernel("fused_scan", SOURCE, "src/repro/kernels/fused_scan.py:99")
BATCH = build.Kernel("fused_scan_batch", SOURCE, "src/repro/kernels/fused_scan.py:61")

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def fused_scan(
    packed: torch.Tensor, k: int, lo: int, hi: int,
    dictionary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nblocks, k, 128) int32 words on the card, int32 bounds and an
    optional (D,) int32/float32 dictionary on the card ->
    (mask (nblocks, 4096) bool: lo <= v <= hi, counts (nblocks,) int32)."""
    nb = build.check_packed(packed, k)
    lo, hi = int(lo), int(hi)
    if not (INT32_MIN <= lo <= INT32_MAX and INT32_MIN <= hi <= INT32_MAX):
        raise ValueError(f"bounds ({lo}, {hi}) outside int32")
    if dictionary is None:
        kind, d_len = 0, 0
    else:
        build.check_operand(dictionary, "dictionary", (torch.int32, torch.float32), (None,),
                            packed.device)
        kind, d_len = (1 if dictionary.dtype == torch.int32 else 2), int(dictionary.numel())
        if d_len == 0:
            raise ValueError("dictionary must not be empty")
    mask = torch.empty((nb, PACK_BLOCK), dtype=torch.bool, device=packed.device)
    counts = torch.empty((nb,), dtype=torch.int32, device=packed.device)
    if nb:
        build.launch("rt_fused_scan", packed.device, packed,
                     0 if dictionary is None else dictionary, d_len, kind, lo, hi,
                     mask, counts, nb, k)
        KERNEL.launches += 1
    return mask, counts


def fused_scan_batch(packed: torch.Tensor, k: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """(nblocks, k, 128) int32 words and (nblocks,) int32 bounds lo, hi on
    the card -> mask (nblocks, 4096) bool: lo[b] <= v <= hi[b]."""
    nb = build.check_packed(packed, k)
    build.check_operand(lo, "lo", (torch.int32,), (nb,), packed.device)
    build.check_operand(hi, "hi", (torch.int32,), (nb,), packed.device)
    mask = torch.empty((nb, PACK_BLOCK), dtype=torch.bool, device=packed.device)
    if nb:
        build.launch("rt_fused_scan_batch", packed.device, packed, lo, hi, mask, nb, k)
        BATCH.launches += 1
    return mask
