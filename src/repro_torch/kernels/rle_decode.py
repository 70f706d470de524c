"""Hopper kernel: block-aligned RLE expansion by a rank table or a search
(csrc/rle_decode.cu).

Port of `rle_decode_pallas` (repro/kernels/rle_decode.py:48), with the
semantics of `repro/kernels/ref.py` rle_decode: position j of a block takes
run min(|{r : ends[r] <= j}|, 127) over the block's nondecreasing ends.  Runs
move as raw 32-bit words, so one kernel serves int32 and float32 columns.

The wrapper picks the launch's shape (`launch_shape`): a warp a block on a
grid-stride walk (the rank table) or a CTA a block (the search).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import RLE_OUT_BLOCK, RLE_WINDOW

KERNEL = build.Kernel("rle_decode", "src/repro_torch/kernels/csrc/rle_decode.cu",
                      "src/repro/kernels/rle_decode.py:48")

WARPS = 8  # warps a CTA (kWarps)
SPLITS = (1, 8)  # tiles a block: a warp's rank table, or the 8 warps of a CTA searching
CTAS_PER_SM = 2  # the walk's grid: 16 warps an SM, each with 2 windows in flight


def grid(nblk: int, split: int, sms: int) -> int:
    """CTAs for `nblk` blocks at `split` tiles a block on a card of `sms`
    SMs: a block each at 8 tiles; the walk of a warp a block takes at most
    CTAS_PER_SM an SM, fewer where the blocks do not fill them."""
    if split == 8:
        return nblk
    return min(-(-nblk // WARPS), sms * CTAS_PER_SM)


def launch_shape(nblk: int, sms: int) -> Tuple[int, int]:
    """(tiles a block, CTAs) for `nblk` blocks on a card of `sms` SMs: the
    rank table's walk once the blocks give every SM half a CTA's warps (528
    blocks on an H100, where the two arms time alike: PERF.md), the search
    below (the 64-block path), and their `grid`."""
    split = 1 if 2 * nblk >= sms * WARPS else 8
    return split, grid(nblk, split, sms)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rle_decode(values: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """(nblk, 128) int32/float32 run values + (nblk, 128) int32 nondecreasing
    ends on the card -> (nblk, 1024) values of the runs' dtype.  The kernel
    copies the windows in 16-byte pieces: a view that does not start on a
    16-byte boundary is copied first."""
    build.check_operand(values, "values", (torch.int32, torch.float32), (None, RLE_WINDOW))
    nblk = int(values.shape[0])
    build.check_operand(ends, "ends", (torch.int32,), (nblk, RLE_WINDOW), values.device)
    values, ends = build.aligned(values, 16), build.aligned(ends, 16)
    out = torch.empty((nblk, RLE_OUT_BLOCK), dtype=values.dtype, device=values.device)
    if nblk:
        split, ctas = launch_shape(nblk, _sms(values.device.index))
        build.launch("rt_rle_decode", values.device, values, ends, out, nblk, split, ctas)
        KERNEL.launches += 1
    return out
