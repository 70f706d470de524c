"""Hopper kernel: block-aligned RLE expansion by rank lookup (csrc/rle_decode.cu).

Port of `rle_decode_pallas` (repro/kernels/rle_decode.py:48), with the
semantics of `repro/kernels/ref.py` rle_decode: position j of a block takes
run min(|{r : ends[r] <= j}|, 127).  Runs move as raw 32-bit words, so one
kernel serves int32 and float32 columns.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import RLE_OUT_BLOCK, RLE_WINDOW

KERNEL = build.Kernel("rle_decode", "src/repro_torch/kernels/csrc/rle_decode.cu",
                      "src/repro/kernels/rle_decode.py:48")


def rle_decode(values: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """(nblk, 128) int32/float32 run values + (nblk, 128) int32 nondecreasing
    ends on the card -> (nblk, 1024) values of the runs' dtype."""
    build.check_operand(values, "values", (torch.int32, torch.float32), (None, RLE_WINDOW))
    nblk = int(values.shape[0])
    build.check_operand(ends, "ends", (torch.int32,), (nblk, RLE_WINDOW), values.device)
    out = torch.empty((nblk, RLE_OUT_BLOCK), dtype=values.dtype, device=values.device)
    if nblk:
        build.launch("rt_rle_decode", values.device, values, ends, out, nblk)
        KERNEL.launches += 1
    return out
