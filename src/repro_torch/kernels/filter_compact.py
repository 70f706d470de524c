"""Hopper kernel: per-block stable stream compaction (csrc/filter_compact.cu).

Port of `filter_compact_pallas` (repro/kernels/filter_compact.py:52), with
the semantics of `repro/kernels/ref.py` filter_compact: per 1024-value
block, the values whose mask is set packed to the front in order, zeros
after them, and the count.  Values move as raw 32-bit words, so one launch
is exact for int32 and float32 alike; the reference's two 16-bit halves for
large ints are a device of its f32 contraction that this kernel does not
need.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import RLE_OUT_BLOCK

KERNEL = build.Kernel("filter_compact", "src/repro_torch/kernels/csrc/filter_compact.cu",
                      "src/repro/kernels/filter_compact.py:52")


def filter_compact(values: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nblk, 1024) int32/float32 values + (nblk, 1024) bool mask on the
    card -> (compacted (nblk, 1024) of the values' dtype, counts (nblk,) int32).
    From 512 blocks on, the kernel reads the values in 16-byte vectors and
    the mask in 4-byte words."""
    build.check_operand(values, "values", (torch.int32, torch.float32), (None, RLE_OUT_BLOCK))
    nblk = int(values.shape[0])
    build.check_operand(mask, "mask", (torch.bool,), (nblk, RLE_OUT_BLOCK), values.device)
    values, mask = build.aligned(values, 16), build.aligned(mask, 4)
    out = torch.empty_like(values)
    counts = torch.empty((nblk,), dtype=torch.int32, device=values.device)
    if nblk:
        build.launch("rt_filter_compact", values.device, values, mask, out, counts, nblk)
        KERNEL.launches += 1
    return out, counts
