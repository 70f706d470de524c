"""Hopper kernel: unpack + un-zigzag + blocked prefix sum (csrc/delta_decode.cu).

Port of `delta_decode_pallas` (repro/kernels/delta_decode.py:57), with the
semantics of `repro/kernels/ref.py` delta_decode: int32 wraparound, prefix
order v = s*128 + l within each 4096-value block.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import PACK_BLOCK

SOURCE = "src/repro_torch/kernels/csrc/delta_decode.cu"
REPLACES = "src/repro/kernels/delta_decode.py:57"

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> int:
    """Zero the launch count; returns the value it had."""
    global launches
    n, launches = launches, 0
    return n


def delta_decode(packed: torch.Tensor, bases: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 zigzag words + (nblocks,) int32 bases on the
    card -> (nblocks, 4096) int32."""
    global launches
    nb = build.check_packed(packed, k)
    build.check_operand(bases, "bases", (torch.int32,), (nb,), packed.device)
    out = torch.empty((nb, PACK_BLOCK), dtype=torch.int32, device=packed.device)
    if nb:
        build.launch("rt_delta_decode", packed.device, packed, bases, out, nb, k)
        launches += 1
    return out
