"""Hopper kernel: unpack + un-zigzag + blocked prefix sum (csrc/delta_decode.cu).

Port of `delta_decode_pallas` (repro/kernels/delta_decode.py:57), with the
semantics of `repro/kernels/ref.py` delta_decode: int32 wraparound, prefix
order v = s*128 + l within each 4096-value block.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import PACK_BLOCK

KERNEL = build.Kernel("delta_decode", "src/repro_torch/kernels/csrc/delta_decode.cu",
                      "src/repro/kernels/delta_decode.py:57")


def delta_decode(packed: torch.Tensor, bases: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 zigzag words + (nblocks,) int32 bases on the
    card -> (nblocks, 4096) int32."""
    nb = build.check_packed(packed, k)
    build.check_operand(bases, "bases", (torch.int32,), (nb,), packed.device)
    out = torch.empty((nb, PACK_BLOCK), dtype=torch.int32, device=packed.device)
    if nb:
        build.launch("rt_delta_decode", packed.device, packed, bases, out, nb, k)
        KERNEL.launches += 1
    return out
