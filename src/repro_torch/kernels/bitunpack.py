"""Hopper kernel: lane-transposed k-bit unpack (csrc/bitunpack.cu).

Port of `bitunpack_pallas` (repro/kernels/bitunpack.py:52).  The wrapper
launches the CUDA kernel on a CUDA tensor and nothing else; the plain
version it is held against is `repro_torch.kernels.ref.bitunpack`, and
`kernels.ops` picks between the two by the operand's device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import LANES, SUBLANES

SOURCE = "src/repro_torch/kernels/csrc/bitunpack.cu"
REPLACES = "src/repro/kernels/bitunpack.py:52"

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> int:
    """Zero the launch count; returns the value it had."""
    global launches
    n, launches = launches, 0
    return n


def bitunpack(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 words on the card -> (nblocks, 32, 128) int32."""
    global launches
    nb = build.check_packed(packed, k)
    out = torch.empty((nb, SUBLANES, LANES), dtype=torch.int32, device=packed.device)
    if nb:
        build.launch("rt_bitunpack", packed.device, packed, out, nb, k)
        launches += 1
    return out
