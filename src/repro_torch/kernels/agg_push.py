"""Hopper kernels: aggregate pushdown, decode -> aggregate (csrc/agg_push.cu).

`grouped_agg` ports `grouped_agg_pallas` (repro/kernels/agg_push.py:59) and
`fused_agg` ports `fused_agg_pallas` (repro/kernels/agg_push.py:105), with
the semantics of `repro/kernels/ref.py` grouped_agg and fused_agg_scan.
Both emit per-block partial accumulators (count, hi/lo-split int sums or
the float32 sum, min, max); core/agg.py folds them.  The float sum is taken
in the fixed order of `kernels/ref.py` grouped_agg, so kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import PACK_BLOCK

SOURCE = "src/repro_torch/kernels/csrc/agg_push.cu"
GROUPED = build.Kernel("grouped_agg", SOURCE, "src/repro/kernels/agg_push.py:59")
FUSED = build.Kernel("fused_agg", SOURCE, "src/repro/kernels/agg_push.py:105")

MAX_GROUPS = 128  # groups per launch (the engine reduces wider domains in windows)

_MASK_KINDS = {torch.bool: 0, torch.int32: 1}


def _planes(nb: int, n_groups: int, vdtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """The 5 empty accumulator planes cnt, s0, s1, mn, mx (agg_push.py:44-46
    of the reference): s0 is float32 for float values, else int32."""
    dts = (torch.int32, torch.float32 if vdtype.is_floating_point else torch.int32,
           torch.int32, vdtype, vdtype)
    return tuple(torch.empty((nb, n_groups), dtype=dt, device=device) for dt in dts)


def grouped_agg(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                n_groups: int) -> Tuple[torch.Tensor, ...]:
    """(nblocks, 4096) int32/float32 values, int32 group ids and bool/int32
    mask on the card -> 5 x (nblocks, n_groups): cnt, s0, s1, mn, mx.  The
    kernel reads values, ids and an int32 mask in 16-byte vectors and a bool
    mask in 4-byte words."""
    if not 1 <= n_groups <= MAX_GROUPS:
        raise ValueError(f"n_groups={n_groups} outside 1..{MAX_GROUPS}")
    build.check_operand(values, "values", (torch.int32, torch.float32), (None, PACK_BLOCK))
    nb = int(values.shape[0])
    build.check_operand(gids, "gids", (torch.int32,), (nb, PACK_BLOCK), values.device)
    build.check_operand(mask, "mask", tuple(_MASK_KINDS), (nb, PACK_BLOCK), values.device)
    values, gids = build.aligned(values, 16), build.aligned(gids, 16)
    mask = build.aligned(mask, 4 * mask.element_size())
    outs = _planes(nb, n_groups, values.dtype, values.device)
    if nb:
        build.launch("rt_grouped_agg", values.device, values, gids, mask, n_groups,
                     int(values.dtype.is_floating_point), _MASK_KINDS[mask.dtype], *outs, nb)
        GROUPED.launches += 1
    return outs


def fused_agg(packed: torch.Tensor, k: int, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(nblocks, k, 128) int32 BITPACK words and (nblocks, 4096) bool/int32
    mask on the card -> 5 x (nblocks, 1) int32: cnt, s0, s1, mn, mx.  The
    kernel reads the words in 16-byte vectors and a lane's 4 mask entries of
    a row in one load."""
    nb = build.check_packed(packed, k)
    build.check_operand(mask, "mask", tuple(_MASK_KINDS), (nb, PACK_BLOCK), packed.device)
    packed, mask = build.aligned(packed, 16), build.aligned(mask, 4 * mask.element_size())
    outs = _planes(nb, 1, torch.int32, packed.device)
    if nb:
        build.launch("rt_fused_agg", packed.device, packed, mask, _MASK_KINDS[mask.dtype],
                     *outs, nb, k)
        FUSED.launches += 1
    return outs
