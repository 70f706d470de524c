"""Host-side partial-aggregate algebra for operator pushdown.

Port of `repro.core.agg`.  The kernels (kernels/agg_push.py) emit PER-BLOCK
accumulators: count, 16-bit hi/lo split int sums, float32 block sums, min
and max.  This module defines the one canonical way to reduce them: per row
group, blocks fold left to right; across row groups, per-row-group partials
fold left to right in global row-group order.  Int sums are exact (the
hi/lo split recombines losslessly in int64), so their merge is
order-independent; float sums are float64 left folds whose bit pattern the
canonical order pins.  Every path (sequential, batched, sliced) partitions
at row-group granularity and folds in the same order, which makes pushed-
down aggregation bit-identical to scan-then-aggregate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import (
    AGG_FLT_MAX_IDENT,
    AGG_FLT_MIN_IDENT,
    AGG_INT_MAX_IDENT,
    AGG_INT_MIN_IDENT,
    AGG_INT_SHIFT,
)
from repro_torch.lakeformat.encodings import PACK_BLOCK


@dataclasses.dataclass
class ColPartial:
    """One column's merged accumulator over some set of blocks: cnt and sum
    are exact int64 (or canonical-order float64), mn and mx carry the value
    dtype with the identity fill where no masked row contributed."""

    cnt: np.ndarray  # (G,) int64
    s: np.ndarray  # (G,) int64 (int values) | float64 (float values)
    mn: np.ndarray  # (G,) value dtype
    mx: np.ndarray  # (G,) value dtype
    is_float: bool


def _host(a) -> np.ndarray:
    """A plane as a host numpy array (a tensor on any device, or an array)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def identity_partial(n_groups: int, dtype) -> ColPartial:
    """The merge identity: what an all-pruned (or fully masked-out) scan
    contributes.  Merging it into any partial on either side is a no-op."""
    dtype = np.dtype(dtype)
    is_float = np.issubdtype(dtype, np.floating)
    if is_float:
        mn_f, mx_f = AGG_FLT_MIN_IDENT, AGG_FLT_MAX_IDENT
        s = np.zeros(n_groups, np.float64)
    else:
        mn_f, mx_f = AGG_INT_MIN_IDENT, AGG_INT_MAX_IDENT
        s = np.zeros(n_groups, np.int64)
    return ColPartial(
        np.zeros(n_groups, np.int64), s,
        np.full(n_groups, mn_f, dtype), np.full(n_groups, mx_f, dtype),
        is_float,
    )


def _seq_sum(a: np.ndarray) -> np.ndarray:
    """Left fold over axis 0: np.cumsum is sequential by definition, so this
    pins the float64 accumulation order (np.sum reassociates pairwise)."""
    return a.cumsum(axis=0)[-1] if a.shape[0] else a.sum(axis=0)


def fold_blocks(planes: Tuple, is_float: bool) -> ColPartial:
    """Reduce the kernel's 5 x (nblocks, G) planes (cnt, s0, s1, mn, mx from
    ops.grouped_agg_batch / ops.fused_agg_batch) to one (G,) partial."""
    cnt, s0, s1, mn, mx = (_host(p) for p in planes)
    out_cnt = _seq_sum(cnt.astype(np.int64))
    if is_float:
        s = _seq_sum(s0.astype(np.float64))
    else:
        # v == (v >> 16) * 2^16 + (v & 0xFFFF): both planes fit int32 per
        # block, and the int64 recombination is exact
        s = _seq_sum((s0.astype(np.int64) << AGG_INT_SHIFT) + s1.astype(np.int64))
    return ColPartial(out_cnt, s, mn.min(axis=0), mx.max(axis=0), is_float)


def merge_partials(parts: Sequence[ColPartial]) -> ColPartial:
    """Left-fold per-row-group partials IN THE GIVEN ORDER; callers pass
    global row-group order, which pins the float-sum bit pattern."""
    assert parts, "merge_partials needs at least one partial"
    first = parts[0]
    cnt = first.cnt.copy()
    s = first.s.copy()
    mn = first.mn.copy()
    mx = first.mx.copy()
    for p in parts[1:]:
        cnt += p.cnt
        s += p.s
        np.minimum(mn, p.mn, out=mn)
        np.maximum(mx, p.mx, out=mx)
    return ColPartial(cnt, s, mn, mx, first.is_float)


def finalize(specs, merged: Dict[Optional[str], ColPartial],
             n_groups: int) -> Dict[str, np.ndarray]:
    """Per-spec (n_groups,) result arrays.  Empty groups keep the merge
    identities: count 0, sum 0, min/max at the identity fill."""
    out: Dict[str, np.ndarray] = {}
    any_part = next(iter(merged.values()))
    for spec in specs:
        p = merged.get(spec.column, any_part)
        if spec.op == "count":
            # the row count is value-independent: any column's cnt plane works
            out[spec.out_name()] = (p if spec.column in merged else any_part).cnt
        elif spec.op == "sum":
            out[spec.out_name()] = p.s
        elif spec.op == "min":
            out[spec.out_name()] = p.mn
        else:
            out[spec.out_name()] = p.mx
    return out


def agg_sources(specs) -> List[Optional[str]]:
    """Distinct value columns the specs reduce, in spec order; [None] when
    every spec is a bare count(*) (cnt is value-independent)."""
    value_cols = dict.fromkeys(s.column for s in specs if s.column is not None)
    return list(value_cols) or [None]


def rows_partials(cols: Dict[str, np.ndarray], mask: np.ndarray,
                  specs, group_by: Optional[str], n_groups: int,
                  segments: Optional[Sequence[int]] = None,
                  ) -> Dict[Optional[str], List[ColPartial]]:
    """Per-source, per-segment ColPartials from already-decoded rows (numpy
    arrays or tensors), through the exact pushdown conventions: rows
    reshape into PACK_BLOCK blocks, each block reduces through the plain
    `grouped_agg` on the CPU (bit for bit the kernel's planes, float sums
    included), and blocks fold in the canonical order.  `segments` gives
    the per-row-group block counts, so fold boundaries match the engine's
    (None = one segment).  Used by the scan-then-aggregate comparator below."""
    mask = _host(mask)
    L = mask.shape[0]
    assert L % PACK_BLOCK == 0, L
    nb = L // PACK_BLOCK
    segments = list(segments) if segments is not None else [nb]
    assert sum(segments) == nb, (segments, nb)
    if group_by is not None:
        gids = _host(cols[group_by]).astype(np.int32).reshape(nb, PACK_BLOCK)
    else:
        gids = np.zeros((nb, PACK_BLOCK), np.int32)
    m = torch.from_numpy(np.ascontiguousarray(mask.reshape(nb, PACK_BLOCK)))
    g = torch.from_numpy(gids)
    out: Dict[Optional[str], List[ColPartial]] = {}
    for name in agg_sources(specs):
        if name is None:
            vals = gids  # pure count(*): cnt is value-independent
        else:
            vals = np.ascontiguousarray(_host(cols[name]).reshape(nb, PACK_BLOCK))
        is_float = np.issubdtype(vals.dtype, np.floating)
        v = torch.from_numpy(vals)
        parts: List[ColPartial] = []
        off = 0
        for seg in segments:
            planes = ref.grouped_agg(v[off:off + seg], g[off:off + seg],
                                     m[off:off + seg], n_groups)
            parts.append(fold_blocks(planes, is_float))
            off += seg
        out[name] = parts
    return out


def aggregate_rows_host(cols: Dict[str, np.ndarray], mask: np.ndarray,
                        specs, group_by: Optional[str], n_groups: int,
                        segments: Optional[Sequence[int]] = None,
                        ) -> Dict[str, np.ndarray]:
    """Scan-then-aggregate comparator: `rows_partials` merged per source in
    segment (= global row-group) order, then finalized.  The bit-identity
    tests hold pushed-down results equal to this."""
    by_src = rows_partials(cols, mask, specs, group_by, n_groups, segments)
    merged = {name: merge_partials(parts) for name, parts in by_src.items()}
    return finalize(specs, merged, n_groups)
