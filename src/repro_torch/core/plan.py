"""Scan plans and the pushdown predicate algebra.

Port copy of `repro.core.plan`, kept in step with it so both packages build
the same plans and bind the same predicates; the port never imports the JAX
package.

This is the framework's "post-optimizer hook" (paper §2): a query's plan is
rewritten so that its filtered table scans become DatapathEngine scans —
decode + predicate + projection evaluated in the datapath — and the host
query only ever sees pre-filtered columns.

Predicate expressions form a small algebra (Cmp / And / Or / InSet /
BloomProbe) that the engine can evaluate entirely on-device.  String
constants are folded to dictionary codes at bind time (bind_plan), mirroring
how real engines constant-fold against file metadata.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

Value = Union[int, float, str]

INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


@dataclasses.dataclass(frozen=True)
class Cmp:
    column: str
    op: str  # 'lt','le','gt','ge','eq','ne','between'
    value: Union[Value, Tuple[Value, Value]]


@dataclasses.dataclass(frozen=True)
class InSet:
    column: str
    values: Tuple[Value, ...]


@dataclasses.dataclass(frozen=True)
class BloomProbe:
    """Probe-side semijoin filter: keep rows whose `column` hits the bloom."""

    column: str
    n_bits: int = 1 << 15
    n_hashes: int = 4
    name: str = "bloom"  # key into ScanRequest.blooms


@dataclasses.dataclass(frozen=True)
class And:
    children: Tuple["Expr", ...]


@dataclasses.dataclass(frozen=True)
class Or:
    children: Tuple["Expr", ...]


Expr = Union[Cmp, InSet, BloomProbe, And, Or]


def and_(*children: Expr) -> Expr:
    return And(tuple(children))


def or_(*children: Expr) -> Expr:
    return Or(tuple(children))


def expr_columns(e: Optional[Expr]) -> List[str]:
    if e is None:
        return []
    if isinstance(e, (Cmp, InSet, BloomProbe)):
        return [e.column]
    cols: List[str] = []
    for c in e.children:
        cols.extend(expr_columns(c))
    return cols


AGG_OPS = ("sum", "min", "max", "count")


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One pushed-down aggregate: `op` over `column` (None for a bare row
    count).  The engine reduces these per block inside the bucket launch
    and only partial accumulators — never the value column — cross the
    result DMA."""

    op: str  # 'sum' | 'min' | 'max' | 'count'
    column: Optional[str] = None  # None only for count
    name: Optional[str] = None  # result key override

    def __post_init__(self):
        assert self.op in AGG_OPS, self.op
        assert self.column is not None or self.op == "count", self

    def out_name(self) -> str:
        if self.name is not None:
            return self.name
        return f"{self.op}({self.column})" if self.column else "count(*)"


@dataclasses.dataclass
class ScanPlan:
    """One pushed-down table scan."""

    table: str  # reader key / path
    columns: List[str]  # projection the consumer needs (post-filter)
    predicate: Optional[Expr] = None
    compact: bool = False  # materialize survivors packed to the front
    # operator pushdown (DESIGN.md §16): when `aggregates` is set the scan
    # returns (n_groups,) accumulators instead of row columns, optionally
    # keyed by `group_by` (a DICT/string column whose decoded form is
    # already a dense int code — groups never require decoding strings)
    aggregates: Optional[Tuple[AggSpec, ...]] = None
    group_by: Optional[str] = None

    def all_columns(self) -> List[str]:
        seen = dict.fromkeys(self.columns)
        for spec in self.aggregates or ():
            if spec.column is not None:
                seen.setdefault(spec.column)
        if self.group_by is not None:
            seen.setdefault(self.group_by)
        for c in expr_columns(self.predicate):
            seen.setdefault(c)
        return list(seen)

    def materialized_columns(self) -> List[str]:
        """Columns whose decoded VALUES the scan consumes (projection +
        aggregate inputs + group key) — as opposed to predicate-only
        columns, which exist solely to produce the mask and are dropped
        before the result DMA (decode→project)."""
        seen = dict.fromkeys(self.columns)
        for spec in self.aggregates or ():
            if spec.column is not None:
                seen.setdefault(spec.column)
        if self.group_by is not None:
            seen.setdefault(self.group_by)
        return list(seen)

    def signature(self) -> str:
        """Stable id for prefiltered-cache keys."""
        sig = {
            "table": self.table,
            "columns": self.columns,
            "pred": _expr_repr(self.predicate),
            "compact": self.compact,
        }
        if self.aggregates:
            sig["aggs"] = [[s.op, s.column, s.name] for s in self.aggregates]
            sig["group_by"] = self.group_by
        blob = json.dumps(sig, sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _expr_repr(e: Optional[Expr]):
    if e is None:
        return None
    if isinstance(e, Cmp):
        return ["cmp", e.column, e.op, e.value]
    if isinstance(e, InSet):
        return ["in", e.column, list(e.values)]
    if isinstance(e, BloomProbe):
        return ["bloom", e.column, e.n_bits, e.n_hashes, e.name]
    tag = "and" if isinstance(e, And) else "or"
    return [tag] + [_expr_repr(c) for c in e.children]


def pred_int_bounds(e: Optional[Expr]) -> Optional[Tuple[int, int]]:
    """Closed integer interval [lo, hi] equivalent to a single comparison,
    or None when the predicate is not a bounds-expressible integer Cmp.
    This is the predicate half of the engine's fused decode+filter
    eligibility test, shared with the metadata-only cost estimator
    (datapath/costmodel.py) so both agree on what will fuse."""
    if not isinstance(e, Cmp):
        return None
    if e.op == "between":
        lo, hi = e.value
    elif e.op in ("ge", "gt"):
        lo = e.value + (e.op == "gt")
        hi = INT32_MAX
    elif e.op in ("le", "lt"):
        lo = INT32_MIN
        hi = e.value - (e.op == "lt")
    elif e.op == "eq":
        lo = hi = e.value
    else:
        return None
    if not (isinstance(lo, (int, np.integer)) and isinstance(hi, (int, np.integer))):
        return None
    return int(lo), int(hi)


def bind_expr(e: Optional[Expr], reader) -> Optional[Expr]:
    """Fold string constants to dictionary codes using file metadata."""
    if e is None:
        return None
    if isinstance(e, Cmp):
        v = e.value
        if isinstance(v, str):
            v = reader.string_code(e.column, v)
        elif isinstance(v, tuple):
            v = tuple(
                reader.string_code(e.column, x) if isinstance(x, str) else x for x in v
            )
        return Cmp(e.column, e.op, v)
    if isinstance(e, InSet):
        vals = tuple(
            reader.string_code(e.column, x) if isinstance(x, str) else x
            for x in e.values
        )
        return InSet(e.column, vals)
    if isinstance(e, BloomProbe):
        return e
    children = tuple(bind_expr(c, reader) for c in e.children)
    return And(children) if isinstance(e, And) else Or(children)
