"""Zone-map row-group pruning (paper Fig. 3b).

Port copy of `repro.core.zonemap`, kept in step with it so both packages
prune the same row groups; the port never imports the JAX package.

Metadata-only: evaluates the pushed-down predicate against per-row-group
min/max from the lakeformat footer and returns the surviving row-group ids,
before a single data byte is read or decoded.  On sorted data this is where
the paper's large Q6/Q14/Q15 wins come from.

The evaluation is conservative three-valued logic: a row group is pruned
only if the predicate is provably false for every row in it.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.core.plan import And, BloomProbe, Cmp, Expr, InSet, Or


def _maybe_true(e: Expr, zonemaps: dict, rg: int) -> bool:
    """Can any row in row group `rg` satisfy e?  (conservative)."""
    if isinstance(e, Cmp):
        zm = zonemaps[e.column][rg]
        lo, hi = zm["min"], zm["max"]
        v = e.value
        if e.op == "between":
            a, b = v
            return not (hi < a or lo > b)
        if e.op in ("lt", "le"):
            return lo < v if e.op == "lt" else lo <= v
        if e.op in ("gt", "ge"):
            return hi > v if e.op == "gt" else hi >= v
        if e.op == "eq":
            return lo <= v <= hi
        if e.op == "ne":
            return not (lo == hi == v)
        raise ValueError(e.op)
    if isinstance(e, InSet):
        zm = zonemaps[e.column][rg]
        return any(zm["min"] <= v <= zm["max"] for v in e.values)
    if isinstance(e, BloomProbe):
        return True  # bloom membership is not derivable from min/max
    if isinstance(e, And):
        return all(_maybe_true(c, zonemaps, rg) for c in e.children)
    if isinstance(e, Or):
        return any(_maybe_true(c, zonemaps, rg) for c in e.children)
    raise TypeError(e)


def prune_row_groups(reader, predicate: Optional[Expr]) -> List[int]:
    """Surviving row-group ids for `predicate` over `reader`'s zone maps."""
    n = reader.n_row_groups
    if predicate is None:
        return list(range(n))
    from repro_torch.core.plan import expr_columns

    cols = set(expr_columns(predicate))
    zonemaps = {c: reader.zonemaps(c) for c in cols}
    return [rg for rg in range(n) if _maybe_true(predicate, zonemaps, rg)]


# ---------------------------------------------------------------------------
# Selectivity estimation (metadata only) — the adaptive-offload-policy input
# ---------------------------------------------------------------------------

_BLOOM_SELECTIVITY = 0.5  # membership is not derivable from min/max
_EQ_NARROW = 0.1  # eq on a sub-unit float range: cardinality unknown


def _eq_frac(lo: float, hi: float, v: float, width: float) -> float:
    if not (lo <= v <= hi):
        return 0.0
    # integers: ~width+1 distinct values; narrow float ranges (width < 1)
    # would invert the estimate under 1/width, so use a fixed guess
    return 1.0 / (width + 1.0) if width >= 1.0 else _EQ_NARROW


def _range_frac(zm: dict, a: float, b: float) -> float:
    """P(a <= value <= b) within one row group.  Uses the footer's
    equi-width histogram when present — full bins contribute their true
    mass, the two boundary bins prorate uniformly within the bin — and
    degrades to uniform-over-[min,max] for legacy files without one."""
    lo, hi = float(zm["min"]), float(zm["max"])
    width = hi - lo
    if width <= 0:
        return 1.0 if a <= lo <= b else 0.0
    a2, b2 = max(a, lo), min(b, hi)
    if a2 > b2:
        return 0.0
    hist = zm.get("hist")
    if hist:
        total = float(sum(hist)) or 1.0
        bw = width / len(hist)
        acc = 0.0
        for i, c in enumerate(hist):
            if not c:
                continue
            ov = min(lo + (i + 1) * bw, b2) - max(lo + i * bw, a2)
            if ov > 0:
                acc += c * min(1.0, ov / bw)
        return min(1.0, acc / total)
    return (b2 - a2) / width


def _eq_frac_zm(zm: dict, v: float) -> float:
    """P(value == v): the containing histogram bin's mass spread over the
    bin's distinct values; uniform-assumption fallback without a hist."""
    lo, hi = float(zm["min"]), float(zm["max"])
    width = hi - lo
    if width <= 0:
        return 1.0 if v == lo else 0.0
    if not (lo <= v <= hi):
        return 0.0
    hist = zm.get("hist")
    if hist:
        total = float(sum(hist)) or 1.0
        bw = width / len(hist)
        i = min(int((v - lo) / bw), len(hist) - 1)
        mass = hist[i] / total
        return mass / (bw + 1.0) if bw >= 1.0 else mass
    return _eq_frac(lo, hi, v, width)


def _frac_true(e: Expr, zonemaps: dict, rg: int) -> float:
    """Estimated fraction of rows in row group `rg` satisfying e, from the
    footer's per-row-group value histograms (uniform over [min, max] for
    files without them).  Cheap and rough by design — it only has to rank
    requests for the offload policy, not be an optimizer."""
    if isinstance(e, Cmp):
        zm = zonemaps[e.column][rg]
        v = e.value
        if float(zm["max"]) - float(zm["min"]) <= 0:
            return 1.0 if _maybe_true(e, zonemaps, rg) else 0.0
        if e.op == "between":
            return _range_frac(zm, float(v[0]), float(v[1]))
        v = float(v)
        if e.op in ("lt", "le"):
            return _range_frac(zm, float("-inf"), v)
        if e.op in ("gt", "ge"):
            return _range_frac(zm, v, float("inf"))
        if e.op == "eq":
            return _eq_frac_zm(zm, v)
        if e.op == "ne":
            return 1.0 - _eq_frac_zm(zm, v)
        raise ValueError(e.op)
    if isinstance(e, InSet):
        zm = zonemaps[e.column][rg]
        lo, hi = float(zm["min"]), float(zm["max"])
        if hi - lo <= 0:
            return 1.0 if any(lo <= float(v) <= hi for v in e.values) else 0.0
        return min(1.0, sum(_eq_frac_zm(zm, float(v)) for v in e.values))
    if isinstance(e, BloomProbe):
        return _BLOOM_SELECTIVITY
    if isinstance(e, And):
        f = 1.0
        for c in e.children:
            f *= _frac_true(c, zonemaps, rg)
        return f
    if isinstance(e, Or):
        f = 1.0
        for c in e.children:
            f *= 1.0 - _frac_true(c, zonemaps, rg)
        return 1.0 - f
    raise TypeError(e)


def prune_and_estimate(reader, predicate: Optional[Expr]):
    """One zone-map walk -> (surviving row-group ids, estimated selectivity).

    The admission path needs both; computing them together halves the
    per-request metadata cost vs prune_row_groups + estimate_selectivity."""
    n_rg = reader.n_row_groups
    if predicate is None:
        return list(range(n_rg)), 1.0
    from repro_torch.core.plan import expr_columns

    cols = set(expr_columns(predicate))
    zonemaps = {c: reader.zonemaps(c) for c in cols}
    rgs: List[int] = []
    total = 0
    surviving = 0.0
    for rg in range(n_rg):
        n = reader.row_group_meta(rg)["n"]
        total += n
        if _maybe_true(predicate, zonemaps, rg):
            rgs.append(rg)
            surviving += _frac_true(predicate, zonemaps, rg) * n
    return rgs, surviving / max(total, 1)


def estimate_selectivity(reader, predicate: Optional[Expr]) -> float:
    """Estimated fraction of the table's rows surviving `predicate`,
    row-count-weighted across row groups.  Pruned groups contribute 0."""
    return prune_and_estimate(reader, predicate)[1]
