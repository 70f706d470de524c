"""When two runs of a query agree: the one rule the tests and chip_smoke.py use.

Integers (counts, rows, keys) must be equal.  Float totals are float32 sums
taken in another order (or, for Q15's `index_add_` on CUDA, in an atomic,
run-dependent order), so they must agree within `RTOL`.  Q15's supplier is
compared exactly only when the reference's top two per-supplier revenues are
further apart than `RTOL`; in a near tie either of the two is right.

Pushed-down aggregates are held to `scan_then_aggregate`, bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.core import agg
from repro_torch.core.engine import DatapathEngine, group_domain
from repro_torch.core.plan import Cmp, ScanPlan, bind_expr
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.lakeformat.encodings import PACK_BLOCK, padded_rows

RTOL = 1e-4


def scan_then_aggregate(engine: DatapathEngine, reader, plan: ScanPlan,
                        blooms=None) -> dict:
    """An aggregate plan's answer without pushdown: a row scan of its value
    and group columns on `engine`, then the host fold
    (agg.aggregate_rows_host) with the row groups as segments."""
    srcs = [c for c in agg.agg_sources(plan.aggregates) if c is not None]
    cols = list(dict.fromkeys(srcs + ([plan.group_by] if plan.group_by else [])))
    rows = engine.scan(reader, ScanPlan(plan.table, cols, plan.predicate), blooms=blooms)
    rgs = prune_row_groups(reader, bind_expr(plan.predicate, reader))
    segments = [padded_rows(reader.row_group_meta(rg)["n"]) // PACK_BLOCK for rg in rgs]
    n_groups = group_domain(reader, plan.group_by) if plan.group_by else 1
    return agg.aggregate_rows_host({c: rows.columns[c] for c in cols}, rows.mask,
                                   plan.aggregates, plan.group_by, n_groups, segments)


def per_supplier_revenue(lineitem, quarter_start: int = 365) -> np.ndarray:
    """Q15's per-supplier revenue in float64, scanned on the CPU: the
    reference the near-tie rule reads.  `lineitem` is the table's reader."""
    res = DatapathEngine(device="cpu").scan(lineitem, ScanPlan(
        "lineitem", ["l_suppkey", "l_extendedprice", "l_discount"],
        Cmp("l_shipdate", "between", (quarter_start, quarter_start + 89))))
    m = res.mask.numpy()
    rev = (res.columns["l_extendedprice"].numpy()[m].astype(np.float64)
           * (1 - res.columns["l_discount"].numpy()[m].astype(np.float64)))
    per = np.zeros(max(zm["max"] for zm in lineitem.zonemaps("l_suppkey")) + 1)
    np.add.at(per, res.columns["l_suppkey"].numpy()[m], rev)
    return per


def close(a: float, b: float) -> bool:
    """|a - b| <= RTOL * |b|, both finite."""
    return math.isfinite(a) and math.isfinite(b) and abs(a - b) <= RTOL * abs(b)


def q15_agrees(got: dict, want: dict, per_supp: np.ndarray) -> bool:
    """Revenue within `RTOL`; the supplier exactly unless the top two of
    `per_supp` are within `RTOL` of each other."""
    if not close(got["revenue"], want["revenue"]):
        return False
    order = np.argsort(per_supp)
    top, second = per_supp[order[-1]], per_supp[order[-2]]
    if top - second > RTOL * abs(top):
        return got["suppkey"] == want["suppkey"]
    return got["suppkey"] in {int(order[-1]), int(order[-2])}


def compare(name: str, got: dict, want: dict, per_supp: Optional[np.ndarray] = None) -> None:
    """Raise AssertionError unless query `name`'s result `got` agrees with
    `want`.  Q15 needs `per_supp` (`per_supplier_revenue` of its scan)."""
    if name == "q1":
        if not want or sorted(got) != sorted(want):
            raise AssertionError(f"q1 groups {sorted(got)} vs {sorted(want)}")
        for key, row in want.items():
            if got[key]["count"] != row["count"]:
                raise AssertionError(f"q1 {key} counts {got[key]} vs {row}")
            # sum_qty passes 2^24 at SF1, so it too is a rounded float32 sum
            for f in ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge"):
                if not close(got[key][f], row[f]):
                    raise AssertionError(f"q1 {key} {f}: {got[key][f]} vs {row[f]}")
    elif name == "q6":
        if got["rows"] != want["rows"] or not close(got["revenue"], want["revenue"]):
            raise AssertionError(f"q6 {got} vs {want}")
    elif name == "q12":
        if got != want:
            raise AssertionError(f"q12 {got} vs {want}")
    elif name == "q14":
        if not (close(got["total_revenue"], want["total_revenue"])
                and close(got["promo_revenue_pct"], want["promo_revenue_pct"])):
            raise AssertionError(f"q14 {got} vs {want}")
    elif name == "q15":
        if not q15_agrees(got, want, per_supp):
            raise AssertionError(f"q15 {got} vs {want}")
    elif name == "q19":
        if got["rows"] != want["rows"] or not close(got["revenue"], want["revenue"]):
            raise AssertionError(f"q19 {got} vs {want}")
    else:
        raise KeyError(name)
