"""TPC-H-shaped query suite over the datapath engine ("the DuckDB host").

Port of `repro.core.queries`: Q1, Q6, Q12, Q14, Q15 and Q19.  Every
filtered scan is pushed down to the DatapathEngine; the host algebra runs in
torch on the engine's device.  Joins whose build side fits on the card are
gathers against the engine-decoded build table (`jnp.take(..., mode="clip")`
in the reference is a clamp followed by `index_select` here), and Q19 uses a
pushed-down bloom semijoin whose build keys come from a compacted scan.

Each query returns plain floats/dicts.  Float totals are float32 sums in
another order than XLA's, so they agree with the reference within a
tolerance; Q15's per-supplier sums use `index_add_`, which on CUDA adds
with atomics in a run-dependent order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine import DatapathEngine
from repro_torch.core.plan import BloomProbe, Cmp, InSet, ScanPlan, and_, or_
from repro_torch.kernels import ops

EPS = 1e-4  # float32 predicate tolerance on 2-decimal columns


def _msum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x.to(torch.float32), 0.0).sum()


def _take_clip(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with out-of-range indices clamped (jnp.take mode="clip")."""
    return table.index_select(0, idx.to(torch.int64).clamp(0, table.shape[0] - 1))


# ---------------------------------------------------------------------------
# Q1 — pricing summary report (aggregation-heavy)
# ---------------------------------------------------------------------------


def q1_plan(delta_days: int = 90) -> ScanPlan:
    return ScanPlan(
        "lineitem",
        ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
         "l_discount", "l_tax"],
        Cmp("l_shipdate", "le", 2556 - delta_days),
    )


def q1(engine: DatapathEngine, readers: Dict, delta_days: int = 90) -> dict:
    r = readers["lineitem"]
    res = engine.scan(r, q1_plan(delta_days))
    c, m = res.columns, res.mask
    gid = c["l_returnflag"] * 2 + c["l_linestatus"]  # codes are small ints
    ngroups = 6
    onehot = (gid[:, None] == torch.arange(ngroups, device=gid.device)[None, :]) & m[:, None]
    disc_price = c["l_extendedprice"] * (1 - c["l_discount"])
    charge = disc_price * (1 + c["l_tax"])

    def group_sum(x: torch.Tensor) -> torch.Tensor:
        # the reference's one-hot matmul as a masked column reduction: the
        # sums stay full float32 without a TF32-eligible matmul
        return torch.where(onehot, x.to(torch.float32)[:, None], 0.0).sum(dim=0)

    sums = {
        "sum_qty": group_sum(c["l_quantity"]),
        "sum_base_price": group_sum(c["l_extendedprice"]),
        "sum_disc_price": group_sum(disc_price),
        "sum_charge": group_sum(charge),
        "count": onehot.sum(dim=0).to(torch.float32),
    }
    sums = {k: v.cpu().numpy() for k, v in sums.items()}
    rf_dict = r.string_dicts["l_returnflag"]
    ls_dict = r.string_dicts["l_linestatus"]
    out = {}
    for rf in range(min(3, len(rf_dict))):
        for ls in range(min(2, len(ls_dict))):
            g = rf * 2 + ls
            cnt = float(sums["count"][g])
            if cnt == 0:
                continue
            out[(rf_dict[rf], ls_dict[ls])] = {
                k: float(v[g]) for k, v in sums.items()
            }
    return out


# ---------------------------------------------------------------------------
# Q6 — forecasting revenue change (scan-heavy: pure filter + sum)
# ---------------------------------------------------------------------------


def q6_plan(year_start: int = 365) -> ScanPlan:
    return ScanPlan(
        "lineitem",
        ["l_extendedprice", "l_discount"],
        and_(
            Cmp("l_shipdate", "between", (year_start, year_start + 364)),
            Cmp("l_discount", "between", (0.05 - EPS, 0.07 + EPS)),
            Cmp("l_quantity", "lt", 24),
        ),
    )


def q6(engine: DatapathEngine, readers: Dict, year_start: int = 365) -> dict:
    res = engine.scan(readers["lineitem"], q6_plan(year_start))
    rev = _msum(res.columns["l_extendedprice"] * res.columns["l_discount"], res.mask)
    return {"revenue": float(rev), "rows": int(res.count)}


# ---------------------------------------------------------------------------
# Q12 — shipping modes and order priority (join via on-card build side)
# ---------------------------------------------------------------------------


def q12_plan(year_start: int = 730) -> ScanPlan:
    return ScanPlan(
        "lineitem",
        ["l_orderkey", "l_shipmode"],
        and_(
            InSet("l_shipmode", ("MAIL", "SHIP")),
            Cmp("l_receiptdate", "between", (year_start, year_start + 364)),
        ),
    )


def q12(engine: DatapathEngine, readers: Dict, year_start: int = 730) -> dict:
    ro, rl = readers["orders"], readers["lineitem"]
    # Build side: whole orders priority column, decoded in the datapath.
    build = engine.scan(ro, ScanPlan("orders", ["o_orderkey", "o_orderpriority"]))
    prio = build.columns["o_orderpriority"]  # dense by orderkey (generator invariant)

    res = engine.scan(rl, q12_plan(year_start))
    c, m = res.columns, res.mask
    l_prio = _take_clip(prio, c["l_orderkey"])
    pr_dict = ro.string_dicts["o_orderpriority"]
    high_codes = [i for i, s in enumerate(pr_dict) if s.startswith(("1-", "2-"))]
    is_high = torch.zeros(l_prio.shape, dtype=torch.bool, device=l_prio.device)
    for hc in high_codes:
        is_high = is_high | (l_prio == hc)
    out = {}
    sm_dict = rl.string_dicts["l_shipmode"]
    for mode in ("MAIL", "SHIP"):
        code = sm_dict.index(mode)
        sel = m & (c["l_shipmode"] == code)
        out[mode] = {
            "high": int((sel & is_high).sum()),
            "low": int((sel & ~is_high).sum()),
        }
    return out


# ---------------------------------------------------------------------------
# Q14 — promotion effect (join + arithmetic projection; scan-heavy)
# ---------------------------------------------------------------------------


def q14_plan(month_start: int = 1000) -> ScanPlan:
    return ScanPlan(
        "lineitem",
        ["l_partkey", "l_extendedprice", "l_discount"],
        Cmp("l_shipdate", "between", (month_start, month_start + 29)),
    )


def q14(engine: DatapathEngine, readers: Dict, month_start: int = 1000) -> dict:
    rp, rl = readers["part"], readers["lineitem"]
    build = engine.scan(rp, ScanPlan("part", ["p_partkey", "p_type"]))
    type_codes = build.columns["p_type"]  # dense by partkey
    tdict = rp.string_dicts["p_type"]
    promo = torch.from_numpy(
        np.array([s.startswith("PROMO") for s in tdict], dtype=np.bool_)
    ).to(type_codes.device)
    part_is_promo = _take_clip(promo, type_codes)

    res = engine.scan(rl, q14_plan(month_start))
    c, m = res.columns, res.mask
    rev = c["l_extendedprice"] * (1 - c["l_discount"])
    is_promo = _take_clip(part_is_promo, c["l_partkey"])
    promo_rev = _msum(rev, m & is_promo)
    total_rev = _msum(rev, m)
    return {
        "promo_revenue_pct": float(100.0 * promo_rev / torch.clamp(total_rev, min=1e-9)),
        "total_revenue": float(total_rev),
    }


# ---------------------------------------------------------------------------
# Q15 — top supplier (scan-heavy + group-by)
# ---------------------------------------------------------------------------


def q15_plan(quarter_start: int = 365) -> ScanPlan:
    return ScanPlan(
        "lineitem",
        ["l_suppkey", "l_extendedprice", "l_discount"],
        Cmp("l_shipdate", "between", (quarter_start, quarter_start + 89)),
    )


def q15(engine: DatapathEngine, readers: Dict, quarter_start: int = 365, n_supp: int = None) -> dict:
    rl = readers["lineitem"]
    res = engine.scan(rl, q15_plan(quarter_start))
    c, m = res.columns, res.mask
    if n_supp is None:
        n_supp = int(rl.zonemaps("l_suppkey")[0]["max"]) + 1
        for zm in rl.zonemaps("l_suppkey"):
            n_supp = max(n_supp, int(zm["max"]) + 1)
    rev = torch.where(m, c["l_extendedprice"] * (1 - c["l_discount"]), 0.0)
    ids = c["l_suppkey"].to(torch.int64)
    # .at[ids].add(rev, mode="drop"): out-of-range ids add nothing (their
    # +0.0 lands on slot 0 instead, which leaves every sum unchanged)
    keep = (ids >= 0) & (ids < n_supp)
    per_supp = torch.zeros((n_supp,), dtype=torch.float32, device=rev.device).index_add_(
        0, torch.where(keep, ids, 0), torch.where(keep, rev, 0.0))
    best = int(torch.argmax(per_supp))
    return {"suppkey": best, "revenue": float(per_supp[best])}


# ---------------------------------------------------------------------------
# Q19 — discounted revenue (disjunctive predicate + bloom semijoin pushdown)
# ---------------------------------------------------------------------------

_Q19_BRANCHES = [
    # (brand, containers, qty_lo, qty_hi, size_hi)
    ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 11, 5),
    ("Brand#23", ("MED BOX", "MED PACK", "MED PKG", "MED CASE"), 10, 20, 10),
    ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20, 30, 15),
]


def q19_bloom(engine: DatapathEngine, readers: Dict) -> torch.Tensor:
    """Q19's build side: the parts matching ANY branch, by a compacted
    pushed-down scan, as a bloom filter of their keys."""
    part_pred = or_(
        *[
            and_(Cmp("p_brand", "eq", b), InSet("p_container", c), Cmp("p_size", "le", s))
            for b, c, _, _, s in _Q19_BRANCHES
        ]
    )
    build = engine.scan(readers["part"], ScanPlan("part", ["p_partkey"], part_pred, compact=True))
    keys = build.columns["p_partkey"].to(torch.int32)
    return ops.bloom_build(keys[: int(build.count)], n_bits=1 << 15)


def q19_plan() -> ScanPlan:
    """Q19's lineitem scan; its BloomProbe takes the filter named "q19"."""
    return ScanPlan(
        "lineitem",
        ["l_partkey", "l_quantity", "l_extendedprice", "l_discount"],
        and_(
            BloomProbe("l_partkey", n_bits=1 << 15, name="q19"),
            Cmp("l_quantity", "between", (1, 30)),
            InSet("l_shipinstruct", ("DELIVER IN PERSON",)),
            InSet("l_shipmode", ("AIR", "REG AIR")),
        ),
    )


def q19(engine: DatapathEngine, readers: Dict) -> dict:
    rp, rl = readers["part"], readers["lineitem"]

    # Build side: a bloom of the matching partkeys (pushdown), plus dense
    # per-part attributes for the exact residual check.
    bloom = q19_bloom(engine, readers)
    attrs = engine.scan(rp, ScanPlan("part", ["p_brand", "p_container", "p_size"]))
    p_brand, p_cont, p_size = (
        attrs.columns["p_brand"],
        attrs.columns["p_container"],
        attrs.columns["p_size"],
    )

    res = engine.scan(rl, q19_plan(), blooms={"q19": bloom})
    c, m = res.columns, res.mask
    pk = c["l_partkey"].to(torch.int32)
    lb = _take_clip(p_brand, pk)
    lc = _take_clip(p_cont, pk)
    ls = _take_clip(p_size, pk)

    bdict = rp.string_dicts["p_brand"]
    cdict = rp.string_dicts["p_container"]
    keep = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
    for brand, containers, qlo, qhi, shi in _Q19_BRANCHES:
        bcode = bdict.index(brand) if brand in bdict else -1
        ccodes = [cdict.index(x) for x in containers if x in cdict]
        cm = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
        for cc in ccodes:
            cm = cm | (lc == cc)
        keep = keep | (
            (lb == bcode) & cm & (c["l_quantity"] >= qlo) & (c["l_quantity"] <= qhi)
            & (ls >= 1) & (ls <= shi)
        )
    rev = _msum(c["l_extendedprice"] * (1 - c["l_discount"]), m & keep)
    return {"revenue": float(rev), "rows": int((m & keep).sum())}


QUERIES = {"q1": q1, "q6": q6, "q12": q12, "q14": q14, "q15": q15, "q19": q19}
# each query's lineitem scan at its default parameters (Q19's needs the
# bloom of `q19_bloom` under the name "q19")
LINEITEM_PLANS = {"q1": q1_plan, "q6": q6_plan, "q12": q12_plan, "q14": q14_plan,
                  "q15": q15_plan, "q19": q19_plan}
SCAN_HEAVY = ("q6", "q14", "q15")
AGG_HEAVY = ("q1", "q12", "q19")


# ---------------------------------------------------------------------------
# Service-client path: run any query through the shared DatapathService
# ---------------------------------------------------------------------------


def run_via_service(service, name: str, readers: Dict, tenant: str = "default", **kwargs):
    """Run one of the six queries through a repro_torch.datapath.DatapathService.

    The service client is engine-compatible (`.scan(reader, plan, blooms)`),
    so every pushed-down scan in the query goes through admission control,
    the tick scheduler and shared-scan coalescing instead of calling the
    engine directly.  Its scans are bit-identical to the direct-engine path;
    the queries' answers agree by `agreement.compare`, since Q15's
    `index_add_` is atomic on the card (tests/test_torch_service.py)."""
    return QUERIES[name](service.client(tenant), readers, **kwargs)
