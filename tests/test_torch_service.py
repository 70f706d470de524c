"""The port's multi-tenant service (`repro_torch.datapath`: service, policy,
telemetry) on the CPU against the JAX service, on the same seeded files and
submissions.

Every scenario runs twice, once on each package (the port's pod on a
`DatapathEngine(device="cpu")`, the JAX pod on `backend="ref"`), and the two
runs must agree on:

- results: ints, masks and decoded values exactly, pushed-down float sums
  within rtol 1e-4, and every ScanStats field but `kernel_launches` and
  `batch_pad_blocks`;
- tickets: status, error type, `submitted_tick` and `done_tick`;
- deterministic telemetry: counters, per-tenant virtual time, charged /
  reconciled / actual / fault seconds, the fault and batch reports, the
  fairness shares and the store's ledger (wall-clock fields excluded);
- span trees under a fake-clock Tracer, span for span.

Ports tests/test_datapath.py and the service cases that the engine slice left
for the service: test_blockstore.py's retained-window and auto-hold cases,
test_costmodel.py::test_service_and_netsim_share_one_table, test_trace.py's
service lifecycle and telemetry cases, test_pushdown.py's pre-aggregated
cache hit through a Pod.  Also: a pod's defaults (the card unless told
otherwise, the cost model keyed by the engine's device), and a kernel
failure propagating out of `tick()` instead of landing on a ticket.

The twin harness (the sides `J` and `T`, `twin`, the `same_*` checks) is
imported by the other service test files (test_torch_scheduler.py,
test_torch_faults.py, test_torch_service_props.py).
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.datapath as jdp
from repro.core import cache as jcache
from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import queries as jqueries
from repro.core import tpch as jtpch
from repro.datapath import faults as jfaults
from repro.datapath import trace as jtrace
from repro.kernels import ops as jops
from repro.lakeformat import integrity as jintegrity
from repro.lakeformat.reader import LakeReader as JReader
from repro.lakeformat.schema import ColumnSchema, TableSchema
from repro.lakeformat.writer import write_table
import repro_torch.datapath as tdp
from repro_torch.core import agreement
from repro_torch.core import cache as tcache
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core import queries as tqueries
from repro_torch.datapath import costmodel as tcostmodel
from repro_torch.datapath import faults as tfaults
from repro_torch.datapath import scheduler as tscheduler
from repro_torch.datapath import trace as ttrace
from repro_torch.kernels import build, ops
from repro_torch.lakeformat import integrity as tintegrity
from repro_torch.lakeformat.reader import LakeReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# the twin harness
# ---------------------------------------------------------------------------

J = types.SimpleNamespace(
    name="jax", P=jplan, dp=jdp, Q=jqueries, engine_mod=jengine, trace=jtrace,
    faults=jfaults, integrity=jintegrity, Reader=JReader, BlockCache=jcache.BlockCache,
    engine=lambda **kw: jengine.DatapathEngine(backend="ref", **kw),
    bloom=lambda lo, hi, n_bits: jops.bloom_build(jnp.arange(lo, hi, dtype=jnp.int32), n_bits),
)
T = types.SimpleNamespace(
    name="torch", P=tplan, dp=tdp, Q=tqueries, engine_mod=tengine, trace=ttrace,
    faults=tfaults, integrity=tintegrity, Reader=LakeReader, BlockCache=tcache.BlockCache,
    engine=lambda **kw: tengine.DatapathEngine(device="cpu", **kw),
    bloom=lambda lo, hi, n_bits: ops.bloom_build(torch.arange(lo, hi, dtype=torch.int32),
                                                 n_bits),
)


def service(S, **kw):
    """A pod of side `S` over a 1 GiB store (the reference tests' default)."""
    kw.setdefault("engine", S.engine(cache=S.BlockCache(1 << 30)))
    return S.dp.DatapathService(**kw)


def twin(fn, *args, **kw):
    """(fn(J, ...), fn(T, ...)): one scenario on both packages."""
    return fn(J, *args, **kw), fn(T, *args, **kw)


@pytest.fixture(autouse=True)
def trace_hooks():
    """Both engines' flight-recorder hooks installed, as each scheduler
    installs its own at import (another test may have reset one)."""
    jengine.TRACE, tengine.TRACE = jtrace, ttrace
    yield


class FakeClock:
    """Monotonic counter clock: every read advances by `step`."""

    def __init__(self, step: float = 1.0):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def fake_tracer(S, capacity: int = 64, **kw):
    return S.dp.Tracer(clock=FakeClock(), capacity=capacity, **kw)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bits(a):
    a = _np(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


STATS_SKIP = ("kernel_launches", "batch_pad_blocks")


def stats_view(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items() if k not in STATS_SKIP}


def same_rows(got, want):
    """Two results of either package: count, mask and columns (floats as
    bits) equal."""
    assert int(got.count) == int(want.count)
    np.testing.assert_array_equal(_np(got.mask), _np(want.mask))
    assert set(got.columns) == set(want.columns)
    for name in want.columns:
        assert _np(got.columns[name]).dtype == _np(want.columns[name]).dtype, name
        np.testing.assert_array_equal(_bits(got.columns[name]), _bits(want.columns[name]),
                                      err_msg=name)


def same_aggs(got, want, exact: bool):
    """Aggregates: bit for bit within one package; across packages ints
    exactly and float sums within rtol 1e-4."""
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.dtype == w.dtype, k
        if not exact and k.startswith("sum") and w.dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def same_result(got, want, exact: bool = False, stats: bool = True):
    """One scan's result: rows or aggregates, and (by default) every
    ScanStats field but the launch counts."""
    if want.aggregates is not None:
        same_aggs(got.aggregates, want.aggregates, exact)
        assert int(got.count) == int(want.count)
    else:
        same_rows(got, want)
    if stats:
        assert stats_view(got.stats) == stats_view(want.stats)


def ticket_view(t) -> tuple:
    return (t.req_id, t.tenant, t.status, type(t.error).__name__ if t.error else None,
            t.submitted_tick, t.done_tick)


def same_tickets(tt, jt):
    """The port's tickets against the reference's: the same terminal states,
    error types and ticks, and equal results."""
    assert [ticket_view(t) for t in tt] == [ticket_view(j) for j in jt]
    for a, b in zip(tt, jt):
        if b.result is not None:
            same_result(a.result, b.result)
        else:
            assert a.result is None


# wall-clock fields of a snapshot: the only parts that may differ
_WALL = ("tick_p50_s", "tick_p99_s", "tick_p999_s", "tenants", "trace")


def telemetry_view(svc) -> dict:
    """A pod's deterministic telemetry and scheduler state."""
    snap = svc.telemetry.snapshot()
    snap["latency_n"] = {t: v["n"] for t, v in snap["tenants"].items()}
    for k in _WALL:
        snap.pop(k)
    snap["fairness"].pop("tenant_latency_p999_s")
    snap["costmodel"].pop("backend")  # "ref" against the device's key
    snap["vtime"] = dict(sorted(svc._vtime.items()))
    snap["est_scale"] = dict(sorted(svc._est_scale.items()))
    snap["tick"] = svc._tick
    snap["hold_ticks"] = svc.hold_ticks
    snap["queue"] = [r.req_id for r in svc.queue]
    snap["decisions"] = dict(sorted(getattr(svc.policy, "decisions", {}).items()))
    return snap


def _diff(a, b, path=""):
    """The first differing leaf of two nested views, for a readable failure."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}/{k}: only in {'port' if k in a else 'reference'}"
            d = _diff(a[k], b[k], f"{path}/{k}")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: lengths {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: port {a!r} != reference {b!r}"


def same_telemetry(tsvc, jsvc):
    d = _diff(telemetry_view(tsvc), telemetry_view(jsvc))
    assert d is None, d


# span arguments that follow the port's own dispatches: a bucket's padded
# blocks (the port pads no stack)
SPAN_ARGS_SKIP = ("pad_blocks",)


def span_args(args: dict) -> dict:
    return {k: (v.item() if hasattr(v, "item") else v)
            for k, v in sorted(args.items()) if k not in SPAN_ARGS_SKIP}


def span_view(sp) -> dict:
    return {"name": sp["name"], "t0": sp["t0"], "t1": sp["t1"], "args": span_args(sp["args"]),
            "children": [span_view(c) for c in sp["children"]]}


def trace_view(tracer) -> list:
    """Every recorded request's span tree and summary."""
    return [{"req_id": rt.req_id, "tenant": rt.tenant, "root": span_view(rt.root),
             "summary": rt.summary} for rt in tracer.recorder.traces()]


def same_traces(tsvc, jsvc):
    d = _diff(trace_view(tsvc.tracer), trace_view(jsvc.tracer))
    assert d is None, d


def same_pods(tsvc, jsvc, tt, jt, traces: bool = False):
    """Everything a scenario's two pods must agree on."""
    same_tickets(tt, jt)
    same_telemetry(tsvc, jsvc)
    if traces:
        same_traces(tsvc, jsvc)


# ---------------------------------------------------------------------------
# fixtures: the reference tests' files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_dp")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192)


def readers_of(S, paths):
    return {k: S.Reader(p) for k, p in paths.items()}


def plans(P):
    return [
        P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                   P.Cmp("l_shipdate", "between", (365, 729))),  # fused fast path
        P.ScanPlan("lineitem", ["l_quantity", "l_extendedprice"],
                   P.and_(P.Cmp("l_shipdate", "between", (365, 729)),
                          P.Cmp("l_quantity", "lt", 25))),  # multi-column predicate
        P.ScanPlan("lineitem", ["l_quantity"], P.InSet("l_shipmode", ("MAIL", "SHIP"))),
        P.ScanPlan("lineitem", ["l_quantity"], P.Cmp("l_quantity", "le", 3), compact=True),
        P.ScanPlan("part", ["p_partkey", "p_size"], P.Cmp("p_size", "le", 10)),
    ]


# ---------------------------------------------------------------------------
# tests/test_datapath.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", range(5))
def test_service_bit_identical_to_direct_scan(small_tables, idx):
    """(a) service results == direct DatapathEngine.scan(), bit for bit,
    with the adaptive policy free to pick any offload mode; the port's pod
    makes the reference's choices, ticks and charges."""
    def run(S):
        R = readers_of(S, small_tables)
        plan = plans(S.P)[idx]
        direct = S.engine().scan(R[plan.table], plan)
        svc = service(S, policy=S.dp.AdaptiveOffloadPolicy(), tracer=fake_tracer(S))
        tickets = []
        for _ in range(2):  # second pass may hit preloaded/prefiltered paths
            tickets.append(svc.submit("t0", R[plan.table], plan))
            same_rows(svc.result(tickets[-1]), direct)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_service_queries_match_direct(small_tables):
    """All six queries through the service-client path == the port's direct
    engine exactly (on the CPU every float sum is in a fixed order), and
    agree with the JAX service's answers by `agreement.compare`; each
    lineitem scan through `ServiceClient.scan` equals the direct scan bit
    for bit."""
    R = readers_of(T, small_tables)
    eng = T.engine()
    svc = service(T, batch_per_tick=8)
    jR = readers_of(J, small_tables)
    jsvc = service(J, batch_per_tick=8)
    per_supp = agreement.per_supplier_revenue(R["lineitem"])
    bloom = tqueries.q19_bloom(eng, R)
    client = svc.client("scans")
    for name in tqueries.QUERIES:
        got = tqueries.run_via_service(svc, name, R, tenant=name)
        assert got == tqueries.QUERIES[name](eng, R)
        agreement.compare(name, got, jqueries.run_via_service(jsvc, name, jR, tenant=name),
                          per_supp)
        plan = tqueries.LINEITEM_PLANS[name]()
        blooms = {"q19": bloom} if name == "q19" else None
        same_result(client.scan(R["lineitem"], plan, blooms),
                    eng.scan(R["lineitem"], plan, blooms=blooms), exact=True, stats=False)
    assert client.backend == "auto" and client.cache is svc.engine.cache


def test_quota_rejects_over_budget_tenant(small_tables):
    """(b) byte and row quotas both reject at admission; other tenants and
    later windows are unaffected."""
    def run(S):
        R = readers_of(S, small_tables)
        svc = service(S, quotas={"small": S.dp.TenantQuota(max_bytes=1000),
                                 "narrow": S.dp.TenantQuota(max_rows=10)},
                      quota_window_ticks=4)
        plan = plans(S.P)[0]
        with pytest.raises(S.dp.QuotaExceeded):
            svc.submit("small", R["lineitem"], plan)
        with pytest.raises(S.dp.QuotaExceeded):
            svc.submit("narrow", R["lineitem"], plan)
        t = svc.submit("big", R["lineitem"], plan)  # unconstrained tenant still admitted
        assert int(svc.result(t).count) > 0
        assert svc.telemetry.counters["rejected_quota_bytes"] == 1
        assert svc.telemetry.counters["rejected_quota_rows"] == 1
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_quota_window_refills(small_tables):
    def run(S):
        R = readers_of(S, small_tables)
        plan = S.P.ScanPlan("part", ["p_size"], S.P.Cmp("p_size", "le", 5))
        est = S.engine().estimate_scan_bytes(R["part"], plan)
        svc = service(S, quotas={"t": S.dp.TenantQuota(max_bytes=int(est * 1.5))},
                      quota_window_ticks=2, batch_per_tick=1)
        tickets = [svc.submit("t", R["part"], plan)]
        with pytest.raises(S.dp.QuotaExceeded):  # same window, queue busy: rejected
            svc.submit("t", R["part"], plan)
        svc.drain()  # tick 1
        svc.tick()  # tick 2 = window boundary, usage refills
        tickets.append(svc.submit("t", R["part"], plan))
        svc.drain()
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_quota_refills_on_idle_service(small_tables):
    """An exhausted tenant is not locked out once the queue is empty: idle
    submits fast-forward the window."""
    def run(S):
        R = readers_of(S, small_tables)
        plan = S.P.ScanPlan("part", ["p_size"], S.P.Cmp("p_size", "le", 5))
        est = S.engine().estimate_scan_bytes(R["part"], plan)
        svc = service(S, quotas={"t": S.dp.TenantQuota(max_bytes=int(est * 1.5))},
                      quota_window_ticks=1000)
        t1 = svc.submit("t", R["part"], plan)
        svc.result(t1)  # exhausts the window
        t2 = svc.submit("t", R["part"], plan)  # queue empty: refills
        assert int(svc.result(t2).count) >= 0
        with pytest.raises(S.dp.QuotaExceeded):  # no fresh window could afford it
            service(S, quotas={"t": S.dp.TenantQuota(max_bytes=10)}).submit(
                "t", R["part"], plan)
        return svc, [t1, t2]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_queue_depth_admission(small_tables):
    def run(S):
        R = readers_of(S, small_tables)
        svc = service(S, max_queue_depth=2)
        plan = plans(S.P)[0]
        tickets = [svc.submit("a", R["lineitem"], plan), svc.submit("b", R["lineitem"], plan)]
        with pytest.raises(S.dp.QueueFull):
            svc.submit("c", R["lineitem"], plan)
        svc.drain()
        tickets.append(svc.submit("c", R["lineitem"], plan))
        svc.drain()
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_coalescing_decodes_each_group_once(small_tables):
    """(c) two scans over the same row groups through one pool: every shared
    (row group, column) pair is decoded exactly once."""
    def run(S):
        R = readers_of(S, small_tables)
        r = R["lineitem"]
        plan_a = S.P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                              S.P.Cmp("l_shipdate", "between", (365, 729)))
        plan_b = S.P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                              S.P.Cmp("l_shipdate", "between", (400, 800)))
        svc = service(S, batch_per_tick=2, policy=S.dp.StaticPolicy("raw"))
        ta = svc.submit("a", r, plan_a)
        tb = svc.submit("b", r, plan_b)
        batch, svc.queue = svc.queue[:2], svc.queue[2:]
        pool = S.dp.DecodePool()
        for req in batch:
            req.ticket.result = svc.engine.scan(req.reader, req.plan, blooms=req.blooms,
                                                offload="raw", pool=pool)
            req.ticket.status = "done"
        assert pool.puts == len(pool)
        assert pool.hits > 0
        a, b = ta.result, tb.result
        assert a.stats.decoded_bytes_fresh > 0
        assert b.stats.decoded_bytes_fresh == 0  # fully served from the pool
        assert b.stats.pool_hits == len(plan_b.columns) * a.stats.row_groups_scanned
        same_rows(a, S.engine().scan(r, plan_a))
        same_rows(b, S.engine().scan(r, plan_b))
        return (pool.puts, pool.hits, len(pool)), [ta, tb]

    (jpool, jt), (tpool, tt) = twin(run)
    assert tpool == jpool
    same_tickets(tt, jt)


def tenant_plans(P, n_tenants: int):
    """benchmarks/service_bench.py's per-tenant revenue scans: the same hot
    columns, shifted overlapping date windows."""
    return [P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                       P.Cmp("l_shipdate", "between", (200 + 45 * t, 564 + 45 * t)))
            for t in range(n_tenants)]


def test_coalescing_saves_decoded_bytes_for_four_tenants(small_tables):
    """Fresh decoded bytes through one coalesced tick << 4 independent scans
    (service_bench's `_run_independent` / `_run_service`)."""
    def run(S):
        R = readers_of(S, small_tables)
        ps = tenant_plans(S.P, 4)
        ind = sum(S.engine(offload="raw").scan(R["lineitem"], p).stats.decoded_bytes_fresh
                  for p in ps)
        svc = S.dp.DatapathService(engine=S.engine(cache=S.BlockCache(4 << 30)),
                                   batch_per_tick=len(ps), policy=S.dp.StaticPolicy("raw"))
        tickets = [svc.submit(f"tenant{t}", R["lineitem"], p) for t, p in enumerate(ps)]
        svc.drain()
        assert int(svc.telemetry.counters["decoded_bytes_fresh"]) < ind
        assert int(svc.telemetry.counters["decoded_bytes_saved"]) > 0
        return svc, tickets, ind

    (jsvc, jt, jind), (tsvc, tt, tind) = twin(run)
    assert tind == jind
    same_pods(tsvc, jsvc, tt, jt)


def test_prefiltered_cache_keys_include_blooms(small_tables):
    """Two tenants, identical plan, DIFFERENT bloom bits: the recurring-
    signature promotion to 'prefiltered' never serves one tenant's semijoin
    result to the other."""
    def run(S):
        r = readers_of(S, small_tables)["lineitem"]
        plan = S.P.ScanPlan("lineitem", ["l_partkey"], S.P.BloomProbe("l_partkey", name="b"))
        bloom_a, bloom_b = S.bloom(0, 30, 1 << 14), S.bloom(500, 530, 1 << 14)
        eng = S.engine()
        want_a = eng.scan(r, plan, blooms={"b": bloom_a})
        want_b = eng.scan(r, plan, blooms={"b": bloom_b})
        assert int(want_a.count) != int(want_b.count)  # distinct probe sets
        svc = service(S, policy=S.dp.AdaptiveOffloadPolicy(repeat_k=2))
        tickets = []
        for _ in range(2):  # repeat to trigger prefiltered promotion
            tickets.append(svc.submit("a", r, plan, blooms={"b": bloom_a}))
            same_rows(svc.result(tickets[-1]), want_a)
            tickets.append(svc.submit("b", r, plan, blooms={"b": bloom_b}))
            same_rows(svc.result(tickets[-1]), want_b)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_failed_request_does_not_wedge_the_batch(small_tables):
    """A faulty request errors its own ticket; co-batched requests still
    complete, and result() raises instead of spinning forever."""
    def run(S):
        R = readers_of(S, small_tables)
        svc = service(S, batch_per_tick=2, policy=S.dp.StaticPolicy("raw"))
        t_bad = svc.submit("a", R["lineitem"], S.P.ScanPlan("lineitem", ["no_such_column"]))
        t_good = svc.submit("b", R["lineitem"], plans(S.P)[0])
        svc.drain()
        assert t_bad.status == "error" and t_good.status == "done"
        with pytest.raises(KeyError):
            svc.result(t_bad)
        assert int(svc.result(t_good).count) > 0
        assert svc.telemetry.counters["failed"] == 1
        return svc, [t_bad, t_good]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_decode_pool_budget_is_enforced(small_tables):
    """A tiny pool budget refuses inserts instead of pinning unbounded
    decoded bytes; scans still return correct results."""
    def run(S):
        r = readers_of(S, small_tables)["lineitem"]
        plan = plans(S.P)[0]
        svc = service(S, batch_per_tick=2, policy=S.dp.StaticPolicy("raw"), pool_bytes=1024)
        ta, tb = svc.submit("a", r, plan), svc.submit("b", r, plan)
        svc.drain()
        assert svc.telemetry.counters["pool_rejected_puts"] > 0
        assert svc.telemetry.counters["decoded_bytes_saved"] == 0  # nothing pooled
        direct = S.engine().scan(r, plan)
        same_rows(ta.result, direct)
        same_rows(tb.result, direct)
        return svc, [ta, tb]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_pool_hit_still_populates_preloaded_cache(small_tables):
    """A 'preloaded' request served from a pool still leaves its decoded
    columns in the persistent store for later ticks."""
    def run(S):
        r = readers_of(S, small_tables)["lineitem"]
        plan = S.P.ScanPlan("lineitem", ["l_extendedprice"],
                            S.P.Cmp("l_shipdate", "between", (365, 729)))
        eng = S.engine(cache=S.BlockCache(1 << 30))
        pool = S.dp.DecodePool()
        eng.scan(r, plan, offload="raw", pool=pool)  # raw: pool filled, cache not
        assert eng.cache.stats()["entries"] == 0
        res = eng.scan(r, plan, offload="preloaded", pool=pool)
        assert res.stats.pool_hits > 0 and res.stats.decoded_bytes_fresh == 0
        assert eng.cache.stats()["entries"] > 0  # persisted despite pool hits
        return res, eng.cache.stats()

    (jres, jst), (tres, tst) = twin(run)
    same_result(tres, jres)
    assert tst == jst


def test_fully_pooled_scan_skips_encoded_fetch(small_tables):
    """A scan whose columns are all pool-resident reads zero encoded bytes
    and still matches the direct scan bit for bit."""
    def run(S):
        r = readers_of(S, small_tables)["lineitem"]
        plan_a = S.P.ScanPlan("lineitem", ["l_quantity", "l_extendedprice"],
                              S.P.Cmp("l_quantity", "le", 10))
        plan_b = S.P.ScanPlan("lineitem", ["l_quantity", "l_extendedprice"],
                              S.P.Cmp("l_quantity", "le", 20))
        eng = S.engine()
        pool = S.dp.DecodePool()
        res_a = eng.scan(r, plan_a, offload="raw", pool=pool)
        res_b = eng.scan(r, plan_b, offload="raw", pool=pool)
        assert res_a.stats.encoded_bytes > 0
        assert res_b.stats.encoded_bytes == 0  # fed entirely by the pool
        assert res_b.stats.decoded_bytes_fresh == 0
        same_rows(res_b, S.engine().scan(r, plan_b))
        return res_a, res_b

    (ja, jb), (ta, tb) = twin(run)
    same_result(ta, ja)
    same_result(tb, jb)


def test_cache_bills_prefiltered_results_by_real_size(small_tables):
    """The store bills a cached ScanResult at its array size, so the budget
    bounds service memory."""
    def run(S):
        r = readers_of(S, small_tables)["lineitem"]
        plan = S.P.ScanPlan("lineitem", ["l_extendedprice"], S.P.Cmp("l_shipdate", "le", 1000))
        eng = S.engine(offload="prefiltered", cache=S.BlockCache(1 << 30))
        res = eng.scan(r, plan)
        arrays = sum(_np(a).nbytes for a in res.columns.values()) + _np(res.mask).nbytes
        assert eng.cache.used >= arrays  # plus the rg columns it preloaded
        return eng.cache.used

    jused, tused = twin(run)
    assert tused == jused


def test_adaptive_policy_promotes_recurring_scans(small_tables):
    def run(S):
        R = readers_of(S, small_tables)
        svc = service(S, policy=S.dp.AdaptiveOffloadPolicy(repeat_k=2))
        tickets = []
        for _ in range(3):
            tickets.append(svc.submit("t", R["lineitem"], plans(S.P)[0]))
            svc.result(tickets[-1])
        assert svc.policy.decisions.get("prefiltered", 0) >= 1
        assert svc.telemetry.counters.get("prefiltered_hits", 0) >= 1
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_selectivity_estimates_rank_predicates(small_tables):
    def run(S):
        eng = S.engine()
        r = readers_of(S, small_tables)["lineitem"]

        def sel(pred):
            return eng.estimate_selectivity(r, S.P.ScanPlan("lineitem", ["l_quantity"], pred))

        narrow = sel(S.P.Cmp("l_shipdate", "between", (100, 120)))
        broad = sel(S.P.Cmp("l_shipdate", "between", (0, 2000)))
        everything = sel(None)
        assert 0.0 <= narrow < broad <= 1.0
        assert everything == 1.0
        ne, eq = sel(S.P.Cmp("l_discount", "ne", 0.05)), sel(S.P.Cmp("l_discount", "eq", 0.05))
        assert ne > 0.5 > eq
        return narrow, broad, everything, ne, eq

    assert twin(run)[1] == twin(run)[0]


def test_preloaded_cache_resident_scan_skips_encoded_fetch(small_tables):
    """Once decoded columns are store-resident, repeat preloaded scans
    fetch zero encoded bytes."""
    def run(S):
        r = readers_of(S, small_tables)["lineitem"]
        plan = S.P.ScanPlan("lineitem", ["l_quantity", "l_extendedprice"],
                            S.P.Cmp("l_quantity", "le", 10))
        eng = S.engine(cache=S.BlockCache(1 << 30))
        first = eng.scan(r, plan, offload="preloaded")
        again = eng.scan(r, plan, offload="preloaded")
        assert first.stats.encoded_bytes > 0
        assert again.stats.encoded_bytes == 0
        same_rows(again, S.engine().scan(r, plan))
        return first, again

    (jf, ja), (tf, ta) = twin(run)
    same_result(tf, jf)
    same_result(ta, ja)


def test_netsim_overlap_math():
    def run(S):
        pipe = S.dp.PrefetchPipeline(S.dp.LinkModel(bandwidth_gbps=1.0, latency_us=0.0))
        sim = pipe.simulate([1 << 20] * 8, [1 << 20] * 8)
        assert sim["overlapped_s"] < sim["serial_s"]
        assert abs(sim["serial_s"] - (sim["overlapped_s"] + sim["saved_s"])) < 1e-12
        fetch = pipe.link.fetch_seconds(1 << 20)
        dec_t = pipe.decode.decode_seconds(1 << 20)
        assert abs(sim["overlapped_s"] - (fetch + 7 * max(fetch, dec_t) + dec_t)) < 1e-12
        assert pipe.simulate([], [])["serial_s"] == 0.0
        return sim

    jsim, tsim = twin(run)
    assert tsim == jsim


# -- telemetry units: the same observations give the same reports ----------

def _quantile_cases(S):
    quantile = S.dp.quantile
    t = S.dp.Telemetry()
    for i in range(100):
        t.observe_latency("a", float(i))
    lat = t.tenant_latency("a")
    assert lat["n"] == 100 and abs(lat["p50_s"] - 50.0) <= 1.0 and lat["p99_s"] >= 97.0
    assert quantile([], 0.5) == 0.0
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert quantile([7.0], q) == 7.0
    # nearest rank, half up: two-sample p50 is the larger sample
    assert quantile([2.0, 1.0], 0.0) == 1.0
    assert quantile([2.0, 1.0], 1.0) == 2.0
    assert quantile([2.0, 1.0], 0.5) == 2.0
    assert quantile([1.0, 2.0, 3.0, 4.0], 0.5) == 3.0
    assert quantile([1.0, 2.0], -0.5) == 1.0 and quantile([1.0, 2.0], 1.5) == 2.0
    return lat, [quantile(list(range(n)), q) for n in (1, 2, 7, 100) for q in (0.1, 0.5, 0.999)]


def _starved_cases(S):
    t = S.dp.Telemetry()
    t.observe_tenant_bytes("fed", 1000.0)
    t.observe_sched("starved", 0.0, 0.0)  # the scheduler knows it; it never ran
    fair = t.fairness()
    assert fair["tenant_share"] == {"fed": 1.0, "starved": 0.0}
    assert fair["min_share"] == 0.0
    assert fair["jain_index"] == pytest.approx(0.5)
    t2 = S.dp.Telemetry()
    t2.observe_tenant_bytes("fed", 1000.0)
    t2.observe_latency("unlucky", 0.1)  # latency-only tenants show up too
    assert t2.fairness()["tenant_share"]["unlucky"] == 0.0
    assert t2.fairness()["jain_index"] == pytest.approx(0.5)
    return fair, t2.fairness()


def _cost_cases(S):
    t = S.dp.Telemetry()
    t.observe_sched("u", 1.0, 100.0)
    t.observe_actual_cost("u", 4.0)
    t.observe_recon("u", 3.0)
    t.observe_sched("o", 2.0, 100.0)
    t.observe_actual_cost("o", 1.0)
    t.observe_recon("o", -1.0)
    rep = t.cost_report()
    assert rep["u"]["rel_err"] == pytest.approx(-0.75) and rep["u"]["recon_s"] == 3.0
    assert rep["o"]["rel_err"] == pytest.approx(1.0)
    assert t.counters["recon_slices"] == 2
    assert t.counters["recon_abs_seconds"] == pytest.approx(4.0)
    t.observe_sched("pending", 1.0, 10.0)
    assert t.cost_report()["pending"]["rel_err"] == 0.0
    return t.snapshot()


def _snapshot_cases(S):
    empty_a, empty_b = S.dp.Telemetry().snapshot(), S.dp.Telemetry().snapshot()
    assert empty_a == empty_b and json.dumps(empty_a) == json.dumps(empty_b)
    assert empty_a["tick_p50_s"] == empty_a["tick_p99_s"] == 0.0
    assert empty_a["queue_depth_max"] == 0 and empty_a["queue_depth_mean"] == 0.0
    assert empty_a["fairness"]["jain_index"] == 1.0
    ta, tb = S.dp.Telemetry(), S.dp.Telemetry()
    for t in (ta, tb):
        t.observe_tick(0.25)
    ta.inc("x"); ta.inc("y", 2.0)  # noqa: E702
    tb.inc("y", 2.0); tb.inc("x")  # noqa: E702
    ta.observe_latency("t0", 1.0); ta.observe_latency("t1", 2.0)  # noqa: E702
    tb.observe_latency("t1", 2.0); tb.observe_latency("t0", 1.0)  # noqa: E702
    ta.observe_tenant_bytes("t0", 10.0); ta.observe_tenant_bytes("t1", 30.0)  # noqa: E702
    tb.observe_tenant_bytes("t1", 30.0); tb.observe_tenant_bytes("t0", 10.0)  # noqa: E702
    assert json.dumps(ta.snapshot()) == json.dumps(tb.snapshot())
    fair = ta.snapshot()["fairness"]
    assert fair["tenant_share"] == {"t0": 0.25, "t1": 0.75}
    assert 0.0 < fair["jain_index"] < 1.0
    return json.dumps(empty_a), json.dumps(ta.snapshot())


def _p999_cases(S):
    tm = S.dp.Telemetry()
    for i in range(1000):
        tm.observe_latency("t", float(i))
        tm.observe_tick(float(i) / 10.0)
    lat = tm.tenant_latency("t")
    assert lat["p999_s"] >= lat["p99_s"] >= lat["p50_s"]
    assert lat["p999_s"] == 998.0  # rank floor(0.999 * 999 + 0.5)
    assert tm.fairness()["tenant_latency_p999_s"]["t"] == 998.0
    snap = tm.snapshot()
    assert snap["tick_p999_s"] >= snap["tick_p99_s"]
    return json.dumps(snap)


def _known_tenants_cases(S):
    tm = S.dp.Telemetry()
    tm.observe_actual_cost("only-actual", 0.5)
    tm.observe_recon("only-recon", -0.1)
    assert {"only-actual", "only-recon"} <= set(tm.known_tenants())
    cost = tm.cost_report()
    assert cost["only-actual"]["actual_s"] == 0.5 and cost["only-recon"]["recon_s"] == -0.1
    return cost


def _jain_cases(S):
    j = S.dp.jain_index
    assert j([]) == 1.0 and j([0.0, 0.0]) == 1.0 and j([1.0, 1.0, 1.0]) == 1.0
    assert j([1.0, 0.0, 0.0, 0.0]) == pytest.approx(0.25)
    return [j(x) for x in ([1.0, 2.0], [3.0, 0.5, 0.25], [1e-9, 1.0])]


@pytest.mark.parametrize("case", [_quantile_cases, _starved_cases, _cost_cases,
                                  _snapshot_cases, _p999_cases, _known_tenants_cases,
                                  _jain_cases],
                         ids=["quantiles", "starved_tenants", "cost_report", "snapshot",
                              "p999", "known_tenants", "jain_index"])
def test_telemetry_units_match_the_reference(case):
    """tests/test_datapath.py's and test_trace.py's telemetry units on both
    packages: each holds, and both give the same reports."""
    jout, tout = twin(case)
    assert tout == jout


# ---------------------------------------------------------------------------
# tests/test_blockstore.py: retained windows, per-table scales, auto hold
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sorted_tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_store_svc")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, sorted_data=True, row_group_size=8192)


def early_late(P):
    return (P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                       P.Cmp("l_shipdate", "between", (300, 700))),
            P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                       P.Cmp("l_shipdate", "between", (350, 750))))


def late_partner(S, paths, hold_ticks):
    """A scan dispatches (alone, at its hold deadline), THEN a compatible
    partner arrives within the hold window."""
    lineitem = S.Reader(paths["lineitem"])
    plan_early, plan_late = early_late(S.P)
    svc = service(S, policy=S.dp.StaticPolicy("raw"), hold_ticks=hold_ticks,
                  tracer=fake_tracer(S))
    early = svc.submit("early", lineitem, plan_early)
    while early.status == "queued":
        svc.tick()
    late = svc.submit("late", lineitem, plan_late)
    svc.drain()
    return svc, early, late, lineitem


@pytest.mark.parametrize("hold", [0, 2])
def test_late_partner_matches_reference(sorted_tables, hold):
    """hold 2: the partner dispatches against the retained window (reuse,
    re-decode seconds saved, retained bytes billed to the early tenant);
    hold 0, the tick-scoped control: no retained reuse.  Bit-identical to
    single-shot scans, and the pods agree with the reference's."""
    def run(S):
        svc, early, late, r = late_partner(S, sorted_tables, hold)
        c = svc.telemetry.counters
        plan_early, plan_late = early_late(S.P)
        same_rows(early.result, S.engine().scan(r, plan_early))
        same_rows(late.result, S.engine().scan(r, plan_late))
        if hold:
            assert c.get("retained_partner_dispatch", 0) >= 1
            assert late.done_tick - late.submitted_tick == 1
            assert c.get("retained_hits", 0) > 0 and c.get("retained_reuse_bytes", 0) > 0
            assert c.get("retained_redecode_saved_s", 0.0) > 0.0
            assert late.result.stats.pool_hits > 0
            assert c.get("retained_byte_ticks", 0) > 0
            assert c.get("retained_charge_seconds", 0.0) > 0.0
            assert svc.telemetry.fairness()["tenant_retained_bytes"]["early"] > 0
            assert svc._vtime.get("early", 0.0) > 0.0
            snap = svc.telemetry.snapshot()
            assert set(snap["store"]["tiers"]) == {"encoded", "decoded", "prefiltered"}
            json.dumps(snap)
        else:
            assert c.get("retained_hits", 0) == 0 and c.get("retained_reuse_bytes", 0) == 0
            assert late.result.stats.pool_hits == 0
        return svc, [early, late]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_raw_window_pins_leave_no_persistent_state(sorted_tables):
    """Once the retained pins expire, raw decodes drop from the store."""
    def run(S):
        svc, early, late, _ = late_partner(S, sorted_tables, 2)
        for _ in range(4):  # idle ticks past every window
            svc.tick()
        st = svc.store.stats()
        assert st["tiers"]["decoded"]["entries"] == 0
        assert st["tiers"]["decoded"]["expired"] > 0
        assert svc.store.used == (st["tiers"]["encoded"]["bytes"]
                                  + st["tiers"]["prefiltered"]["bytes"])
        return svc, [early, late]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_per_table_scale_isolates_a_lying_table(sorted_tables):
    """A tenant under-estimating ONE table 4x is re-priced on that table
    only; its honest table keeps its own scale, an unseen one the blend."""
    def run(S):
        R = readers_of(S, sorted_tables)
        lineitem, part = R["lineitem"], R["part"]
        svc = service(S, policy=S.dp.StaticPolicy("raw"))
        tickets = [svc.submit("t", lineitem, S.P.ScanPlan("lineitem", ["l_extendedprice"]))]
        req = next(q for q in svc.queue if q.reader is lineitem)
        req.rg_costs = tuple(c / 4 for c in req.rg_costs)  # the lie
        tickets.append(svc.submit("t", part, S.P.ScanPlan("part", ["p_size"])))
        svc.drain()
        assert svc._est_scale_table[("t", lineitem.path)] > 1.5
        assert svc._est_scale_table[("t", part.path)] == pytest.approx(1.0)
        assert svc._scale_for("t", part.path) == pytest.approx(1.0)
        assert svc._scale_for("t", "never_seen") == svc._est_scale["t"]
        assert svc._est_scale["t"] > 1.0
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)
    assert tsvc._est_scale_table == jsvc._est_scale_table


@pytest.mark.parametrize("recurring", [True, False], ids=["recurring", "one_off"])
def test_auto_hold_window(sorted_tables, recurring):
    """'auto' opens the hold window for recurring footprints (within
    HOLD_AUTO_MAX) and keeps it closed for one-off ones."""
    def run(S):
        lineitem = S.Reader(sorted_tables["lineitem"])
        svc = service(S, policy=S.dp.StaticPolicy("raw"), hold_ticks="auto")
        assert svc.hold_ticks == 0
        tickets = []
        for i, day in enumerate((200, 900, 1600, 200, 900)):
            plan = (early_late(S.P)[0] if recurring else
                    S.P.ScanPlan("lineitem", ["l_extendedprice"],
                                 S.P.Cmp("l_shipdate", "between", (day, day + 150))))
            if not recurring and i >= 3:
                break
            tickets.append(svc.submit(f"t{i}", lineitem, plan))
            svc.drain()
        if recurring:
            assert 1 <= svc.hold_ticks <= svc.HOLD_AUTO_MAX
            assert svc.telemetry.counters["hold_ticks_auto"] == float(svc.hold_ticks)
        else:
            assert svc.hold_ticks == 0
            assert svc.telemetry.counters.get("held_requests", 0) == 0
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


# ---------------------------------------------------------------------------
# tests/test_costmodel.py: the service and netsim share one table
# ---------------------------------------------------------------------------

def test_service_and_netsim_share_one_table(sorted_tables):
    def run(S):
        lineitem = S.Reader(sorted_tables["lineitem"])
        cm = S.dp.CostModel(rates={"plain": 7.0, "rle": 9.0}, source="calibrated")
        svc = service(S, policy=S.dp.StaticPolicy("raw"), cost_model=cm)
        assert svc.pipeline.decode.rates == cm.rates
        assert svc.pipeline.link.bandwidth_gbps == cm.link_bandwidth_gbps
        t = svc.submit("t", lineitem, S.P.ScanPlan("lineitem", ["l_extendedprice"]))
        svc.drain()
        assert t.status == "done"
        assert svc.telemetry.counters["sim_fetch_decoded_bytes"] > 0
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


# ---------------------------------------------------------------------------
# tests/test_trace.py: the service's lifecycle and the telemetry section
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_path(tmp_path_factory):
    rng = np.random.default_rng(3)
    n = 4096
    cols = {"a": np.arange(n, dtype=np.int32), "b": rng.standard_normal(n).astype(np.float32)}
    schema = TableSchema("smoke", [ColumnSchema("a", "int32", "bitpack"),
                                   ColumnSchema("b", "float32", "plain")])
    path = str(tmp_path_factory.mktemp("trace_svc") / "smoke.lake")
    write_table(path, schema, cols, row_group_size=1024)
    return path


def _names(sp, seen):
    seen.add(sp["name"])
    for c in sp["children"]:
        _names(c, seen)
    return seen


def test_service_traces_full_lifecycle(smoke_path):
    """Every completed request is reconstructable (admission, slices,
    decodes, waits), and the port's span trees are the reference's, span
    for span, under a fake clock."""
    def run(S):
        table = S.Reader(smoke_path)
        svc = service(S, policy=S.dp.StaticPolicy("raw"), hold_ticks=2, tick_bytes=1024 * 8,
                      tracer=fake_tracer(S, capacity=8))
        tickets = [svc.submit("alice", table, S.P.ScanPlan("smoke", ["b"],
                                                           S.P.Cmp("a", "lt", 3000))),
                   svc.submit("bob", table, S.P.ScanPlan("smoke", ["a", "b"]))]
        svc.drain()
        rep = svc.telemetry.trace_report()
        assert rep["enabled"] and rep["completed"] == 2 == rep["recorded"]
        names = []
        for rt in svc.tracer.recorder.traces():
            names.append(_names(rt.root, set()))
            sm = rt.summary
            assert sm["status"] == "done"
            assert sm["attributed_s"] <= sm["wall_s"] + 1e-9
            assert sm["done_tick"] >= sm["submitted_tick"]
        for n in names:
            assert {"request", "admission", "slice_dispatch", "decode_launch"} <= n
        assert any("wfq_wait" in n for n in names)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)
    assert tsvc.telemetry.trace_report() == jsvc.telemetry.trace_report()


def test_service_trace_survives_snapshot(smoke_path):
    def run(S):
        table = S.Reader(smoke_path)
        svc = service(S, policy=S.dp.StaticPolicy("raw"), trace_capacity=4)
        t = svc.submit("t", table, S.P.ScanPlan("smoke", ["b"]))
        svc.drain()
        snap = svc.telemetry.snapshot()
        assert snap["trace"]["recorded"] == 1
        assert "tick_p999_s" in snap
        assert json.dumps(snap["trace"], sort_keys=True)
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


# ---------------------------------------------------------------------------
# tests/test_pushdown.py: the pre-aggregated answer through a Pod
# ---------------------------------------------------------------------------

def test_pre_aggregated_cache_hit_through_a_pod(small_tables):
    """The third identical aggregate submit hits the prefiltered tier: the
    cached accumulators round-trip bit for bit, flagged as a hit."""
    def run(S):
        r = S.Reader(small_tables["lineitem"])
        plan = S.P.ScanPlan("lineitem", [], S.P.Cmp("l_shipdate", "between", (365, 729)),
                            aggregates=(S.P.AggSpec("sum", "l_extendedprice"),
                                        S.P.AggSpec("count"), S.P.AggSpec("min", "l_quantity"),
                                        S.P.AggSpec("max", "l_quantity")),
                            group_by="l_returnflag")
        pod = S.dp.Pod(engine=S.engine(cache=S.BlockCache()))
        tickets = []
        for _ in range(3):
            tickets.append(pod.submit("a", r, plan))
            pod.drain()
        assert pod.policy.decisions["pre-aggregated"] >= 1
        assert tickets[2].result.stats.cache_hit
        same_aggs(tickets[2].result.aggregates, tickets[0].result.aggregates, exact=True)
        return pod, tickets

    (jpod, jt), (tpod, tt) = twin(run)
    same_pods(tpod, jpod, tt, jt)


# ---------------------------------------------------------------------------
# the port's own: defaults, and kernel failures are not request failures
# ---------------------------------------------------------------------------

def test_pod_without_an_engine_runs_on_the_card(monkeypatch):
    """The default pod builds DatapathEngine(cache=BlockCache()) on the
    card, so without one it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdp.Pod()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdp.DatapathService()


@pytest.mark.parametrize("device,backend,key", [("cpu", "auto", "cpu"), ("cpu", "host", "host")])
def test_default_cost_model_is_keyed_by_the_engines_device(device, backend, key):
    """A pod's default table carries its engine's key, never "cuda" on the
    CPU; the nominal prices are the same under every key."""
    pod = tdp.Pod(engine=tengine.DatapathEngine(device=device, backend=backend))
    assert pod.cost_model.backend == key
    assert pod.telemetry.costmodel_info["backend"] == key
    assert pod.cost_model.rates == tcostmodel.NOMINAL_RATES_GBPS
    assert pod.cost_model.launch_overhead_s == jdp.CostModel().launch_overhead_s
    assert tcostmodel.default_cost_model() is pod.cost_model


def test_the_scheduler_installs_the_engines_trace_hook():
    """Importing the service (in a fresh process) installs the port's
    trace module on the port's engine, as the reference's scheduler does."""
    code = ("import repro_torch.core.engine as e\n"
            "assert e.TRACE is None\n"
            "import repro_torch.datapath\n"
            "from repro_torch.datapath import trace\n"
            "assert e.TRACE is trace, e.TRACE\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert tscheduler._engine_mod is tengine


def _failing_pod(paths, batch_decode, n_tenants):
    R = readers_of(T, paths)
    svc = service(T, batch_decode=batch_decode, batch_per_tick=n_tenants,
                  policy=tdp.StaticPolicy("raw"))
    tickets = [svc.submit(f"t{i}", R["lineitem"], p)
               for i, p in enumerate(tenant_plans(tplan, n_tenants))]
    return svc, tickets


@pytest.mark.parametrize("batch_decode,n_tenants,wrapper", [
    (True, 3, "dict_decode_batch"),  # the stacked cross-request pass
    (True, 1, "dict_decode_batch"),  # one request's batched slice
    (False, 2, "dict_decode"),  # the sequential loop
], ids=["stacked", "batched", "sequential"])
def test_kernel_failure_propagates_out_of_tick(small_tables, monkeypatch, batch_decode,
                                               n_tenants, wrapper):
    """A kernel that fails to build or launch inside a tick raises out of
    Pod.tick() and lands on no ticket; the stacked pass does not fall back
    to per-request dispatch after it."""
    svc, tickets = _failing_pod(small_tables, batch_decode, n_tenants)

    def boom(*a, **kw):
        raise build.KernelError("rt_dict_decode failed: CUDA error 719 (unspecified launch "
                                "failure)")

    monkeypatch.setattr(ops, wrapper, boom)
    with pytest.raises(build.KernelError, match="unspecified launch failure"):
        svc.tick()
    assert all(t.error is None and t.result is None and t.status == "queued" for t in tickets)
    c = svc.telemetry.counters
    assert c.get("failed", 0) == 0 and c.get("xreq_fallback", 0) == 0


def test_cuda_errors_raised_by_torch_propagate_too(small_tables, monkeypatch):
    """torch's own card errors (out of memory here) are the card's, not a
    request's: they leave tick() the same way."""
    svc, tickets = _failing_pod(small_tables, True, 2)

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(ops, "dict_decode_batch", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        svc.tick()
    assert all(t.error is None for t in tickets)
    assert set(build.DEVICE_ERRORS) >= {build.KernelError, torch.cuda.OutOfMemoryError}
    assert all(issubclass(e, RuntimeError) for e in build.DEVICE_ERRORS)


def test_a_requests_own_failure_is_still_isolated(small_tables, monkeypatch):
    """Any other exception from the stacked pass keeps the reference's
    semantics: the group falls back to per-request dispatch (counted as
    xreq_fallback) and every result is still bit-identical."""
    svc, tickets = _failing_pod(small_tables, True, 3)
    monkeypatch.setattr(svc.engine, "scan_group_batched",
                        lambda *a, **kw: (_ for _ in ()).throw(ValueError("bad group")))
    svc.drain()
    assert svc.telemetry.counters["xreq_fallback"] == 1
    eng, r = T.engine(), T.Reader(small_tables["lineitem"])
    for t, p in zip(tickets, tenant_plans(tplan, 3)):
        assert t.status == "done"
        same_rows(t.result, eng.scan(r, p))


def test_kernel_errors_are_runtime_errors_of_a_type_of_their_own():
    assert issubclass(build.KernelError, RuntimeError)
    assert not issubclass(build.KernelError, tdp.StorageFault)


def test_stacked_pass_probes_each_bloom_once(small_tables, monkeypatch):
    """Four tenants' lineitem plans in one tick, one with a bloom semijoin
    on l_partkey: the stacked pass probes its keys in one launch, the
    l_partkey pages an earlier tenant decoded first among them (the
    reference probes such pages per row group); every result equals the
    request's own scan and the JAX pod's, and the telemetry is the
    reference's."""
    def run(S):
        P = S.P
        r = S.Reader(small_tables["lineitem"])
        eng = S.engine()
        subs = [
            (P.ScanPlan("lineitem", ["l_quantity", "l_extendedprice", "l_discount", "l_tax"],
                        P.Cmp("l_shipdate", "le", 2436)), None),
            (P.ScanPlan("lineitem", ["l_partkey", "l_extendedprice", "l_discount"],
                        P.Cmp("l_shipdate", "between", (1000, 1029))), None),
            (P.ScanPlan("lineitem", ["l_partkey", "l_quantity", "l_extendedprice"],
                        P.and_(P.BloomProbe("l_partkey", n_bits=1 << 15, name="b"),
                               P.Cmp("l_quantity", "between", (1, 30)),
                               P.InSet("l_shipmode", ("AIR", "REG AIR")))),
             {"b": S.bloom(0, 2000, 1 << 15)}),
            (plans(P)[0], None),
        ]
        svc = service(S, batch_per_tick=len(subs), policy=S.dp.StaticPolicy("raw"))
        tickets = [svc.submit(f"t{i}", r, p, bl) for i, (p, bl) in enumerate(subs)]
        calls = []
        if S is T:
            real = ops.bloom_probe
            monkeypatch.setattr(ops, "bloom_probe",
                                lambda *a, **kw: calls.append(1) or real(*a, **kw))
        svc.drain()
        probes = len(calls)
        assert svc.telemetry.counters["xreq_groups"] == 1
        for (p, bl), t in zip(subs, tickets):
            same_rows(t.result, eng.scan(r, p, blooms=bl))
        assert int(tickets[2].result.count) > 0
        return svc, tickets, probes

    (jsvc, jt, _), (tsvc, tt, probes) = twin(run)
    assert probes == 1
    same_pods(tsvc, jsvc, tt, jt)
