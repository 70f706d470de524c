"""Property sweeps of the port's service on the CPU, each configuration run on
both packages (test_torch_service.py's harness):

- reconciliation (tests/test_recon_props.py): with reconciliation on,
  sched + recon == actual per tenant, virtual time never negative at a tick
  boundary, and FIFO's schedule unchanged by reconciliation; the port's
  charges, corrections and virtual time after every tick equal the
  reference's;
- the flight recorder (tests/test_trace_props.py): every span tree is
  well-formed, attribution never over-bills, every admitted request is
  reconstructable, the Chrome-trace export is deterministic, tracing never
  changes a result; under a fake clock the port's span trees are the
  reference's, span for span;
- batched ≡ sequential dispatch within the port: the same results, done
  ticks and charges whichever path a pod dispatches on.

Fixed cases always run; the hypothesis sweeps keep the reference's
max_examples and skip without hypothesis, as the reference's do.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import json

import numpy as np
import pytest

from repro.core import tpch as jtpch
from repro.lakeformat.schema import ColumnSchema, TableSchema
from repro.lakeformat.writer import write_table
from tests.test_torch_service import (  # noqa: F401 (trace_hooks: autouse)
    T, fake_tracer, same_pods, same_rows, span_args, trace_hooks, twin)

EPS = 1e-9

# ---------------------------------------------------------------------------
# reconciliation
# ---------------------------------------------------------------------------

RG_ROWS = 8192
RG_COST = RG_ROWS * 4 * 2


@pytest.fixture(scope="module")
def lineitem_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_recon")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, sorted_data=True,
                              row_group_size=RG_ROWS)["lineitem"]


def recon_plans(P):
    return [
        P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"]),  # elephant
        P.ScanPlan("lineitem", ["l_discount", "l_tax"]),  # disjoint elephant
        P.ScanPlan("lineitem", ["l_extendedprice"],
                   P.Cmp("l_shipdate", "between", (300, 700))),  # mouse
        P.ScanPlan("lineitem", ["l_extendedprice"], P.Cmp("l_quantity", "le", 10)),  # fused
    ]


def recon_service(S, scheduler="wfq", tick_bytes=None, hold_ticks=0, reconcile=True,
                  weights=(), batch_decode=True):
    return S.dp.DatapathService(
        engine=S.engine(cache=S.BlockCache(1 << 30)), policy=S.dp.StaticPolicy("raw"),
        scheduler=scheduler, tick_bytes=tick_bytes, hold_ticks=hold_ticks,
        reconcile=reconcile, quotas={t: S.dp.TenantQuota(weight=w) for t, w in weights},
        batch_decode=batch_decode)


def run_workload(S, svc, path, plan_idxs, cheat_factor=1.0):
    """One tenant per plan (tenant t0 cheats by `cheat_factor`), drained while
    checking virtual time each tick; returns (tickets, vtime after each tick)."""
    reader = S.Reader(path)
    ps = recon_plans(S.P)
    tickets = []
    for i, pi in enumerate(plan_idxs):
        tickets.append(svc.submit(f"t{i}", reader, ps[pi]))
        if i == 0 and cheat_factor != 1.0:
            req = next(q for q in svc.queue if q.tenant == "t0")
            req.rg_costs = tuple(c * cheat_factor for c in req.rg_costs)
    history = []
    while svc.queue:
        svc.tick()
        assert len(history) < 10_000, "drain did not converge"
        assert all(v >= 0.0 for v in svc._vtime.values()), svc._vtime
        history.append(dict(svc._vtime))
    return tickets, history


def check_charge_equals_actual(path, plan_idxs, scheduler="wfq", tick_bytes=None,
                               hold_ticks=0, cheat_factor=1.0, weights=()):
    def run(S):
        svc = recon_service(S, scheduler=scheduler, tick_bytes=tick_bytes,
                            hold_ticks=hold_ticks, weights=weights)
        tickets, history = run_workload(S, svc, path, plan_idxs, cheat_factor)
        assert all(t.status == "done" for t in tickets)
        tel = svc.telemetry
        for t in tickets:
            est = tel.tenant_sched_seconds.get(t.tenant, 0.0)
            recon = tel.tenant_recon_seconds.get(t.tenant, 0.0)
            actual = tel.tenant_actual_seconds.get(t.tenant, 0.0)
            assert est + recon == pytest.approx(actual, rel=1e-9, abs=1e-15), (t.tenant, est,
                                                                               recon, actual)
            assert actual >= 0.0
        return svc, tickets, history

    (jsvc, jt, jh), (tsvc, tt, th) = twin(run)
    assert th == jh
    same_pods(tsvc, jsvc, tt, jt)


def check_fifo_unaffected_by_reconcile(path, plan_idxs, tick_bytes=None, cheat_factor=1.0):
    def run(S, reconcile):
        svc = recon_service(S, scheduler="fifo", tick_bytes=tick_bytes, reconcile=reconcile)
        tickets, _ = run_workload(S, svc, path, plan_idxs, cheat_factor)
        return svc, tickets

    for reconcile in (True, False):
        (jsvc, jt), (tsvc, tt) = twin(run, reconcile)
        same_pods(tsvc, jsvc, tt, jt)
        done = [(t.tenant, t.done_tick, int(t.result.count)) for t in tt]
        if reconcile:
            with_recon = done
    assert done == with_recon


FIXED_CASES = [
    dict(plan_idxs=(0, 1)),  # two honest elephants, unbounded ticks
    dict(plan_idxs=(0, 1), tick_bytes=RG_COST, cheat_factor=0.25),  # 4x cheat
    dict(plan_idxs=(0, 1, 2, 3), tick_bytes=RG_COST * 2, hold_ticks=2),  # holds
    dict(plan_idxs=(3, 2), cheat_factor=4.0, weights=(("t0", 2.0), ("t1", 0.5))),  # refunds
]


@pytest.mark.parametrize("case", FIXED_CASES)
def test_charge_equals_actual_fixed(lineitem_path, case):
    check_charge_equals_actual(lineitem_path, **case)


@pytest.mark.parametrize("tick_bytes", [None, RG_COST])
@pytest.mark.parametrize("cheat_factor", [1.0, 0.25])
def test_fifo_unaffected_fixed(lineitem_path, tick_bytes, cheat_factor):
    check_fifo_unaffected_by_reconcile(lineitem_path, (0, 2), tick_bytes=tick_bytes,
                                       cheat_factor=cheat_factor)


def test_reconcile_off_still_reports_actuals(lineitem_path):
    def run(S):
        svc = recon_service(S, reconcile=False)
        tickets, _ = run_workload(S, svc, lineitem_path, (0,), cheat_factor=0.5)
        tel = svc.telemetry
        assert tel.tenant_actual_seconds["t0"] > 0
        assert tel.tenant_recon_seconds.get("t0", 0.0) == 0.0
        assert tel.cost_report()["t0"]["rel_err"] < -0.4  # the 2x lie is visible
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


@pytest.mark.parametrize("case", FIXED_CASES[:3])
def test_batched_and_sequential_dispatch_agree(lineitem_path, case):
    """Within the port, a pod on the batched path and one on the sequential
    path return the same results on the same ticks with the same charges;
    only the launch counts differ."""
    runs = []
    for batch_decode in (True, False):
        svc = recon_service(T, tick_bytes=case.get("tick_bytes"),
                            hold_ticks=case.get("hold_ticks", 0), batch_decode=batch_decode)
        tickets, history = run_workload(T, svc, lineitem_path, case["plan_idxs"],
                                        case.get("cheat_factor", 1.0))
        runs.append((svc, tickets, history))
    (bsvc, bt, bh), (ssvc, st_, sh) = runs
    assert bh == sh
    for a, b in zip(bt, st_):
        assert (a.status, a.done_tick) == (b.status, b.done_tick)
        same_rows(a.result, b.result)
    assert (bsvc.telemetry.tenant_sched_seconds == ssvc.telemetry.tenant_sched_seconds)
    assert (bsvc.telemetry.tenant_actual_seconds == ssvc.telemetry.tenant_actual_seconds)
    assert (bsvc.telemetry.counters["decode_launches"]
            <= ssvc.telemetry.counters["decode_launches"])


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

TRACE_RG_ROWS = 900  # ragged: not a PACK_BLOCK multiple


@pytest.fixture(scope="module")
def mixed_path(tmp_path_factory):
    """A small mixed-encoding table, 5 ragged row groups."""
    rng = np.random.default_rng(11)
    n = 4 * TRACE_RG_ROWS + 420
    cols = {
        "ts": np.arange(n, dtype=np.int32),
        "flag": np.repeat(rng.integers(0, 4, n // 60 + 1), 60)[:n].astype(np.int32),
        "price": rng.standard_normal(n).astype(np.float32),
        "key": rng.integers(0, 1 << 11, n).astype(np.int32),
    }
    schema = TableSchema("mixed", [
        ColumnSchema("ts", "int32", "delta"),
        ColumnSchema("flag", "int32", "rle"),
        ColumnSchema("price", "float32", "plain"),
        ColumnSchema("key", "int32", "bitpack"),
    ])
    path = str(tmp_path_factory.mktemp("traceprops") / "mixed.lake")
    write_table(path, schema, cols, row_group_size=TRACE_RG_ROWS)
    return path


def trace_plans(P):
    return [
        P.ScanPlan("mixed", ["price"], P.Cmp("ts", "lt", 2 * TRACE_RG_ROWS)),
        P.ScanPlan("mixed", ["price", "flag"], P.Cmp("key", "lt", 700)),
        P.ScanPlan("mixed", ["ts", "price"]),
        P.ScanPlan("mixed", ["flag"], P.Cmp("flag", "between", (1, 2))),
    ]


def build(S, c, tracing: bool):
    kw = dict(tracer=fake_tracer(S, capacity=16)) if tracing else dict(trace_sample_rate=0.0)
    return S.dp.DatapathService(
        engine=S.engine(cache=S.BlockCache(1 << 30)), policy=S.dp.StaticPolicy(c["offload"]),
        scheduler=c["scheduler"], batch_decode=c["batch_decode"], hold_ticks=c["hold_ticks"],
        tick_bytes=c["tick_bytes"], **kw)


def trace_workload(S, svc, c, path):
    reader = S.Reader(path)
    ps = trace_plans(S.P)
    tickets = []
    for i in range(c["n_reqs"]):
        tickets.append(svc.submit(f"tenant{i % 2}", reader, ps[i % len(ps)]))
        if c["hold_ticks"] and i == 0:
            svc.tick()  # let the first request enter its hold window
    svc.drain()
    if c["repeat"]:  # a second pass hits the store
        tickets.append(svc.submit("tenant0", reader, ps[0]))
        svc.drain()
    return tickets


def check_tree(sp, lo, hi):
    assert sp["t1"] is not None, sp["name"]
    assert sp["t0"] <= sp["t1"] + EPS, sp["name"]
    assert sp["t0"] >= lo - EPS and sp["t1"] <= hi + EPS, sp["name"]
    for ch in sp["children"]:
        check_tree(ch, sp["t0"], sp["t1"])


def check_span_invariants(svc, tickets):
    traces = svc.tracer.recorder.traces()
    assert len(traces) == len(tickets)
    assert {rt.req_id for rt in traces} == {t.req_id for t in tickets}
    for rt in traces:
        root = rt.root
        check_tree(root, root["t0"], root["t1"])
        assert root["name"] == "request" and root["children"][0]["name"] == "admission"
        sm = rt.summary
        assert sm["status"] == "done" and sm["done_tick"] >= sm["submitted_tick"]
        assert sm["attributed_s"] <= sm["wall_s"] + EPS
        assert sum(sm["stages_s"].values()) == pytest.approx(sm["attributed_s"])
        assert sm["rest_pct"] >= -EPS
    blob = json.dumps(svc.tracer.recorder.to_chrome_trace(), sort_keys=True)
    assert blob == json.dumps(svc.tracer.recorder.to_chrome_trace(), sort_keys=True)
    events = json.loads(blob)["traceEvents"]
    for e in events:
        assert list(e["args"]) == sorted(e["args"])
        e["args"] = span_args(e["args"])
    return events


def check_trace_case(path, c):
    """Span invariants on each package, the port's trees equal to the
    reference's, and traced ≡ untraced within the port."""
    def run(S):
        svc = build(S, c, tracing=True)
        tickets = trace_workload(S, svc, c, path)
        return svc, tickets, check_span_invariants(svc, tickets)

    (jsvc, jt, jevents), (tsvc, tt, tevents) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)
    assert tevents == jevents  # the Chrome traces too
    plain = trace_workload(T, build(T, c, tracing=False), c, path)
    assert len(plain) == len(tt)
    for a, b in zip(tt, plain):
        assert a.status == b.status == "done"
        same_rows(a.result, b.result)


FIXED_TRACE = [
    dict(scheduler="fifo", batch_decode=False, hold_ticks=0, tick_bytes=None,
         offload="raw", n_reqs=2, repeat=False),
    dict(scheduler="wfq", batch_decode=True, hold_ticks=0, tick_bytes=None,
         offload="raw", n_reqs=3, repeat=False),
    dict(scheduler="wfq", batch_decode=True, hold_ticks=2,
         tick_bytes=TRACE_RG_ROWS * 4 * 2, offload="raw", n_reqs=4, repeat=False),
    dict(scheduler="wfq", batch_decode=False, hold_ticks=2,
         tick_bytes=TRACE_RG_ROWS * 4 * 2, offload="preloaded", n_reqs=2, repeat=True),
    dict(scheduler="fifo", batch_decode=True, hold_ticks=0, tick_bytes=None,
         offload="prefiltered", n_reqs=2, repeat=True),
]
IDS = ["seq-fifo", "batch-wfq", "sliced-hold", "preloaded-repeat", "prefiltered-repeat"]


@pytest.mark.parametrize("c", FIXED_TRACE, ids=IDS)
def test_span_invariants_and_bit_identity_fixed(mixed_path, c):
    check_trace_case(mixed_path, c)


def test_ring_and_sampler_accounting(mixed_path):
    for n_reqs, rate in [(1, 1.0), (4, 0.5), (5, 0.5), (5, 1.0)]:
        def run(S):
            svc = S.dp.DatapathService(
                engine=S.engine(cache=S.BlockCache(1 << 30)), policy=S.dp.StaticPolicy("raw"),
                trace_sample_rate=rate, trace_capacity=2)
            reader = S.Reader(mixed_path)
            tickets = [svc.submit("t", reader, trace_plans(S.P)[i % 4]) for i in range(n_reqs)]
            svc.drain()
            tr = svc.tracer
            sampled = int(n_reqs * rate)  # exact: fractional accumulator
            assert tr.sampled == sampled and tr.sampled + tr.skipped == n_reqs
            rep = tr.report()
            assert rep["completed"] == sampled
            assert rep["recorded"] == min(2, sampled) and rep["live"] == 0
            return svc, tickets

        (jsvc, jt), (tsvc, tt) = twin(run)
        same_pods(tsvc, jsvc, tt, jt)
        assert [rt.req_id for rt in tsvc.tracer.recorder.traces()] == \
            [rt.req_id for rt in jsvc.tracer.recorder.traces()]


# ---------------------------------------------------------------------------
# hypothesis sweeps
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @settings(deadline=None, max_examples=15)
    @given(
        plan_idxs=st.lists(st.integers(0, 3), min_size=1, max_size=4),
        scheduler=st.sampled_from(["wfq", "fifo"]),
        tick_bytes=st.sampled_from([None, 0, RG_COST, RG_COST * 3]),
        hold_ticks=st.integers(0, 2),
        cheat_factor=st.sampled_from([0.25, 0.5, 1.0, 4.0]),
        w0=st.sampled_from([0.5, 1.0, 3.0]),
    )
    def _hyp_charge(path, plan_idxs, scheduler, tick_bytes, hold_ticks, cheat_factor, w0):
        check_charge_equals_actual(path, tuple(plan_idxs), scheduler=scheduler,
                                   tick_bytes=tick_bytes, hold_ticks=hold_ticks,
                                   cheat_factor=cheat_factor, weights=(("t0", w0),))

    @settings(deadline=None, max_examples=10)
    @given(
        plan_idxs=st.lists(st.integers(0, 3), min_size=1, max_size=3),
        tick_bytes=st.sampled_from([None, RG_COST]),
        cheat_factor=st.sampled_from([0.25, 1.0, 4.0]),
    )
    def _hyp_fifo(path, plan_idxs, tick_bytes, cheat_factor):
        check_fifo_unaffected_by_reconcile(path, tuple(plan_idxs), tick_bytes=tick_bytes,
                                           cheat_factor=cheat_factor)

    cfg = st.fixed_dictionaries({
        "scheduler": st.sampled_from(["fifo", "wfq"]),
        "batch_decode": st.booleans(),
        "hold_ticks": st.sampled_from([0, 2]),
        "tick_bytes": st.sampled_from([None, TRACE_RG_ROWS * 4 * 2]),
        "offload": st.sampled_from(["raw", "preloaded", "prefiltered"]),
        "n_reqs": st.integers(1, 4),
        "repeat": st.booleans(),
    })

    @settings(deadline=None, max_examples=15)
    @given(cfg)
    def _hyp_trace(path, c):
        check_trace_case(path, c)

    def test_charge_equals_actual_property(lineitem_path):
        _hyp_charge(lineitem_path)

    def test_fifo_unaffected_property(lineitem_path):
        _hyp_fifo(lineitem_path)

    def test_trace_sweep(mixed_path):
        _hyp_trace(mixed_path)

else:

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_charge_equals_actual_property():
        pass

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_fifo_unaffected_property():
        pass

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_trace_sweep():
        pass
