"""The port's flight recorder (`repro_torch.datapath.trace`): the
reference's recorder units (tests/test_trace.py, all but the service's)
driving the port — deterministic sampling, the bounded ring, the span cap,
the wait-state machine, stage attribution, the Chrome-trace export and the
module-level slice context — and the engine's spans: a traced scan on the
port emits `fetch`, `decode_launch`, `filter` and `store_hit`, with the same
span names and counts as the JAX engine's, and returns what an untraced
scan returns."""

import json

import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.core.cache import BlockCache as JBlockCache
from repro.datapath import trace as jtrace
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import BlockCache, DatapathEngine
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.datapath import PAPER_FIG2_PCT, STAGES, Tracer
from repro_torch.datapath import trace as trace_mod
from repro_torch.lakeformat.reader import LakeReader


class FakeClock:
    """Monotonic counter clock: every read advances by `step`."""

    def __init__(self, step: float = 1.0):
        self.t = 0.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def make_tracer(**kw) -> Tracer:
    kw.setdefault("clock", FakeClock())
    return Tracer(**kw)


def test_sampling_is_deterministic_and_exact():
    tr = make_tracer(sample_rate=0.5)
    picks = [tr.start(i, "t", "tbl") is not None for i in range(8)]
    # accumulator: 0.5 (skip), 1.0 (sample), ... — every second request
    assert picks == [False, True] * 4
    assert tr.sampled == 4 and tr.skipped == 4
    # an identical tracer makes identical picks (no hidden RNG state)
    tr2 = make_tracer(sample_rate=0.5)
    assert [tr2.start(i, "t", "tbl") is not None for i in range(8)] == picks


def test_sampling_rate_one_traces_everything():
    tr = make_tracer(sample_rate=1.0)
    assert all(tr.start(i, "t", "tbl") is not None for i in range(5))
    assert tr.skipped == 0


def test_sampling_fractional_rate_hits_expected_count():
    tr = make_tracer(sample_rate=0.25)
    n = sum(tr.start(i, "t", "tbl") is not None for i in range(100))
    assert n == 25  # exact, not approximate: the accumulator never drifts


# ---------------------------------------------------------------------------
# ring: bounded memory, completed counts keep running
# ---------------------------------------------------------------------------

def test_ring_keeps_last_capacity_traces():
    tr = make_tracer(capacity=3)
    for i in range(7):
        tr.start(i, f"tenant{i % 2}", "tbl")
        tr.finish(i, "done")
    rec = tr.recorder
    assert rec.completed == 7
    assert [rt.req_id for rt in rec.traces()] == [4, 5, 6]
    rep = tr.report()
    assert rep["completed"] == 7 and rep["recorded"] == 3
    assert [r["req_id"] for r in rep["requests"]] == [4, 5, 6]


# ---------------------------------------------------------------------------
# span cap: overflow drops spans but never desyncs the stack
# ---------------------------------------------------------------------------

def test_max_spans_drop_keeps_stack_discipline():
    tr = make_tracer(max_spans=3)  # root + 2 children
    rt = tr.start(1, "t", "tbl")
    tr.begin(rt, "slice_dispatch")
    tr.begin(rt, "fetch")          # 3rd span: at cap from here on
    tr.begin(rt, "decode_launch")  # dropped
    tr.begin(rt, "inner")          # dropped
    tr.end(rt)                     # matches dropped "inner"
    tr.end(rt)                     # matches dropped "decode_launch"
    tr.end(rt, name="fetch")       # closes the REAL fetch span
    tr.end(rt, name="slice_dispatch")
    tr.finish(1, "done")
    sm = rt.summary
    assert rt.dropped_spans == 2 and rt.drop_depth == 0
    assert sm["spans"] == 3 and sm["dropped_spans"] == 2
    (sd,) = rt.root["children"]
    assert sd["name"] == "slice_dispatch" and sd["t1"] is not None
    (fe,) = sd["children"]
    assert fe["name"] == "fetch" and fe["children"] == []


def test_named_end_closes_dangling_children():
    """An exception between begin(fetch) and its end leaves fetch open;
    the slice's named end must close it (at the same instant) instead of
    mis-attributing the rest of the run to fetch."""
    tr = make_tracer()
    rt = tr.start(1, "t", "tbl")
    tr.begin(rt, "slice_dispatch")
    tr.begin(rt, "fetch")
    # error path: no end for fetch
    tr.end(rt, name="slice_dispatch")
    assert len(rt.stack) == 1  # back at the root
    (sd,) = rt.root["children"]
    (fe,) = sd["children"]
    assert fe["t1"] == sd["t1"]  # closed together, zero residual width
    tr.finish(1, "error")
    assert rt.summary["status"] == "error"


def test_unmatched_end_never_pops_the_root():
    tr = make_tracer()
    rt = tr.start(1, "t", "tbl")
    tr.end(rt)  # nothing open: must be a no-op
    assert rt.stack == [rt.root]
    tr.finish(1, "done")
    assert rt.root["t1"] >= rt.root["t0"]


# ---------------------------------------------------------------------------
# wait-state machine
# ---------------------------------------------------------------------------

def test_wait_extends_same_kind_and_switches_kinds():
    tr = make_tracer()
    rt = tr.start(1, "t", "tbl")
    tr.wait(rt, "hold_window")
    tr.wait(rt, "hold_window")
    tr.wait(rt, "hold_window")
    tr.wait(rt, "wfq_wait")  # kind switch closes the hold span
    tr.wait(rt, "wfq_wait")
    tr.end_wait(rt)
    hold, wfq = rt.root["children"]
    assert hold["name"] == "hold_window" and hold["args"]["ticks"] == 3
    assert wfq["name"] == "wfq_wait" and wfq["args"]["ticks"] == 2
    assert hold["t1"] <= wfq["t0"]  # waits never overlap
    assert rt.wait_kind is None
    tr.finish(1, "done")


def test_finish_closes_an_open_wait():
    tr = make_tracer()
    rt = tr.start(1, "t", "tbl")
    tr.wait(rt, "wfq_wait")
    tr.finish(1, "cancelled")
    (w,) = rt.root["children"]
    assert w["t1"] is not None and rt.summary["status"] == "cancelled"


# ---------------------------------------------------------------------------
# stage attribution
# ---------------------------------------------------------------------------

def test_attribution_maps_spans_and_never_double_bills():
    clock = FakeClock()
    tr = Tracer(clock=clock)
    rt = tr.start(1, "t", "tbl")
    tr.begin(rt, "slice_dispatch")      # unmapped: recursed, not billed
    tr.begin(rt, "fetch")
    tr.event(rt, "store_hit")           # child of a mapped span: ignored
    tr.end(rt, name="fetch")
    tr.begin(rt, "decode_launch")
    tr.end(rt, name="decode_launch")
    tr.begin(rt, "filter")
    tr.end(rt, name="filter")
    tr.end(rt, name="slice_dispatch")
    tr.finish(1, "done")
    sm = rt.summary
    assert set(sm["stages_s"]) == set(STAGES)
    assert sm["stages_s"]["fetch"] > 0
    assert sm["stages_s"]["decode"] > 0  # decode_launch -> decode
    assert sm["stages_s"]["filter"] > 0
    assert sm["stages_s"]["admission"] == 0.0
    assert sm["attributed_s"] <= sm["wall_s"] + 1e-12
    assert 0.0 <= sm["decode_pct"] <= 100.0
    assert abs(sm["decode_pct"] + sm["filter_pct"] + sm["rest_pct"] - 100.0) < 1e-9


def test_report_rolls_up_by_tenant_with_paper_anchor():
    tr = make_tracer()
    for i, tenant in enumerate(("alice", "alice", "bob")):
        rt = tr.start(i, tenant, "tbl")
        tr.begin(rt, "decode_launch")
        tr.end(rt, name="decode_launch")
        tr.finish(i, "done")
    rep = tr.report()
    assert rep["paper_fig2_pct"] == dict(sorted(PAPER_FIG2_PCT.items()))
    assert set(rep["by_tenant"]) == {"alice", "bob"}
    assert rep["by_tenant"]["alice"]["n"] == 2
    for bt in rep["by_tenant"].values():
        assert abs(bt["decode_pct"] + bt["filter_pct"] + bt["rest_pct"]
                   - 100.0) < 1e-9
    # fleet wall is the sum of per-tenant walls
    assert abs(rep["wall_s"]
               - sum(bt["wall_s"] for bt in rep["by_tenant"].values())) < 1e-9


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

def test_chrome_trace_shape_and_determinism(tmp_path):
    tr = make_tracer()
    for i, tenant in enumerate(("alice", "bob")):
        rt = tr.start(i, tenant, "tbl")
        tr.begin(rt, "slice_dispatch")
        tr.event(rt, "store_hit", tier="decoded")
        tr.end(rt, name="slice_dispatch")
        tr.finish(i, "done")
    doc = tr.recorder.to_chrome_trace()
    events = doc["traceEvents"]
    meta = [e for e in events if e["ph"] == "M"]
    spans = [e for e in events if e["ph"] == "X"]
    instants = [e for e in events if e["ph"] == "i"]
    assert {e["args"]["name"] for e in meta if e["name"] == "process_name"} \
        == {"alice", "bob"}
    assert all(e["dur"] > 0 and e["ts"] >= 0 for e in spans)
    assert all(e["s"] == "t" for e in instants)
    assert any(e["name"] == "store_hit" for e in instants)
    # export is deterministic and valid JSON
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        tr.recorder.to_chrome_trace(), sort_keys=True)
    path = tmp_path / "trace.json"
    n = tr.recorder.save_chrome_trace(str(path))
    assert n == len(events)
    assert json.loads(path.read_text())["traceEvents"] == json.loads(
        json.dumps(events))


def test_chrome_trace_empty_ring():
    tr = make_tracer()
    assert tr.recorder.to_chrome_trace() == {"displayTimeUnit": "ms",
                                             "traceEvents": []}


# ---------------------------------------------------------------------------
# module-level slice context
# ---------------------------------------------------------------------------

def test_module_hooks_noop_without_slice_context():
    assert trace_mod._CUR is None
    # must not raise, must not allocate a trace anywhere
    trace_mod.begin("fetch")
    trace_mod.event("store_hit")
    trace_mod.end(name="fetch")


def test_module_hooks_record_into_published_slice():
    tr = make_tracer()
    rt = tr.start(1, "t", "tbl")
    trace_mod.set_slice(tr, rt)
    try:
        trace_mod.begin("fetch", rg=0)
        trace_mod.event("store_hit", tier="encoded")
        trace_mod.end(name="fetch", nbytes=10)
    finally:
        trace_mod.set_slice(None, None)
    (fe,) = rt.root["children"]
    assert fe["name"] == "fetch" and fe["args"]["nbytes"] == 10
    assert fe["children"][0]["name"] == "store_hit"
    tr.finish(1, "done")




# ---------------------------------------------------------------------------
# the engine's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_trace")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192)["lineitem"]


def _names(span, out):
    for c in span["children"]:
        out.append(c["name"])
        _names(c, out)
    return out


def _traced(mod, tracer_cls, engine_mod, scan):
    """Run `scan()` inside a published slice of a fresh tracer of `mod`
    with `engine_mod.TRACE` installed; returns (result, span names)."""
    tr = tracer_cls(clock=FakeClock())
    rt = tr.start(1, "t", "lineitem")
    engine_mod.TRACE = mod
    mod.set_slice(tr, rt)
    try:
        res = scan()
    finally:
        mod.set_slice(None, None)
        engine_mod.TRACE = None
    tr.finish(1, "done")
    return res, _names(rt.root, [])


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("offload", ["raw", "preloaded", "prefiltered"])
def test_engine_spans_match_the_reference_and_change_nothing(lineitem_path, batched, offload):
    """Two scans in one slice (the second a cache hit under the cached
    modes): the port's span names, in order, are the JAX engine's, and the
    traced results equal an untraced run bit for bit."""
    def plan(P):
        return P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                          P.and_(P.Cmp("l_shipdate", "between", (365, 729)),
                                 P.Cmp("l_quantity", "lt", 24)))

    t_eng = DatapathEngine(device="cpu", offload=offload, cache=BlockCache(1 << 30))
    r = LakeReader(lineitem_path)
    got, t_names = _traced(trace_mod, Tracer, tengine, lambda: [
        t_eng.scan(r, plan(tplan), batched=batched) for _ in range(2)])
    j_eng = jengine.DatapathEngine(backend="ref", offload=offload, cache=JBlockCache(1 << 30))
    jr = JReader(lineitem_path)
    _, j_names = _traced(jtrace, jtrace.Tracer, jengine, lambda: [
        j_eng.scan(jr, plan(jplan), batched=batched) for _ in range(2)])
    assert t_names == j_names
    assert {"fetch", "decode_launch", "filter"} <= set(t_names)
    if offload != "raw":
        assert "store_hit" in t_names
    want = DatapathEngine(device="cpu", offload=offload, cache=BlockCache(1 << 30))
    for res in got:
        plain = want.scan(r, plan(tplan), batched=batched)
        assert torch.equal(res.mask, plain.mask) and int(res.count) == int(plain.count)
        for c in plain.columns:
            assert torch.equal(res.columns[c], plain.columns[c])


def test_untraced_engine_builds_no_span():
    """Without a published slice `_tr()` is None whether or not the hook
    is installed: the untraced path builds no span arguments."""
    assert tengine._tr() is None
    tengine.TRACE = trace_mod
    try:
        assert tengine._tr() is None
    finally:
        tengine.TRACE = None
