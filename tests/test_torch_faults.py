"""The port's storage fault plane (`repro_torch.datapath.faults`) on the CPU
against the JAX one: tests/test_faults.py and tests/test_chaos_props.py,
the fabric's cases included (fleets of 1, 2 and 4 pods under the
recoverable mix, one poisoned pod, the hypothesis sweep's two-pod arm).

- The schedule: both packages' FaultPlans make the same decision at every
  (table, row group, column, attempt) of a grid, for every fault kind, and
  the same byte flip and truncation of a page copy.
- Each service scenario runs on both packages with the same plan, policy and
  submissions: the reference's assertions hold on the port (recoverable
  faults recover bit-identically, terminal ones end typed, the breaker
  degrades, probes and sheds, fault seconds are reconciled into WFQ), and
  the two pods agree on results, tickets, counters, the fault ledger,
  virtual time and span trees (test_torch_service.py's harness); two fleets
  agree as test_torch_fabric.py's `same_fabrics` holds them.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import pytest
import torch

from repro.core import tpch as jtpch
from repro.datapath import faults as jfaults
from repro.lakeformat import integrity as jintegrity
from repro_torch.datapath import faults as tfaults
from repro_torch.lakeformat import integrity as tintegrity
from tests.test_torch_fabric import fabric, same_fabrics
from tests.test_torch_service import (  # noqa: F401 (trace_hooks: autouse)
    J, T, fake_tracer, same_pods, same_rows, service, trace_hooks, twin)

RG_ROWS = 2048
TICK_BYTES = 1 << 14
MAX_TICKS = 2000  # hang guard: orders of magnitude above any real drain



@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_faults")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=RG_ROWS)


def the_plan(P):
    return P.ScanPlan("lineitem", ["l_quantity", "l_extendedprice"],
                      P.Cmp("l_quantity", "le", 25))  # unprunable: every rg survives


@functools.lru_cache(maxsize=None)
def _direct_scan(side: str, path):
    S = J if side == "jax" else T
    return S.engine().scan(S.Reader(path), the_plan(S.P))


def _direct(S, path):
    return _direct_scan(S.name, path)


def _service(S, **kw):
    kw.setdefault("tick_bytes", TICK_BYTES)
    kw.setdefault("tracer", fake_tracer(S))
    return service(S, **kw)


def _scan_through(S, tables, **kw):
    """One tenant's PLAN through a faulted pod; returns (pod, [ticket])."""
    r = S.Reader(tables["lineitem"])
    svc = _service(S, **kw)
    t = svc.submit("t0", r, the_plan(S.P))
    same_rows(svc.result(t), _direct(S, tables["lineitem"]))
    return svc, [t]


# ---------------------------------------------------------------------------
# the schedule: the same faults at the same coordinates
# ---------------------------------------------------------------------------

PLAN_KW = [
    dict(seed=7, transient_rate=0.3, corrupt_rate=0.2, short_read_rate=0.1, spike_rate=0.5,
         spike_s=1e-3),
    dict(seed=1, transient_rate=0.5, corrupt_rate=0.5, fail_forever=True),
    dict(seed=2 ** 16, transient_rate=0.05, corrupt_rate=0.02, short_read_rate=0.3,
         spike_rate=0.9, spike_s=10.0, straggler_pods={"pod1": 2e-3}),
]


@pytest.mark.parametrize("kw", PLAN_KW, ids=["mixed", "fail_forever", "straggler"])
def test_fault_plans_decide_the_same_faults_as_the_reference(kw):
    jp, tp = jfaults.FaultPlan(**kw), tfaults.FaultPlan(**kw)
    grid = itertools.product(("/a/lineitem.lake", "/b/part.lake", "orders.lake"), range(40),
                             ("l_quantity", "p_size", "c"), range(4))
    for table, rg, col, attempt in grid:
        assert tp.transient(table, rg, attempt) == jp.transient(table, rg, attempt)
        assert tp.corrupt(table, rg, col, attempt) == jp.corrupt(table, rg, col, attempt)
        assert tp.short_read(table, rg, col, attempt) == jp.short_read(table, rg, col, attempt)
        assert tp.spike(table, rg, attempt) == jp.spike(table, rg, attempt)
    for pod in ("pod0", "pod1"):
        assert tp.straggle(pod) == jp.straggle(pod)
    assert tp.any_faults() == jp.any_faults()
    assert [tfaults._u(s, "x", i) for s in (0, 3) for i in range(16)] == \
        [jfaults._u(s, "x", i) for s in (0, 3) for i in range(16)]


def test_fault_plan_is_deterministic_and_path_stable():
    def sched(p, table):
        return [(p.transient(table, rg, 0), p.corrupt(table, rg, "c", 0), p.spike(table, rg, 0))
                for rg in range(64)]

    for F in (jfaults, tfaults):
        p = F.FaultPlan(seed=7, transient_rate=0.3, corrupt_rate=0.2, spike_rate=0.5,
                        spike_s=1e-3)
        a = sched(p, "/a/lineitem.lake")
        assert a == sched(p, "/elsewhere/lineitem.lake")
        assert any(t for t, _, _ in a) and not all(t for t, _, _ in a)
        assert a != sched(dataclasses.replace(p, seed=8), "/a/lineitem.lake")
        p = F.FaultPlan(seed=1, transient_rate=0.5)
        rows = [rg for rg in range(200) if p.transient("t", rg, 0)]
        assert any(not p.transient("t", rg, 1) for rg in rows)  # per-attempt by default
        forever = dataclasses.replace(p, fail_forever=True)
        hit = [rg for rg in range(200) if forever.transient("t", rg, 0)]
        assert all(forever.transient("t", rg, a) for rg in hit for a in range(6))


def test_retry_policy_backoff_is_exponential():
    for F in (jfaults, tfaults):
        pol = F.RetryPolicy(backoff_base_s=1e-4, backoff_mult=2.0)
        assert pol.backoff(0) == 0.0
        assert pol.backoff(1) == pytest.approx(1e-4)
        assert pol.backoff(3) == pytest.approx(4e-4)
    assert tfaults.RetryPolicy() == tfaults.RetryPolicy(**dataclasses.asdict(jfaults.RetryPolicy()))


@pytest.mark.parametrize("column", ["l_quantity", "l_extendedprice", "l_shipmode", "l_shipdate"])
def test_page_damage_matches_the_reference(tables, column):
    """The same byte flip and truncation of a page copy, caught by the same
    checksum; the reader's own buffers are never touched."""
    jcol = J.Reader(tables["lineitem"]).read_encoded(0, [column])[column]
    tcol = T.Reader(tables["lineitem"]).read_encoded(0, [column])[column]
    before = {k: v.copy() for k, v in tcol.buffers.items()}
    for damage in ("_flip_byte", "_truncate"):
        jd, td = getattr(jfaults, damage)(jcol), getattr(tfaults, damage)(tcol)
        assert sorted(td.buffers) == sorted(jd.buffers)
        for k in jd.buffers:
            assert td.buffers[k].dtype == jd.buffers[k].dtype
            np.testing.assert_array_equal(td.buffers[k], jd.buffers[k])
        ck = tintegrity.page_checksum(tcol)
        assert ck == jintegrity.page_checksum(jcol)
        assert not tintegrity.verify_page(td, ck)
        assert tintegrity.page_checksum(td) == jintegrity.page_checksum(jd)
        assert tintegrity.verify_page(td, None)  # legacy footer: unverified, not failed
    for k, v in tcol.buffers.items():
        np.testing.assert_array_equal(v, before[k])


# ---------------------------------------------------------------------------
# page integrity through the pod
# ---------------------------------------------------------------------------

def test_writer_stamps_checksums_and_reader_exposes_them(tables):
    for S in (J, T):
        r = S.Reader(tables["lineitem"])
        for name in the_plan(S.P).columns:
            ck = r.page_checksum_meta(0, name)
            assert isinstance(ck, int) and 0 <= ck <= 0xFFFFFFFF
            col = r.read_encoded(0, [name])[name]
            assert S.integrity.page_checksum(col) == ck and S.integrity.verify_page(col, ck)
        assert r.page_checksum_meta(0, "no_such_column") is None


def test_legacy_footer_without_checksums_still_scans(tables):
    def run(S):
        r = S.Reader(tables["lineitem"])
        for rg in r.footer["row_groups"]:
            for cmeta in rg["columns"].values():
                cmeta.pop("checksum", None)
        assert r.page_checksum_meta(0, "l_quantity") is None
        same_rows(S.engine().scan(r, the_plan(S.P)), _direct(S, tables["lineitem"]))
        svc = _service(S, fault_plan=S.dp.FaultPlan())  # injector on, nothing to verify
        t = svc.submit("t0", r, the_plan(S.P))
        same_rows(svc.result(t), _direct(S, tables["lineitem"]))
        assert svc.telemetry.counters["unverified_pages"] > 0
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_engine_detects_doctored_checksum_and_quarantines(tables):
    """Without an injector the engine's own verify path raises a typed
    CorruptPageError onto the ticket and quarantines the page."""
    def run(S):
        r = S.Reader(tables["lineitem"])
        r.footer["row_groups"][0]["columns"]["l_quantity"]["checksum"] ^= 0x1
        svc = _service(S)
        t = svc.submit("t0", r, the_plan(S.P))
        with pytest.raises(S.integrity.CorruptPageError):
            svc.result(t)
        assert svc.store.stats()["quarantines"] >= 1
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_blockstore_quarantine_and_absolving_put():
    def run(S):
        st = S.dp.BlockStore(1 << 20)
        page = np.zeros(16) if S is J else torch.zeros(16, dtype=torch.float64)
        key = ("page", "t", 0, "c")
        st.put(key, page, tier="encoded")
        st.quarantine(key)
        assert key not in st and st.get(key, tier="encoded") is None
        s = st.stats()
        assert s["quarantines"] == 1 and s["quarantined_live"] == 1
        st.put(key, page, tier="encoded")  # a fresh put IS the verified re-fetch
        assert st.stats()["quarantined_live"] == 0
        assert st.get(key, tier="encoded") is not None
        return s, st.stats()

    assert twin(run)[1] == twin(run)[0]


# ---------------------------------------------------------------------------
# the injector: recoverable faults recover; terminal ones end typed
# ---------------------------------------------------------------------------

def test_recoverable_faults_scan_bit_identical(tables):
    def run(S):
        svc, tickets = _scan_through(
            S, tables, fault_plan=S.dp.FaultPlan(seed=3, transient_rate=0.15, corrupt_rate=0.08,
                                                 short_read_rate=0.05, spike_rate=0.3,
                                                 spike_s=1e-3),
            retry_policy=S.dp.RetryPolicy(max_attempts=10))
        f = svc.telemetry.snapshot()["faults"]
        assert f["transient_errors"] > 0
        assert f["corrupt_detected"] == f["corrupt_injected"] + f["short_reads"]
        assert f["quarantined_pages"] == f["corrupt_detected"]
        assert f["retry_successes"] > 0 and f["retries_exhausted"] == 0
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_corrupt_page_refetched_never_decoded(tables):
    def run(S):
        svc, tickets = _scan_through(S, tables,
                                     fault_plan=S.dp.FaultPlan(seed=11, corrupt_rate=0.3),
                                     retry_policy=S.dp.RetryPolicy(max_attempts=10))
        f = svc.telemetry.snapshot()["faults"]
        assert f["corrupt_injected"] > 0
        assert f["corrupt_detected"] == f["corrupt_injected"]
        assert svc.store.stats()["quarantines"] == f["quarantined_pages"]
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


@pytest.mark.parametrize("kind", ["transient", "corrupt"])
def test_exhausted_retries_raise_typed(tables, kind):
    """Retries exhausted: FetchFailed for transient errors, Quarantined
    (and a quarantined page) for corruption."""
    def run(S):
        rate = {"transient_rate": 1.0} if kind == "transient" else {"corrupt_rate": 1.0}
        svc = _service(S, fault_plan=S.dp.FaultPlan(seed=0, fail_forever=True, **rate),
                       retry_policy=S.dp.RetryPolicy(max_attempts=3))
        t = svc.submit("t0", S.Reader(tables["lineitem"]), the_plan(S.P))
        with pytest.raises(S.dp.FetchFailed if kind == "transient" else S.dp.Quarantined):
            svc.result(t)
        if kind == "transient":
            assert svc.telemetry.counters["fetch_retries_exhausted"] >= 1
        else:
            assert svc.store.stats()["quarantines"] >= 1
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)
    assert str(tt[0].error).replace(tables["lineitem"], "") == \
        str(jt[0].error).replace(tables["lineitem"], "")


def test_timeout_retries_and_bills_the_full_wait(tables):
    def run(S):
        svc, tickets = _scan_through(
            S, tables, fault_plan=S.dp.FaultPlan(seed=5, spike_rate=0.4, spike_s=10.0),
            retry_policy=S.dp.RetryPolicy(max_attempts=6, timeout_s=1.0))
        f = svc.telemetry.snapshot()["faults"]
        assert f["fetch_timeouts"] > 0
        assert f["fault_seconds"]["timeout"] == pytest.approx(f["fetch_timeouts"] * 1.0)
        assert f["tenant_fault_seconds"]["t0"] >= f["fault_seconds"]["timeout"]
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_hedged_read_caps_the_straggler_tail(tables):
    def run(S):
        svc, tickets = _scan_through(S, tables,
                                     fault_plan=S.dp.FaultPlan(seed=9, spike_rate=1.0, spike_s=0.5),
                                     retry_policy=S.dp.RetryPolicy(hedge_after_s=1e-3))
        f = svc.telemetry.snapshot()["faults"]
        assert f["hedged_fetches"] > 0 and f["hedge_wins"] > 0
        assert f["fault_seconds"]["hedge_saved"] > 0
        assert f["tenant_fault_seconds"]["t0"] <= f["hedged_fetches"] * (1e-3 + 1e-9)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_straggler_pod_term_applies_to_every_fetch(tables):
    def run(S):
        plan = S.dp.FaultPlan(straggler_pods={"pod0": 2e-3})
        assert plan.straggle("pod0") == 2e-3 and plan.straggle("pod1") == 0.0
        svc, tickets = _scan_through(S, tables, fault_plan=plan)
        assert svc.telemetry.snapshot()["faults"]["tenant_fault_seconds"]["t0"] > 0
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_fault_seconds_reconciled_into_wfq_vtime(tables):
    """sched + recon == actual per tenant, fault waits included."""
    def run(S):
        svc = _service(S, fault_plan=S.dp.FaultPlan(seed=3, transient_rate=0.3, spike_rate=0.5,
                                                    spike_s=2e-3),
                       retry_policy=S.dp.RetryPolicy(max_attempts=6))
        tickets = []
        for t in ("a", "b"):
            tickets.append(svc.submit(t, S.Reader(tables["lineitem"]), the_plan(S.P)))
            same_rows(svc.result(tickets[-1]), _direct(S, tables["lineitem"]))
        snap = svc.telemetry.snapshot()
        assert snap["counters"]["fault_wait_seconds"] > 0
        check_honesty(svc.telemetry)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


# ---------------------------------------------------------------------------
# the circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    def run(F):
        br = F.CircuitBreaker(fail_threshold=3, cooldown_ticks=5)
        t = "table.lake"
        log = [br.state(t), br.record_failure(t, 0), br.record_failure(t, 0),
               br.record_failure(t, 0), br.state(t), br.any_open(), br.admit(t, 1),
               br.admit(t, 9), br.state(t), br.record_failure(t, 9), br.state(t),
               br.admit(t, 20)]
        br.record_success(t, 20)
        log += [br.state(t), br.any_open(), br.trips, br.probes]
        br.record_failure(t, 21)
        br.record_success(t, 21)
        log += [br.record_failure(t, 22), br.state(t), br.report()]
        return log

    want = run(jfaults)
    assert want[:16] == ["closed", False, False, True, "open", True, "degraded", "probe",
                         "half-open", True, "open", "probe", "closed", False, 2, 2]
    assert run(tfaults) == want


def test_breaker_sheds_with_typed_overloaded_when_queue_near_full(tables):
    def run(S):
        r = S.Reader(tables["lineitem"])
        svc = _service(S, fault_plan=S.dp.FaultPlan(transient_rate=1.0, fail_forever=True),
                       retry_policy=S.dp.RetryPolicy(max_attempts=5), max_queue_depth=4)
        tickets = [svc.submit("t0", r, the_plan(S.P))]
        with pytest.raises(S.dp.FetchFailed):
            svc.result(tickets[0])  # trips the breaker
        assert svc.breaker_open()
        tickets += [svc.submit("t0", r, the_plan(S.P)) for _ in range(3)]  # queue at 3/4
        with pytest.raises(S.dp.Overloaded):
            svc.submit("t0", r, the_plan(S.P))
        assert svc.telemetry.counters["rejected_overloaded"] == 1
        assert svc.telemetry.snapshot()["faults"]["breaker_trips"] >= 1
        svc.drain()
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)
    assert tsvc.breaker.report() == jsvc.breaker.report()


def test_breaker_degrades_to_raw_then_probes_closed(tables):
    def run(S):
        r = S.Reader(tables["lineitem"])
        svc = _service(S, fault_plan=S.dp.FaultPlan(transient_rate=1.0, fail_forever=True),
                       retry_policy=S.dp.RetryPolicy(max_attempts=5))
        tickets = [svc.submit("t0", r, the_plan(S.P))]
        with pytest.raises(S.dp.FetchFailed):
            svc.result(tickets[0])
        assert svc.breaker_open()
        svc.install_faults(S.dp.FaultPlan())  # storage recovers; the breaker remembers
        tickets.append(svc.submit("t0", r, the_plan(S.P)))
        same_rows(svc.result(tickets[-1]), _direct(S, tables["lineitem"]))
        c = svc.telemetry.counters
        assert c["breaker_degraded_admits"] >= 1 and c["breaker_degraded_dispatches"] >= 1
        for _ in range(S.dp.CircuitBreaker().cooldown_ticks + 1):
            svc.tick()
        tickets.append(svc.submit("t0", r, the_plan(S.P)))
        same_rows(svc.result(tickets[-1]), _direct(S, tables["lineitem"]))
        assert c["breaker_probes"] >= 1
        assert not svc.breaker_open()
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


# ---------------------------------------------------------------------------
# peer fetch against a dead sibling; link provenance
# ---------------------------------------------------------------------------

def test_peer_fetch_dead_sibling_falls_back_to_storage():
    def run(S):
        local, remote = S.dp.BlockStore(1 << 20), S.dp.BlockStore(1 << 20)
        key = ("page", "t.lake", 0, "c")
        remote.put(key, np.zeros(64) if S is J else torch.zeros(64, dtype=torch.float64),
                   tier="encoded")
        pf = S.dp.PeerFetcher("pod0", lambda: [("pod1", remote)])
        assert pf.fetch(key, into=local) is not None  # a healthy sibling serves
        remote.dead = True
        with pytest.raises(ConnectionError):
            remote.peek(key)
        local2 = S.dp.BlockStore(1 << 20)
        assert pf.fetch(key, into=local2) is None  # a dead sibling is a miss
        assert local2.peer_errors == 1

        def exploding_peers():
            raise ConnectionError("membership view lost")

        local3 = S.dp.BlockStore(1 << 20)
        assert S.dp.PeerFetcher("pod0", exploding_peers).fetch(key, into=local3) is None
        assert local3.peer_errors == 1
        return local.stats(), local2.stats(), local3.stats()

    assert twin(run)[1] == twin(run)[0]


def test_nominal_link_surfaces_in_snapshot(tables):
    def run(S):
        svc = _service(S)
        snap = svc.telemetry.snapshot()
        assert snap["costmodel"]["nominal_link"] is True
        assert snap["costmodel"]["link_source"] == "nominal"
        assert "nominal_link" in snap["warnings"]
        assert svc.telemetry.counters["warnings"] == 1  # once, not per lookup
        svc.telemetry.note_costmodel(svc.cost_model)
        assert svc.telemetry.counters["warnings"] == 1
        return svc, []

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_calibrated_link_source_round_trips(tmp_path):
    def run(S):
        cm = S.dp.CostModel(link_source="calibrated")
        p = str(tmp_path / f"cal_{S.name}.json")
        cm.save(p)
        back = S.dp.CostModel.load(p, backend=cm.backend)
        assert back.link_source == "calibrated"
        t = S.dp.Telemetry()
        t.note_costmodel(back)
        snap = t.snapshot()
        assert snap["costmodel"]["nominal_link"] is False
        assert "nominal_link" not in snap["warnings"]
        return {k: v for k, v in snap["costmodel"].items() if k != "backend"}

    assert twin(run)[1] == twin(run)[0]


# ---------------------------------------------------------------------------
# tests/test_chaos_props.py: the single-pod chaos grid
# ---------------------------------------------------------------------------

def plans(P):
    return [
        P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"],
                   P.Cmp("l_quantity", "le", 25)),  # unprunable
        P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                   P.Cmp("l_shipdate", "between", (365, 729))),  # zone-map pruned
        P.ScanPlan("lineitem", ["l_quantity"], P.Cmp("l_quantity", "le", 3), compact=True),
        P.ScanPlan("part", ["p_partkey", "p_size"], P.Cmp("p_size", "le", 10)),
    ]


def recoverable(F):
    """Every fault kind, at rates bounded retries always clear."""
    return F.FaultPlan(seed=0, transient_rate=0.12, corrupt_rate=0.06, short_read_rate=0.04,
                       spike_rate=0.25, spike_s=1e-3)


def policy(F):
    return F.RetryPolicy(max_attempts=10, timeout_s=0.5, hedge_after_s=5e-4)


def bounded_drain(svc):
    """Tick a pod or a fleet until idle, with a hang guard."""
    for _ in range(MAX_TICKS):
        svc.tick()
        if not (svc.active if hasattr(svc, "active") else svc.queue):
            return
    pytest.fail(f"no progress after {MAX_TICKS} ticks — hang")


def check_honesty(telemetry, requests=()):
    """sched + recon == actual per tenant.  A slice that fails is never
    reconciled (the reference's semantics): its charge stays on its request
    (`ScanRequest.charged_s`), so `requests` (every request admitted) adds
    those charges to the actual side."""
    for t, row in telemetry.snapshot()["cost"].items():
        unreconciled = sum(r.charged_s for r in requests if r.tenant == t)
        assert row["est_s"] + row["recon_s"] == pytest.approx(row["actual_s"] + unreconciled,
                                                              abs=1e-9), (t, row)


def chaos_pod(S, tables, scheduler, batch, fault_plan, retry_policy, **kw):
    R = {k: S.Reader(p) for k, p in tables.items()}
    svc = _service(S, scheduler=scheduler, batch_decode=batch, fault_plan=fault_plan,
                   retry_policy=retry_policy, **kw)
    tickets = [svc.submit(f"t{i}", R[p.table], p) for i, p in enumerate(plans(S.P))]
    bounded_drain(svc)
    return svc, tickets


@pytest.mark.parametrize("scheduler", ["wfq", "fifo"])
@pytest.mark.parametrize("batch", [True, False])
def test_pod_chaos_bit_identical(tables, scheduler, batch):
    def run(S):
        F = S.faults
        svc, tickets = chaos_pod(S, tables, scheduler, batch, recoverable(F), policy(F))
        eng = S.engine()
        for t, p in zip(tickets, plans(S.P)):
            same_rows(svc.result(t), eng.scan(S.Reader(tables[p.table]), p))
        f = svc.telemetry.snapshot()["faults"]
        assert f["retries_exhausted"] == 0
        assert f["corrupt_detected"] == f["corrupt_injected"] + f["short_reads"]
        check_honesty(svc.telemetry)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


@pytest.mark.parametrize("kind", ["transient", "corrupt"])
def test_fail_forever_terminates_typed_never_hangs(tables, kind):
    def run(S):
        rates = {"transient_rate": 1.0} if kind == "transient" else {"corrupt_rate": 1.0}
        svc, tickets = chaos_pod(S, tables, "wfq", True, S.dp.FaultPlan(fail_forever=True, **rates),
                                 S.dp.RetryPolicy(max_attempts=3))
        for t in tickets:
            assert t.status == "error"  # terminal, never dropped
            with pytest.raises((S.dp.StorageFault, S.integrity.CorruptPageError)):
                svc.result(t)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_every_rejection_is_typed(tables):
    def run(S):
        r = S.Reader(tables["lineitem"])
        svc = _service(S, max_queue_depth=4,
                       fault_plan=S.dp.FaultPlan(transient_rate=1.0, fail_forever=True),
                       retry_policy=S.dp.RetryPolicy(max_attempts=5))
        submitted, rejected = [], []
        for i in range(16):
            try:
                submitted.append(svc.submit("t0", r, plans(S.P)[0]))
            except (S.dp.QueueFull, S.dp.QuotaExceeded, S.dp.Overloaded) as e:
                rejected.append(type(e).__name__)
            if i % 4 == 3:
                svc.tick()
        bounded_drain(svc)
        assert rejected and svc.telemetry.counters["rejected_overloaded"] >= 1
        for t in submitted:
            assert t.status in ("done", "error")
            if t.status == "error":
                assert isinstance(t.error, (S.dp.StorageFault, S.integrity.CorruptPageError))
        return svc, submitted, rejected

    (jsvc, jt, jrej), (tsvc, tt, trej) = twin(run)
    assert trej == jrej
    same_pods(tsvc, jsvc, tt, jt, traces=True)


def test_one_failing_table_fails_typed_and_the_others_complete(tables):
    """A fail_forever plan that hits one table: that table's requests end
    with a typed StorageFault, the others complete bit-identical."""
    def run(S):
        R = {k: S.Reader(p) for k, p in tables.items()}
        svc = _service(S, retry_policy=S.dp.RetryPolicy(max_attempts=3))
        svc.install_faults(FailOneTable(S.faults, "part.lake"))
        tickets = [svc.submit(f"t{i}", R[p.table], p) for i, p in enumerate(plans(S.P))]
        requests = list(svc.queue)
        bounded_drain(svc)
        eng = S.engine()
        for t, p in zip(tickets, plans(S.P)):
            if p.table == "part":
                assert t.status == "error" and isinstance(t.error, S.dp.StorageFault)
            else:
                same_rows(t.result, eng.scan(R[p.table], p))
        check_honesty(svc.telemetry, requests)
        assert any(r.charged_s > 0 for r in requests if r.ticket.status == "error")
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt, traces=True)


# ---------------------------------------------------------------------------
# the fabric: the pod-count grid under the recoverable mix, a straggler pod,
# and one poisoned pod
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pods", [1, 2, 4])
@pytest.mark.parametrize("scheduler,batch", [("wfq", True), ("fifo", False)])
def test_fabric_chaos_bit_identical(tables, n_pods, scheduler, batch):
    def run(S):
        F = S.faults
        plan = recoverable(F)
        if n_pods > 1:  # one whole-pod straggler exercises the hedge path
            plan = dataclasses.replace(plan, straggler_pods={"pod1": 2e-3})
        R = {k: S.Reader(p) for k, p in tables.items()}
        fab = fabric(S, n_pods=n_pods, scheduler=scheduler, batch_decode=batch,
                     tick_bytes=TICK_BYTES, fault_plan=plan, retry_policy=policy(F))
        tickets = [fab.submit(f"t{i}", R[p.table], p) for i, p in enumerate(plans(S.P))]
        bounded_drain(fab)
        eng = S.engine()
        for t, p in zip(tickets, plans(S.P)):
            assert t.status == "done", (p, t.status, t.error)
            same_rows(t.result, eng.scan(R[p.table], p))
        for pid in fab.live_pods:
            assert fab.pods[pid].telemetry.snapshot()["faults"]["retries_exhausted"] == 0
            check_honesty(fab.pods[pid].telemetry)
        return fab, tickets

    (jfab, jt), (tfab, tt) = twin(run)
    same_fabrics(tfab, jfab, tt, jt, tables)


def test_fabric_one_poisoned_pod_survivors_complete(tables):
    """Fault schedules confined to one pod: the breaker-drain path removes
    it and every scan still completes bit-identically."""
    def run(S):
        R = {k: S.Reader(p) for k, p in tables.items()}
        fab = fabric(S, n_pods=3, tick_bytes=TICK_BYTES)
        tickets = [fab.submit(f"t{i}", R[p.table], p) for i, p in enumerate(plans(S.P))]
        fab.inject_faults("pod2", S.dp.FaultPlan(transient_rate=1.0, fail_forever=True),
                          S.dp.RetryPolicy(max_attempts=5))
        bounded_drain(fab)
        eng = S.engine()
        for t, p in zip(tickets, plans(S.P)):
            assert t.status == "done", (p, t.error)
            same_rows(t.result, eng.scan(R[p.table], p))
        assert "pod2" not in fab.live_pods
        assert fab.report()["breaker_drains"] >= 1
        return fab, tickets

    (jfab, jt), (tfab, tt) = twin(run)
    same_fabrics(tfab, jfab, tt, jt, tables)


def FailOneTable(F, table):
    """A fail_forever transient plan confined to one table (by basename)."""
    class Plan(F.FaultPlan):
        def transient(self, t, rg, attempt):
            return self._table(t) == table

    return Plan(fail_forever=True)


# ---------------------------------------------------------------------------
# hypothesis sweep: random seeds and rates on one pod or a fleet of two
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @settings(deadline=None, max_examples=15)
    @given(seed=st.integers(0, 2 ** 16), transient=st.floats(0.0, 0.2),
           corrupt=st.floats(0.0, 0.1), spike=st.floats(0.0, 0.5),
           n_pods=st.sampled_from([1, 2]), scheduler=st.sampled_from(["wfq", "fifo"]),
           batch=st.booleans(), idx=st.integers(0, 3))
    def _hyp_chaos(tables, seed, transient, corrupt, spike, n_pods, scheduler, batch, idx):
        def run(S):
            p = plans(S.P)[idx]
            r = S.Reader(tables[p.table])
            kw = dict(scheduler=scheduler, batch_decode=batch,
                      fault_plan=S.dp.FaultPlan(seed=seed, transient_rate=transient,
                                                corrupt_rate=corrupt, spike_rate=spike,
                                                spike_s=1e-3),
                      retry_policy=S.dp.RetryPolicy(max_attempts=12, hedge_after_s=1e-3))
            # one pod is the reference's one-pod fleet; two pods a fleet
            svc = _service(S, **kw) if n_pods == 1 else fabric(
                S, n_pods=n_pods, tick_bytes=TICK_BYTES, **kw)
            t = svc.submit("t0", r, p)
            bounded_drain(svc)
            assert t.status == "done", t.error
            same_rows(t.result, S.engine().scan(r, p))
            for pod in (svc.pods[pid] for pid in svc.live_pods) if n_pods > 1 else (svc,):
                check_honesty(pod.telemetry)
            return svc, [t]

        (jsvc, jt), (tsvc, tt) = twin(run)
        if n_pods == 1:
            same_pods(tsvc, jsvc, tt, jt, traces=True)
        else:
            same_fabrics(tsvc, jsvc, tt, jt, tables)

    def test_chaos_hypothesis_sweep(tables):
        _hyp_chaos(tables)

else:

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_chaos_hypothesis_sweep():
        pass
