"""The port's tick scheduler (`repro_torch.datapath.scheduler`) on the CPU
against the JAX scheduler: tests/test_scheduler.py's cases (WFQ weight-share
invariants, elephant-vs-mice starvation bounds, split-scan bit-identity,
cross-tick coalescing holds, the fetch simulation's reader identity and
sizing, reconciliation of honest, lying and cache-hit slices), each run on
both packages with the same submissions: the reference's assertions hold on
the port, and the two pods agree on results, ScanStats, done ticks,
deterministic telemetry and virtual time (test_torch_service.py's harness).
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import copy

import pytest

from repro.core import tpch as jtpch
from repro.lakeformat.encodings import padded_rows
from tests.test_torch_service import (  # noqa: F401 (trace_hooks: autouse)
    J, T, same_pods, same_rows, service, trace_hooks, twin)

RG_ROWS = 8192  # row-group size: sorted l_shipdate => narrow scans hit 1-2 groups
RG_COST = RG_ROWS * 4 * 2  # decoded bytes per row group for a 2-column scan


@pytest.fixture(scope="module")
def lineitem_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_sched")
    return jtpch.write_tables(str(d), sf=0.1, seed=0, sorted_data=True,
                              row_group_size=RG_ROWS)["lineitem"]


def _service(S, **kw):
    kw.setdefault("policy", S.dp.StaticPolicy("raw"))
    return service(S, **kw)


def elephant(P, cols=("l_extendedprice", "l_quantity")):
    """Whole-table scan: every row group, no pruning."""
    return P.ScanPlan("lineitem", list(cols))


def mouse(P, day, width=200):
    """Narrow window on the sort column: 1-2 row groups after pruning."""
    return P.ScanPlan("lineitem", ["l_extendedprice"],
                      P.Cmp("l_shipdate", "between", (day, day + width)))


def _padded_bytes(reader, n_cols=2) -> int:
    return sum(padded_rows(reader.row_group_meta(rg)["n"]) * 4 * n_cols
               for rg in range(reader.n_row_groups))


# ---------------------------------------------------------------------------
# WFQ invariants
# ---------------------------------------------------------------------------

def test_wfq_equal_weights_share_bound(lineitem_path):
    """While two equal-weight tenants are both backlogged their charged
    decode-seconds never diverge by more than one row group's cost; totals
    equal the honest padded estimates."""
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, tick_bytes=int(RG_COST * 1.5))
        tickets = [svc.submit("a", r, elephant(S.P, ("l_extendedprice", "l_quantity"))),
                   svc.submit("b", r, elephant(S.P, ("l_discount", "l_tax")))]
        reqs = {q.tenant: q for q in svc.queue}
        tol = max(max(reqs["a"].rg_costs), max(reqs["b"].rg_costs))
        est_s = {t: sum(q.rg_costs) for t, q in reqs.items()}
        shares = []
        while svc.queue:
            svc.tick()
            still = {t: any(q.tenant == t and q.cursor < len(q.row_groups) for q in svc.queue)
                     for t in ("a", "b")}
            if still["a"] and still["b"]:
                sched = svc.telemetry.tenant_sched_seconds
                assert abs(sched["a"] - sched["b"]) <= tol + 1e-12, sched
                shares.append(dict(sched))
        for t in ("a", "b"):
            assert svc.telemetry.tenant_sched_seconds[t] == pytest.approx(est_s[t])
            assert svc.telemetry.tenant_sched_bytes[t] == _padded_bytes(r)
            assert abs(svc.telemetry.tenant_recon_seconds.get(t, 0.0)) < 1e-9
        return svc, tickets, shares

    (jsvc, jt, jsh), (tsvc, tt, tsh) = twin(run)
    assert tsh == jsh  # the same charges after every tick
    same_pods(tsvc, jsvc, tt, jt)


def test_wfq_weighted_share_bound(lineitem_path):
    """A weight-2 tenant gets twice the decode-seconds of a weight-1 one,
    within one row group's cost, while both are backlogged."""
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, tick_bytes=int(RG_COST * 1.5),
                       quotas={"heavy": S.dp.TenantQuota(weight=2.0),
                               "light": S.dp.TenantQuota(weight=1.0)})
        tickets = [svc.submit("heavy", r, elephant(S.P, ("l_extendedprice", "l_quantity"))),
                   svc.submit("light", r, elephant(S.P, ("l_discount", "l_tax")))]
        tol = max(max(q.rg_costs) for q in svc.queue)
        checked = 0
        while svc.queue:
            svc.tick()
            still = {t: any(q.tenant == t and q.cursor < len(q.row_groups) for q in svc.queue)
                     for t in ("heavy", "light")}
            if still["heavy"] and still["light"]:
                sched = svc.telemetry.tenant_sched_seconds
                assert abs(sched["heavy"] / 2.0 - sched["light"]) <= tol + 1e-12, sched
                checked += 1
        assert checked > 0
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


@pytest.mark.parametrize("scheduler,with_elephant", [("wfq", False), ("wfq", True),
                                                     ("fifo", True)],
                         ids=["solo", "wfq", "fifo"])
def test_skewed_runs_match_reference(lineitem_path, scheduler, with_elephant):
    """service_bench's skewed workload (one elephant, three mice) on each
    scheduler: the same done ticks and charges as the reference's."""
    (jsvc, jt), (tsvc, tt) = twin(_skewed, lineitem_path, scheduler, with_elephant)
    same_pods(tsvc, jsvc, tt, jt)


def _skewed(S, path, scheduler, with_elephant):
    r = S.Reader(path)
    svc = _service(S, scheduler=scheduler, tick_bytes=int(RG_COST * 1.5))
    tickets = [svc.submit("elephant", r, elephant(S.P))] if with_elephant else []
    tickets += [svc.submit(f"mouse{i}", r, mouse(S.P, d)) for i, d in enumerate((300, 900, 1500))]
    svc.drain()
    return svc, tickets


def test_wfq_mice_not_starved_by_elephant(lineitem_path):
    """With a pinned elephant, mice p99 ticks under WFQ stay within 2x their
    solo value; FIFO, head-of-line, is strictly worse."""
    def p99(S, scheduler, with_elephant):
        _, tickets = _skewed(S, lineitem_path, scheduler, with_elephant)
        return max(t.done_tick - t.submitted_tick for t in tickets if t.tenant != "elephant")

    for S in (J, T):
        solo, wfq, fifo = (p99(S, "wfq", False), p99(S, "wfq", True), p99(S, "fifo", True))
        assert wfq <= 2 * solo, (S.name, solo, wfq, fifo)
        assert fifo > wfq, (S.name, solo, wfq, fifo)


def test_split_elephant_completes(lineitem_path):
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, tick_bytes=RG_COST)
        tickets = [svc.submit("elephant", r, elephant(S.P))]
        tickets += [svc.submit("mouse", r, mouse(S.P, 600)) for _ in range(3)]
        svc.drain()
        assert tickets[0].status == "done"
        assert svc.telemetry.counters["split_scans"] >= 1
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


# ---------------------------------------------------------------------------
# split-scan bit-identity
# ---------------------------------------------------------------------------

def split_plans(P):
    return [
        P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"]),  # full scan
        P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                   P.Cmp("l_shipdate", "between", (365, 1460))),  # fused fast path
        P.ScanPlan("lineitem", ["l_quantity"], P.Cmp("l_quantity", "le", 3),
                   compact=True),  # compaction crosses slice boundaries
    ]


@pytest.mark.parametrize("batch_decode", [True, False], ids=["batched", "sequential"])
@pytest.mark.parametrize("idx", range(3))
def test_split_scan_bit_identical_to_direct(lineitem_path, idx, batch_decode):
    """A scan sliced across many ticks equals the single-shot engine scan
    bit for bit, on either dispatch path."""
    def run(S):
        r = S.Reader(lineitem_path)
        plan = split_plans(S.P)[idx]
        direct = S.engine().scan(r, plan)
        svc = _service(S, tick_bytes=RG_ROWS * 4, batch_decode=batch_decode)
        t = svc.submit("t", r, plan)
        svc.drain()
        assert svc.telemetry.counters.get("split_scans", 0) >= 1  # really sliced
        same_rows(t.result, direct)
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_resumable_scan_matches_single_shot(lineitem_path):
    """Advancing one row group at a time assembles the same result as
    scan(), and pending() shrinks in dispatch order."""
    def run(S):
        r = S.Reader(lineitem_path)
        plan = S.P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"],
                            S.P.Cmp("l_quantity", "lt", 25))
        rs = S.engine_mod.ResumableScan(S.engine(), r, plan)
        seen = []
        while rs.result is None:
            seen.append(rs.pending[0])
            rs.advance([seen[-1]])
        assert seen == sorted(seen)
        same_rows(rs.result, S.engine().scan(r, plan))
        # out-of-order slices are refused: the reference asserts, the port
        # raises ValueError (test_torch_engine.py::test_sliced_scan_equals_one_shot)
        fresh = S.engine_mod.ResumableScan(S.engine(), r, elephant(S.P))
        with pytest.raises(AssertionError if S is J else ValueError):
            fresh.advance([fresh.pending[-1]])
        return rs.result

    jres, tres = twin(run)
    same_rows(tres, jres)


# ---------------------------------------------------------------------------
# cross-tick coalescing window
# ---------------------------------------------------------------------------

def plan_ab(P):
    return (P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                       P.Cmp("l_shipdate", "between", (300, 700))),
            P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                       P.Cmp("l_shipdate", "between", (350, 750))))


@pytest.mark.parametrize("hold", [0, 2])
def test_hold_window_coalesces_across_ticks(lineitem_path, hold):
    """Compatible requests arriving a tick apart share decodes when a hold
    window is open, and decode independently when it is not."""
    def run(S):
        r = S.Reader(lineitem_path)
        plan_a, plan_b = plan_ab(S.P)
        svc = _service(S, hold_ticks=hold)
        a = svc.submit("t0", r, plan_a)
        svc.tick()  # without a hold, t0 decodes alone here
        b = svc.submit("t1", r, plan_b)
        svc.drain()
        c = svc.telemetry.counters
        if hold:
            assert c["decoded_bytes_saved"] > 0
            assert a.done_tick == b.done_tick  # released into the partner's tick
            assert c["hold_released"] >= 1 and c["held_ticks"] == 1
        else:
            assert c.get("decoded_bytes_saved", 0) == 0
        same_rows(a.result, S.engine().scan(r, plan_a))
        same_rows(b.result, S.engine().scan(r, plan_b))
        return svc, [a, b]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_hold_window_deadline_always_dispatches(lineitem_path):
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, hold_ticks=3)
        t = svc.submit("t0", r, plan_ab(S.P)[0])
        for expected_held in (1, 2, 3):
            svc.tick()
            assert t.status == "queued"
            assert svc.telemetry.counters["held_ticks"] == expected_held
        svc.tick()  # deadline: dispatches regardless of partners
        assert t.status == "done" and t.done_tick == 4
        assert svc.telemetry.counters["hold_deadline_dispatch"] == 1
        assert svc.telemetry.counters["held_requests"] == 1
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_hold_window_result_api_still_blocks_correctly(lineitem_path):
    def run(S):
        svc = _service(S, hold_ticks=5)
        t = svc.submit("t0", S.Reader(lineitem_path), plan_ab(S.P)[0])
        assert int(svc.result(t).count) > 0
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_zero_tick_budget_still_progresses(lineitem_path):
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, tick_bytes=0)
        t = svc.submit("t", r, mouse(S.P, 600))
        ticks = 0
        while svc.queue:
            svc.tick()
            ticks += 1
            assert ticks <= 4 * r.n_row_groups, "no per-tick progress"
        assert t.status == "done"
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_fully_pruned_request_is_not_held(lineitem_path):
    def run(S):
        impossible = S.P.ScanPlan("lineitem", ["l_extendedprice"],
                                  S.P.Cmp("l_shipdate", "between", (-20, -10)))
        svc = _service(S, hold_ticks=3)
        t = svc.submit("t0", S.Reader(lineitem_path), impossible)
        svc.tick()
        assert t.status == "done" and t.done_tick == 1
        assert int(t.result.count) == 0
        assert svc.telemetry.counters.get("held_requests", 0) == 0
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_incompatible_requests_are_not_held(lineitem_path):
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, hold_ticks=2)
        tickets = [svc.submit("t0", r, mouse(S.P, 200)), svc.submit("t1", r, mouse(S.P, 2200))]
        svc.tick()
        assert svc.telemetry.counters["held_requests"] == 2
        svc.drain()
        assert svc.telemetry.counters.get("hold_released", 0) == 0
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_pulled_in_partner_cannot_bypass_tick_budget(lineitem_path):
    """A fresh elephant compatible with a held mouse is not dumped whole
    into one tick by the coalescing sweep."""
    def run(S):
        r = S.Reader(lineitem_path)
        svc = _service(S, hold_ticks=2, tick_bytes=RG_COST)
        m = svc.submit("m", r, mouse(S.P, 600))
        svc.tick()  # mouse held, waiting for a partner
        el = svc.submit("e", r, elephant(S.P))
        svc.drain()
        assert m.status == "done" and el.status == "done"
        assert el.done_tick - el.submitted_tick >= r.n_row_groups // 2
        return svc, [m, el]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def test_prefiltered_cache_hit_is_never_held_and_is_refunded(lineitem_path):
    """A request the prefiltered cache answers decodes nothing: it is not
    held, its whole estimate is refunded, and the zero-work slice does not
    train the dispatch-price EWMA."""
    def run(S):
        r = S.Reader(lineitem_path)
        plan = plan_ab(S.P)[0]
        svc = _service(S, policy=S.dp.AdaptiveOffloadPolicy(repeat_k=2), hold_ticks=3)
        tickets = [svc.submit("t", r, plan)]
        svc.result(tickets[-1])  # seen=1: held to its deadline
        tickets.append(svc.submit("t", r, plan))
        svc.result(tickets[-1])  # seen=2: prefiltered, caches
        before = svc.telemetry.tenant_recon_seconds.get("t", 0.0)
        t3 = svc.submit("t", r, plan)
        tickets.append(t3)
        svc.tick()
        assert t3.status == "done" and t3.done_tick - t3.submitted_tick == 1
        assert t3.result.stats.cache_hit
        assert svc.telemetry.tenant_recon_seconds["t"] < before - 1e-12
        assert svc._est_scale.get("t", 1.0) == pytest.approx(1.0)
        return svc, tickets

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


# ---------------------------------------------------------------------------
# the fetch simulation
# ---------------------------------------------------------------------------

def _inflated(S):
    class InflatedMetaReader(S.Reader):
        """Same path, 1000x encoded_bytes: a reader whose metadata
        disagrees with another open handle of the file."""

        def row_group_meta(self, rg):
            meta = copy.deepcopy(super().row_group_meta(rg))
            for c in meta["columns"].values():
                c["encoded_bytes"] *= 1000
            return meta

    return InflatedMetaReader


@pytest.mark.parametrize("batch_decode", [True, False], ids=["batched", "sequential"])
def test_simulate_fetch_uses_contributing_readers_metadata(lineitem_path, batch_decode):
    """Two reader objects for one path in one coalesced tick: each row group
    is priced with the reader that scanned it."""
    def run(S, second):
        svc = _service(S, batch_per_tick=2, batch_decode=batch_decode)
        tickets = [svc.submit("a", S.Reader(lineitem_path), mouse(S.P, 200)),
                   svc.submit("b", second(lineitem_path), mouse(S.P, 2200))]
        svc.drain()
        return svc, tickets

    for second in ("honest", "inflated"):
        (jsvc, jt), (tsvc, tt) = twin(
            lambda S: run(S, S.Reader if second == "honest" else _inflated(S)))
        same_pods(tsvc, jsvc, tt, jt)
        if second == "honest":
            honest = tsvc.telemetry.counters["sim_fetch_serial_s"]
    assert tsvc.telemetry.counters["sim_fetch_serial_s"] > honest * 10


def test_simulate_fetch_sizes_decode_like_the_engine(lineitem_path):
    """For a fused plan over a non-block-aligned last row group the
    simulated decoded bytes equal the engine's materialized bytes."""
    def run(S):
        r = S.Reader(lineitem_path)
        assert r.row_group_meta(r.n_row_groups - 1)["n"] % 8192 != 0
        plan = S.P.ScanPlan("lineitem", ["l_extendedprice"], S.P.Cmp("l_quantity", "le", 10))
        svc = _service(S)
        t = svc.submit("t", r, plan)
        svc.drain()
        assert t.result.stats.fused
        sim_dec = svc.telemetry.counters["sim_fetch_decoded_bytes"]
        assert sim_dec == t.result.stats.decoded_bytes
        rows = sum(r.row_group_meta(rg)["n"] for rg in range(r.n_row_groups))
        assert sim_dec != rows * 4 * 2
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


# ---------------------------------------------------------------------------
# reconciliation
# ---------------------------------------------------------------------------

def test_honest_estimates_reconcile_to_zero(lineitem_path):
    def run(S):
        svc = _service(S)
        t = svc.submit("t", S.Reader(lineitem_path), elephant(S.P))
        svc.drain()
        cost = svc.telemetry.cost_report()["t"]
        assert cost["actual_s"] == pytest.approx(cost["est_s"])
        assert abs(cost["recon_s"]) < 1e-9 and abs(cost["rel_err"]) < 1e-9
        return svc, [t]

    (jsvc, jt), (tsvc, tt) = twin(run)
    same_pods(tsvc, jsvc, tt, jt)


def run_adversarial(S, path, cheat: bool, reconcile: bool):
    """service_bench's `_run_adversarial`: two whole-table elephants, one
    under-estimating its decode cost 4x, ticked while both are backlogged."""
    r = S.Reader(path)
    svc = S.dp.DatapathService(
        engine=S.engine(cache=S.BlockCache(4 << 30)), policy=S.dp.StaticPolicy("raw"),
        scheduler="wfq", tick_bytes=int(RG_ROWS * 4 * 2 * 1.5), cost_model=S.dp.CostModel(),
        reconcile=reconcile)
    tickets = [svc.submit("cheat", r, elephant(S.P, ("l_extendedprice", "l_quantity"))),
               svc.submit("honest", r, elephant(S.P, ("l_discount", "l_tax")))]
    if cheat:
        req = next(q for q in svc.queue if q.tenant == "cheat")
        req.rg_costs = tuple(c / 4 for c in req.rg_costs)
    while all(any(q.tenant == t and q.cursor < len(q.row_groups) for q in svc.queue)
              for t in ("cheat", "honest")):
        svc.tick()
    dec = svc.telemetry.tenant_decoded_bytes
    return svc, tickets, dec.get("cheat", 0.0) / sum(dec.values())


def test_under_estimating_tenant_is_rebilled(lineitem_path):
    """A tenant under-pricing its decode 4x is re-billed at slice completion
    (its share stays within 10% of the honest one); with reconciliation off
    the cheat pays."""
    out = {}
    for cheat, reconcile in ((False, True), (True, True), (True, False)):
        (jsvc, jt, jshare), (tsvc, tt, tshare) = twin(run_adversarial, lineitem_path, cheat,
                                                      reconcile)
        same_pods(tsvc, jsvc, tt, jt)
        assert tshare == jshare
        out[cheat, reconcile] = (tsvc, tshare)
    base, on, off = (out[False, True][1], out[True, True][1], out[True, False][1])
    assert on <= base * 1.10
    assert off > on
    cost = out[True, True][0].telemetry.cost_report()["cheat"]
    assert cost["rel_err"] < -0.1
    assert cost["recon_s"] == pytest.approx(cost["actual_s"] - cost["est_s"], rel=1e-6)


def test_disjoint_footprints_precondition(lineitem_path):
    from repro_torch.core.plan import bind_expr
    from repro_torch.core.zonemap import prune_row_groups

    r = T.Reader(lineitem_path)
    lo = prune_row_groups(r, bind_expr(mouse(T.P, 200).predicate, r))
    hi = prune_row_groups(r, bind_expr(mouse(T.P, 2200).predicate, r))
    assert lo and hi and not (set(lo) & set(hi))
