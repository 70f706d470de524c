"""The port's scan fabric (`repro_torch.datapath.fabric`) on the CPU against
the JAX fabric, on the same seeded files and submissions.

Every scenario runs twice, once on each package (the port's fleet with
`ScanFabric(device="cpu")`, the JAX fleet with `backend="ref"`), and the two
runs must agree on (`same_fabrics`):

- fabric tickets: status, error type, pruned row groups, replays, and results
  (rows exactly, every merged ScanStats field but `kernel_launches` and
  `batch_pad_blocks`);
- every pod, live or drained: test_torch_service.py's deterministic
  telemetry view (counters, virtual time, the cost and fault ledgers, the
  store's ledger), ticks and queue;
- the fleet: `report()` less its wall-clock straggler seconds, peer counters,
  drain plans, ring membership and ownership of every row group, heartbeat
  state, the fairness watermarks and the catalog's pins.

Within the port, every fleet result is bit-identical to the direct
single-engine scan (the reference's own assertion).  Ports every case of
tests/test_fabric.py but the catalog's unit test and the pure peer-price
test (tests/test_torch_fabric_parts.py has them).  Also: the fleet's
defaults (the card unless told otherwise, a cost model keyed by the
device), a peer hit aliasing its sibling's tensor, and a kernel failure
propagating out of `tick()` instead of draining a pod.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os

import pytest
import torch

from repro.core import tpch as jtpch
from repro_torch.datapath import costmodel as tcostmodel
from repro_torch.distributed.sharding import HashRing, rg_key
from repro_torch.lakeformat.reader import LakeReader
from repro_torch.kernels import build, ops
from tests.test_torch_service import (  # noqa: F401 (trace_hooks: autouse)
    J, T, _diff, same_result, same_rows, same_telemetry, trace_hooks)

# 2048-row groups: lineitem at sf=0.05 spans ~15 row groups, so every
# multi-pod split exercises routing, and TICK_BYTES keeps scans multi-tick
# (preemptable mid-flight for the failure tests)
RG_ROWS = 2048
TICK_BYTES = 1 << 14


def scale_out_steals(path: str, n_rgs: int) -> bool:
    """Whether the pod that `_scale_out` adds to a 2-pod fleet owns one of
    the file's row groups.  The ring hashes `rg_key(path, rg)`, which holds
    the file's absolute path, so where the tables lie decides it: for ~0.3%
    of directories the added pod owns none of lineitem's 15 row groups and
    has nothing to pull from its siblings."""
    ring = HashRing(["pod0", "pod1"])
    ring.add_node("pod2")
    return any(ring.owner(rg_key(path, rg)) == "pod2" for rg in range(n_rgs))


def write_lakes(base: str) -> dict:
    """The seed-0 tables in the first `base/tpch<i>` whose lineitem gives
    `_scale_out`'s new pod row groups (written once, then renamed)."""
    first = os.path.join(base, "tpch0")
    paths = jtpch.write_tables(first, sf=0.05, seed=0, row_group_size=RG_ROWS)
    n_rgs = LakeReader(paths["lineitem"]).n_row_groups
    for i in itertools.count():
        d = os.path.join(base, f"tpch{i}")
        if scale_out_steals(os.path.join(d, "lineitem.lake"), n_rgs):
            if d != first:
                os.rename(first, d)
            return {k: os.path.join(d, os.path.basename(p)) for k, p in paths.items()}


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    return write_lakes(str(tmp_path_factory.mktemp("tpch_fabric")))


@functools.lru_cache(maxsize=None)
def _readers(side: str, paths: tuple):
    S = J if side == "jax" else T
    return {k: S.Reader(p) for k, p in paths}


def readers(S, lakes):
    return _readers(S.name, tuple(sorted(lakes.items())))


def plans(P):
    return [
        P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                   P.Cmp("l_shipdate", "between", (365, 729))),  # zone-map pruned
        P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"],
                   P.Cmp("l_quantity", "le", 25)),  # unprunable: every rg survives
        P.ScanPlan("lineitem", ["l_quantity"], P.Cmp("l_quantity", "le", 3),
                   compact=True),  # global compaction over the merged stream
        P.ScanPlan("part", ["p_partkey", "p_size"], P.Cmp("p_size", "le", 10)),
    ]


@functools.lru_cache(maxsize=None)
def _direct_scan(side: str, paths: tuple, idx: int):
    S = J if side == "jax" else T
    plan = plans(S.P)[idx]
    return S.engine().scan(_readers(side, paths)[plan.table], plan)


def direct(S, lakes, idx):
    """The single-engine scan of plan `idx` on side `S`."""
    return _direct_scan(S.name, tuple(sorted(lakes.items())), idx)


def fabric(S, **kw):
    """A fleet of side `S`: the port's on the CPU, the reference's on its
    `ref` backend."""
    if S is J:
        return S.dp.ScanFabric(backend="ref", **kw)
    return S.dp.ScanFabric(device="cpu", **kw)


def policy_of(S, mode):
    if mode is None:
        return {}
    if mode == "adaptive":
        return {"policy": S.dp.AdaptiveOffloadPolicy()}
    return {"policy": S.dp.StaticPolicy(mode)}


# ---------------------------------------------------------------------------
# the twin checks
# ---------------------------------------------------------------------------

def fabric_ticket_view(t) -> tuple:
    return (t.req_id, t.tenant, t.status, type(t.error).__name__ if t.error else None,
            tuple(t.pruned_rgs), t.replays, sorted(t.subs), t.snapshot is None)


def same_fabric_tickets(tt, jt):
    assert [fabric_ticket_view(t) for t in tt] == [fabric_ticket_view(j) for j in jt]
    for a, b in zip(tt, jt):
        if b.result is not None:
            same_result(a.result, b.result)
        else:
            assert a.result is None


def fabric_view(fab, keys=()) -> dict:
    """The fleet's deterministic state: report() less the straggler
    seconds (wall clock) and the per-pod snapshots (compared by
    same_telemetry), plus the drain plans, ring, heartbeats, fairness
    watermarks and catalog pins."""
    rep = fab.report()
    strag = rep.pop("stragglers")
    rep.pop("pods")
    rep["straggler_samples"] = {pid: v["n"] for pid, v in strag.items() if pid != "stragglers"}
    rep["drain_plans"] = [dataclasses.asdict(p) for p in fab.drains]
    rep["ring_nodes"] = list(fab.ring.nodes)
    rep["owners"] = fab.ring.owners(keys) if fab.ring.nodes else {}
    rep["last_seen"] = dict(sorted(fab.monitor.last_seen.items()))
    rep["occ_seen"] = {f"{p}/{t}": v for (p, t), v in sorted(fab._occ_seen.items())}
    rep["silent"] = sorted(fab._silent)
    rep["active"] = [t.req_id for t in fab.active]
    rep["pinned"] = fab.catalog.pinned_versions()
    rep["catalog"] = (fab.catalog.version, fab.catalog.tables())
    rep["pod_ids"] = sorted(fab.pods)
    return rep


def ring_keys(fab_readers) -> list:
    return [rg_key(r.path, rg) for r in fab_readers.values() for rg in range(r.n_row_groups)]


def same_fabrics(tfab, jfab, tt, jt, lakes):
    """Everything a scenario's two fleets must agree on."""
    same_fabric_tickets(tt, jt)
    keys = ring_keys(readers(T, lakes))
    d = _diff(fabric_view(tfab, keys), fabric_view(jfab, keys))
    assert d is None, d
    for pid in sorted(jfab.pods):
        same_telemetry(tfab.pods[pid], jfab.pods[pid])


def twin_fabrics(lakes, run):
    """run(S) -> (fabric, tickets) on both packages, then same_fabrics."""
    jfab, jt = run(J)
    tfab, tt = run(T)
    same_fabrics(tfab, jfab, tt, jt, lakes)
    return tfab, tt


# ---------------------------------------------------------------------------
# bit-identity sweep: N pods x offload mode x scheduler x batch decode
# ---------------------------------------------------------------------------

SWEEP = [
    # (n_pods, policy, scheduler, batch_decode)
    (1, None, "wfq", True),  # degenerate fabric == one pod
    (2, None, "wfq", True),
    (4, None, "wfq", True),
    (2, "raw", "fifo", False),
    (2, "preloaded", "wfq", True),
    (4, "prefiltered", "wfq", True),
    (4, "adaptive", "fifo", True),
    (3, "raw", "wfq", True),
    (2, "adaptive", "wfq", False),
]


@pytest.mark.parametrize("n_pods,mode,sched,batch", SWEEP)
def test_fabric_bit_identical_to_single_node(lakes, n_pods, mode, sched, batch):
    def run(S):
        R = readers(S, lakes)
        fab = fabric(S, n_pods=n_pods, scheduler=sched, batch_decode=batch,
                     **policy_of(S, mode))
        tickets = []
        for idx, plan in enumerate(plans(S.P)):
            # twice: the second pass may serve from preloaded/prefiltered tiers
            for _ in range(2):
                tickets.append(fab.submit("t0", R[plan.table], plan))
                got = fab.result(tickets[-1])
                same_rows(got, direct(S, lakes, idx))
        return fab, tickets

    twin_fabrics(lakes, run)


def test_prefiltered_keys_carry_the_fabric_tag(lakes):
    """A sub-scan's prefiltered result is keyed by its pod's row-group
    subset, ("fab", rgs), folded into the plan's cache key as the
    reference folds it: the same tags on the same pods."""
    def run(S):
        R = readers(S, lakes)
        fab = fabric(S, n_pods=3, **policy_of(S, "prefiltered"))
        tickets = [fab.submit("t0", R[p.table], p) for p in plans(S.P) for _ in range(2)]
        fab.drain()
        for i, t in enumerate(tickets):
            same_rows(t.result, direct(S, lakes, i // 2))
        tags = {pid: sorted((k[1], k[-1]) for k in fab.pods[pid].store._entries
                            if k[0] == "scan") for pid in fab.live_pods}
        return fab, tickets, tags

    (jfab, jt, jtags), (tfab, tt, ttags) = run(J), run(T)
    assert ttags == jtags and any(ttags.values())
    assert all(tag[0] == "fab" for v in ttags.values() for _, tag in v)
    same_fabrics(tfab, jfab, tt, jt, lakes)


def test_fabric_merged_stats_cover_whole_table(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=4)
        t = fab.submit("t0", r, plans(S.P)[1])  # unprunable
        got = fab.result(t)
        want = direct(S, lakes, 1)
        assert got.stats.row_groups_total == r.n_row_groups
        assert got.stats.rows_total == r.n_rows
        assert got.stats.row_groups_scanned == want.stats.row_groups_scanned
        assert got.stats.rows_out == int(want.count)
        return fab, [t]

    twin_fabrics(lakes, run)


def test_fabric_routing_is_ring_derived(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=4)
        t = fab.submit("t0", r, plans(S.P)[1])
        routes = {pid: sub.rgs for pid, sub in t.subs.items()}
        for sub in t.subs.values():
            for rg in sub.rgs:
                assert fab.owner_of(r.path, rg) == sub.pod_id
        fab.drain()
        assert t.status == "done"
        return fab, [t], routes

    (jfab, jt, jroutes), (tfab, tt, troutes) = run(J), run(T)
    assert troutes == jroutes and len(troutes) >= 2
    same_fabrics(tfab, jfab, tt, jt, lakes)


def test_fabric_all_pruned_is_engine_empty(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        plan = S.P.ScanPlan("lineitem", ["l_extendedprice"], S.P.Cmp("l_quantity", "lt", -1))
        fab = fabric(S, n_pods=2)
        t = fab.submit("t0", r, plan)
        got = fab.result(t)
        same_rows(got, S.engine().scan(r, plan))
        assert tuple(got.mask.shape) == (0,)
        assert not fab.active  # nothing lingers (zero-sub tickets merge at submit)
        return fab, [t]

    tfab, (t,) = twin_fabrics(lakes, run)
    assert t.result.columns["l_extendedprice"].dtype == torch.float32
    assert t.result.count.dtype == torch.int32 and t.result.count.shape == ()


def test_fabric_concurrent_tenants_interleaved(lakes):
    def run(S):
        R = readers(S, lakes)
        fab = fabric(S, n_pods=2, tick_bytes=TICK_BYTES)
        ps = plans(S.P)
        tickets = [fab.submit(f"t{i % 3}", R[p.table], p) for i, p in enumerate(ps)]
        fab.drain()
        for i, t in enumerate(tickets):
            same_rows(t.result, direct(S, lakes, i))
        return fab, tickets

    twin_fabrics(lakes, run)


# ---------------------------------------------------------------------------
# pod failure: explicit kill and silent heartbeat death, mid-scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("silent", [False, True])
@pytest.mark.parametrize("batch", [True, False])
def test_fabric_pod_failure_mid_scan_replays_bit_identical(lakes, silent, batch):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=3, tick_bytes=TICK_BYTES, batch_decode=batch,
                     heartbeat_timeout_ticks=2)
        plan = plans(S.P)[1]
        t = fab.submit("t0", r, plan)  # unprunable -> subs on several pods
        assert len(t.subs) >= 2
        fab.tick()  # some slices land; the victim must still have queued work
        victims = [s.pod_id for s in t.subs.values() if s.ticket.status == "queued"]
        assert victims
        fab.fail_pod(victims[0], silent=silent)
        fab.drain()
        assert t.status == "done" and t.replays >= 1
        assert victims[0] not in fab.live_pods
        rep = fab.report()
        assert rep["drains"] and rep["drains"][-1]["dead"] == victims[0]
        assert rep["drains"][-1]["replayed"] >= 1
        same_rows(t.result, direct(S, lakes, 1))
        # the fleet still works after the drain
        t2 = fab.submit("t0", r, plan)
        same_rows(fab.result(t2), direct(S, lakes, 1))
        return fab, [t, t2]

    twin_fabrics(lakes, run)


def test_fabric_last_pod_failure_raises(lakes):
    for S in (J, T):
        fab = fabric(S, n_pods=1)
        with pytest.raises(RuntimeError):
            fab.fail_pod("pod0")


# ---------------------------------------------------------------------------
# catalog: shared registry, snapshot isolation for in-flight scans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lakes_v2(tmp_path_factory):
    """A second lake with different data, same schema."""
    d = tmp_path_factory.mktemp("tpch_fabric_v2")
    return jtpch.write_tables(str(d), sf=0.05, seed=1, row_group_size=RG_ROWS)


def test_fabric_snapshot_isolation_mid_scan(lakes, lakes_v2):
    def run(S):
        r1, r2 = readers(S, lakes)["lineitem"], S.Reader(lakes_v2["lineitem"])
        plan = plans(S.P)[1]
        eng = S.engine()
        want1, want2 = eng.scan(r1, plan), eng.scan(r2, plan)
        fab = fabric(S, n_pods=2, tick_bytes=TICK_BYTES)
        fab.catalog.register("lineitem", r1)
        t_old = fab.submit("t0", "lineitem", plan)
        fab.tick()  # in flight...
        assert fab.catalog.pinned_versions() == [1]
        fab.catalog.register("lineitem", r2)  # ...when the table is swapped
        t_new = fab.submit("t0", "lineitem", plan)
        fab.drain()
        same_rows(t_old.result, want1)  # pinned: pre-swap data
        same_rows(t_new.result, want2)  # a post-swap submission sees v2
        assert fab.catalog.pinned_versions() == []  # the merge released the pins
        return fab, [t_old, t_new]

    twin_fabrics(lakes, run)


def test_fabric_unknown_table_releases_pin(lakes):
    for S in (J, T):
        fab = fabric(S, n_pods=2)
        with pytest.raises(KeyError):
            fab.submit("t0", "nope", plans(S.P)[0])
        assert fab.catalog.pinned_versions() == []


# ---------------------------------------------------------------------------
# peer fetch: warm siblings beat the storage hop, and the tenant pays
# ---------------------------------------------------------------------------

def _scale_out(S, lakes, peer_fetch=True):
    r = readers(S, lakes)["lineitem"]
    fab = fabric(S, n_pods=2, peer_fetch=peer_fetch, **policy_of(S, "preloaded"))
    plan = plans(S.P)[1]
    t1 = fab.submit("default", r, plan)
    same_rows(fab.result(t1), direct(S, lakes, 1))  # warm the original owners' tiers
    new_pid = fab.add_pod()
    t2 = fab.submit("default", r, plan)
    same_rows(fab.result(t2), direct(S, lakes, 1))  # stolen arcs pull from old owners
    return fab, [t1, t2], new_pid


def test_fabric_scale_out_peer_fetches_from_warm_owners(lakes):
    def run(S):
        fab, tickets, new_pid = _scale_out(S, lakes)
        got = tickets[1].result
        store = fab.pods[new_pid].store
        assert store.peer_hits > 0 and store.peer_hit_bytes > 0
        assert got.stats.peer_bytes == store.peer_hit_bytes
        # ...and the hop was billed to the tenant that missed
        tel = fab.pods[new_pid].telemetry
        assert tel.tenant_peer_bytes.get("default", 0) > 0
        assert tel.counters.get("peer_fetch_seconds", 0) > 0
        # someone served it: fleet-wide serves match hits
        assert sum(fab.pods[p].store.peer_serves for p in fab.live_pods) == store.peer_hits
        return fab, tickets

    twin_fabrics(lakes, run)


def test_peer_hit_aliases_the_siblings_tensor(lakes):
    """On one device a peer hit installs the sibling's own tensor: nothing
    is copied, both ledgers bill it (as the reference's do), and clearing
    the new pod's store frees none of its siblings' entries."""
    fab, _, new_pid = _scale_out(T, lakes)
    new = fab.pods[new_pid].store
    shared = []
    for key in list(new._entries):
        e = new.peek(key)
        for pid in fab.live_pods:
            s = fab.pods[pid].store
            if pid != new_pid and s.peek(key) is not None and s.peek(key).value is e.value:
                shared.append((key, s, e.value, e.nbytes))
    assert shared and any(isinstance(v, torch.Tensor) for _, _, v, _ in shared)
    kept = {id(v): (v.clone() if isinstance(v, torch.Tensor) else v) for _, _, v, _ in shared}
    before = {id(s): (s.used, len(s._entries)) for _, s, _, _ in shared}
    new.clear()
    assert new.used == 0 and not new._entries
    for key, s, v, nb in shared:
        e = s.peek(key)
        assert e is not None and e.value is v and e.nbytes == nb
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, kept[id(v)])
        assert (s.used, len(s._entries)) == before[id(s)]


def test_scale_out_peer_fetches_wherever_the_tables_lie(tmp_path):
    """Tables whose default directory routes none of lineitem's row groups
    to the added pod: `write_lakes` places them where it owns some, and the
    scale-out then takes peer hits (both tests above failed in a run whose
    temporary directory was such a one)."""
    base = next(str(tmp_path / f"b{i}") for i in itertools.count()
                if not scale_out_steals(str(tmp_path / f"b{i}" / "tpch0" / "lineitem.lake"), 15))
    lk = write_lakes(base)
    assert LakeReader(lk["lineitem"]).n_row_groups == 15
    assert os.path.dirname(lk["lineitem"]) != os.path.join(base, "tpch0")
    fab, _, new_pid = _scale_out(T, lk)
    store = fab.pods[new_pid].store
    assert store.peer_hits > 0 and store.peer_hit_bytes > 0


def test_fabric_peer_fetch_disabled_is_isolated(lakes):
    def run(S):
        fab, tickets, _ = _scale_out(S, lakes, peer_fetch=False)
        assert all(fab.pods[p].store.peer_hits == 0 for p in fab.live_pods)
        assert tickets[1].result.stats.peer_bytes == 0
        return fab, tickets

    twin_fabrics(lakes, run)


# ---------------------------------------------------------------------------
# fleet fairness: a tenant cannot dodge its backlog across pod clocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", ["wfq", "fifo"])
def test_fleet_vtime_releveling_charges_cross_pod_consumption(lakes, scheduler):
    def run(S):
        R = readers(S, lakes)
        ps = plans(S.P)
        fab = fabric(S, n_pods=2, tick_bytes=TICK_BYTES, scheduler=scheduler)
        # the hog has multi-tick work queued on both pods at once, so while
        # it consumes on one pod the other must charge its local clock
        t_hog = [fab.submit("hog", R["lineitem"], ps[1]) for _ in range(2)]
        t_mouse = fab.submit("mouse", R["part"], ps[3])
        fab.drain()
        for t in t_hog:
            same_rows(t.result, direct(S, lakes, 1))
        same_rows(t_mouse.result, direct(S, lakes, 3))
        charges = sum(fab.pods[p].telemetry.counters.get("fleet_vtime_charges", 0)
                      for p in fab.live_pods)
        # the re-level never touches fifo pods
        assert charges > 0 if scheduler == "wfq" else charges == 0
        return fab, t_hog + [t_mouse]

    twin_fabrics(lakes, run)


# ---------------------------------------------------------------------------
# cross-request bucket stacking: same-tick same-table requests decode
# through one bucket pass
# ---------------------------------------------------------------------------

def test_cross_request_stacking_bit_identical_and_fewer_launches(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        p1 = S.P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                          S.P.Cmp("l_quantity", "le", 25))
        p2 = S.P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"],
                          S.P.Cmp("l_quantity", "le", 10))
        eng = S.engine()
        want = [eng.scan(r, p) for p in (p1, p2)]
        pods = {}
        for batch in (True, False):
            pod = S.dp.Pod(engine=S.engine(cache=S.BlockCache(1 << 30)),
                           policy=S.dp.StaticPolicy("raw"), batch_decode=batch)
            tks = [pod.submit("a", r, p1), pod.submit("b" if batch else "a", r, p2)]
            pod.drain()
            for tk, w in zip(tks, want):
                same_rows(tk.result, w)
            pods[batch] = pod
        tel = pods[True].telemetry.counters
        assert tel.get("xreq_groups", 0) >= 1 and tel.get("xreq_requests", 0) >= 2
        assert tel.get("xreq_fallback", 0) == 0
        assert (pods[True].telemetry.counters["decode_launches"]
                < pods[False].telemetry.counters["decode_launches"])
        return pods

    jpods, tpods = run(J), run(T)
    for batch in (True, False):
        same_telemetry(tpods[batch], jpods[batch])


def test_fabric_stacks_across_requests_and_stays_identical(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=2, **policy_of(S, "raw"))
        ps = plans(S.P)
        t1, t2 = fab.submit("a", r, ps[0]), fab.submit("b", r, ps[1])
        fab.drain()
        same_rows(t1.result, direct(S, lakes, 0))
        same_rows(t2.result, direct(S, lakes, 1))
        assert sum(fab.pods[p].telemetry.counters.get("xreq_groups", 0)
                   for p in fab.live_pods) >= 1
        return fab, [t1, t2]

    twin_fabrics(lakes, run)


# ---------------------------------------------------------------------------
# drain windows: a pod dies while a request is parked in the coalescing hold
# window, or while peer fetches feed survivors; the breaker drains too
# ---------------------------------------------------------------------------

def test_drain_while_request_parked_in_hold_window(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=3, tick_bytes=TICK_BYTES, hold_ticks=4,
                     heartbeat_timeout_ticks=2)
        t = fab.submit("t0", r, plans(S.P)[1])
        fab.tick()  # every sub is now held (a lone request has no partner)
        parked = [s for s in t.subs.values() if s.ticket.status == "queued"
                  and any(q.held_ticks > 0 and not q.started
                          for q in fab.pods[s.pod_id].queue if q.ticket is s.ticket)]
        assert parked, "expected at least one sub parked in the hold window"
        fab.fail_pod(parked[0].pod_id, silent=True)
        fab.drain()
        assert t.status == "done" and t.replays >= 1
        same_rows(t.result, direct(S, lakes, 1))
        return fab, [t]

    twin_fabrics(lakes, run)


def test_drain_mid_peer_fetch_falls_back_to_storage(lakes):
    """A warm pod killed silently mid-scan: until its heartbeat times out,
    survivors' peer fetches may list it, hit its dead store and fall back to
    the next peer or storage; then the drain replays its own work."""
    def run(S):
        r = readers(S, lakes)["lineitem"]
        plan = plans(S.P)[1]
        fab = fabric(S, n_pods=3, tick_bytes=TICK_BYTES, heartbeat_timeout_ticks=3)
        t0 = fab.submit("t0", r, plan)
        fab.result(t0)  # warm every pod's store
        t = fab.submit("t0", r, plan)
        fab.tick()
        victims = [s.pod_id for s in t.subs.values() if s.ticket.status == "queued"]
        assert victims
        assert fab.pods[victims[0]].store.dead is False
        fab.fail_pod(victims[0], silent=True)
        assert fab.pods[victims[0]].store.dead is True
        with pytest.raises(ConnectionError):
            fab.pods[victims[0]].store.peek(("page", r.path, 0, "l_quantity"))
        fab.drain()
        assert t.status == "done"
        same_rows(t.result, direct(S, lakes, 1))
        t2 = fab.submit("t0", r, plan)  # the fleet stays healthy
        same_rows(fab.result(t2), direct(S, lakes, 1))
        return fab, [t0, t, t2]

    twin_fabrics(lakes, run)


def test_breaker_open_pod_is_drained_and_replayed(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=3, tick_bytes=TICK_BYTES)
        t = fab.submit("t0", r, plans(S.P)[1])
        victim = next(s.pod_id for s in t.subs.values())
        fab.inject_faults(victim, S.dp.FaultPlan(transient_rate=1.0, fail_forever=True),
                          S.dp.RetryPolicy(max_attempts=5))
        fab.drain()
        assert t.status == "done" and t.replays >= 1
        assert victim not in fab.live_pods
        assert fab.report()["breaker_drains"] >= 1
        same_rows(t.result, direct(S, lakes, 1))
        return fab, [t]

    twin_fabrics(lakes, run)


def test_breaker_drain_never_takes_the_last_pod(lakes):
    def run(S):
        r = readers(S, lakes)["lineitem"]
        fab = fabric(S, n_pods=1, tick_bytes=TICK_BYTES)
        fab.inject_faults("pod0", S.dp.FaultPlan(transient_rate=1.0, fail_forever=True),
                          S.dp.RetryPolicy(max_attempts=5))
        t = fab.submit("t0", r, plans(S.P)[1])
        fab.drain()
        assert t.status == "error" and isinstance(t.error, S.dp.FetchFailed)
        assert fab.live_pods == ["pod0"] and fab.report()["breaker_drains"] == 0
        return fab, [t]

    twin_fabrics(lakes, run)


# ---------------------------------------------------------------------------
# the port's own: defaults, and a kernel's failure
# ---------------------------------------------------------------------------

def test_fabric_defaults_to_the_card(monkeypatch):
    """Built without a device the fleet runs on the card, and raises
    without one; on the CPU its pods share one device and a cost model
    keyed by it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.dp.ScanFabric()
    fab = T.dp.ScanFabric(n_pods=3, device="cpu")
    assert fab.cost_model.backend == "cpu"
    assert {p.engine.device for p in fab.pods.values()} == {torch.device("cpu")}
    assert all(p.cost_model is fab.cost_model for p in fab.pods.values())
    assert T.dp.ScanFabric(n_pods=1, device="cpu", backend="host").cost_model.backend == "host"
    assert tcostmodel.active_backend("cuda") == "cuda"


@pytest.mark.parametrize("batch_decode,wrapper,error", [
    (True, "dict_decode_batch", "kernel"),
    (False, "dict_decode", "kernel"),
    (True, "dict_decode_batch", "oom"),
], ids=["batched", "sequential", "torch_oom"])
def test_kernel_failure_propagates_out_of_fabric_tick(lakes, monkeypatch, batch_decode,
                                                      wrapper, error):
    """A kernel that fails inside a pod's tick leaves ScanFabric.tick():
    no pod is drained, and no fabric or pod ticket carries the error."""
    r = readers(T, lakes)["lineitem"]
    fab = fabric(T, n_pods=2, batch_decode=batch_decode, **policy_of(T, "raw"))
    plan = T.P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                        T.P.Cmp("l_shipdate", "between", (200, 564)))
    t = fab.submit("t0", r, plan)
    assert len(t.subs) == 2

    def boom(*a, **kw):
        if error == "oom":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        raise build.KernelError("rt_dict_decode failed: CUDA error 719 (unspecified launch "
                                "failure)")

    monkeypatch.setattr(ops, wrapper, boom)
    with pytest.raises(build.DEVICE_ERRORS):
        fab.tick()
    assert fab.live_pods == ["pod0", "pod1"] and not fab.drains and fab.breaker_drains == 0
    assert t.status == "queued" and t.error is None and t.result is None
    assert all(s.ticket.error is None for s in t.subs.values())
    assert all(p.telemetry.counters.get("failed", 0) == 0 for p in fab.pods.values())


# ---------------------------------------------------------------------------
# hypothesis sweep (the fixed grid above always runs)
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @settings(deadline=None, max_examples=12)
    @given(n_pods=st.sampled_from([1, 2, 4]),
           mode=st.sampled_from(["adaptive", "raw", "preloaded", "prefiltered"]),
           scheduler=st.sampled_from(["wfq", "fifo"]), batch=st.booleans(),
           kill=st.booleans(), idx=st.integers(0, 3))
    def _hyp_fabric_identity(lakes, n_pods, mode, scheduler, batch, kill, idx):
        def run(S):
            plan = plans(S.P)[idx]
            fab = fabric(S, n_pods=n_pods, scheduler=scheduler, batch_decode=batch,
                         tick_bytes=TICK_BYTES, **policy_of(S, mode))
            t = fab.submit("t0", readers(S, lakes)[plan.table], plan)
            if kill and n_pods > 1:
                fab.tick()
                queued = [s.pod_id for s in t.subs.values() if s.ticket.status == "queued"]
                if queued:
                    fab.fail_pod(queued[0])
            fab.drain()
            same_rows(t.result, direct(S, lakes, idx))
            return fab, [t]

        twin_fabrics(lakes, run)

    def test_fabric_identity_hypothesis_sweep(lakes):
        _hyp_fabric_identity(lakes)

else:

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_fabric_identity_hypothesis_sweep():
        pass
