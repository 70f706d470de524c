"""The fabric's parts on the CPU against the reference's: the consistent-hash
ring (`repro_torch.distributed.sharding`), the fault-tolerance policies
(`repro_torch.distributed.fault_tolerance`) and the catalog
(`repro_torch.datapath.catalog`).

- `HashRing` ownership equals the reference's key for key: every `rg_key`
  of the test tables and random keys, under adds and removes.  Two
  fabrics that route differently could not be compared pod by pod.
- tests/test_sharding_ring.py's properties hold on the port's ring.
- tests/test_fault_tolerance.py's cases hold on the port, and each plan
  equals the reference's on the same inputs.
- `Catalog`'s versions, pins and errors equal the reference's.
- tests/test_fabric.py's pure pricing case: a peer fetch is cheaper than
  the storage hop at any size, under both cost models.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

from repro.core import tpch as jtpch
from repro.datapath import catalog as jcatalog
from repro.datapath.costmodel import CostModel as JCostModel
from repro.distributed import fault_tolerance as jft
from repro.distributed import sharding as jsharding
from repro_torch.datapath import catalog as tcatalog
from repro_torch.datapath.costmodel import CostModel as TCostModel
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor,
    StragglerDetector,
    plan_elastic_mesh,
    plan_pod_drain,
)
from repro_torch.distributed.sharding import HashRing, rg_key
from repro_torch.lakeformat.reader import LakeReader

KEYS = [rg_key(f"/lake/t{t}.lake", rg) for t in range(4) for rg in range(128)]


@pytest.fixture(scope="module")
def table_keys(tmp_path_factory):
    """The rg_key of every row group of the fabric tests' tables."""
    d = tmp_path_factory.mktemp("tpch_ring")
    paths = jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=2048)
    keys = [rg_key(p, rg) for p in paths.values() for rg in range(LakeReader(p).n_row_groups)]
    assert len(keys) >= 20
    return keys


# ---------------------------------------------------------------------------
# the ring against the reference's
# ---------------------------------------------------------------------------

def test_rg_key_is_the_references():
    for path, rg in (("/a/lineitem.lake", 0), ("part.lake", 91), ("", 7)):
        assert rg_key(path, rg) == jsharding.rg_key(path, rg)


def _random_keys(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return ["".join(rng.choice("abcdefgh/#0123456789") for _ in range(rng.randint(0, 24)))
            for _ in range(n)]


@pytest.mark.parametrize("replicas", [1, 8, 64])
def test_ring_ownership_equals_the_references_under_adds_and_removes(table_keys, replicas):
    keys = table_keys + KEYS + _random_keys(500, replicas)
    tr, jr = HashRing(replicas=replicas), jsharding.HashRing(replicas=replicas)
    with pytest.raises(ValueError):
        tr.owner(keys[0])
    steps = [("add", "pod0"), ("add", "pod1"), ("add", "pod2"), ("add", "pod1"),
             ("remove", "pod1"), ("add", "pod3"), ("remove", "nope"), ("remove", "pod0"),
             ("add", "pod1"), ("add", "pod4"), ("remove", "pod2")]
    for op, node in steps:
        getattr(tr, f"{op}_node")(node)
        getattr(jr, f"{op}_node")(node)
        assert tr.nodes == jr.nodes
        assert tr._points == jr._points and tr._owner_at == jr._owner_at
        assert tr.owners(keys) == jr.owners(keys), (op, node)


# ---------------------------------------------------------------------------
# tests/test_sharding_ring.py on the port
# ---------------------------------------------------------------------------

def test_ring_deterministic_across_instances():
    a = HashRing(["pod0", "pod1", "pod2"])
    b = HashRing(["pod0", "pod1", "pod2"])
    assert a.owners(KEYS) == b.owners(KEYS)
    # insertion order of nodes must not matter either
    c = HashRing(["pod2", "pod0", "pod1"])
    assert a.owners(KEYS) == c.owners(KEYS)


def test_ring_balance():
    ring = HashRing([f"pod{i}" for i in range(4)])
    counts = {n: 0 for n in ring.nodes}
    for o in ring.owners(KEYS).values():
        counts[o] += 1
    # 512 keys over 4 nodes -> ~128 each; none starved, none above 3x fair
    for n, c in counts.items():
        assert 0 < c < 3 * len(KEYS) // 4, (n, c, counts)


def test_ring_minimal_movement_on_remove():
    ring = HashRing(["pod0", "pod1", "pod2"])
    before = ring.owners(KEYS)
    ring.remove_node("pod1")
    after = ring.owners(KEYS)
    for k in KEYS:
        if before[k] != "pod1":
            assert after[k] == before[k], k  # survivors keep their arcs
        else:
            assert after[k] != "pod1"  # dead arcs re-home to survivors


def test_ring_minimal_movement_on_add():
    ring = HashRing(["pod0", "pod1"])
    before = ring.owners(KEYS)
    ring.add_node("pod2")
    after = ring.owners(KEYS)
    moved = [k for k in KEYS if after[k] != before[k]]
    # every moved key moved to the new node, and it stole a real arc
    assert moved and all(after[k] == "pod2" for k in moved)
    # add + remove round-trips to the original ownership
    ring.remove_node("pod2")
    assert ring.owners(KEYS) == before


def test_ring_add_is_idempotent_and_remove_unknown_is_noop():
    ring = HashRing(["pod0", "pod1"])
    before = ring.owners(KEYS)
    ring.add_node("pod0")
    ring.remove_node("nope")
    assert ring.owners(KEYS) == before and ring.nodes == ["pod0", "pod1"]


def test_ring_empty_raises():
    with pytest.raises(ValueError):
        HashRing().owner("k")


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py on the port, each plan against the reference's
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _heartbeats(ft, hosts, timeout, spares, beats, mesh):
    """Drive a monitor through (time, hosts that beat) steps; the plan."""
    clock = FakeClock()
    mon = ft.HeartbeatMonitor(hosts, timeout_s=timeout, spares=spares, clock=clock)
    for t, beating in beats:
        clock.t = t
        for h in beating:
            mon.beat(h)
    return mon.plan(mesh)


HEARTBEATS = {
    "shrink": ([f"h{i}" for i in range(8)], 60, 0,
               [(30, [f"h{i}" for i in range(8)]), (100, [f"h{i}" for i in range(6)]),
                (150, [])], (16, 16)),
    "restart_same": (["a", "b", "c"], 10, 1, [(20, ["a", "b"])], (4, 4)),
    "none": (["a", "b"], 10, 0, [(5, ["a", "b"])], (2, 2)),
}


@pytest.mark.parametrize("case", sorted(HEARTBEATS))
def test_heartbeat_plans_equal_the_references(case):
    got = _heartbeats(tft, *HEARTBEATS[case])
    want = _heartbeats(jft, *HEARTBEATS[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.action == case


def test_heartbeat_detects_death_and_plans_shrink():
    clock = FakeClock()
    hosts = [f"h{i}" for i in range(8)]
    mon = HeartbeatMonitor(hosts, timeout_s=60, spares=0, clock=clock)
    clock.t = 30
    for h in hosts:
        mon.beat(h)
    clock.t = 100
    for h in hosts[:6]:
        mon.beat(h)
    clock.t = 150  # h6, h7 silent for 120 s; h0-5 for 50 s (< timeout)
    plan = mon.plan((16, 16))
    assert set(plan.dead_hosts) == {"h6", "h7"}
    assert plan.action == "shrink"
    assert plan.new_mesh[1] == 16  # model axis preserved
    assert plan.new_mesh[0] <= 16 and plan.new_mesh[0] & (plan.new_mesh[0] - 1) == 0


def test_heartbeat_spares_restart_same():
    clock = FakeClock()
    mon = HeartbeatMonitor(["a", "b", "c"], timeout_s=10, spares=1, clock=clock)
    clock.t = 20
    mon.beat("a")
    mon.beat("b")
    plan = mon.plan((4, 4))
    assert plan.action == "restart_same" and plan.dead_hosts == ["c"]


def test_elastic_mesh_sizing():
    assert plan_elastic_mesh(64, (16, 16), chips_per_host=4) == (16, 16)
    assert plan_elastic_mesh(63, (16, 16), chips_per_host=4) == (8, 16)
    assert plan_elastic_mesh(9, (16, 16), chips_per_host=4) == (2, 16)
    for n in range(1, 80, 3):
        for mesh in ((16, 16), (4, 8), (1, 1)):
            assert plan_elastic_mesh(n, mesh) == jft.plan_elastic_mesh(n, mesh)


def test_straggler_detection_and_policy():
    det = StragglerDetector(factor=2.0, min_samples=5, policy="skip_batch")
    ref = jft.StragglerDetector(factor=2.0, min_samples=5, policy="skip_batch")
    for step in range(6):
        for h in ("h0", "h1", "h2", "h3"):
            for d in (det, ref):
                d.record(h, step, 1.0 if h != "h2" else 3.5)
    assert det.stragglers() == ["h2"]
    assert det.action_for("h2") == "skip_batch"
    assert det.action_for("h0") == "none"
    rep = det.report()
    assert rep["h2"]["median_s"] > 3 and rep["stragglers"] == ["h2"]
    assert rep == ref.report()


def test_plan_pod_drain_reassigns_only_dead_arcs():
    ring, jring = HashRing(["pod0", "pod1", "pod2"]), jsharding.HashRing(["pod0", "pod1", "pod2"])
    keys = [rg_key("/lake/l.lake", rg) for rg in range(64)]
    before = ring.owners(keys)
    owned = [k for k, o in before.items() if o == "pod1"]
    plan = plan_pod_drain("pod1", ring, owned, in_flight=[7, 9])
    assert plan.dead == "pod1"
    assert plan.survivors == ["pod0", "pod2"]
    assert plan.replay == [7, 9]
    # every dead-owned key re-homed to a survivor...
    assert set(plan.reassigned) == set(owned)
    assert all(o in ("pod0", "pod2") for o in plan.reassigned.values())
    # ...and the ring was mutated minimally: survivors keep their arcs
    after = ring.owners(keys)
    for k in keys:
        if before[k] != "pod1":
            assert after[k] == before[k], k
        else:
            assert after[k] == plan.reassigned[k]
    want = jft.plan_pod_drain("pod1", jring, owned, in_flight=[7, 9])
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)


def test_plan_pod_drain_last_pod_raises():
    with pytest.raises(RuntimeError):
        plan_pod_drain("pod0", HashRing(["pod0"]), [], [])


def test_plan_pod_drain_empty_workload():
    plan = plan_pod_drain("pod0", HashRing(["pod0", "pod1"]), [], [])
    assert plan.reassigned == {} and plan.replay == []
    assert plan.survivors == ["pod1"]


# ---------------------------------------------------------------------------
# the catalog against the reference's
# ---------------------------------------------------------------------------

def _catalog_script(cat_mod):
    """tests/test_fabric.py's catalog case, recording every observable."""
    out = []
    cat = cat_mod.Catalog()
    out.append((cat.version, cat.tables(), cat.pinned_versions()))
    v1 = cat.register("t", "readerA")
    snap = cat.pin()
    out.append((v1, snap.version, snap.table("t"), "t" in snap, "u" in snap))
    v2 = cat.register("t", "readerB")
    cat.register("u", "readerC")
    snap2, snap3 = cat.pin(), cat.pin()
    out.append((v2, cat.resolve("t"), snap.table("t"), cat.pinned_versions(), cat.tables()))
    with pytest.raises(KeyError) as e:
        snap.table("u")
    out.append(str(e.value))
    cat.release(snap)
    cat.release(snap2)
    out.append(cat.pinned_versions())
    cat.release(snap3)
    out.append(cat.pinned_versions())
    cat.release(None)  # tolerated
    with pytest.raises(RuntimeError):
        cat.release(snap)  # a double release is a bug
    out.append(cat.drop("t"))
    with pytest.raises(KeyError) as e:
        cat.resolve("t")
    out.append(str(e.value))
    with pytest.raises(KeyError):
        cat.drop("t")
    out.append((cat.version, cat.tables(), snap2.tables, type(snap).__name__))
    with pytest.raises(dataclasses.FrozenInstanceError):
        snap.version = 0
    return out


def test_catalog_versions_and_pins_equal_the_references():
    got = _catalog_script(tcatalog)
    assert got == _catalog_script(jcatalog)
    assert got[0] == (0, [], []) and got[1][:3] == (1, 1, "readerA")
    assert got[2][:4] == (2, "readerB", "readerA", [1, 3])
    assert got[4] == [3] and got[5] == []


# ---------------------------------------------------------------------------
# tests/test_fabric.py's pricing case
# ---------------------------------------------------------------------------

def test_peer_fetch_cheaper_than_storage_at_any_size():
    tcm, jcm = TCostModel(), JCostModel()
    for nb in (1, 4096, 1 << 20, 1 << 28):
        assert tcm.peer_fetch_seconds(nb) < tcm.link_model().fetch_seconds(nb)
        assert tcm.peer_fetch_seconds(nb) == jcm.peer_fetch_seconds(nb)


def test_modules_are_the_ports_own():
    for mod in (tsharding, tft, tcatalog):
        assert mod.__name__.startswith("repro_torch.")
    assert tsharding.HashRing is not jsharding.HashRing
