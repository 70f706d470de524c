"""ScanFabric — N pods behind consistent-hash row-group ownership.

One Pod (datapath/service.py) is the single-node appliance: scheduler,
block store, netsim clock, telemetry.  The fabric is the fleet layer
(DESIGN.md §15):

  routing    a scan's pruned row groups partition by the consistent-hash
             ring (distributed/sharding.HashRing over `rg_key(path, rg)`)
             into one sub-scan per owning pod; each pod runs its slice
             through its own admission/WFQ/decode machinery unchanged
  merging    sub-results come back pre-compaction (sub-plans strip
             `compact`), are sliced back into per-row-group chunks, and
             reassemble in GLOBAL row-group order — so an N-pod scan is
             bit-identical to the single-node scan, compaction included
  peer fetch a pod that misses locally may pull encoded pages / decoded
             columns from a sibling's block store (blockstore.PeerFetcher
             installed on each pod's cache) over the inter-pod link —
             cheaper than the storage hop at any size, and billed to the
             tenant whose miss pulled it (scheduler._reconcile_slice)
  catalog    all pods resolve tables through one Catalog; every scan pins
             the version current at submission, so a mid-scan
             re-registration is invisible to in-flight work
  fairness   WFQ virtual time is per pod; the fabric re-levels it each
             tick by charging every pod the decode-seconds its queued
             tenants consumed ELSEWHERE, so a tenant cannot dodge its
             backlog by having its bytes land on another pod's scheduler
  drain      a pod failure (heartbeat silence or explicit fail_pod) pulls
             it from the ring — minimal moved arc, survivors' ownership
             untouched — and re-partitions only the uncollected sub-scans
             among survivors; collected sub-results are fabric-held and
             survive, so a scan replays from its last COMPLETED slice and
             still merges bit-identically

Everything stays deterministically single-threaded: pods tick in pod-id
order inside `ScanFabric.tick()`, which is what makes the bit-identity
sweep in tests/test_torch_fabric.py a hard equality, not a tolerance check.

Port copy of `repro.datapath.fabric`, kept in step with it.  What differs:

  device     every pod's engine lives on the fleet's one device:
             `ScanFabric(device="cuda")` is the default and raises without
             a card; tests pass `device="cpu"`.  `backend` is the engine's
             ("auto": the device's kernels, "host": numpy decode).  The
             merge's compaction runs on a surviving pod's engine, so on the
             card it launches `filter_compact` once per column of a
             compact plan's merged stream
  pricing    a fleet built without a cost model gets the nominal table
             keyed by its device (`costmodel.active_backend`), as a pod's
             default is; the nominal rates are the same under every key
  peer hits  alias: a pod that peer-fetches a block installs the sibling's
             own tensor (or page buffer) in its store, with no copy.  Both
             stores bill its bytes in their ledgers, as the reference's
             do, and clearing one store drops only that store's reference
  faults     a kernel's build or launch failure, or a CUDA error raised by
             torch, propagates out of `Pod.tick()` and so out of `tick()`:
             it drains no pod and lands on no fabric ticket
  stragglers the per-pod tick seconds time completed device work, because
             a pod on the card synchronizes before it reads its clock
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import agg as agg_merge
from repro_torch.core.cache import BlockCache
from repro_torch.core.engine import (
    _TORCH_DTYPES,
    DatapathEngine,
    ScanResult,
    ScanStats,
    group_domain,
    resolve_device,
)
from repro_torch.core.plan import ScanPlan, bind_expr
from repro_torch.core.zonemap import prune_and_estimate
from repro_torch.datapath.blockstore import PeerFetcher
from repro_torch.datapath.catalog import Catalog, Snapshot
from repro_torch.datapath.costmodel import CostModel, active_backend
from repro_torch.datapath.faults import StorageFault
from repro_torch.datapath.service import Pod, TenantQuota
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor,
    StragglerDetector,
    plan_pod_drain,
)
from repro_torch.distributed.sharding import HashRing, rg_key
from repro_torch.lakeformat.encodings import padded_rows


@dataclasses.dataclass
class _SubScan:
    """One pod's slice of a fabric scan: the pod ticket plus the row
    groups it was asked to produce (global-order subsequence)."""

    pod_id: str
    ticket: object
    rgs: Tuple[int, ...]


@dataclasses.dataclass
class FabricTicket:
    req_id: int
    tenant: str
    reader: object
    plan: ScanPlan
    blooms: Optional[Dict]
    snapshot: Optional[Snapshot]
    pruned_rgs: Tuple[int, ...] = ()
    status: str = "queued"  # queued | done | error
    subs: Dict[str, _SubScan] = dataclasses.field(default_factory=dict)
    # rg -> (cols, mask) chunks collected from COMPLETED sub-scans; these
    # survive a pod failure (replay granularity is the pod sub-scan)
    parts: Dict[int, object] = dataclasses.field(default_factory=dict)
    stats_parts: List[ScanStats] = dataclasses.field(default_factory=list)
    replays: int = 0  # sub-scans re-submitted after a pod drain
    result: Optional[ScanResult] = None
    error: Optional[BaseException] = None


class ScanFabric:
    """An N-pod scan fleet with one routing/merge/fairness brain.

    `n_pods=1` degenerates to a thin wrapper over a single Pod — the
    identity tests lean on that — and every pod shares one calibrated
    CostModel so the fleet's WFQ charges, eviction prices and netsim
    clocks read a single table.  All pods run on `device`."""

    def __init__(
        self,
        n_pods: int = 2,
        device="cuda",
        backend: str = "auto",
        cost_model: Optional[CostModel] = None,
        catalog: Optional[Catalog] = None,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        default_quota: Optional[TenantQuota] = None,
        scheduler: str = "wfq",
        batch_decode: bool = True,
        hold_ticks=0,
        replicas: int = 64,
        # fleet-level WFQ re-leveling (see _rebalance_vtime)
        reconcile_fairness: bool = True,
        # heartbeat silence (in fabric ticks) before a pod is declared dead
        heartbeat_timeout_ticks: int = 3,
        peer_fetch: bool = True,
        **pod_kwargs,
    ):
        assert n_pods >= 1, n_pods
        self.device = resolve_device(device)
        self.cost_model = cost_model or CostModel(
            backend=active_backend(self.device, backend))
        self.catalog = catalog or Catalog()
        self.reconcile_fairness = reconcile_fairness
        self._backend = backend
        self._peer_fetch = peer_fetch
        self._pod_cfg = dict(
            quotas=quotas, default_quota=default_quota, scheduler=scheduler,
            batch_decode=batch_decode, hold_ticks=hold_ticks, **pod_kwargs,
        )
        self.pods: Dict[str, Pod] = {}
        self._live: List[str] = []
        self._silent: set = set()  # failed pods that simply stop beating
        self._next_idx = 0
        for _ in range(n_pods):
            self._make_pod()
        self.ring = HashRing(self._live, replicas=replicas)
        self._tick = 0
        self.monitor = HeartbeatMonitor(
            list(self._live), timeout_s=float(heartbeat_timeout_ticks),
            clock=lambda: float(self._tick),
        )
        self.stragglers = StragglerDetector()
        self._ids = 0
        self.active: List[FabricTicket] = []
        self.drains: List[object] = []  # PodDrainPlans, newest last
        # pods evicted because their storage circuit breaker tripped open
        # (fault plane, DESIGN.md §17) — same drain path as heartbeat death
        self.breaker_drains = 0
        # per-(pod, tenant) occupancy watermark for the fairness re-level
        self._occ_seen: Dict[Tuple[str, str], float] = {}

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    def _make_pod(self) -> str:
        pid = f"pod{self._next_idx}"
        self._next_idx += 1
        cfg = dict(self._pod_cfg)
        if cfg.get("quotas"):
            cfg["quotas"] = dict(cfg["quotas"])
        pod = Pod(
            engine=DatapathEngine(device=self.device, backend=self._backend,
                                  cache=BlockCache()),
            cost_model=self.cost_model, pod_id=pid, **cfg,
        )
        # the merge compacts on any surviving pod's engine: one device
        assert pod.engine.device == self.device, (pod.engine.device, self.device)
        if self._peer_fetch:
            # each pod consults its LIVE siblings' stores on a counting
            # miss; a drained pod drops out of everyone's peer list the
            # moment it leaves self._live
            pod.engine.cache.peer = PeerFetcher(
                pid, self._peers, link=self.cost_model.interpod_link_model()
            )
        self.pods[pid] = pod
        self._live.append(pid)
        return pid

    def add_pod(self) -> str:
        """Scale out by one pod.  The ring steals ONLY the arcs the new
        pod now owns (minimal movement), so scans routed after this reuse
        every survivor-owned block — and the new pod's first scans of its
        stolen arcs pull warm blocks from the OLD owners over the
        inter-pod hop instead of re-fetching storage (the PeerFetcher's
        headline win).  In-flight sub-scans keep their old assignment:
        their tags pin the exact row-group subsets they were issued
        with."""
        pid = self._make_pod()
        self.ring.add_node(pid)
        self.monitor.beat(pid)
        return pid

    def _peers(self) -> List[Tuple[str, object]]:
        # A silently-crashed pod is still in _live until its heartbeat
        # times out, but its store must NOT serve peer fetches during
        # that window — it is dead, the fabric just doesn't know yet.
        # (PeerFetcher additionally absorbs a store that dies between
        # this listing and the peek itself.)
        return [(pid, self.pods[pid].store) for pid in self._live
                if pid not in self._silent]

    @property
    def live_pods(self) -> List[str]:
        return list(self._live)

    def pod(self, pod_id: str) -> Pod:
        return self.pods[pod_id]

    def owner_of(self, path: str, rg: int) -> str:
        return self.ring.owner(rg_key(path, rg))

    # ------------------------------------------------------------------
    # submission / routing
    # ------------------------------------------------------------------
    def submit(self, tenant: str, reader, plan: ScanPlan,
               blooms: Optional[Dict] = None) -> FabricTicket:
        """Route one scan: pin the catalog, prune once, partition the
        surviving row groups by ring ownership, and submit one tagged
        sub-scan per owning pod.  `reader` may be a catalog table name
        (resolved through the pinned snapshot) or a reader object."""
        snap = self.catalog.pin()
        try:
            if isinstance(reader, str):
                reader = snap.table(reader)
            pred = bind_expr(plan.predicate, reader)
            rgs, _sel = prune_and_estimate(reader, pred)
            rgs = tuple(rgs)
        except Exception:
            self.catalog.release(snap)
            raise
        t = FabricTicket(self._ids, tenant, reader, plan, blooms, snap,
                         pruned_rgs=rgs)
        self._ids += 1
        try:
            for pid, sub_rgs in self._partition(reader.path, rgs):
                t.subs[pid] = self._submit_sub(t, pid, sub_rgs)
        except Exception:
            self.catalog.release(snap)
            raise
        if t.subs:
            self.active.append(t)
        else:  # everything pruned: nothing to run anywhere, merge empty now
            self._try_merge(t)
        return t

    def _partition(self, path: str, rgs) -> List[Tuple[str, Tuple[int, ...]]]:
        """Group row groups by owning pod, preserving global scan order
        within each pod's slice.  Pods are emitted in first-ownership
        order (deterministic, ring-derived)."""
        by_pod: Dict[str, List[int]] = {}
        order: List[str] = []
        for rg in rgs:
            pid = self.ring.owner(rg_key(path, rg))
            if pid not in by_pod:
                by_pod[pid] = []
                order.append(pid)
            by_pod[pid].append(rg)
        return [(pid, tuple(by_pod[pid])) for pid in order]

    def _submit_sub(self, t: FabricTicket, pid: str, sub_rgs) -> _SubScan:
        # compaction is GLOBAL (row i of the compacted stream can come
        # from any pod), so sub-plans run uncompacted and the merge
        # compacts once over the reassembled stream
        sub_plan = (dataclasses.replace(t.plan, compact=False)
                    if t.plan.compact else t.plan)
        ticket = self.pods[pid].submit(
            t.tenant, t.reader, sub_plan, t.blooms,
            row_groups=sub_rgs,
            # the tag folds the exact row-group subset into the
            # prefiltered-cache identity: identical sub-scans hit, but a
            # post-drain re-partition (different subset) can never be
            # served a stale slice
            scan_tag=("fab", sub_rgs),
        )
        return _SubScan(pid, ticket, tuple(sub_rgs))

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One fabric tick: heartbeats -> drain dead pods -> fleet WFQ
        re-level -> tick every live pod in pod-id order -> collect
        completed sub-scans and merge finished tickets.  Returns the
        number of fabric tickets that reached a terminal state."""
        self._tick += 1
        for pid in self._live:
            if pid not in self._silent:
                self.monitor.beat(pid)
        for pid in self.monitor.dead_hosts():
            if pid in self._live:
                self._drain_pod(pid)
        # A pod whose storage fetches tripped its circuit breaker open is
        # treated exactly like a heartbeat-silent pod: drain it and replay
        # its uncollected sub-scans bit-identically on survivors, whose
        # own breakers (separate storage paths) are presumed healthy.
        # Never drain the last pod — a one-pod fleet degrades in place.
        if len(self._live) > 1:
            for pid in list(self._live):
                if pid in self._silent or len(self._live) <= 1:
                    continue
                br = getattr(self.pods[pid], "breaker", None)
                if br is not None and br.any_open():
                    self.breaker_drains += 1
                    self._drain_pod(pid)
        if self.reconcile_fairness:
            self._rebalance_vtime()
        for pid in list(self._live):
            if pid in self._silent:
                continue  # a crashed pod does no work while the fabric
                # waits out its heartbeat timeout
            pod = self.pods[pid]
            # a pod on the card synchronizes before its tick returns, so
            # this times the pod's device work too; a kernel failure
            # leaves pod.tick() and this loop alike
            t0 = time.perf_counter()
            pod.tick()
            self.stragglers.record(pid, self._tick, time.perf_counter() - t0)
        return self._collect()

    def _collect(self) -> int:
        done = 0
        for t in list(self.active):
            if t.status != "queued":
                continue
            for pid, sub in list(t.subs.items()):
                tk = sub.ticket
                if tk.status == "error":
                    # A storage-hop failure on a pod whose circuit breaker
                    # is OPEN is the pod's problem, not the scan's: drain
                    # it like a heartbeat-silent pod, which pops this sub
                    # (and every other uncollected sub it held) and
                    # replays them bit-identically on survivors.  With no
                    # survivors the typed error propagates.
                    br = getattr(self.pods[sub.pod_id], "breaker", None)
                    if (isinstance(tk.error, StorageFault)
                            and sub.pod_id in self._live
                            and len(self._live) > 1
                            and br is not None and br.any_open()):
                        self.breaker_drains += 1
                        self._drain_pod(sub.pod_id)
                        break  # subs changed; re-examine next tick
                    t.error = tk.error
                    t.status = "error"
                    self.catalog.release(t.snapshot)
                    t.snapshot = None
                    break
                if tk.status == "done":
                    self._absorb(t, sub, tk.result)
                    del t.subs[pid]
            if t.status == "error":
                self.active.remove(t)
                done += 1
                continue
            if self._try_merge(t):
                self.active.remove(t)
                done += 1
        return done

    def _absorb(self, t: FabricTicket, sub: _SubScan, res: ScanResult) -> None:
        """Slice one completed sub-result back into per-row-group chunks.
        Sub-results are uncompacted, so each row group occupies exactly
        `padded_rows(n)` consecutive rows of the concatenated arrays.
        Aggregate sub-results carry per-row-group ColPartials instead
        (ScanResult.agg_partials) — the merge re-folds them in GLOBAL
        row-group order, so the fabric's float sums land on the exact
        bit pattern the single-node fold produces."""
        if res.agg_partials is not None:
            for rg in sub.rgs:
                t.parts[rg] = res.agg_partials[rg]
            t.stats_parts.append(res.stats)
            return
        off = 0
        for rg in sub.rgs:
            L = padded_rows(t.reader.row_group_meta(rg)["n"])
            cols = {c: v[off:off + L] for c, v in res.columns.items()}
            t.parts[rg] = (cols, res.mask[off:off + L])
            off += L
        t.stats_parts.append(res.stats)

    def _try_merge(self, t: FabricTicket) -> bool:
        if t.subs or t.status != "queued":
            return bool(t.status != "queued")
        stats = _merge_stats(t.stats_parts, t.reader)
        if t.plan.aggregates:
            t.result = self._merge_agg(t, stats)
        elif not t.pruned_rgs:  # all pruned — same empty result the engine builds
            dev = self.device
            empty = {c: torch.zeros((0,), dtype=_TORCH_DTYPES[t.reader.decoded_dtype(c)],
                                    device=dev)
                     for c in t.plan.columns}
            mask = torch.zeros((0,), dtype=torch.bool, device=dev)
            t.result = ScanResult(empty, mask,
                                  torch.zeros((), dtype=torch.int32, device=dev), stats)
        else:
            first_cols = t.parts[t.pruned_rgs[0]][0]
            cols = {
                c: torch.cat([t.parts[rg][0][c] for rg in t.pruned_rgs])
                for c in first_cols
            }
            mask = torch.cat([t.parts[rg][1] for rg in t.pruned_rgs])
            count = mask.sum(dtype=torch.int32)
            if t.plan.compact:
                # one global compaction over the reassembled stream — the
                # exact call ResumableScan._finish makes single-node
                engine = self.pods[self._live[0]].engine
                cols, mask, count = engine._compact(cols, mask)
            stats.rows_out = int(count)
            t.result = ScanResult(cols, mask, count, stats)
        t.status = "done"
        self.catalog.release(t.snapshot)
        t.snapshot = None
        return True

    def _merge_agg(self, t: FabricTicket, stats: ScanStats) -> ScanResult:
        """Deterministic partial-aggregate merge: every pod's per-row-group
        ColPartials re-fold in GLOBAL row-group order (t.pruned_rgs), the
        exact boundary-and-order ResumableScan._finish_agg uses — so the
        N-pod grouped sum is bit-identical to the single-node one, float
        accumulation included, regardless of which pods owned what or how
        a drain replayed a slice."""
        sources = agg_merge.agg_sources(t.plan.aggregates)
        n_groups = (group_domain(t.reader, t.plan.group_by)
                    if t.plan.group_by is not None else 1)
        if not t.pruned_rgs:
            merged = {
                src: agg_merge.identity_partial(
                    n_groups,
                    t.reader.decoded_dtype(src) if src is not None else np.int32,
                )
                for src in sources
            }
        else:
            merged = {
                src: agg_merge.merge_partials(
                    [t.parts[rg][src] for rg in t.pruned_rgs])
                for src in sources
            }
        aggs = agg_merge.finalize(t.plan.aggregates, merged, n_groups)
        count = int(next(iter(merged.values())).cnt.sum())
        stats.rows_out = count
        stats.result_bytes = sum(int(a.nbytes) for a in aggs.values())
        dev = self.device
        return ScanResult(
            {}, torch.zeros((0,), dtype=torch.bool, device=dev),
            torch.tensor(count, dtype=torch.int32, device=dev), stats,
            aggregates=aggs, agg_partials=dict(t.parts),
        )

    def result(self, ticket: FabricTicket) -> ScanResult:
        while ticket.status == "queued":
            if not self.active:
                raise RuntimeError(f"fabric ticket {ticket.req_id} queued "
                                   "but nothing is active")
            self.tick()
        if ticket.status == "error":
            raise ticket.error
        return ticket.result

    def scan(self, reader, plan: ScanPlan, blooms: Optional[Dict] = None,
             tenant: str = "default") -> ScanResult:
        return self.result(self.submit(tenant, reader, plan, blooms))

    def drain(self) -> int:
        done = 0
        while self.active:
            done += self.tick()
        return done

    # ------------------------------------------------------------------
    # failure / drain
    # ------------------------------------------------------------------
    def fail_pod(self, pod_id: str, silent: bool = False) -> None:
        """Kill one pod.  `silent=True` models a crash the fabric only
        notices by heartbeat silence (drained after the timeout);
        otherwise the drain runs immediately."""
        assert pod_id in self._live, pod_id
        if silent:
            self._silent.add(pod_id)
            # the crashed pod's store now refuses probes by raising —
            # exactly what a sibling's peer fetch racing the crash sees
            self.pods[pod_id].store.dead = True
        else:
            self._drain_pod(pod_id)

    def inject_faults(self, pod_id: str, plan, policy=None) -> None:
        """Install a fault plan on ONE pod's storage path (the other pods
        keep clean reads) — the per-pod chaos knob the breaker-drain and
        straggler tests drive."""
        self.pods[pod_id].install_faults(plan, policy)

    def _drain_pod(self, dead: str) -> None:
        """Remove `dead` from the fleet and replay its uncollected work.

        The ring mutation moves ONLY the dead pod's arcs (HashRing's
        minimal-movement property), so survivors keep their ownership and
        their caches stay warm.  Every active ticket with an uncollected
        sub-scan on the dead pod re-partitions THAT SUB'S row groups over
        the new ring — collected parts are fabric-held and survive, which
        is what makes post-drain results still bit-identical."""
        owned: List[str] = []
        in_flight: List[object] = []
        lost: List[Tuple[FabricTicket, List[_SubScan]]] = []
        for t in self.active:
            # match by the sub's pod_id, not the dict key — a replay from
            # an EARLIER drain rides under a suffixed key
            dead_subs = [k for k, s in t.subs.items() if s.pod_id == dead]
            if dead_subs:
                subs = [t.subs.pop(k) for k in dead_subs]
                lost.append((t, subs))
                for s in subs:
                    owned.extend(rg_key(t.reader.path, rg) for rg in s.rgs)
                in_flight.append(t.req_id)
        plan = plan_pod_drain(dead, self.ring, owned, in_flight)
        self.drains.append(plan)
        self._live.remove(dead)
        self._silent.discard(dead)
        self.monitor.last_seen.pop(dead, None)
        for t, subs in lost:
            t.replays += 1
            # re-partition each lost slice over the survivors; merging
            # with an existing sub on the same pod would break the
            # pod-side in-order contract, so a replay rides as its own
            # sub-scan under a suffixed dict key
            for s in subs:
                for pid, sub_rgs in self._partition(t.reader.path, s.rgs):
                    key = pid if pid not in t.subs else f"{pid}#replay{t.replays}"
                    while key in t.subs:
                        key += "+"
                    t.subs[key] = self._submit_sub(t, pid, sub_rgs)

    # ------------------------------------------------------------------
    # fleet fairness
    # ------------------------------------------------------------------
    def _rebalance_vtime(self) -> None:
        """Re-level per-pod WFQ clocks with fleet-wide consumption.

        Each pod's virtual time only sees the decode-seconds IT charged;
        a tenant whose requests land on several pods would otherwise get
        one fresh WFQ clock per pod (N-fold share).  Every tick, each
        pod charges its QUEUED tenants the occupancy those tenants
        accrued on OTHER pods since the last tick (scheduled + reconciled
        + retention seconds — the same currency _vcharge uses), divided
        by the tenant's weight on the charging pod.  Idle tenants are
        skipped: vtime only orders tenants who are contending here."""
        deltas: Dict[str, Dict[str, float]] = {}
        for pid in self._live:
            tel = self.pods[pid].telemetry
            d: Dict[str, float] = {}
            for tenant in tel.known_tenants():
                occ = (tel.tenant_sched_seconds.get(tenant, 0.0)
                       + tel.tenant_recon_seconds.get(tenant, 0.0)
                       + tel.tenant_retained_seconds.get(tenant, 0.0))
                prev = self._occ_seen.get((pid, tenant), 0.0)
                if occ != prev:
                    d[tenant] = occ - prev
                    self._occ_seen[(pid, tenant)] = occ
            deltas[pid] = d
        for pid in self._live:
            pod = self.pods[pid]
            if pod.scheduler != "wfq":
                continue
            queued = {r.tenant for r in pod.queue if r.ticket.status == "queued"}
            for tenant in queued:
                foreign = sum(d.get(tenant, 0.0)
                              for q, d in deltas.items() if q != pid)
                if foreign > 0.0:
                    pod._vtime[tenant] = (
                        pod._vtime.get(tenant, 0.0)
                        + foreign / pod._weight(tenant)
                    )
                    pod.telemetry.inc("fleet_vtime_charges")
                    pod.telemetry.inc("fleet_vtime_seconds", foreign)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def report(self) -> dict:
        """Fleet roll-up: per-pod telemetry snapshots plus the fabric's
        own counters (peer traffic, drains, straggler timings)."""
        pods = {pid: self.pods[pid].telemetry.snapshot() for pid in self._live}
        peer = {
            pid: {
                "peer_hits": self.pods[pid].store.peer_hits,
                "peer_hit_bytes": self.pods[pid].store.peer_hit_bytes,
                "peer_hit_seconds": self.pods[pid].store.peer_hit_seconds,
                "peer_serves": self.pods[pid].store.peer_serves,
                "peer_serve_bytes": self.pods[pid].store.peer_serve_bytes,
            }
            for pid in self._live
        }
        return {
            "tick": self._tick,
            "live_pods": list(self._live),
            "drains": [
                {"dead": p.dead, "survivors": p.survivors,
                 "reassigned": len(p.reassigned), "replayed": len(p.replay)}
                for p in self.drains
            ],
            "breaker_drains": self.breaker_drains,
            "pods": pods,
            "peer": peer,
            "stragglers": self.stragglers.report(),
        }


def _merge_stats(parts: List[ScanStats], reader) -> ScanStats:
    """Sum sub-scan stats into one fleet-level ScanStats: numeric fields
    add, dict fields merge-add, bools OR.  rows_out is overwritten by the
    merge's final count; totals reflect the whole table."""
    out = ScanStats(row_groups_total=reader.n_row_groups,
                    rows_total=reader.n_rows)
    for s in parts:
        for f in dataclasses.fields(ScanStats):
            if f.name in ("row_groups_total", "rows_total"):
                continue
            v = getattr(s, f.name)
            cur = getattr(out, f.name)
            if isinstance(v, bool):
                setattr(out, f.name, cur or v)
            elif isinstance(v, dict):
                for k, n in v.items():
                    cur[k] = cur.get(k, 0) + n
            elif isinstance(v, (int, float)):
                setattr(out, f.name, cur + v)
    return out
