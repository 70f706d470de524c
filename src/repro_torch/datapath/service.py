"""Pod — the SmartNIC as a shared, multi-tenant appliance.

The seed engine was a synchronous per-caller library (`engine.scan()`);
the paper's vision is a device on the network datapath serving MANY
queries at once.  This module is that service layer.  Since the fabric
refactor the single-node core is the `Pod` class — one scheduler, one
block store, one netsim clock, one telemetry sink — and
`DatapathService` is a back-compat alias (a one-pod deployment IS the
old service, bit for bit).  `datapath/fabric.py` composes N pods behind
consistent-hash row-group ownership; each pod stays deterministically
single-threaded, which is what keeps fabric results bit-identical to
single-node scans.

  submit()  bounded-queue admission with per-tenant byte/row quotas,
            estimated from footer metadata only (zone maps + encoded
            sizes) — nothing is fetched or decoded to say "no"
  tick()    the scheduler forms one fair-share batch (weighted fair
            queueing over estimated decode-SECONDS from the calibrated
            encoding-aware cost model, reconciled against actual decode
            cost at slice completion, row-group preemption points,
            cross-tick coalescing holds — scheduler.py), hands each
            request's slice to the engine as ONE bucketed batch decode
            (batch_decode=True: one kernel launch per (encoding, k,
            dtype) bucket instead of one per (row group, column)) and
            runs it
            around a window-scoped view into the unified BlockStore's
            decoded tier, so each (row group, column) pair is decoded
            once per tick AND stays pinned for hold_ticks more ticks
            (late partners reuse instead of re-decoding; retained bytes
            bill the holder's virtual time)
  client()  an engine-compatible adapter (`.scan(reader, plan)`) so the
            whole query suite in core/queries.py runs through the
            service unchanged

Everything is deterministically single-threaded: "concurrency" is queue
depth per tick, which keeps service results bit-identical to direct
engine scans (tests/test_torch_service.py and tests/test_torch_scheduler.py
assert this, including for scans sliced across ticks).

Port copy of `repro.datapath.service`, kept in step with it.  What differs:

  engine     a pod built without one gets `DatapathEngine(cache=
             BlockCache())`, which runs on the card and raises without one
             (the port never falls back to the CPU unasked); tests pass a
             `device="cpu"` engine
  pricing    a pod built without a cost model gets the nominal table keyed
             by its engine's device (`costmodel.active_backend`: "cuda",
             "cpu" or "host"), so a CPU pod never reports a "cuda" table;
             the nominal rates are the same under every key
  clocks     the card runs kernels after the host enqueues them, so on the
             card `tick()` synchronizes the engine's device once before it
             reads the clock: tick seconds and request latencies measure
             completed work, and no result changes
  faults     a kernel's build or launch failure, or a CUDA error raised by
             torch, propagates out of `tick()` and lands on no ticket
             (scheduler.py)
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.cache import BlockCache
from repro_torch.core.engine import DatapathEngine, ScanResult
from repro_torch.core.plan import ScanPlan, bind_expr
from repro_torch.core.zonemap import prune_and_estimate
from repro_torch.datapath.blockstore import BlockStore
from repro_torch.datapath.costmodel import CostModel, active_backend
from repro_torch.datapath.faults import (
    CircuitBreaker,
    FaultInjector,
    FaultPlan,
    Overloaded,
    RetryPolicy,
)
from repro_torch.datapath.netsim import PrefetchPipeline, SliceClock
from repro_torch.datapath.policy import AdaptiveOffloadPolicy
from repro_torch.datapath.scheduler import form_batch, run_tick
from repro_torch.datapath.telemetry import Telemetry, quantile
from repro_torch.datapath.trace import Tracer


class QueueFull(RuntimeError):
    """Admission control: the service queue is at max depth."""


class QuotaExceeded(RuntimeError):
    """Admission control: the tenant is over its byte or row budget."""


@dataclasses.dataclass
class TenantQuota:
    """Per-quota-window budgets plus the tenant's fair-share weight.  Bytes
    are *encoded* bytes pulled over the storage->NIC hop (what the
    appliance actually meters); rows are estimated output rows; `weight`
    scales the tenant's share of each tick's decode capacity under the WFQ
    scheduler (virtual time advances by estimated decode-seconds / weight,
    reconciled against actual decode cost at slice completion)."""

    max_bytes: int = 1 << 40
    max_rows: int = 1 << 40
    weight: float = 1.0


@dataclasses.dataclass
class _TenantState:
    used_bytes: int = 0
    used_rows: int = 0

    def reset(self) -> None:
        self.used_bytes = 0
        self.used_rows = 0


@dataclasses.dataclass
class Ticket:
    req_id: int
    tenant: str
    status: str = "queued"  # queued | done | error
    result: Optional[ScanResult] = None
    error: Optional[BaseException] = None
    submitted_s: float = 0.0
    done_s: float = 0.0
    submitted_tick: int = 0  # service tick counter at admission
    done_tick: int = 0  # tick on which the request reached a terminal state


@dataclasses.dataclass
class ScanRequest:
    req_id: int
    tenant: str
    reader: object
    plan: ScanPlan
    blooms: Optional[Dict]
    ticket: Ticket
    est_bytes: int = 0
    est_rows: int = 0
    # bound predicate + surviving row groups, computed once at admission and
    # reused by the scheduler's fetch simulation (no repeat footer walks)
    pred: object = None
    row_groups: tuple = ()
    # -- scheduler state (datapath/scheduler.py) -----------------------------
    rg_costs: tuple = ()  # estimated decode-SECONDS per row group (WFQ charge)
    rg_bytes: tuple = ()  # estimated decoded bytes per row group (tick budget)
    rg_set: frozenset = frozenset()  # hold-window footprint: row groups
    col_set: frozenset = frozenset()  # hold-window footprint: columns
    cursor: int = 0  # next row-group index to dispatch
    charged_s: float = 0.0  # decode-seconds charged for not-yet-reconciled slices
    charged_raw_s: float = 0.0  # same charges before the adaptive scale
    started: bool = False  # first slice has been dispatched
    held_ticks: int = 0  # ticks spent waiting for a coalescing partner
    release_counted: bool = False  # hold_released already recorded
    first_tick: int = 0  # tick of the first dispatched slice
    mode: Optional[str] = None  # offload mode pinned at first dispatch
    rs: object = None  # ResumableScan, created at first dispatch
    # fabric: disambiguates a sub-scan's prefiltered-cache identity from the
    # whole-table scan (and from other row-group subsets after a drain
    # re-partitions ownership) — threaded into every plan_cache_key
    scan_tag: object = None


class Pod:
    """One single-node scan service: scheduler + block store + netsim
    clock + telemetry behind an admission-controlled queue.  `pod_id`
    names the pod inside a ScanFabric (peer-fetch attribution, hash-ring
    membership); a standalone pod keeps the default and never notices."""

    def __init__(
        self,
        engine: Optional[DatapathEngine] = None,
        max_queue_depth: int = 64,
        batch_per_tick: int = 8,
        quota_window_ticks: int = 16,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        default_quota: Optional[TenantQuota] = None,
        policy=None,
        pipeline: Optional[PrefetchPipeline] = None,
        telemetry: Optional[Telemetry] = None,
        pool_bytes: int = 1 << 30,  # per-tick decode-window pin budget
        scheduler: str = "wfq",  # "wfq" | "fifo" (seed behavior, for A/B)
        tick_bytes: Optional[int] = None,  # per-tick decoded-byte budget
        # cross-tick coalescing window: 0 = off, N = hold up to N ticks,
        # "auto" = tuned from observed footprint-recurrence gaps
        hold_ticks: Union[int, str] = 0,
        cost_model: Optional[CostModel] = None,  # encoding-aware decode pricing
        reconcile: bool = True,  # re-bill vtime by actual decode cost
        # bucketed batch decode: each WFQ slice decodes in one kernel
        # launch per (encoding, k, dtype) bucket instead of one per
        # (row group, column) — bit-identical results, ~4-100x fewer
        # device dispatches.  False = the seed per-row-group loop (kept
        # for A/B in benchmarks/service_bench.py `batchdecode`).
        batch_decode: bool = True,
        # flight recorder (datapath/trace.py): fraction of requests that
        # carry a span tree (deterministic sampler, 0.0 = tracing off and
        # allocation-free) and how many completed traces the bounded ring
        # retains.  `tracer` injects a pre-built Tracer (e.g. with a fake
        # clock for deterministic tests) and overrides both knobs.
        trace_sample_rate: float = 1.0,
        trace_capacity: int = 64,
        tracer: Optional[Tracer] = None,
        # storage fault plane (datapath/faults.py, DESIGN.md §17): a
        # FaultPlan installs the deterministic injector on the engine's
        # storage-read seam; a RetryPolicy alone still installs it (clean
        # plan) so retries/timeouts/hedging and checksum verification run
        # against real storage faults too.  The breaker defaults on
        # whenever the injector is installed.
        fault_plan: Optional[FaultPlan] = None,
        retry_policy: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        pod_id: str = "pod0",
    ):
        assert scheduler in ("wfq", "fifo"), scheduler
        self.pod_id = pod_id
        assert hold_ticks == "auto" or int(hold_ticks) >= 0, hold_ticks
        self.engine = engine or DatapathEngine(cache=BlockCache())
        self.max_queue_depth = max_queue_depth
        self.batch_per_tick = batch_per_tick
        self.quota_window_ticks = quota_window_ticks
        self.quotas = dict(quotas or {})
        self.default_quota = default_quota or TenantQuota()
        self.policy = policy if policy is not None else AdaptiveOffloadPolicy()
        self.cost_model = cost_model or CostModel(
            backend=active_backend(self.engine.device, self.engine.backend))
        # register as the process-default table so default-constructed
        # netsim models (DecodeModel()/PrefetchPipeline()) price decode
        # from the same per-backend table the scheduler charges with
        from repro_torch.datapath import costmodel as _costmodel_mod

        _costmodel_mod.set_default_cost_model(self.cost_model)
        self.reconcile = reconcile
        self.batch_decode = batch_decode
        # scheduler and netsim share one calibrated table unless the caller
        # injects a bespoke pipeline
        self.pipeline = pipeline or self.cost_model.pipeline()
        # cross-tick fetch/decode pipeline clock for batched dispatch: one
        # slice per tick means per-tick simulation can never see the next
        # slice's fetch hiding behind this slice's batch decode — the
        # streaming clock can (telemetry sim_pipe_* counters)
        self.slice_clock = SliceClock(self.pipeline.link) if batch_decode else None
        self.pool_bytes = pool_bytes
        self.scheduler = scheduler
        self.tick_bytes = tick_bytes
        self.hold_auto = hold_ticks == "auto"
        self.hold_ticks = 0 if self.hold_auto else int(hold_ticks)
        self.telemetry = telemetry or Telemetry()
        # per-request flight recorder; None when sampling is fully off so
        # every trace touchpoint is a single attribute check
        if tracer is not None:
            self.tracer: Optional[Tracer] = tracer
        elif trace_sample_rate > 0.0:
            self.tracer = Tracer(capacity=trace_capacity,
                                 sample_rate=trace_sample_rate)
        else:
            self.tracer = None
        self.telemetry.tracer = self.tracer
        # ONE tiered store backs the engine's cache, the scheduler's decode
        # windows, and the policy's residency probes — a single byte ledger
        # priced by the service's cost model (an engine with a bespoke
        # cache still gets a private store for window coalescing)
        self.store: BlockStore = (
            getattr(self.engine.cache, "store", None) or BlockStore()
        )
        self.store.cost_model = self.cost_model
        self.telemetry.store = self.store
        self.queue: List[ScanRequest] = []
        self._tenants: Dict[str, _TenantState] = {}
        self._vtime: Dict[str, float] = {}  # WFQ virtual time, decode-s/weight
        # EWMA of actual/estimated decode cost, applied at charge time: a
        # tenant whose scans systematically under-estimate is re-priced at
        # dispatch (not only retroactively), closing the within-tick window
        # where a stale estimate could still buy extra slots.  The tenant-
        # level scale is the fallback; per-(tenant, table) scales keep one
        # lying table from re-pricing the same tenant's honest tables.
        self._est_scale: Dict[str, float] = {}
        self._est_scale_table: Dict[Tuple[str, str], float] = {}
        # footprint-recurrence log driving the "auto" hold window
        self._footprints: collections.deque = collections.deque(maxlen=64)
        self._recur_gaps: collections.deque = collections.deque(maxlen=32)
        self._ids = itertools.count()
        self._tick = 0
        # -- storage fault plane -------------------------------------------
        self.breaker = breaker
        self.retry_policy = retry_policy
        self.faults: Optional[FaultInjector] = None
        if fault_plan is not None or retry_policy is not None:
            self.install_faults(fault_plan or FaultPlan(), retry_policy)
        # cost-model provenance into telemetry (one-time nominal-link
        # warning when the per-backend JSON never calibrated the link)
        self.telemetry.note_costmodel(self.cost_model)

    EST_SCALE_ALPHA = 0.5  # EWMA weight of the newest slice's observed error
    EST_SCALE_CLAMP = 64.0  # bound on the adaptive dispatch-time scale
    HOLD_AUTO_MAX = 4  # ceiling on the auto-tuned coalescing window
    HOLD_AUTO_MIN_RECUR = 0.25  # recurrence rate below which holding is off

    # ------------------------------------------------------------------
    # storage fault plane
    # ------------------------------------------------------------------
    def install_faults(self, plan: FaultPlan,
                       policy: Optional[RetryPolicy] = None) -> None:
        """Install (or replace) the fault injector on the engine's storage
        read seam.  Idempotent per pod; the fabric's `inject_faults` routes
        here for per-pod chaos."""
        self.retry_policy = policy or self.retry_policy or RetryPolicy()
        if self.breaker is None:
            self.breaker = CircuitBreaker()
        self.faults = FaultInjector(
            plan, self.retry_policy, link=self.cost_model.link_model(),
            pod_id=self.pod_id, telemetry=self.telemetry,
            breaker=self.breaker, clock=lambda: self._tick,
        )
        self.engine.faults = self.faults

    def breaker_open(self) -> bool:
        """Any storage target's circuit breaker currently open?  The
        fabric polls this each tick: an open breaker evicts the pod from
        the fleet exactly like heartbeat silence (drain + replay)."""
        return self.breaker is not None and self.breaker.any_open()

    def _choose_mode(self, req: ScanRequest) -> str:
        """Offload mode for a request's first dispatch — the ONE place
        both scheduler paths (sequential run_tick and the stacked group
        pass) decide it.  An open breaker on the request's table degrades
        to raw offload: no caching ambitions, minimum bytes at risk,
        while recovery probes decide when to trust the target again."""
        if self.breaker is not None and self.breaker.degraded(req.reader.path):
            self.telemetry.inc("breaker_degraded_dispatches")
            return "raw"
        return self.policy.choose(
            self.engine, req.reader, req.plan, req.blooms,
            row_groups=req.row_groups,
            selectivity=req.est_rows / max(req.reader.n_rows, 1),
            scan_tag=req.scan_tag,
        )

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def _state(self, tenant: str) -> _TenantState:
        return self._tenants.setdefault(tenant, _TenantState())

    def _weight(self, tenant: str) -> float:
        return max(self._quota(tenant).weight, 1e-9)

    def _scale_for(self, tenant: str, table: Optional[str] = None) -> float:
        """Dispatch-time estimate-error scale: the (tenant, table) EWMA when
        that table has reconciled slices, else the tenant-level blend — an
        unseen table inherits the tenant's history rather than scale 1.0."""
        if table is not None:
            s = self._est_scale_table.get((tenant, table))
            if s is not None:
                return s
        return self._est_scale.get(tenant, 1.0)

    def _vcharge(self, tenant: str, seconds: float, nbytes: float,
                 table: Optional[str] = None) -> float:
        """Advance `tenant`'s virtual time by a dispatched row group's
        estimated decode-SECONDS over its weight (the WFQ clock is device
        time, not nominal bytes — an RLE group is cheaper than PLAIN).
        The estimate is re-priced by the observed estimate-error scale of
        the (tenant, table) pair before charging; returns the seconds
        actually charged."""
        charged = seconds * self._scale_for(tenant, table)
        self._vtime[tenant] = self._vtime.get(tenant, 0.0) + charged / self._weight(tenant)
        self.telemetry.observe_sched(tenant, charged, nbytes)
        return charged

    def _vreconcile(self, tenant: str, charged_s: float, raw_s: float,
                    actual_seconds: float, table: Optional[str] = None) -> None:
        """Re-bill `tenant`'s virtual time by a completed slice's ACTUAL
        decode cost: `charged_s` was charged at dispatch, so apply only
        the difference (positive for under-estimates — a tenant whose
        scans under-price cannot buy extra share; negative refunds
        over-estimates, e.g. cache-resident slices that decoded nothing).
        Same estimate-then-correct pattern the quota path uses for encoded
        bytes.  The clamp keeps virtual time non-negative under any
        correction ordering.

        `raw_s` is the slice's pre-scale estimate; actual/raw drives the
        EWMA dispatch-time scale so a SYSTEMATIC mis-estimate stops paying
        off after its first reconciled slice, instead of re-buying a
        within-tick advantage every tick."""
        self.telemetry.observe_actual_cost(tenant, actual_seconds)
        if not self.reconcile:
            return
        correction = actual_seconds - charged_s
        if correction != 0.0:
            self._vtime[tenant] = max(
                0.0, self._vtime.get(tenant, 0.0) + correction / self._weight(tenant)
            )
            self.telemetry.observe_recon(tenant, correction)
        # Only slices that did real decode work train the scale: a cache/
        # pool-resident slice (actual == 0) is a scheduling outcome, not an
        # estimate error — folding it in would drive the scale to the floor
        # and let the tenant's next FRESH scan monopolize ticks at a
        # near-zero dispatch price.
        if raw_s > 0.0 and actual_seconds > 0.0:
            target = min(max(actual_seconds / raw_s, 1.0 / self.EST_SCALE_CLAMP),
                         self.EST_SCALE_CLAMP)
            a = self.EST_SCALE_ALPHA
            prev = self._est_scale.get(tenant, 1.0)
            self._est_scale[tenant] = (1.0 - a) * prev + a * target
            if table is not None:
                # the per-table scale trains on the same slices but never
                # blends across tables: one lying table cannot re-price a
                # tenant's honest tables (ROADMAP per-(tenant, table) item)
                prev_t = self._est_scale_table.get((tenant, table), 1.0)
                self._est_scale_table[(tenant, table)] = (1.0 - a) * prev_t + a * target

    def submit(self, tenant: str, reader, plan: ScanPlan, blooms: Optional[Dict] = None,
               row_groups=None, scan_tag=None) -> Ticket:
        """Admit one scan request or raise (QueueFull / QuotaExceeded).
        Cost estimates are metadata-only — no data bytes move on rejection.

        `row_groups` restricts the scan to a subset of the table's row
        groups (the fabric routes each pod only the groups it owns);
        pruning still runs first and the pruned order is preserved, so a
        restricted scan decodes exactly the intersection.  `scan_tag`
        disambiguates the request's prefiltered-cache identity — fabric
        sub-scans tag with their row-group subset so a cached sub-result
        can never serve a DIFFERENT subset after a drain re-partitions."""
        tr = self.tracer
        t_tr0 = tr.clock() if tr is not None else 0.0  # trace time base
        self.telemetry.inc("submitted")
        if len(self.queue) >= self.max_queue_depth:
            self.telemetry.inc("rejected_queue_full")
            raise QueueFull(
                f"queue at max depth {self.max_queue_depth}; tenant={tenant!r}"
            )
        if self.breaker is not None:
            # Graceful degradation instead of queue collapse: while the
            # table's storage target is tripped open, requests still admit
            # in degraded (raw) mode — but once the queue nears capacity
            # they shed with a typed Overloaded, and after the cooldown
            # one admission becomes the half-open recovery probe.
            path = getattr(reader, "path", str(reader))
            verdict = self.breaker.admit(
                path, self._tick,
                queue_frac=len(self.queue) / max(self.max_queue_depth, 1),
            )
            if verdict == "shed":
                self.telemetry.inc("rejected_overloaded")
                raise Overloaded(
                    f"storage target {path!r} breaker open and queue at "
                    f"{len(self.queue)}/{self.max_queue_depth}; "
                    f"tenant={tenant!r} — retry after cooldown"
                )
            if verdict == "probe":
                self.telemetry.inc("breaker_probes")
            elif verdict == "degraded":
                self.telemetry.inc("breaker_degraded_admits")

        pred = bind_expr(plan.predicate, reader)
        rgs, selectivity = prune_and_estimate(reader, pred)
        rgs = tuple(rgs)
        if row_groups is not None:
            allowed = frozenset(row_groups)
            rgs = tuple(rg for rg in rgs if rg in allowed)
        est_bytes = self.engine.estimate_scan_bytes(reader, plan, row_groups=rgs)
        if row_groups is None:
            est_rows = int(selectivity * reader.n_rows)
        else:
            # estimate against the restricted slice of the table, not the
            # whole file — a pod owning 1/N of the groups budgets ~1/N rows
            rows_in = sum(reader.row_group_meta(rg)["n"] for rg in rgs)
            est_rows = int(selectivity * rows_in)
        quota, state = self._quota(tenant), self._state(tenant)
        over_bytes = state.used_bytes + est_bytes > quota.max_bytes
        over_rows = state.used_rows + est_rows > quota.max_rows
        if (over_bytes or over_rows) and not self.queue:
            # Idle service: empty ticks would advance the window with nothing
            # to schedule, so fast-forward to the boundary and refill rather
            # than locking a quota-exhausted tenant out forever.  Quotas
            # still bind whenever there is queued work to arbitrate.
            self._tick += self.quota_window_ticks - (self._tick % self.quota_window_ticks)
            for s in self._tenants.values():
                s.reset()
            over_bytes = est_bytes > quota.max_bytes
            over_rows = est_rows > quota.max_rows
        if over_bytes:
            self.telemetry.inc("rejected_quota_bytes")
            raise QuotaExceeded(
                f"tenant {tenant!r}: {est_bytes}B would exceed byte budget "
                f"({state.used_bytes}/{quota.max_bytes} used this window)"
            )
        if over_rows:
            self.telemetry.inc("rejected_quota_rows")
            raise QuotaExceeded(
                f"tenant {tenant!r}: ~{est_rows} rows would exceed row budget "
                f"({state.used_rows}/{quota.max_rows} used this window)"
            )
        state.used_bytes += est_bytes
        state.used_rows += est_rows

        # WFQ bookkeeping: an idle service starts a fresh round; a tenant
        # joining a busy service starts at the backlog's virtual clock so it
        # cannot cash in credit hoarded while idle.
        if not self.queue:
            self._vtime.clear()
        else:
            vclock = min(self._vtime.get(r.tenant, 0.0) for r in self.queue)
            self._vtime[tenant] = max(self._vtime.get(tenant, 0.0), vclock)

        ticket = Ticket(next(self._ids), tenant, submitted_s=time.perf_counter(),
                        submitted_tick=self._tick)
        rg_costs = self.cost_model.estimate_row_groups(
            self.engine, reader, plan, rgs, pred=pred
        )
        if self.hold_auto and rgs:
            self._observe_footprint(reader.path, frozenset(rgs),
                                    frozenset(plan.all_columns()))
        self.queue.append(
            ScanRequest(ticket.req_id, tenant, reader, plan, blooms, ticket,
                        est_bytes=est_bytes, est_rows=est_rows,
                        pred=pred, row_groups=rgs,
                        rg_costs=tuple(c.seconds for c in rg_costs),
                        rg_bytes=tuple(c.nbytes for c in rg_costs),
                        rg_set=frozenset(rgs),
                        col_set=frozenset(plan.all_columns()),
                        scan_tag=scan_tag)
        )
        self.telemetry.inc("admitted")
        # flight recorder: open the request's root span at submit entry,
        # record admission as a closed child (estimate + quota work), and
        # start the queued-wait clock — run_tick closes it at dispatch
        if tr is not None:
            rt = tr.start(ticket.req_id, tenant, reader.path, t0=t_tr0,
                          submitted_tick=ticket.submitted_tick)
            if rt is not None:
                tr.add_span(rt, "admission", t_tr0, tr.clock(),
                            est_bytes=est_bytes, est_rows=est_rows,
                            row_groups=len(rgs))
                tr.wait(rt, "wfq_wait", tick=self._tick)
        return ticket

    # ------------------------------------------------------------------
    # auto-tuned coalescing window
    # ------------------------------------------------------------------
    def _observe_footprint(self, path: str, rg_set: frozenset,
                           col_set: frozenset) -> None:
        """Feed the hold-window auto-tuner one admitted footprint: the gap
        (in ticks) to the most recent overlapping footprint is a recurrence
        sample; no overlap is a one-off sample.  The window opens only when
        partners actually recur (rate >= HOLD_AUTO_MIN_RECUR) and is sized
        to cover the typical gap (p75, capped) — hold longer when a partner
        is likely, not at all for one-off footprints."""
        gap = None
        for tk, p, rgs, cols in reversed(self._footprints):
            if p == path and (rgs & rg_set) and (cols & col_set):
                gap = self._tick - tk
                break
        self._recur_gaps.append(gap)
        self._footprints.append((self._tick, path, rg_set, col_set))
        gaps = [float(g) for g in self._recur_gaps if g is not None]
        if gaps and len(gaps) / len(self._recur_gaps) >= self.HOLD_AUTO_MIN_RECUR:
            self.hold_ticks = min(self.HOLD_AUTO_MAX, int(quantile(gaps, 0.75)))
        else:
            self.hold_ticks = 0
        self.telemetry.counters["hold_ticks_auto"] = float(self.hold_ticks)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """Process one scheduler tick: form a fair-share batch of row-group
        slices (scheduler.form_batch) and execute it coalesced.  A request
        completes the tick its last row group lands; a large scan may span
        many ticks (preemption points).  Returns requests completed."""
        self._tick += 1
        # expire decode-window pins whose hold window ended (ephemeral raw
        # decodes drop; promoted entries merely become evictable)
        self.store.advance_tick(self._tick)
        # retention isn't free: decoded bytes a tenant keeps window-pinned
        # across a tick boundary bill its virtual time at a rate that sums
        # to one re-decode over the full window (blockstore.retention_charges)
        for tenant, (nbytes, charge_s) in sorted(self.store.retention_charges().items()):
            self._vtime[tenant] = (
                self._vtime.get(tenant, 0.0) + charge_s / self._weight(tenant)
            )
            self.telemetry.observe_retained(tenant, nbytes, charge_s)
        if self._tick % self.quota_window_ticks == 0:  # window boundary: refill
            for state in self._tenants.values():
                state.reset()
        self.telemetry.sample_queue_depth(len(self.queue))
        if not self.queue:
            return 0
        batch = form_batch(self)
        t0 = time.perf_counter()
        if batch:
            run_tick(self, batch)
        if self.engine.device.type == "cuda":
            # a slice that did not complete ends with kernels still queued:
            # wait for them, so the tick's seconds are the card's work
            torch.cuda.synchronize(self.engine.device)
        now = time.perf_counter()
        self.telemetry.observe_tick(now - t0)
        done: List[ScanRequest] = []
        failed = 0
        for req in self.queue:
            if req.ticket.error is None and (req.rs is None or req.rs.result is None):
                continue  # still in flight (or held) — stays queued
            done.append(req)
            req.ticket.status = "error" if req.ticket.error is not None else "done"
            req.ticket.done_s = now
            req.ticket.done_tick = self._tick
            self.telemetry.observe_latency(req.tenant, now - req.ticket.submitted_s)
            failed += req.ticket.status == "error"
            if self._tick > req.first_tick > 0:
                self.telemetry.inc("split_scans")  # preempted across ticks
            res = req.ticket.result
            if self.tracer is not None:
                # close the root span at the request's terminal tick and
                # push the trace into the flight recorder's bounded ring
                self.tracer.finish(
                    req.req_id, req.ticket.status, done_tick=self._tick,
                    mode=req.mode or "", held_ticks=req.held_ticks,
                    rows_out=res.stats.rows_out if res is not None else 0,
                )
            if res is not None:
                # reconcile the admission estimate against bytes actually
                # pulled: cache-resident and pool-coalesced scans fetch less
                # (often zero), and quotas meter the storage->NIC hop
                state = self._state(req.tenant)
                over_b = req.est_bytes - res.stats.encoded_bytes
                if over_b > 0:
                    state.used_bytes = max(0, state.used_bytes - over_b)
                over_r = req.est_rows - res.stats.rows_out
                if over_r > 0:
                    state.used_rows = max(0, state.used_rows - over_r)
        if done:
            done_ids = {r.req_id for r in done}
            self.queue = [r for r in self.queue if r.req_id not in done_ids]
        self.telemetry.inc("completed", len(done) - failed)
        return len(done)

    def drain(self) -> int:
        """Tick until the queue is empty; returns requests completed."""
        done = 0
        while self.queue:
            done += self.tick()
        return done

    def result(self, ticket: Ticket) -> ScanResult:
        while ticket.status == "queued":
            if not self.queue:
                raise RuntimeError(f"ticket {ticket.req_id} queued but queue is empty")
            self.tick()
        if ticket.status == "error":
            raise ticket.error
        return ticket.result

    def client(self, tenant: str = "default") -> "ServiceClient":
        return ServiceClient(self, tenant)


class DatapathService(Pod):
    """The historical single-node name.  A one-pod deployment is exactly
    the old service — same defaults, same scheduling, same bit-identical
    results — so existing callers and tests keep constructing this."""


class ServiceClient:
    """Engine-compatible facade: `.scan(reader, plan, blooms)` routes the
    scan through the shared service, so any code written against
    DatapathEngine (all six queries in core/queries.py) runs through the
    multi-tenant path unchanged."""

    def __init__(self, service: Pod, tenant: str):
        self.service = service
        self.tenant = tenant

    @property
    def backend(self) -> str:
        return self.service.engine.backend

    @property
    def cache(self) -> BlockCache:
        return self.service.engine.cache

    def scan(self, reader, plan: ScanPlan, blooms: Optional[Dict] = None) -> ScanResult:
        ticket = self.service.submit(self.tenant, reader, plan, blooms)
        return self.service.result(ticket)
