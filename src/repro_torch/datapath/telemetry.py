"""Service telemetry: queue depth, coalescing savings, per-tenant latency,
and fair-share metrics.

The paper's SmartNIC is a shared appliance, so the numbers an operator
needs are fleet numbers: how deep the queue runs, how many decoded bytes
shared-scan coalescing saved, what tick latency each tenant sees at
p50/p99 — and, with the WFQ scheduler (DESIGN.md §9), whether decode
capacity is actually being split by weight: per-tenant decoded-byte
shares, a Jain fairness index, and how much latency the cross-tick
coalescing hold window added.  Everything here is plain Python — it must
stay cheap enough to record on every tick.

Port copy of `repro.datapath.telemetry` (stdlib only), kept in step with
it; the port never imports the JAX package.  The one difference is where a
tick's seconds come from: on the card the pod synchronizes the engine's
device before it reads the clock (service.Pod.tick), so tick and request
latencies measure completed kernels, not enqueued ones.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional


def quantile(xs: List[float], q: float) -> float:
    """Nearest-rank quantile of an unsorted list.  `q` is clamped to
    [0, 1]; q=0 is the minimum, q=1 the maximum, and the half-way rank
    rounds UP (half-up, not banker's), so two-sample p50 is the larger
    sample on every platform — deterministic run-to-run."""
    if not xs:
        return 0.0
    q = min(1.0, max(0.0, q))
    s = sorted(xs)
    idx = int(math.floor(q * (len(s) - 1) + 0.5))
    return s[min(len(s) - 1, max(0, idx))]


def jain_index(shares: List[float]) -> float:
    """Jain's fairness index over non-negative allocations: 1.0 when all
    equal, 1/n when one allocation takes everything.  Empty or all-zero
    input reads as perfectly fair (nothing was allocated unevenly)."""
    if not shares:
        return 1.0
    total = float(sum(shares))
    sq = float(sum(x * x for x in shares))
    if sq <= 0.0:
        return 1.0
    return (total * total) / (len(shares) * sq)


class Telemetry:
    def __init__(self, max_samples: int = 4096):
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.queue_depth: collections.deque = collections.deque(maxlen=max_samples)
        self._tenant_latency: Dict[str, collections.deque] = {}
        self._tick_seconds: collections.deque = collections.deque(maxlen=max_samples)
        self._max_samples = max_samples
        # fair-share accounting: actually-decoded bytes vs scheduler-charged
        # (estimated) bytes, per tenant
        self.tenant_decoded_bytes: Dict[str, float] = collections.defaultdict(float)
        self.tenant_sched_bytes: Dict[str, float] = collections.defaultdict(float)
        # time-domain WFQ currency: estimated decode-seconds charged at
        # dispatch, actual decode-seconds observed at slice completion, and
        # the reconciliation corrections applied to virtual time.  With
        # reconciliation on, sched + recon == actual per tenant (property-
        # tested in tests/test_torch_service_props.py).
        self.tenant_sched_seconds: Dict[str, float] = collections.defaultdict(float)
        self.tenant_actual_seconds: Dict[str, float] = collections.defaultdict(float)
        self.tenant_recon_seconds: Dict[str, float] = collections.defaultdict(float)
        # window-retention ledger: decoded byte-ticks a tenant kept pinned
        # across tick boundaries, and the virtual-time it was billed for them
        self.tenant_retained_bytes: Dict[str, float] = collections.defaultdict(float)
        self.tenant_retained_seconds: Dict[str, float] = collections.defaultdict(float)
        # fabric peer-fetch ledger: bytes a tenant's slices pulled over the
        # inter-pod hop (a sibling pod's block store served a local miss)
        # and the link seconds WFQ billed for them
        self.tenant_peer_bytes: Dict[str, float] = collections.defaultdict(float)
        self.tenant_peer_seconds: Dict[str, float] = collections.defaultdict(float)
        # the unified BlockStore, registered by the service so snapshots
        # carry the per-tier hit/eviction/retained ledger
        self.store = None
        # the flight recorder's Tracer (datapath/trace.py), registered by
        # the service so snapshots carry the per-request stage attribution
        self.tracer = None
        # fault-plane ledger: modeled seconds the storage fault plane added,
        # bucketed by cause (backoff / wasted / timeout / straggle /
        # hedge_saved), plus the per-tenant total so the WFQ honesty
        # invariant (sched + recon == actual) stays checkable under faults
        self.fault_seconds: Dict[str, float] = collections.defaultdict(float)
        self.tenant_fault_seconds: Dict[str, float] = collections.defaultdict(float)
        # one-shot warnings (emitted at most once per key, surfaced in the
        # snapshot so headless bench runs still record them)
        self._warnings: Dict[str, str] = {}
        # cost-model provenance, registered by the service at construction:
        # which backend the rate tables came from and whether the link model
        # is still running on nominal (uncalibrated) constants
        self.costmodel_info: Optional[dict] = None

    # -- recording ---------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depth.append(depth)

    def observe_tick(self, seconds: float) -> None:
        self._tick_seconds.append(seconds)

    def observe_latency(self, tenant: str, seconds: float) -> None:
        """One request's submit->complete wall latency for `tenant`."""
        dq = self._tenant_latency.setdefault(
            tenant, collections.deque(maxlen=self._max_samples)
        )
        dq.append(seconds)

    def observe_tenant_bytes(self, tenant: str, nbytes: float) -> None:
        """Decoded bytes materialized for `tenant` by one dispatched slice."""
        self.tenant_decoded_bytes[tenant] += nbytes

    def observe_sched(self, tenant: str, seconds: float, nbytes: float) -> None:
        """One dispatched row group's scheduler charge: estimated decode-
        seconds (the WFQ virtual-time currency) plus the estimated decoded
        bytes it corresponds to (the tick-budget currency)."""
        self.tenant_sched_seconds[tenant] += seconds
        self.tenant_sched_bytes[tenant] += nbytes

    def observe_actual_cost(self, tenant: str, seconds: float) -> None:
        """Actual decode cost of one completed slice (modeled from the
        bytes the engine really materialized) — recorded whether or not
        reconciliation is on, so estimate error is always reportable."""
        self.tenant_actual_seconds[tenant] += seconds

    def observe_recon(self, tenant: str, correction_s: float) -> None:
        """Virtual-time correction applied at slice completion (positive:
        the tenant under-estimated and is re-billed; negative: refund)."""
        self.tenant_recon_seconds[tenant] += correction_s
        self.inc("recon_slices")
        self.inc("recon_abs_seconds", abs(correction_s))

    def observe_retained(self, tenant: str, nbytes: float, charge_s: float) -> None:
        """One tick's window-retention bill for `tenant`: the decoded bytes
        it kept pinned across the tick boundary (a byte-tick of occupancy)
        and the virtual-time charge the scheduler applied for them."""
        self.tenant_retained_bytes[tenant] += nbytes
        self.tenant_retained_seconds[tenant] += charge_s
        self.inc("retained_byte_ticks", nbytes)
        self.inc("retained_charge_seconds", charge_s)

    def observe_peer(self, tenant: str, nbytes: float, seconds: float) -> None:
        """One slice's inter-pod peer-fetch bill: bytes a sibling pod's
        block store served into this pod for `tenant`'s scan, and the
        modeled link seconds reconciliation added to its virtual time."""
        self.tenant_peer_bytes[tenant] += nbytes
        self.tenant_peer_seconds[tenant] += seconds
        self.inc("peer_fetch_bytes", nbytes)
        self.inc("peer_fetch_seconds", seconds)

    def observe_fault_seconds(self, kind: str, seconds: float) -> None:
        """Modeled seconds the fault plane added to one fetch attempt,
        bucketed by cause.  `hedge_saved` is NEGATIVE accounting — the tail
        seconds a hedged read clawed back — and is recorded as a positive
        magnitude under its own key so the win is visible in reports."""
        self.fault_seconds[kind] += seconds
        self.inc("fault_seconds_total", seconds)

    def observe_fault_wait(self, tenant: str, seconds: float) -> None:
        """One slice's total fault-plane delay billed into `tenant`'s WFQ
        virtual time at reconciliation — retries, backoff, spikes, timeouts.
        Kept per-tenant so the honesty ledger (cost_report) can show that
        fault seconds were charged to the tenant that incurred them."""
        self.tenant_fault_seconds[tenant] += seconds
        self.inc("fault_wait_seconds", seconds)

    def warn_once(self, key: str, message: str) -> None:
        """Record a warning at most once per key.  Warnings ride the
        snapshot (benchmark JSON) rather than stderr so headless runs
        keep them."""
        if key not in self._warnings:
            self._warnings[key] = message
            self.inc("warnings")

    def note_costmodel(self, cm) -> None:
        """Register cost-model provenance.  Fires the one-time
        `nominal_link` warning when the link model is running on nominal
        (uncalibrated) constants — the silent fallback the calibration
        loader takes when its JSON lacks link entries."""
        link_source = getattr(cm, "link_source", "nominal")
        self.costmodel_info = {
            "backend": getattr(cm, "backend", "unknown"),
            "source": getattr(cm, "source", "unknown"),
            "link_source": link_source,
            "nominal_link": link_source == "nominal",
        }
        if link_source == "nominal":
            self.warn_once(
                "nominal_link",
                "LinkModel is using nominal bandwidth/latency constants "
                "(calibration provided no link entries); fetch seconds are "
                "modeled, not measured",
            )

    # -- reading -----------------------------------------------------------
    def tenant_latency(self, tenant: str) -> Dict[str, float]:
        xs = list(self._tenant_latency.get(tenant, ()))
        return {
            "n": len(xs),
            "p50_s": quantile(xs, 0.50),
            "p99_s": quantile(xs, 0.99),
            "p999_s": quantile(xs, 0.999),  # tail-of-tail (SLO work)
        }

    def known_tenants(self) -> List[str]:
        """Every tenant the scheduler has seen — decoded bytes, scheduler
        charges, actual/reconciled decode seconds, OR latency samples.
        Fairness must range over all of them: a fully-starved tenant
        decodes zero bytes and would otherwise vanish from the report,
        RAISING the Jain index exactly when it should tank — and a tenant
        observed only via observe_actual_cost/observe_recon must not
        vanish from cost_report()."""
        return sorted(
            set(self.tenant_decoded_bytes)
            | set(self.tenant_sched_bytes)
            | set(self.tenant_sched_seconds)
            | set(self.tenant_actual_seconds)
            | set(self.tenant_recon_seconds)
            | set(self.tenant_retained_bytes)
            | set(self.tenant_peer_bytes)
            | set(self.tenant_fault_seconds)
            | set(self._tenant_latency)
        )

    def cost_report(self) -> dict:
        """Estimated-vs-actual decode cost per tenant: the honesty ledger.
        `rel_err` is (estimate - actual) / actual (negative: the tenant's
        scans under-estimated); `recon_s` is the virtual-time correction
        reconciliation applied to close the gap."""
        out = {}
        for t in self.known_tenants():
            est = self.tenant_sched_seconds.get(t, 0.0)
            act = self.tenant_actual_seconds.get(t, 0.0)
            out[t] = {
                "est_s": est,
                "actual_s": act,
                "recon_s": self.tenant_recon_seconds.get(t, 0.0),
                "fault_s": self.tenant_fault_seconds.get(t, 0.0),
                "rel_err": (est - act) / act if act > 0 else 0.0,
            }
        return out

    def fault_report(self) -> dict:
        """Storage-fault-plane ledger: what went wrong, what the retry /
        hedge / breaker machinery did about it, and what it cost.  Fixed
        keys, zero when the plane is quiet, so benchmark JSON is stable
        whether or not faults were injected."""
        c = self.counters
        return {
            "transient_errors": c.get("faults_transient", 0.0),
            "fetch_timeouts": c.get("fetch_timeouts", 0.0),
            "short_reads": c.get("faults_short_read", 0.0),
            "corrupt_injected": c.get("faults_corrupt", 0.0),
            "corrupt_detected": c.get("corrupt_detected", 0.0),
            "quarantined_pages": c.get("quarantined_pages", 0.0),
            "unverified_pages": c.get("unverified_pages", 0.0),
            "retry_successes": c.get("fetch_retry_successes", 0.0),
            "retries_exhausted": c.get("fetch_retries_exhausted", 0.0),
            "hedged_fetches": c.get("hedged_fetches", 0.0),
            "hedge_wins": c.get("hedge_wins", 0.0),
            "breaker_trips": c.get("breaker_trips", 0.0),
            "breaker_probes": c.get("breaker_probes", 0.0),
            "breaker_degraded_admits": c.get("breaker_degraded_admits", 0.0),
            "breaker_degraded_dispatches": c.get(
                "breaker_degraded_dispatches", 0.0
            ),
            "rejected_overloaded": c.get("rejected_overloaded", 0.0),
            "fault_seconds": dict(sorted(self.fault_seconds.items())),
            "tenant_fault_seconds": dict(
                sorted(self.tenant_fault_seconds.items())
            ),
        }

    def batch_report(self) -> dict:
        """Batched-decode dispatch ledger: slices dispatched through the
        bucketed path, row groups they carried, and total decode-path
        kernel launches — `launches_per_rg` is the headline batching win
        (sequential pays one launch per (row group, column); batched pays
        one per bucket) and is computed over the row groups dispatched in
        EITHER mode, so a sequential service reports its true per-group
        dispatch bill rather than a fake zero.  Fixed keys, zero when
        idle."""
        slices = self.counters.get("batch_slices", 0.0)
        batch_rgs = self.counters.get("batch_slice_rgs", 0.0)
        all_rgs = self.counters.get("decode_slice_rgs", 0.0)
        launches = self.counters.get("decode_launches", 0.0)
        return {
            "batch_slices": slices,
            "batch_slice_rgs": batch_rgs,
            "decode_launches": launches,
            "launches_per_rg": launches / all_rgs if all_rgs > 0 else 0.0,
            "rgs_per_slice": batch_rgs / slices if slices > 0 else 0.0,
        }

    def fairness(self, weights: Optional[Dict[str, float]] = None) -> dict:
        """Fair-share report: each tenant's share of the decode capacity it
        OCCUPIED — decoded bytes plus window-retained byte-ticks (a byte
        kept pinned across a tick denies the pool that byte exactly like a
        byte decoded, so hoarding decodes is visible in the shares) — the
        Jain index over weight-normalized allocations (1.0 = perfectly
        weighted-fair), and what the coalescing hold window cost.  Shares
        cover every tenant known to the scheduler, so a starved tenant
        shows up as a zero share and drags the index down."""
        weights = weights or {}
        decoded = {t: self.tenant_decoded_bytes.get(t, 0.0)
                   for t in self.known_tenants()}
        retained = {t: self.tenant_retained_bytes.get(t, 0.0)
                    for t in self.known_tenants()}
        usage = {t: decoded[t] + retained[t] for t in decoded}
        total = float(sum(usage.values()))
        shares = {t: (v / total if total > 0 else 0.0) for t, v in usage.items()}
        normalized = [v / max(weights.get(t, 1.0), 1e-9) for t, v in usage.items()]
        return {
            "tenant_decoded_bytes": decoded,
            "tenant_retained_bytes": dict(sorted(retained.items())),
            "tenant_peer_bytes": dict(sorted(self.tenant_peer_bytes.items())),
            "tenant_sched_bytes": dict(sorted(self.tenant_sched_bytes.items())),
            "tenant_sched_seconds": dict(sorted(self.tenant_sched_seconds.items())),
            "tenant_share": shares,
            "jain_index": jain_index(normalized),
            "min_share": min(shares.values()) if shares else 0.0,
            "max_share": max(shares.values()) if shares else 0.0,
            "held_requests": self.counters.get("held_requests", 0.0),
            "held_ticks": self.counters.get("held_ticks", 0.0),
            # tail-of-tail latency per tenant: the fairness story is
            # incomplete if a fair byte split hides a blown p99.9
            "tenant_latency_p999_s": {
                t: quantile(list(self._tenant_latency.get(t, ())), 0.999)
                for t in self.known_tenants()
            },
        }

    def trace_report(self) -> dict:
        """The flight recorder's stage-attribution report (fixed empty
        shape when no tracer is registered, so benchmark JSON keys are
        stable whether or not tracing ran)."""
        if self.tracer is None:
            return {"enabled": False, "completed": 0, "recorded": 0,
                    "requests": []}
        return self.tracer.report()

    def snapshot(self) -> dict:
        """Deterministic summary: every dict is key-sorted and empty deques
        collapse to fixed zeros, so benchmark JSON is stable run-to-run.
        `store` is the unified block store's per-tier ledger (hits,
        evictions, retained bytes, re-decode seconds saved) when a service
        registered one, else a fixed empty dict."""
        depths = list(self.queue_depth)
        ticks = list(self._tick_seconds)
        return {
            "counters": dict(sorted(self.counters.items())),
            "queue_depth_max": max(depths) if depths else 0,
            "queue_depth_mean": sum(depths) / len(depths) if depths else 0.0,
            "tick_p50_s": quantile(ticks, 0.50),
            "tick_p99_s": quantile(ticks, 0.99),
            "tick_p999_s": quantile(ticks, 0.999),
            "tenants": {
                t: self.tenant_latency(t) for t in sorted(self._tenant_latency)
            },
            "fairness": self.fairness(),
            "cost": self.cost_report(),
            "batch": self.batch_report(),
            "faults": self.fault_report(),
            "costmodel": (
                dict(self.costmodel_info)
                if self.costmodel_info is not None
                else {"backend": "unknown", "source": "unknown",
                      "link_source": "nominal", "nominal_link": True}
            ),
            "warnings": dict(sorted(self._warnings.items())),
            "store": self.store.stats() if self.store is not None else {},
            "trace": self.trace_report(),
        }
