"""Storage fault plane: deterministic fault injection, bounded retries
with backoff, fetch timeouts, hedged reads, and a per-target circuit
breaker (DESIGN.md §17).

The SmartNIC sits between compute and remote disaggregated storage —
exactly where cloud reality bites: tail-latency spikes, transient fetch
errors, short reads, bit-rot, and straggler pods.  This module makes all
of those injectable and all of the recovery machinery observable:

* `FaultPlan` — a seedable, STATELESS fault schedule.  Every decision is
  a pure hash of (seed, kind, table, row group[, column], attempt): no
  RNG object, no replay-time state, so any chaos run reproduces exactly
  from its seed and the same scan reproduces the same faults in every
  chaos iteration of a property sweep.
* `FaultInjector` — wraps the engine's two storage-read seams
  (`DatapathEngine._storage_read`) with the retry loop: transient errors
  retry with exponential backoff, corrupt pages are checksum-detected,
  quarantined in the BlockStore and re-fetched (never decoded), modeled
  fetch times past `timeout_s` retry, and past `hedge_after_s` race a
  hedged second fetch.  Every extra modeled second lands in
  `ScanStats.fault_wait_s`, which the scheduler reconciles into WFQ
  vtime — a faulty tenant's retries bill to that tenant, not the fleet.
* `CircuitBreaker` — per storage target (table path).  Consecutive
  attempt failures trip it open: dispatch degrades to raw offload,
  admission sheds with a typed `Overloaded` once the queue nears
  collapse, and after a cooldown a half-open probe decides recovery.
  `fabric.ScanFabric` treats a pod with an open breaker like a
  heartbeat-silent pod: drain + bit-identical replay on survivors.

Like the rest of the datapath, nothing here sleeps: latency is modeled
seconds threaded through the same netsim/WFQ ledgers as fetch and
decode time.  Injected corruption only ever tampers with COPIES of the
reader's buffers (they are read-only views over the mapped file), so
the file itself — and therefore bit-identity of recovered scans — is
never at risk.

Port copy of `repro.datapath.faults`, kept in step with it: the same
schedule (a blake2b hash of the same coordinate tuple), the same numpy
damage to page copies and the same retry loop, so the port's injector
faults the same (table, row group, column, attempt) coordinates as the
reference's.  Every fault happens on the host, before a page is copied to
the card; a kernel's own build or launch failure is not a storage fault
(kernels/build.py `KernelError`) and the scheduler never parks one on a
ticket.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.datapath import trace
from repro_torch.datapath.netsim import LinkModel
from repro_torch.lakeformat.encodings import EncodedColumn
from repro_torch.lakeformat.integrity import CorruptPageError, page_checksum, verify_page

__all__ = [
    "StorageFault",
    "TransientFetchError",
    "FetchTimeout",
    "FetchFailed",
    "Quarantined",
    "Overloaded",
    "CorruptPageError",
    "FaultPlan",
    "RetryPolicy",
    "FaultInjector",
    "CircuitBreaker",
]


# ---------------------------------------------------------------------------
# typed errors — a request NEVER fails silently: every terminal outcome is
# one of these, parked on the ticket and re-raised by Ticket/service.result()
# ---------------------------------------------------------------------------
class StorageFault(RuntimeError):
    """Base class for storage-hop failures."""


class TransientFetchError(StorageFault):
    """One fetch attempt failed; retryable."""


class FetchTimeout(StorageFault):
    """One fetch attempt exceeded the policy's modeled timeout; retryable."""


class FetchFailed(StorageFault):
    """Retries exhausted without a clean page (terminal, typed)."""


class Quarantined(StorageFault):
    """Retries exhausted and every attempt failed checksum verification —
    the page is quarantined in the BlockStore and unreadable (terminal)."""


class Overloaded(RuntimeError):
    """Admission load-shed: the target's circuit breaker is open and the
    queue is near collapse.  Typed so callers can distinguish 'come back
    later' from QueueFull/QuotaExceeded."""


# ---------------------------------------------------------------------------
# deterministic fault schedule
# ---------------------------------------------------------------------------
def _u(seed: int, *coords) -> float:
    """Uniform [0, 1) as a pure function of (seed, *coords) — blake2b of
    the repr'd coordinate tuple.  This is the whole 'no RNG at replay
    time' trick: the schedule is a mathematical function, not a stream."""
    payload = repr((seed,) + coords).encode()
    h = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seedable fault schedule over (table, row group[, column], attempt).

    Rates are per-attempt probabilities.  By default a selected fault
    clears on the next attempt (transient), so bounded retries recover;
    `fail_forever=True` pins every selected coordinate permanently —
    that is how tests drive terminal FetchFailed/Quarantined outcomes
    and breaker trips.  Tables hash by basename so a plan's schedule is
    stable across tmpdir locations.
    """

    seed: int = 0
    transient_rate: float = 0.0     # attempt raises before any byte lands
    corrupt_rate: float = 0.0       # page arrives with a flipped byte
    short_read_rate: float = 0.0    # page arrives truncated
    spike_rate: float = 0.0         # attempt's fetch takes spike_s extra
    spike_s: float = 0.0            # latency spike magnitude (modeled s)
    fail_forever: bool = False      # faults never clear across attempts
    # pod_id -> extra modeled seconds added to EVERY fetch on that pod —
    # the whole-pod straggler the hedge/breaker machinery exists to absorb.
    straggler_pods: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    def _attempt(self, attempt: int) -> int:
        # fail_forever collapses the attempt axis: a selected coordinate
        # fires on every retry instead of clearing after the first.
        return 0 if self.fail_forever else int(attempt)

    @staticmethod
    def _table(table: str) -> str:
        return os.path.basename(table)

    def transient(self, table: str, rg: int, attempt: int) -> bool:
        return _u(self.seed, "transient", self._table(table), rg,
                  self._attempt(attempt)) < self.transient_rate

    def corrupt(self, table: str, rg: int, column: str, attempt: int) -> bool:
        return _u(self.seed, "corrupt", self._table(table), rg, column,
                  self._attempt(attempt)) < self.corrupt_rate

    def short_read(self, table: str, rg: int, column: str,
                   attempt: int) -> bool:
        return _u(self.seed, "short", self._table(table), rg, column,
                  self._attempt(attempt)) < self.short_read_rate

    def spike(self, table: str, rg: int, attempt: int) -> float:
        """Latency spike for this attempt (0.0 when not selected), plus
        this plan's straggler term is added separately by the injector."""
        t = self._table(table)
        a = self._attempt(attempt)
        if _u(self.seed, "spike", t, rg, a) >= self.spike_rate:
            return 0.0
        # deterministic magnitude jitter in [0.5, 1.5)·spike_s
        return self.spike_s * (0.5 + _u(self.seed, "spike_mag", t, rg, a))

    def straggle(self, pod_id: str) -> float:
        return float(self.straggler_pods.get(pod_id, 0.0))

    def any_faults(self) -> bool:
        return (self.transient_rate > 0 or self.corrupt_rate > 0
                or self.short_read_rate > 0 or self.spike_rate > 0
                or bool(self.straggler_pods))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff, per-fetch timeout, and a
    hedge threshold.  All times are modeled seconds (netsim clock)."""

    max_attempts: int = 4
    backoff_base_s: float = 200e-6
    backoff_mult: float = 2.0
    # One attempt's modeled fetch time past this aborts the attempt and
    # retries (the full timeout is billed — we waited it out).  None
    # disables.
    timeout_s: Optional[float] = None
    # One attempt's modeled fetch time past this launches a hedged second
    # fetch; the attempt completes at min(primary, hedge_after_s + clean
    # fetch).  None disables.
    hedge_after_s: Optional[float] = None

    def backoff(self, attempt: int) -> float:
        if attempt <= 0:
            return 0.0
        return self.backoff_base_s * (self.backoff_mult ** (attempt - 1))


# ---------------------------------------------------------------------------
# circuit breaker — per storage target (table path)
# ---------------------------------------------------------------------------
class CircuitBreaker:
    """closed → open on `fail_threshold` consecutive attempt failures;
    open → half-open after `cooldown_ticks` (next admission becomes the
    recovery probe); half-open → closed on probe success, → open on
    probe failure.  While open: dispatch degrades to raw offload and
    admission sheds (`Overloaded`) once the queue passes
    `shed_queue_frac` of capacity — degrade, never collapse."""

    def __init__(self, fail_threshold: int = 4, cooldown_ticks: int = 8,
                 shed_queue_frac: float = 0.75):
        self.fail_threshold = int(fail_threshold)
        self.cooldown_ticks = int(cooldown_ticks)
        self.shed_queue_frac = float(shed_queue_frac)
        self._state: Dict[str, str] = {}
        self._fails: Dict[str, int] = {}
        self._opened_at: Dict[str, int] = {}
        self.trips = 0
        self.probes = 0
        self.sheds = 0

    def state(self, target: str) -> str:
        return self._state.get(target, "closed")

    def degraded(self, target: str) -> bool:
        return self.state(target) == "open"

    def any_open(self) -> bool:
        return any(s == "open" for s in self._state.values())

    def record_failure(self, target: str, tick: int = 0) -> bool:
        """Returns True when this failure TRIPPED the breaker open."""
        f = self._fails.get(target, 0) + 1
        self._fails[target] = f
        st = self.state(target)
        if st == "half-open" or (st == "closed" and f >= self.fail_threshold):
            self._state[target] = "open"
            self._opened_at[target] = int(tick)
            self.trips += 1
            return True
        return False

    def record_success(self, target: str, tick: int = 0) -> None:
        self._fails[target] = 0
        if self.state(target) == "half-open":
            self._state[target] = "closed"

    def admit(self, target: str, tick: int, queue_frac: float = 0.0) -> str:
        """Admission verdict: 'ok' | 'degraded' | 'probe' | 'shed'."""
        if self.state(target) != "open":
            return "ok"
        if tick - self._opened_at.get(target, tick) >= self.cooldown_ticks:
            self._state[target] = "half-open"
            self.probes += 1
            return "probe"
        if queue_frac >= self.shed_queue_frac:
            self.sheds += 1
            return "shed"
        return "degraded"

    def report(self) -> dict:
        return {
            "trips": self.trips,
            "probes": self.probes,
            "sheds": self.sheds,
            "open": sorted(t for t, s in self._state.items() if s == "open"),
        }


# ---------------------------------------------------------------------------
# injected-corruption helpers — always tamper with COPIES
# ---------------------------------------------------------------------------
def _flip_byte(col: EncodedColumn) -> EncodedColumn:
    """Flip one byte of the page's first (sorted-name) non-empty buffer."""
    bufs = dict(col.buffers)
    for name in sorted(bufs):
        arr = bufs[name]
        raw = bytearray(np.ascontiguousarray(arr).tobytes())
        if not raw:
            continue
        raw[0] ^= 0xFF
        bufs[name] = np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(
            arr.shape)
        break
    return dataclasses.replace(col, buffers=bufs)


def _truncate(col: EncodedColumn) -> EncodedColumn:
    """Short read: the page's first buffer arrives one element short,
    flattened — the checksum's shape fold catches it like a flipped bit."""
    bufs = dict(col.buffers)
    for name in sorted(bufs):
        arr = np.ascontiguousarray(bufs[name]).reshape(-1)
        if arr.size == 0:
            continue
        bufs[name] = arr[: arr.size - 1].copy()
        break
    return dataclasses.replace(col, buffers=bufs)


# ---------------------------------------------------------------------------
# the injector: retry / verify / quarantine / hedge loop
# ---------------------------------------------------------------------------
class FaultInjector:
    """Installed on `DatapathEngine.faults` by the service (duck-typed —
    core never imports datapath).  `read()` replaces a bare
    `reader.read_encoded` with the full fault-plane loop; with an empty
    FaultPlan it still verifies checksums and enforces the retry policy,
    so the machinery is exercised even fault-free."""

    def __init__(
        self,
        plan: Optional[FaultPlan] = None,
        policy: Optional[RetryPolicy] = None,
        link: Optional[LinkModel] = None,
        pod_id: str = "pod0",
        telemetry=None,
        breaker: Optional[CircuitBreaker] = None,
        clock: Optional[Callable[[], int]] = None,
    ):
        self.plan = plan if plan is not None else FaultPlan()
        self.policy = policy if policy is not None else RetryPolicy()
        self.link = link if link is not None else LinkModel()
        self.pod_id = pod_id
        self.telemetry = telemetry
        self.breaker = breaker
        self.clock = clock if clock is not None else (lambda: 0)
        # Global per-(table, rg) attempt ordinal.  Deterministic within a
        # run (the datapath is single-threaded by design), and it gives
        # the plan a monotone attempt axis even when the same page is
        # re-fetched after eviction later in the run.
        self._attempt_no: Dict[Tuple[str, int], int] = {}

    # -- small plumbing ----------------------------------------------------
    def _inc(self, name: str, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.inc(name, n)

    def _secs(self, kind: str, s: float) -> None:
        if s and self.telemetry is not None:
            self.telemetry.observe_fault_seconds(kind, s)

    def _fail(self, target: str) -> None:
        if self.breaker is not None:
            if self.breaker.record_failure(target, self.clock()):
                self._inc("breaker_trips")

    def _ok(self, target: str) -> None:
        if self.breaker is not None:
            self.breaker.record_success(target, self.clock())

    @staticmethod
    def _quarantine(engine, reader, rg: int, name: str) -> None:
        store = getattr(engine.cache, "store", None)
        if store is not None and hasattr(store, "quarantine"):
            store.quarantine(engine.page_cache_key(reader, rg, name))

    # -- the read seam -----------------------------------------------------
    def read(self, engine, reader, rg: int, columns,
             stats) -> Dict[str, EncodedColumn]:
        """Fetch `columns` of row group `rg` through the fault plane.

        Returns verified pages or raises a TYPED terminal error
        (FetchFailed / Quarantined).  All modeled extra seconds — failed
        attempts, backoff, spikes survived, hedge exposure — accumulate
        in `stats.fault_wait_s` for WFQ reconciliation.
        """
        plan, policy = self.plan, self.policy
        path = reader.path
        last_err: Optional[Exception] = None
        tr = trace._CUR is not None
        for attempt in range(max(policy.max_attempts, 1)):
            key = (path, rg)
            a = self._attempt_no.get(key, 0)
            self._attempt_no[key] = a + 1
            backoff = policy.backoff(attempt)
            if backoff:
                stats.fault_wait_s += backoff
                self._secs("backoff", backoff)

            spike = plan.spike(path, rg, a) + plan.straggle(self.pod_id)

            # 1) transient error: the attempt dies before any byte lands.
            if plan.transient(path, rg, a):
                stats.retry_fetches += 1
                self._inc("faults_transient")
                self._secs("wasted", spike)
                stats.fault_wait_s += spike
                self._fail(path)
                if tr:
                    trace.event("fault", kind="transient", rg=rg, attempt=a)
                last_err = TransientFetchError(
                    f"{path} rg={rg} attempt={a}: transient fetch error")
                continue

            # 2) the bytes arrive; model the attempt's wall time.
            got = reader.read_encoded(rg, columns)
            nbytes = sum(c.encoded_bytes() for c in got.values())
            base_s = self.link.fetch_seconds(nbytes) if nbytes else 0.0
            t_s = base_s + spike

            if policy.timeout_s is not None and t_s > policy.timeout_s:
                # Waited the full timeout, then gave up on the attempt.
                stats.fetch_timeouts += 1
                stats.retry_fetches += 1
                self._inc("fetch_timeouts")
                stats.fault_wait_s += policy.timeout_s
                self._secs("timeout", policy.timeout_s)
                self._fail(path)
                if tr:
                    trace.event("fault", kind="timeout", rg=rg, attempt=a,
                                t_s=t_s)
                last_err = FetchTimeout(
                    f"{path} rg={rg} attempt={a}: fetch {t_s:.6f}s > "
                    f"timeout {policy.timeout_s:.6f}s")
                continue

            extra_s = spike
            if policy.hedge_after_s is not None and t_s > policy.hedge_after_s:
                # Straggler: at hedge_after_s a second fetch races the
                # first; the hedge is clean (fresh storage attempt, no
                # spike), so the slice completes at the earlier finish.
                hedge_t = policy.hedge_after_s + base_s
                eff = min(t_s, hedge_t)
                stats.hedged_fetches += 1
                self._inc("hedged_fetches")
                if eff < t_s:
                    stats.hedge_wins += 1
                    self._inc("hedge_wins")
                    self._secs("hedge_saved", t_s - eff)
                if tr:
                    trace.event("hedge", rg=rg, primary_s=t_s, hedged_s=eff)
                extra_s = eff - base_s
            stats.fault_wait_s += extra_s
            self._secs("straggle", extra_s)

            # 3) injected payload damage (on COPIES — reader buffers are
            # read-only views over the file).
            for name in list(got):
                if plan.short_read(path, rg, name, a):
                    got[name] = _truncate(got[name])
                    self._inc("faults_short_read")
                elif plan.corrupt(path, rg, name, a):
                    got[name] = _flip_byte(got[name])
                    self._inc("faults_corrupt")

            # 4) verify every page before it can reach a decode kernel.
            meta = getattr(reader, "page_checksum_meta", None)
            bad = []
            for name, col in got.items():
                expect = meta(rg, name) if meta is not None else None
                if expect is None:
                    self._inc("unverified_pages")  # legacy footer
                    continue
                if not verify_page(col, expect):
                    bad.append(name)
            if bad:
                for name in bad:
                    stats.corrupt_pages += 1
                    self._inc("corrupt_detected")
                    self._inc("quarantined_pages")
                    self._quarantine(engine, reader, rg, name)
                    if tr:
                        trace.event("page_quarantined", rg=rg, column=name,
                                    attempt=a)
                stats.retry_fetches += 1
                self._fail(path)
                last_err = CorruptPageError(
                    f"{path} rg={rg} attempt={a}: checksum mismatch on "
                    f"{sorted(bad)}", table=path, rg=rg, column=bad[0])
                continue

            self._ok(path)
            if attempt > 0:
                self._inc("fetch_retry_successes")
            return got

        # retries exhausted — terminal, TYPED, never silent.
        self._inc("fetch_retries_exhausted")
        if isinstance(last_err, CorruptPageError):
            raise Quarantined(
                f"{path} rg={rg}: page corrupt after "
                f"{policy.max_attempts} attempts (quarantined)"
            ) from last_err
        raise FetchFailed(
            f"{path} rg={rg}: fetch failed after "
            f"{policy.max_attempts} attempts"
        ) from last_err
