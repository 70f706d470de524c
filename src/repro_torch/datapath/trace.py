"""Datapath flight recorder — per-request span tracing with paper-anchored
stage attribution and exportable timelines.

Port copy of `repro.datapath.trace` (stdlib only), kept in step with it; the
port never imports the JAX package.  The port's engine emits the same spans
(`decode_launch`, `fetch`, `filter`, `agg_launch`) and the store the same
events (`store_hit`, `evict`, `demote`, `quarantine`); a span's `nbytes` on
a tensor is `numel() * element_size()`.

The paper's headline claim is a TIME-ATTRIBUTION claim: decode is 46% of
TPC-H runtime on Parquet, filter 17% (Fig. 2).  Telemetry reports those
numbers fleet-wide; this module makes them a PER-REQUEST measurement.
Every admitted request (subject to `sample_rate`) carries a span tree —

    request                     submit() -> terminal ticket status
      admission                 metadata-only estimate + quota checks
      wfq_wait | hold_window    queued ticks, by WHY the request waited
      slice_dispatch            one per scheduler slice (run_tick)
        fetch                   storage->NIC pull of encoded pages
        decode_launch           one per device dispatch (bucket or column)
        filter                  predicate eval / stream compaction
        reconcile               actual-cost re-billing of virtual time
        store_hit / evict / sim_fetch   zero-duration instant events

— and the completed trees live in a bounded ring (`FlightRecorder`,
last-N requests, fixed memory, always on).  Exporters: Chrome/Perfetto
`trace_event` JSON (one pid per tenant, one tid per request) and a
deterministic stage-attribution report whose `decode_pct`/`filter_pct`/
`rest_pct` line up against the paper's 46/17 split (PAPER_FIG2_PCT).

Cost discipline (DESIGN.md §13): everything here is pure stdlib, and the
hot path is gated so an untraced run allocates NOTHING — the engine's
call sites check `trace._CUR is None` (one module-attribute load) before
building any kwargs.  The scheduler publishes the active request's trace
via `set_slice()` around each slice, so engine/blockstore code needs no
plumbed-through tracer argument.  Tracing must never perturb results:
bit-identity of scan output with tracing on/off is property-tested in
the reference's tests/test_trace_props.py, and in the port by
tests/test_torch_trace.py.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Any, Dict, List, Optional

# The paper's Fig. 2 TPC-H-on-Parquet breakdown — the anchor every
# stage-attribution report is printed against.
PAPER_FIG2_PCT = {"decode": 46.0, "filter": 17.0, "rest": 37.0}

# span name -> attribution stage.  Children of a mapped span are NOT
# recursed into (a store_hit inside a fetch span must not double-bill),
# so stage seconds over one trace can never exceed the root wall time.
STAGE_OF = {
    "admission": "admission",
    "hold_window": "hold_window",
    "wfq_wait": "wfq_wait",
    "fetch": "fetch",
    "decode_launch": "decode",
    "filter": "filter",
    "reconcile": "reconcile",
}
STAGES = ("admission", "hold_window", "wfq_wait", "fetch", "decode",
          "filter", "reconcile")


def _span(name: str, t0: float, attrs: dict) -> dict:
    return {"name": name, "t0": t0, "t1": None, "args": attrs, "children": []}


class RequestTrace:
    """One request's span tree while in flight.  Spans are plain dicts
    (name/t0/t1/args/children); `stack` enforces strict nesting — the
    scheduler and engine call begin/end in stack discipline, and
    `Tracer.finish` force-closes anything an error path left open."""

    __slots__ = ("req_id", "tenant", "table", "status", "root", "stack",
                 "n_spans", "dropped_spans", "drop_depth", "wait_kind",
                 "summary")

    def __init__(self, req_id: int, tenant: str, table: str, t0: float,
                 attrs: dict):
        attrs = dict(attrs)
        attrs.update(req_id=req_id, tenant=tenant, table=table)
        self.req_id = req_id
        self.tenant = tenant
        self.table = table
        self.status = "queued"
        self.root = _span("request", t0, attrs)
        self.stack: List[dict] = [self.root]
        self.n_spans = 1
        self.dropped_spans = 0  # spans refused by the max_spans cap
        self.drop_depth = 0  # open-but-dropped begins awaiting their end
        self.wait_kind: Optional[str] = None  # open wfq_wait / hold_window
        self.summary: Optional[dict] = None  # filled at finish()


class FlightRecorder:
    """Bounded ring of the last `capacity` COMPLETED request traces.
    Always on, fixed memory: an old trace falls off the back, its spans
    garbage-collected with it."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, int(capacity))
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self.completed = 0  # total finishes ever, including evicted ones

    def add(self, rt: RequestTrace) -> None:
        self._ring.append(rt)
        self.completed += 1

    def traces(self) -> List[RequestTrace]:
        return list(self._ring)

    # -- stage attribution -------------------------------------------------
    def report(self) -> dict:
        """Deterministic stage-attribution report over the ring: one
        summary per recorded request (ring order), fleet stage seconds
        and time-weighted decode/filter/rest percentages, a per-tenant
        rollup, and the paper's Fig. 2 anchor for side-by-side reading.
        Every dict is key-sorted; values are plain floats/ints."""
        traces = list(self._ring)
        stage_s = {s: 0.0 for s in STAGES}
        wall = 0.0
        by_tenant: Dict[str, dict] = {}
        for rt in traces:
            sm = rt.summary or {}
            wall += sm.get("wall_s", 0.0)
            bt = by_tenant.setdefault(
                rt.tenant, {"n": 0, "wall_s": 0.0,
                            "stage_s": {s: 0.0 for s in STAGES}})
            bt["n"] += 1
            bt["wall_s"] += sm.get("wall_s", 0.0)
            for s, v in sm.get("stages_s", {}).items():
                stage_s[s] += v
                bt["stage_s"][s] += v
        for bt in by_tenant.values():
            w = bt["wall_s"]
            bt["stage_pct"] = {
                s: (100.0 * v / w if w > 0 else 0.0)
                for s, v in sorted(bt["stage_s"].items())
            }
            bt["decode_pct"] = bt["stage_pct"]["decode"]
            bt["filter_pct"] = bt["stage_pct"]["filter"]
            bt["rest_pct"] = max(
                0.0, 100.0 - bt["decode_pct"] - bt["filter_pct"])
            bt["stage_s"] = dict(sorted(bt["stage_s"].items()))
        decode_pct = 100.0 * stage_s["decode"] / wall if wall > 0 else 0.0
        filter_pct = 100.0 * stage_s["filter"] / wall if wall > 0 else 0.0
        return {
            "capacity": self.capacity,
            "completed": self.completed,
            "recorded": len(traces),
            "requests": [rt.summary for rt in traces if rt.summary],
            "wall_s": wall,
            "stage_s": dict(sorted(stage_s.items())),
            "stage_pct": {
                "decode": decode_pct,
                "filter": filter_pct,
                "rest": max(0.0, 100.0 - decode_pct - filter_pct),
            },
            "by_tenant": dict(sorted(by_tenant.items())),
            "paper_fig2_pct": dict(sorted(PAPER_FIG2_PCT.items())),
        }

    # -- Chrome/Perfetto export --------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome `trace_event` JSON (load in ui.perfetto.dev or
        chrome://tracing): one process per tenant, one thread per request,
        "X" complete events for spans, "i" instants for zero-duration
        events.  Timestamps are microseconds relative to the earliest
        recorded request, so the export is position-independent."""
        traces = list(self._ring)
        events: List[dict] = []
        if not traces:
            return {"displayTimeUnit": "ms", "traceEvents": events}
        base = min(rt.root["t0"] for rt in traces)
        tenants = sorted({rt.tenant for rt in traces})
        pid_of = {t: i + 1 for i, t in enumerate(tenants)}
        for t in tenants:
            events.append({"args": {"name": t}, "name": "process_name",
                           "ph": "M", "pid": pid_of[t], "tid": 0})
        for rt in sorted(traces, key=lambda r: r.req_id):
            pid, tid = pid_of[rt.tenant], rt.req_id
            events.append({"args": {"name": f"req-{rt.req_id}"},
                           "name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tid})
            stack = [rt.root]
            while stack:
                sp = stack.pop()
                stack.extend(reversed(sp["children"]))
                if sp["t1"] is None:
                    continue
                args = {
                    k: (v if isinstance(v, (str, int, float, bool)) else str(v))
                    for k, v in sorted(sp["args"].items())
                }
                ts = (sp["t0"] - base) * 1e6
                dur = (sp["t1"] - sp["t0"]) * 1e6
                if dur <= 0.0:
                    events.append({"args": args, "name": sp["name"],
                                   "ph": "i", "pid": pid, "s": "t",
                                   "tid": tid, "ts": ts})
                else:
                    events.append({"args": args, "dur": dur,
                                   "name": sp["name"], "ph": "X",
                                   "pid": pid, "tid": tid, "ts": ts})
        return {"displayTimeUnit": "ms", "traceEvents": events}

    def save_chrome_trace(self, path: str) -> int:
        """Write the Chrome-trace JSON to `path`; returns event count."""
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True)
        return len(doc["traceEvents"])


class Tracer:
    """Per-request span recorder.  `sample_rate` in [0, 1] picks requests
    DETERMINISTICALLY (a fractional accumulator, no RNG — rate 0.5 traces
    every second request, run-to-run stable); `max_spans` bounds one
    request's tree (overflow increments `dropped_spans`, stack discipline
    preserved); completed trees land in `recorder` (bounded ring).  The
    clock is injectable so property tests can drive a counter clock and
    assert exact nesting."""

    def __init__(self, capacity: int = 64, sample_rate: float = 1.0,
                 max_spans: int = 4096, clock=time.perf_counter):
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.max_spans = max_spans
        self.clock = clock
        self.recorder = FlightRecorder(capacity)
        self._live: Dict[int, RequestTrace] = {}
        self._acc = 0.0  # deterministic sampling accumulator
        self.sampled = 0
        self.skipped = 0

    # -- lifecycle ---------------------------------------------------------
    def start(self, req_id: int, tenant: str, table: str,
              t0: Optional[float] = None, **attrs) -> Optional[RequestTrace]:
        """Open a request's root span at admission; None when the sampler
        skips this request (all later lookups no-op on None)."""
        self._acc += self.sample_rate
        if self._acc < 1.0:
            self.skipped += 1
            return None
        self._acc -= 1.0
        rt = RequestTrace(req_id, tenant, table,
                          self.clock() if t0 is None else t0, attrs)
        self._live[req_id] = rt
        self.sampled += 1
        return rt

    def live(self, req_id: int) -> Optional[RequestTrace]:
        return self._live.get(req_id)

    def has_live(self) -> bool:
        return bool(self._live)

    def finish(self, req_id: int, status: str, **attrs) -> Optional[RequestTrace]:
        """Close the root span at the request's terminal tick, force-close
        anything an error path left open, compute the stage-attribution
        summary and push the trace into the flight recorder."""
        rt = self._live.pop(req_id, None)
        if rt is None:
            return None
        self.end_wait(rt)
        while len(rt.stack) > 1:  # error paths may leave spans open
            self.end(rt)
        now = self.clock()
        root = rt.root
        root["t1"] = max(now, root["t0"])
        root["args"].update(attrs)
        root["args"]["status"] = status
        rt.status = status
        rt.summary = self._summarize(rt)
        self.recorder.add(rt)
        return rt

    # -- span ops (all take the RequestTrace; None-safe at call sites) -----
    def begin(self, rt: RequestTrace, name: str, **attrs) -> None:
        if rt.n_spans >= self.max_spans:
            rt.dropped_spans += 1
            rt.drop_depth += 1  # the matching end() must not pop a real span
            return
        sp = _span(name, self.clock(), attrs)
        rt.stack[-1]["children"].append(sp)
        rt.stack.append(sp)
        rt.n_spans += 1

    def end(self, rt: RequestTrace, name: Optional[str] = None, **attrs) -> None:
        """Close the innermost open span.  With `name`, pop (and close at
        the same instant) any deeper spans an exception left open until
        that span is closed — keeps the tree well-formed on error paths."""
        if rt.drop_depth > 0:
            rt.drop_depth -= 1
            return
        now = self.clock()
        while len(rt.stack) > 1:
            sp = rt.stack.pop()
            sp["t1"] = max(now, sp["t0"])
            if name is None or sp["name"] == name:
                sp["args"].update(attrs)
                return
        # underflow (unmatched end): ignore rather than corrupt the root

    def event(self, rt: RequestTrace, name: str, **attrs) -> None:
        """Zero-duration instant (store_hit / evict / sim_fetch) attached
        to the innermost open span."""
        if rt.n_spans >= self.max_spans:
            rt.dropped_spans += 1
            return
        now = self.clock()
        sp = _span(name, now, attrs)
        sp["t1"] = now
        rt.stack[-1]["children"].append(sp)
        rt.n_spans += 1

    def add_span(self, rt: RequestTrace, name: str, t0: float, t1: float,
                 **attrs) -> None:
        """Attach an already-closed span (e.g. admission, timed inline)."""
        if rt.n_spans >= self.max_spans:
            rt.dropped_spans += 1
            return
        sp = _span(name, t0, attrs)
        sp["t1"] = max(t1, t0)
        rt.stack[-1]["children"].append(sp)
        rt.n_spans += 1

    # -- wait-state machine (queued time, attributed by WHY) ---------------
    def wait(self, rt: RequestTrace, kind: str, **attrs) -> None:
        """The request is waiting this tick — `kind` is "wfq_wait" or
        "hold_window".  Consecutive same-kind ticks extend the open span
        (its `ticks` arg counts them); a kind switch closes the old span
        and opens the new one."""
        if rt.wait_kind == kind:
            top = rt.stack[-1]
            if top["name"] == kind:
                top["args"]["ticks"] = top["args"].get("ticks", 0) + 1
            return
        self.end_wait(rt)
        self.begin(rt, kind, ticks=1, **attrs)
        rt.wait_kind = kind

    def end_wait(self, rt: RequestTrace) -> None:
        """Close any open wait span — the scheduler calls this right
        before dispatching a slice, so wait time and slice time can never
        overlap (the stage-sum <= wall invariant depends on it)."""
        if rt.wait_kind is not None:
            self.end(rt, name=rt.wait_kind)
            rt.wait_kind = None

    # -- attribution -------------------------------------------------------
    def _summarize(self, rt: RequestTrace) -> dict:
        stages = {s: 0.0 for s in STAGES}

        def walk(sp: dict) -> None:
            stage = STAGE_OF.get(sp["name"])
            if stage is not None and sp["t1"] is not None:
                stages[stage] += sp["t1"] - sp["t0"]
                return  # never double-bill a mapped span's children
            for c in sp["children"]:
                walk(c)

        for c in rt.root["children"]:
            walk(c)
        wall = rt.root["t1"] - rt.root["t0"]
        decode_pct = 100.0 * stages["decode"] / wall if wall > 0 else 0.0
        filter_pct = 100.0 * stages["filter"] / wall if wall > 0 else 0.0
        args = rt.root["args"]
        return {
            "req_id": rt.req_id,
            "tenant": rt.tenant,
            "table": rt.table,
            "status": rt.status,
            "submitted_tick": args.get("submitted_tick", 0),
            "done_tick": args.get("done_tick", 0),
            "mode": args.get("mode", ""),
            "held_ticks": args.get("held_ticks", 0),
            "wall_s": wall,
            "stages_s": dict(sorted(stages.items())),
            "attributed_s": sum(stages.values()),
            "decode_pct": decode_pct,
            "filter_pct": filter_pct,
            "rest_pct": max(0.0, 100.0 - decode_pct - filter_pct),
            "spans": rt.n_spans,
            "dropped_spans": rt.dropped_spans,
        }

    def report(self) -> dict:
        """The recorder's stage-attribution report plus sampler state."""
        out = {
            "enabled": True,
            "sample_rate": self.sample_rate,
            "sampled": self.sampled,
            "skipped": self.skipped,
            "live": len(self._live),
        }
        out.update(self.recorder.report())
        return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# module-level slice context — how the engine/blockstore emit spans without
# a plumbed-through tracer argument
# ---------------------------------------------------------------------------
# The scheduler sets (_CUR_TRACER, _CUR) around each dispatched slice; the
# engine's hot loops gate on `trace._CUR is None` (one attribute load, no
# allocation) before building span kwargs.  Deterministically single-
# threaded by construction (DESIGN.md §7), so one slot suffices.
_CUR: Optional[RequestTrace] = None
_CUR_TRACER: Optional[Tracer] = None


def set_slice(tracer: Optional[Tracer], rt: Optional[RequestTrace]) -> None:
    """Publish (or clear, with Nones) the request whose slice is executing."""
    global _CUR, _CUR_TRACER
    _CUR, _CUR_TRACER = rt, tracer


def begin(name: str, **attrs) -> None:
    if _CUR is not None:
        _CUR_TRACER.begin(_CUR, name, **attrs)


def end(name: Optional[str] = None, **attrs) -> None:
    if _CUR is not None:
        _CUR_TRACER.end(_CUR, name=name, **attrs)


def event(name: str, **attrs) -> None:
    if _CUR is not None:
        _CUR_TRACER.event(_CUR, name, **attrs)
