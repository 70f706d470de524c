"""Tick scheduler: fair-share batch formation + shared-scan coalescing.

Two layers per tick (DESIGN.md §9):

  form_batch  decides WHAT runs — weighted fair queueing ("wfq", default)
              by per-tenant virtual time measured in estimated decode-
              SECONDS (the calibrated encoding-aware cost model's price)
              over tenant weight, dispatching at ROW-GROUP granularity so
              a giant scan is preempted between row groups and small
              scans slip through every tick; or strict arrival order
              ("fifo", the seed behavior, kept for A/B comparison in
              benchmarks/service_bench.py).  At slice completion the
              charge is reconciled against what the engine ACTUALLY
              materialized (service._vreconcile), so a tenant whose scans
              under-estimate cannot buy extra share.
  run_tick    decides HOW it runs — requests grouped by table around a
              window-scoped view into the unified BlockStore's decoded
              tier (datapath/blockstore.py) so each (path, row group,
              column, backend) pair is decoded ONCE per tick, every
              coalesced predicate is evaluated over the shared decoded
              columns, and the decodes stay pinned for `hold_ticks` more
              ticks — a late-arriving partner reuses them instead of
              re-aligning ticks.

Cross-tick coalescing window: a fresh request with no compatible partner
(policy.coalesce_compatible) in the queue may be held up to
service.hold_ticks ticks; the moment a partner dispatches it is released
into the SAME tick and shares that tick's decode window, and if no
partner ever arrives it force-dispatches at its deadline — a held
request is never late by more than hold_ticks.  A request whose
footprint is already window-pinned in the store is never held at all:
the retained decodes ARE its partner, so it dispatches immediately.

Batched dispatch (service.batch_decode, the default): each WFQ slice is
handed to the engine as ONE row-group batch
(`ResumableScan.advance_batched` -> `engine.scan_row_groups_batched`),
which buckets compatible pages by (encoding, k, dtype) and decodes each
bucket in a single kernel launch — ~4-100x fewer device dispatches than
the one-launch-per-(row group, column) sequential loop, bit-identically.
Reconciliation then re-bills each slice by the launches it REALLY made
(`ScanStats.kernel_launches` priced at the calibrated per-launch
overhead), so the batched path's dispatch savings flow back through the
same honesty loop as decode bytes.  When a tick coalesces SEVERAL
requests over one table, their slices stack into a single cross-request
bucket pass (`engine.scan_group_batched` via `_run_group_stacked`): a
page two requests both need decodes once and launches drop again by the
stacking factor, with per-request attribution and fault isolation
preserved.

The storage->NIC fetch for the row groups actually read this tick (store
hits — decoded, window-pinned, or encoded-page — fetch nothing and skip
the simulation) is fed through netsim's double-buffered PrefetchPipeline,
recording how much of the fetch time hides behind on-device decode — at
row-group granularity under sequential dispatch, at SLICE granularity
under batched dispatch (the next slice's fetch hides behind this slice's
batch decode).

Port copy of `repro.datapath.scheduler`, kept in step with it: the same
batch formation, dispatch, reconciliation and fetch simulation over the
port's engine, so a pod makes the same decisions, charges and span trees
as the reference's on the same submissions.  One thing differs: fault
isolation stops at the card.  Each of the three places that park a
request's exception on its ticket, and the stacked pass's fall-back to
per-request dispatch, re-raises `kernels.build.DEVICE_ERRORS` (a kernel
that did not build, load or launch; a CUDA error or out-of-memory raised
by torch) out of `Pod.tick()`: such an error is every tenant's, and
re-running a group request by request after it would hide it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core import engine as _engine_mod
from repro_torch.core.engine import ResumableScan
from repro_torch.datapath import trace
from repro_torch.datapath.policy import coalesce_compatible
from repro_torch.kernels.build import DEVICE_ERRORS

# Install the engine's flight-recorder hook (engine.TRACE).  The engine
# cannot import repro_torch.datapath — that would close an import cycle
# through the package __init__ — so the scheduler, which every traced slice
# flows through, hands it the trace module once at import time.  Library
# users who never import the datapath keep TRACE = None and pay nothing.
_engine_mod.TRACE = trace


def _retained_resident(service, req) -> bool:
    """Does the store hold a live window-pinned decode for any of `req`'s
    (row group, column) blocks?  If so the hold window already paid off
    for this footprint — dispatch now and reuse, don't re-align ticks."""
    engine = service.engine
    return any(
        service.store.pinned(engine.rg_cache_key(req.reader, rg, name))
        for rg in req.row_groups
        for name in req.col_set
    )


# ---------------------------------------------------------------------------
# batch formation (WHAT runs this tick)
# ---------------------------------------------------------------------------

def form_batch(service) -> List[Tuple[object, List[int]]]:
    """Select this tick's dispatch units — ordered (request, row_groups)
    pairs — honoring the scheduling discipline, the per-tick decoded-byte
    budget (`service.tick_bytes`, None = unbounded), the distinct-request
    cap (`service.batch_per_tick`) and the cross-tick hold window.

    Mutates scheduler state: request cursors, per-tenant virtual time,
    hold counters.  Costs are the admission-time metadata estimates
    (`ScanRequest.rg_costs`), so forming a batch moves no data bytes.
    """
    tel = service.telemetry
    active = [r for r in service.queue if r.ticket.status == "queued"]
    if not active:
        return []
    budget = float("inf") if service.tick_bytes is None else float(service.tick_bytes)
    cap = max(1, service.batch_per_tick)

    # -- hold window: fresh requests with no coalescing partner wait -------
    eligible: List = []
    held: List = []
    for req in active:
        if (
            req.started
            or service.hold_ticks <= 0
            or not req.row_groups  # nothing to coalesce: holding never pays
            or req.held_ticks >= service.hold_ticks  # deadline reached
            # a prefiltered-cache-resident answer decodes nothing — waiting
            # for a decode partner cannot pay (non-mutating presence check)
            or service.engine.plan_cache_key(req.reader, req.plan, req.blooms,
                                             tag=req.scan_tag)
            in service.engine.cache
            or any(o is not req and coalesce_compatible(req, o) for o in active)
        ):
            eligible.append(req)
        elif _retained_resident(service, req):
            # the window already holds this footprint's decodes: reuse now
            eligible.append(req)
            tel.inc("retained_partner_dispatch")
        else:
            held.append(req)

    units: Dict[int, Tuple[object, List[int]]] = {}
    order: List[int] = []
    spent = 0.0

    def open_unit(req) -> bool:
        """Ensure req appears in this tick's batch; False on first open."""
        if req.req_id in units:
            return True
        units[req.req_id] = (req, [])
        order.append(req.req_id)
        req.started = True
        if req.first_tick == 0:
            req.first_tick = service._tick
        return False

    def take_rg(req) -> float:
        """Advance req's cursor one row group; charge its tenant's vtime
        in estimated decode-seconds.  Returns the row group's estimated
        decoded BYTES — the tick budget (`tick_bytes`) stays byte-
        denominated even though the fairness clock runs on device time."""
        rg = req.row_groups[req.cursor]
        cost_s = float(req.rg_costs[req.cursor])
        cost_b = float(req.rg_bytes[req.cursor])
        req.cursor += 1
        units[req.req_id][1].append(rg)
        req.charged_s += service._vcharge(req.tenant, cost_s, cost_b,
                                          table=req.reader.path)
        req.charged_raw_s += cost_s
        return cost_b

    def exhausted(req) -> bool:
        return req.cursor >= len(req.row_groups)

    # -- deadline expiry: a held request always dispatches by its deadline,
    #    budget and request cap notwithstanding
    if service.hold_ticks > 0:
        for req in eligible:
            if req.held_ticks >= service.hold_ticks and not req.started:
                open_unit(req)
                if not exhausted(req):
                    spent += take_rg(req)
                tel.inc("hold_deadline_dispatch")

    if service.scheduler == "fifo":
        # Seed behavior: strict arrival order, head-of-line — a request
        # must fully dispatch before the next one starts, so a huge scan
        # occupies tick after tick (the contrast WFQ exists to fix).
        for req in sorted(eligible, key=lambda r: r.req_id):
            if (spent >= budget and spent > 0) or (
                req.req_id not in units and len(units) >= cap
            ):
                break
            open_unit(req)
            while not exhausted(req):
                spent += take_rg(req)
                if spent >= budget:
                    break
            if not exhausted(req):
                break  # head-of-line: the unfinished request blocks
    else:  # wfq
        candidates = [r for r in eligible if not exhausted(r) or r.req_id not in units]
        # `spent == 0` guarantees one dispatch per tick even when tick_bytes
        # is zero or pathologically small — same progress rule as FIFO
        while candidates and (spent < budget or spent == 0.0):
            avail = [r for r in candidates if r.req_id in units or len(units) < cap]
            if not avail:
                break
            tenant = min(
                {r.tenant for r in avail},
                key=lambda t: (service._vtime.get(t, 0.0), t),
            )
            req = min((r for r in avail if r.tenant == tenant), key=lambda r: r.req_id)
            open_unit(req)
            if not exhausted(req):
                spent += take_rg(req)
            if exhausted(req):
                candidates.remove(req)

    # -- coalescing sweep: the hold window's payoff.  A request that waited
    #    (or whose partner waited) rides in the SAME tick as its partner so
    #    the shared row groups decode once in this tick's pool.  Only the
    #    groups ALREADY dispatched this tick ride free (their decodes are
    #    pool hits, not fresh work); any fresh group still charges the tick
    #    budget, so a big pulled-in partner cannot smuggle a whole scan past
    #    WFQ preemption — its unshared tail waits for normal scheduling.
    if service.hold_ticks > 0:
        for req in eligible:
            if req.req_id in units or req.started:
                continue
            partners = [
                u for u, _ in list(units.values())
                if u is not req and coalesce_compatible(req, u)
            ]
            if not partners or not (
                req.held_ticks > 0 or any(p.held_ticks > 0 for p in partners)
            ):
                continue
            shared = {
                rg
                for u, rgs in list(units.values())
                if u is not req and u.reader.path == req.reader.path
                for rg in rgs
            }
            while not exhausted(req):
                free = req.row_groups[req.cursor] in shared
                if not free and spent >= budget:
                    break  # fresh decode work: back to budgeted scheduling
                if req.req_id not in units:
                    open_unit(req)
                cost = take_rg(req)
                if not free:
                    spent += cost
        for req, _ in list(units.values()):
            if (
                req.held_ticks > 0
                and not req.release_counted
                and any(
                    u is not req and coalesce_compatible(req, u)
                    for u, _ in units.values()
                )
            ):
                req.release_counted = True
                tel.inc("hold_released")

    # -- whoever is still held has waited one more tick toward the deadline
    for req in held:
        req.held_ticks += 1
        if req.held_ticks == 1:
            tel.inc("held_requests")
        tel.inc("held_ticks")

    # -- flight recorder: attribute this tick's queued time by WHY the
    #    request waited.  Held requests sit in a hold_window span; eligible
    #    requests the fair scheduler passed over sit in wfq_wait.  The wait
    #    spans close the instant run_tick dispatches a slice, so waiting
    #    and executing can never overlap in the span tree.
    tracer = service.tracer
    if tracer is not None and tracer.has_live():
        for req in held:
            rt = tracer.live(req.req_id)
            if rt is not None:
                tracer.wait(rt, "hold_window", tick=service._tick)
        for req in eligible:
            if req.req_id in units:
                continue
            rt = tracer.live(req.req_id)
            if rt is not None:
                tracer.wait(rt, "wfq_wait", tick=service._tick)

    return [units[rid] for rid in order]


# ---------------------------------------------------------------------------
# tick execution (HOW the batch runs)
# ---------------------------------------------------------------------------

def run_tick(service, batch: List[Tuple[object, List[int]]]) -> None:
    """Execute one tick's dispatch units: group by table, coalesce through
    a window-scoped view into the store's decoded tier, advance each
    request's resumable scan, simulate the storage->NIC fetch.  Completed
    results land on each ticket."""
    groups: Dict[str, List[Tuple[object, List[int]]]] = {}
    for req, rgs in batch:
        groups.setdefault(req.reader.path, []).append((req, rgs))

    tel = service.telemetry
    tracer = service.tracer
    for _path, group in groups.items():
        # decodes pinned through this window survive `hold_ticks` more
        # ticks, so a late-arriving compatible partner reuses them
        pool = service.store.window(
            expires_tick=service._tick + service.hold_ticks,
            max_bytes=service.pool_bytes,
        )
        if len(group) > 1:
            tel.inc("coalesced_groups")
            tel.inc("coalesced_requests", len(group))
        # (req, fetched rgs, launch delta, fault-plane seconds delta)
        fetches: List[Tuple[object, List[int], int, float]] = []
        if service.batch_decode and len(group) > 1:
            # cross-request bucket stacking: every coalesced request's
            # pages decode through ONE bucket pass (engine.
            # scan_group_batched) instead of per-request launches that
            # meet only at the pool
            _run_group_stacked(service, group, pool, fetches)
            _finish_group(service, pool, fetches)
            continue
        for req, rgs in group:
            pool.owner = req.tenant  # retained pins bill their decoder
            # flight recorder: the slice span, plus the engine-side slice
            # context (trace.set_slice) that lets decode/fetch/filter/store
            # spans attach without a plumbed-through tracer argument
            rt = tracer.live(req.req_id) if tracer is not None else None
            if rt is not None:
                tracer.end_wait(rt)  # waiting ends the moment we dispatch
                tracer.begin(rt, "slice_dispatch", tick=service._tick,
                             rgs=len(rgs))
                trace.set_slice(tracer, rt)
            try:
                try:
                    if req.rs is None:  # first dispatch: pin the offload mode
                        # service._choose_mode wraps the adaptive policy
                        # with the circuit breaker's degraded-raw override
                        mode = service._choose_mode(req)
                        tel.inc(f"offload_{mode}")
                        req.mode = mode
                        req.rs = ResumableScan(
                            service.engine, req.reader, req.plan, blooms=req.blooms,
                            offload=mode, row_groups=req.row_groups,
                            scan_tag=req.scan_tag,
                        )
                    rs = req.rs
                    work0 = dict(rs.stats.decode_work)
                    launches0 = rs.stats.kernel_launches
                    peer0 = rs.stats.peer_bytes
                    fault0 = rs.stats.fault_wait_s
                    if rs.result is None and rgs:
                        dec0 = rs.stats.decoded_bytes
                        fetched: List[int] = []
                        if service.batch_decode:
                            # the whole WFQ slice goes to the engine as ONE
                            # batch: pages bucketed by (encoding, k, dtype),
                            # one kernel launch per bucket, and the engine
                            # reports which groups actually pulled encoded
                            # bytes (store-resident groups fetch nothing)
                            _, fetched = rs.advance_batched(rgs, pool=pool)
                            tel.inc("batch_slices")
                            tel.inc("batch_slice_rgs", len(rgs))
                        else:
                            # advance one row group at a time so the fetch
                            # simulation sees exactly the groups that pulled
                            # encoded bytes — store-resident groups (decoded,
                            # window-pinned, or page-tier) fetch nothing and
                            # are skipped at row-group granularity, not per
                            # slice
                            for rg in rgs:
                                enc0 = rs.stats.encoded_bytes
                                rs.advance([rg], pool=pool)
                                if rs.stats.encoded_bytes > enc0:
                                    fetched.append(rg)
                        tel.observe_tenant_bytes(req.tenant, rs.stats.decoded_bytes - dec0)
                        if fetched:
                            fetches.append(
                                (req, fetched,
                                 rs.stats.kernel_launches - launches0,
                                 rs.stats.fault_wait_s - fault0))
                    if rgs:
                        # retroactive honesty: the estimate was charged at
                        # dispatch; re-bill by the decode work the slice REALLY
                        # did (ScanStats.decode_work — keyed by the encodings
                        # actually read, immune to mis-estimated requests) plus
                        # the launches it REALLY dispatched (bucketed batch
                        # slices launch far fewer than the sequential estimate
                        # and are refunded the difference).  A cache/pool-
                        # resident slice did no work — fully refunded.
                        work = {
                            e: b - work0.get(e, 0)
                            for e, b in rs.stats.decode_work.items()
                            if b - work0.get(e, 0)
                        }
                        launches = rs.stats.kernel_launches - launches0
                        tel.inc("decode_launches", launches)
                        tel.inc("decode_slice_rgs", len(rgs))  # both dispatch modes
                        if rt is not None:
                            tracer.begin(rt, "reconcile")
                        actual_s = _reconcile_slice(
                            service, req, work, launches,
                            peer_bytes=rs.stats.peer_bytes - peer0,
                            fault_s=rs.stats.fault_wait_s - fault0)
                        if rt is not None:
                            tracer.end(rt, name="reconcile",
                                       launches=launches, actual_s=actual_s)
                except DEVICE_ERRORS:
                    raise  # the card's fault, not this request's
                except Exception as e:  # noqa: BLE001 — isolate faulty requests
                    req.ticket.error = e
                    tel.inc("failed")
                    continue
                if rs.result is not None:
                    res = rs.result
                    req.ticket.result = res
                    tel.inc("decoded_bytes", res.stats.decoded_bytes)
                    tel.inc("decoded_bytes_fresh", res.stats.decoded_bytes_fresh)
                    tel.inc("encoded_bytes", res.stats.encoded_bytes)
                    tel.inc("rows_out", res.stats.rows_out)
                    if res.stats.cache_hit:
                        tel.inc("prefiltered_hits")
            finally:
                if rt is not None:
                    trace.set_slice(None, None)
                    tracer.end(rt, name="slice_dispatch", mode=req.mode or "")
        _finish_group(service, pool, fetches)


def _finish_group(service, pool, fetches) -> None:
    """Per-group tick epilogue shared by both dispatch paths: pool reuse
    telemetry + the storage->NIC fetch simulation."""
    tel = service.telemetry
    tel.inc("decoded_bytes_saved", pool.hit_bytes)
    if pool.retained_hits:  # served from a PREVIOUS tick's window pins
        tel.inc("retained_hits", pool.retained_hits)
        tel.inc("retained_reuse_bytes", pool.retained_hit_bytes)
        tel.inc("retained_redecode_saved_s", pool.retained_saved_s)
    if pool.rejected_puts:
        tel.inc("pool_rejected_puts", pool.rejected_puts)

    _simulate_fetch(service, fetches)


def _run_group_stacked(service, group, pool, fetches) -> None:
    """Dispatch one table's coalesced requests as a SINGLE cross-request
    bucket pass.

    Before this path, same-tick same-table requests each launched their
    own (encoding, k, dtype) buckets and shared decodes only through pool
    hits at finalize time.  Here the whole group's pages stack into one
    set of buckets (engine.scan_group_batched): a page two requests both
    need decodes once, launches drop again by the stacking factor, and
    the engine's strict item ordering keeps results AND accounting
    bit-identical to the sequential per-request dispatch.  If the group
    pass itself fails, every request falls back to its own
    `advance_batched` (per-request fault isolation is preserved either
    way — one poisoned request never takes down its partners)."""
    tel = service.telemetry
    tracer = service.tracer
    engine = service.engine

    # -- per request: open the slice span, pin mode, create the scan ----
    live = []  # (req, rgs, rt, work0, launches0, dec0, peer0, fault0)
    items: List[dict] = []
    item_of: Dict[int, int] = {}  # req_id -> index into the group output
    for req, rgs in group:
        pool.owner = req.tenant  # retained pins bill their decoder
        rt = tracer.live(req.req_id) if tracer is not None else None
        if rt is not None:
            tracer.end_wait(rt)  # waiting ends the moment we dispatch
            tracer.begin(rt, "slice_dispatch", tick=service._tick,
                         rgs=len(rgs))
            trace.set_slice(tracer, rt)
        try:
            if req.rs is None:  # first dispatch: pin the offload mode
                mode = service._choose_mode(req)
                tel.inc(f"offload_{mode}")
                req.mode = mode
                req.rs = ResumableScan(
                    engine, req.reader, req.plan, blooms=req.blooms,
                    offload=mode, row_groups=req.row_groups,
                    scan_tag=req.scan_tag,
                )
        except DEVICE_ERRORS:
            raise  # the card's fault, not this request's
        except Exception as e:  # noqa: BLE001 — isolate faulty requests
            req.ticket.error = e
            tel.inc("failed")
            if rt is not None:
                trace.set_slice(None, None)
                tracer.end(rt, name="slice_dispatch", mode=req.mode or "")
            continue
        finally:
            if rt is not None:
                trace.set_slice(None, None)
        rs = req.rs
        live.append((req, rgs, rt, dict(rs.stats.decode_work),
                     rs.stats.kernel_launches, rs.stats.decoded_bytes,
                     rs.stats.peer_bytes, rs.stats.fault_wait_s))
        if rs.result is None and rgs:
            item_of[req.req_id] = len(items)
            items.append({
                "reader": req.reader, "rgs": list(rgs), "plan": rs.plan,
                "pred": rs.pred, "blooms": rs.blooms, "stats": rs.stats,
                "offload": rs.offload, "owner": req.tenant,
                "trace": (tracer, rt) if rt is not None else None,
            })

    # -- ONE bucket pass across every request's slice -------------------
    results = None
    if items:
        try:
            results = engine.scan_group_batched(items, pool=pool)
            tel.inc("xreq_groups")
            tel.inc("xreq_requests", len(items))
        except DEVICE_ERRORS:
            raise  # never re-run request by request after the card failed
        except Exception:  # noqa: BLE001 — fall back to per-request dispatch
            results = None
            tel.inc("xreq_fallback")

    # -- finalize per request, in dispatch order ------------------------
    for req, rgs, rt, work0, launches0, dec0, peer0, fault0 in live:
        pool.owner = req.tenant
        rs = req.rs
        if rt is not None:
            trace.set_slice(tracer, rt)
        try:
            try:
                idx = item_of.get(req.req_id)
                if idx is not None:
                    if results is not None:
                        per_rg, fetched = results[idx]
                        rs.ingest_batched(rgs, per_rg)
                    else:  # group pass failed: this request runs alone
                        _, fetched = rs.advance_batched(rgs, pool=pool)
                    tel.inc("batch_slices")
                    tel.inc("batch_slice_rgs", len(rgs))
                    tel.observe_tenant_bytes(
                        req.tenant, rs.stats.decoded_bytes - dec0)
                    if fetched:
                        fetches.append(
                            (req, fetched,
                             rs.stats.kernel_launches - launches0,
                             rs.stats.fault_wait_s - fault0))
                if rgs:
                    work = {
                        e: b - work0.get(e, 0)
                        for e, b in rs.stats.decode_work.items()
                        if b - work0.get(e, 0)
                    }
                    launches = rs.stats.kernel_launches - launches0
                    tel.inc("decode_launches", launches)
                    tel.inc("decode_slice_rgs", len(rgs))
                    if rt is not None:
                        tracer.begin(rt, "reconcile")
                    actual_s = _reconcile_slice(
                        service, req, work, launches,
                        peer_bytes=rs.stats.peer_bytes - peer0,
                        fault_s=rs.stats.fault_wait_s - fault0)
                    if rt is not None:
                        tracer.end(rt, name="reconcile",
                                   launches=launches, actual_s=actual_s)
            except DEVICE_ERRORS:
                raise  # the card's fault, not this request's
            except Exception as e:  # noqa: BLE001 — isolate faulty requests
                req.ticket.error = e
                tel.inc("failed")
                continue
            if rs.result is not None:
                res = rs.result
                req.ticket.result = res
                tel.inc("decoded_bytes", res.stats.decoded_bytes)
                tel.inc("decoded_bytes_fresh", res.stats.decoded_bytes_fresh)
                tel.inc("encoded_bytes", res.stats.encoded_bytes)
                tel.inc("rows_out", res.stats.rows_out)
                if res.stats.cache_hit:
                    tel.inc("prefiltered_hits")
        finally:
            if rt is not None:
                trace.set_slice(None, None)
                tracer.end(rt, name="slice_dispatch", mode=req.mode or "")


def _reconcile_slice(service, req, work: Dict[str, int], launches: int = 0,
                     peer_bytes: int = 0, fault_s: float = 0.0) -> float:
    """Close the loop on one completed slice: compare the decode-seconds
    charged at dispatch against the slice's actual cost and re-bill the
    tenant's virtual time (service._vreconcile).

    Actual cost is priced from the decode work the engine REALLY did
    (`work`: fresh output bytes by the encoding of the buffers actually
    read — ground truth from the scan, independent of the request's own
    estimate) plus the kernel `launches` it really dispatched, through the
    service's cost model.  An honest solo raw sequential scan reconciles
    to exactly zero; a batched slice is refunded the launch overhead its
    buckets amortized; a 4x under-estimating request is re-billed 4x in
    the same tick it decoded (and its tenant's future dispatches are
    re-priced); a pool/cache-fed slice is refunded.

    `peer_bytes` is what this slice pulled over the inter-pod hop (fabric
    peer block-store fetches): the transfer is billed to the tenant whose
    miss triggered it at the calibrated inter-pod link rate — cheaper
    than the storage hop, but never free.

    `fault_s` is the slice's fault-plane time (ScanStats.fault_wait_s
    delta: retry backoff, failed attempts, latency spikes, hedge
    exposure — datapath/faults.py).  It is billed into the SAME actual
    so a faulty tenant's retries advance that tenant's virtual time —
    recovery work can never buy share from healthy tenants — and the
    sched + recon == actual telemetry invariant keeps holding under
    chaos."""
    charged_s, raw_s = req.charged_s, req.charged_raw_s
    req.charged_s = req.charged_raw_s = 0.0
    actual_s = sum(
        service.cost_model.decode_seconds(nbytes, encoding)
        for encoding, nbytes in work.items()
    ) + service.cost_model.launch_seconds(launches)
    if peer_bytes:
        peer_s = service.cost_model.peer_fetch_seconds(peer_bytes)
        actual_s += peer_s
        service.telemetry.observe_peer(req.tenant, peer_bytes, peer_s)
    if fault_s:
        actual_s += fault_s
        service.telemetry.observe_fault_wait(req.tenant, fault_s)
    service._vreconcile(req.tenant, charged_s, raw_s, actual_s,
                        table=req.reader.path)
    return actual_s


def _simulate_fetch(service, fetches) -> None:
    """Model the tick's storage->NIC transfer for the row groups actually
    read this tick (cache-hit / pool-fed / failed slices fetch nothing),
    double-buffered against on-device decode.

    Decode is sized exactly like the engine's (engine.decode_footprint):
    PACK_BLOCK-padded rows, true dtype widths, and a fused scan's
    predicate column is processed (it contributes decode time at its
    encoding's rate) but never materialized (it contributes no decoded
    bytes) — plus the calibrated per-launch dispatch overhead.  All times
    come from the service's cost model, so netsim and the WFQ charge read
    one table.

    Pipeline granularity follows the dispatch mode.  Sequential: one unit
    per ROW GROUP (fetch of group i+1 hides behind its neighbor's decode),
    merged across requests so a shared group is priced once.  Batched: one
    unit per DISPATCH SLICE in dispatch order — the next slice's whole
    fetch overlaps this slice's bucketed batch decode, which is the
    "pipelined fetch/decode scan loop" the batch path exists for; columns
    an earlier slice already priced this tick contribute nothing (same
    first-contributor-wins rule as the merge).

    Each row group's metadata comes from a reader that actually scanned it
    — NOT from whichever request happened to be first in the group.  Two
    reader objects may share a path while disagreeing on metadata (e.g. a
    re-opened file); pricing each request's footprint with its own reader
    keeps the simulated byte counts honest (regression-tested in
    tests/test_torch_scheduler.py).
    """
    cm = service.cost_model
    enc: List[int] = []
    dec: List[int] = []
    dec_s: List[float] = []
    if service.batch_decode:
        # one pipeline unit per slice; dedupe (rg, column) across slices
        seen: Dict[Tuple[int, str], dict] = {}
        for req, rgs, launches, _fault_s in fetches:
            enc_b = dec_b = 0
            dec_t = 0.0
            for fp in service.engine.decode_footprint(req.reader, req.plan,
                                                      rgs, pred=req.pred):
                for name, col in fp["columns"].items():
                    prev = seen.get((fp["rg"], name))
                    if prev is None:
                        seen[(fp["rg"], name)] = dict(col)
                        enc_b += col["encoded_bytes"]
                        dec_t += cm.decode_seconds(col["nbytes"], col["encoding"])
                        if col["materialized"]:
                            dec_b += col["nbytes"]
                    elif col["materialized"] and not prev["materialized"]:
                        prev["materialized"] = True
                        dec_b += col["nbytes"]
            enc.append(enc_b)
            dec.append(dec_b)
            dec_s.append(dec_t + cm.launch_seconds(launches))
        clock = service.slice_clock
        if clock is not None:
            # cumulative cross-tick pipeline: slice i+1's fetch is in
            # flight while slice i's batch decode runs, tick boundaries
            # notwithstanding (counters are set, not incremented — the
            # clock already accumulates)
            tracer = service.tracer
            for (req, frgs, _l, fault_s), enc_b, dec_t in zip(fetches, enc,
                                                              dec_s):
                # fault-plane seconds ride the slice's fetch leg so chaos
                # tails show up in the same hidden-vs-exposed anatomy
                info = clock.feed(enc_b, dec_t, extra_fetch_s=fault_s)
                # flight recorder: per-slice hidden-vs-exposed fetch time
                # from the streaming pipeline clock
                rt = tracer.live(req.req_id) if tracer is not None else None
                if rt is not None:
                    tracer.event(rt, "sim_fetch", nbytes=enc_b, rgs=len(frgs),
                                 fetch_s=info["fetch_s"],
                                 decode_s=info["decode_s"],
                                 hidden_s=info["hidden_s"],
                                 exposed_s=info["exposed_s"])
            tel = service.telemetry
            tel.counters["sim_pipe_slices"] = float(clock.slices)
            tel.counters["sim_pipe_serial_s"] = clock.serial_s
            tel.counters["sim_pipe_overlapped_s"] = clock.overlapped_s
            tel.counters["sim_pipe_saved_s"] = clock.saved_s
    else:
        # rg -> merged column footprints.  engine.decode_footprint is the
        # ONE source of truth for what a scan materializes vs merely
        # processes (padded rows, dtype widths, per-row-group fusability —
        # auto-encoded files can flip a predicate column's encoding between
        # groups), so the transfer model cannot drift from the WFQ charge.
        # Each request's columns are priced with its OWN reader's metadata;
        # on overlap the first contributor wins (materialization is an OR).
        per_rg: Dict[int, Dict[str, dict]] = {}
        for req, rgs, _launches, _fault_s in fetches:
            for fp in service.engine.decode_footprint(req.reader, req.plan,
                                                      rgs, pred=req.pred):
                cols = per_rg.setdefault(fp["rg"], {})
                for name, col in fp["columns"].items():
                    prev = cols.get(name)
                    if prev is None:
                        cols[name] = dict(col)
                    elif col["materialized"] and not prev["materialized"]:
                        prev["materialized"] = True
        for rg in sorted(per_rg):
            cols = per_rg[rg].values()
            enc.append(sum(c["encoded_bytes"] for c in cols))
            dec.append(sum(c["nbytes"] for c in cols if c["materialized"]))
            # sequential decode launches once per column (the same bill
            # estimate_row_groups charges)
            dec_s.append(sum(cm.decode_seconds(c["nbytes"], c["encoding"])
                             for c in cols) + cm.launch_seconds(len(cols)))
    if not enc:
        return
    sim = service.pipeline.simulate(enc, dec, decode_seconds=dec_s)
    tel = service.telemetry
    tel.inc("sim_fetch_encoded_bytes", sum(enc))
    tel.inc("sim_fetch_decoded_bytes", sum(dec))
    tel.inc("sim_fetch_serial_s", sim["serial_s"])
    tel.inc("sim_fetch_overlapped_s", sim["overlapped_s"])
    tel.inc("sim_fetch_saved_s", sim["saved_s"])
    tracer = service.tracer
    if tracer is not None and not service.batch_decode:
        # sequential dispatch pipelines at row-group granularity merged
        # across requests, so per-request anatomy does not exist — attach
        # the tick-level overlap summary to each participating request
        for req, frgs, _l, _fs in fetches:
            rt = tracer.live(req.req_id)
            if rt is not None:
                tracer.event(rt, "sim_fetch", rgs=len(frgs),
                             serial_s=sim["serial_s"],
                             overlapped_s=sim["overlapped_s"],
                             saved_s=sim["saved_s"],
                             shared=len(fetches) > 1)
