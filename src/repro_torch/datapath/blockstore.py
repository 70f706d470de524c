"""Unified tiered block store — ONE cost-aware cache hierarchy.

Port of `repro.datapath.blockstore`, with the same tiers, ledger, eviction,
windows and fabric hook:

  tiers      'encoded'      raw encoded pages (skip the storage->NIC
                            re-fetch; priced by the link model)
             'decoded'      decoded row-group columns (skip the decode;
                            priced by the per-encoding decode rate)
             'prefiltered'  whole filtered ScanResults, or a pushed-down
                            aggregate's accumulators (skip the scan; priced
                            by the ground-truth decode work behind them)
  ledger     one byte budget across every tier — used == the summed billed
             bytes of the kept entries, never above capacity.
  eviction   cost-aware: the victim is the unpinned entry with the lowest
             estimated re-creation seconds per byte, LRU as the tie-break;
             a decoded victim with a demote payload falls back to its
             encoded page.
  windows    a StoreView pins decoded entries for a scheduling window;
             entries a raw scan pinned are ephemeral and drop at expiry.

The ledger's currency.  Decoded columns and prefiltered results are tensors
on the engine's device (the card, unless the engine runs on the CPU), while
encoded pages stay numpy arrays in host memory.  One ledger still counts
them all, as the reference's counts every tier against one budget: the
capacity bounds the card's bytes and the host's pages together.  A tensor
is billed at `numel() * element_size()` (`Tensor.nbytes`), the number the
reference bills for the same array; an EncodedColumn, a ScanResult or any
other dataclass is billed field by field by the reference's rule.

Eviction frees the card.  The store is the only owner of what it keeps: a
tensor put into it that views a larger buffer (a batched decode's slice of
its bucket, say) is copied into a buffer of its own first, so neither the
bucket stays alive behind a small entry nor does the ledger undercount it,
and dropping an entry drops the last reference the engine holds.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Dict, Hashable, List, Optional, Tuple

import torch

from repro_torch.datapath import trace
from repro_torch.datapath.costmodel import CostModel

TIERS = ("encoded", "decoded", "prefiltered")

# A window pin that never expires (standalone DecodePool compatibility).
NEVER = 1 << 62


def _nbytes(obj) -> int:
    if hasattr(obj, "nbytes"):
        return int(obj.nbytes)
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # e.g. a whole prefiltered ScanResult or an EncodedColumn: bill its
        # arrays, otherwise the ledger never sees them and the store grows
        # unbounded
        return sum(_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 64


def _owned(obj):
    """`obj` with every tensor that views a larger buffer replaced by a copy
    of its own (containers and dataclasses rebuilt only where something
    changed): what the store keeps must not hold a bigger buffer alive."""
    if isinstance(obj, torch.Tensor):
        if obj.untyped_storage().nbytes() > obj.nbytes:
            return obj.clone()
        return obj
    if isinstance(obj, dict):
        out = {k: _owned(v) for k, v in obj.items()}
        return obj if all(out[k] is v for k, v in obj.items()) else out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changed = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            w = _owned(v)
            if w is not v:
                changed[f.name] = w
        return dataclasses.replace(obj, **changed) if changed else obj
    return obj


@dataclasses.dataclass
class TierStats:
    """Cumulative per-tier counters (live entries/bytes are computed by
    BlockStore.stats() from the ledger, so they can never drift)."""

    hits: int = 0
    misses: int = 0
    hit_bytes: int = 0
    puts: int = 0
    rejected_puts: int = 0
    evictions: int = 0
    expired: int = 0  # ephemeral window entries dropped at expiry
    demotions: int = 0  # decoded victims demoted to their encoded pages
    redecode_saved_s: float = 0.0  # estimated re-creation seconds hits avoided

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass
class BlockEntry:
    key: Hashable
    value: Any
    tier: str
    nbytes: int
    encoding: Optional[str]  # decoded tier: source encoding (pricing key)
    redecode_s: float  # estimated seconds to re-create this entry
    seq: int  # LRU clock (monotone; refreshed on touch)
    pin_tick: int = -1  # tick of the most recent window pin
    pin_expires: int = -1  # last tick (inclusive) the window pin covers
    ephemeral: bool = False  # drop at pin expiry unless promoted
    owner: Optional[str] = None  # tenant whose decode pinned it
    # eviction fallback: (key, value) of the encoded page(s) this decode
    # came from — eviction demotes to the encoded tier (pay only the
    # re-decode to get back) instead of dropping to zero (pay re-fetch
    # AND re-decode)
    demote: Optional[Tuple[Hashable, Any]] = None
    # tenants observed benefiting from this entry (window hits); retention
    # charges split across them instead of billing only the decoder
    beneficiaries: set = dataclasses.field(default_factory=set)

    def pinned(self, tick: int) -> bool:
        return self.pin_expires >= tick

    def rank(self) -> Tuple[float, int]:
        """Eviction priority: cheapest re-creation seconds per byte first,
        least recently used as the tie-break."""
        return (self.redecode_s / max(self.nbytes, 1), self.seq)


class BlockStore:
    """Tiered block cache with a single byte ledger and cost-aware
    eviction.  Keys live in one flat namespace (the engine's key tuples
    already disambiguate: ("page", ...) / ("rg", ...) / ("scan", ...));
    the tier is entry metadata driving pricing and the telemetry ledger,
    not a lookup dimension."""

    def __init__(self, capacity_bytes: int = 2 << 30,
                 cost_model: Optional[CostModel] = None):
        self.capacity = capacity_bytes
        self.cost_model = cost_model or CostModel()
        self.tick = 0
        self.used = 0
        self._entries: Dict[Hashable, BlockEntry] = {}
        self._seq = itertools.count()
        self._tier_stats: Dict[str, TierStats] = {t: TierStats() for t in TIERS}
        # Lazy-invalidation eviction heap: (seconds/byte, seq, key) records
        # pushed on every insert/touch; a record is live iff the entry
        # still exists with that exact seq (any touch/resize/re-price bumps
        # seq and pushes a fresh record, orphaning the old one).  Victim
        # selection is O(log n) amortized instead of the old O(n log n)
        # sort per eviction (ROADMAP open item).
        self._heap: List[Tuple[float, int, Hashable]] = []
        # keys that MAY hold a live window pin (pruned lazily) — lets the
        # can-we-cover-the-shortfall check sum pinned bytes without a full
        # entry walk
        self._pinned_keys: set = set()
        # window-view hit accounting, kept separate from tier hits so the
        # shim's .hits still means "cache lookups" (not pool coalescing)
        self.window_hits = 0
        self.window_hit_bytes = 0
        self.window_saved_s = 0.0
        # fabric peer-fetch accounting: entries this store pulled from a
        # sibling pod's store (hits) and served to one (serves).  The
        # seconds are the inter-pod hop price — what the scheduler folds
        # into WFQ actuals, and what the bench compares against the
        # storage link to show the remote tier is the cheaper source.
        self.peer_hits = 0
        self.peer_hit_bytes = 0
        self.peer_hit_seconds = 0.0
        self.peer_serves = 0
        self.peer_serve_bytes = 0
        # a sibling probe that raised (pod died between the liveness check
        # and the fetch) — counted here, then the fetch falls back to the
        # next peer / storage instead of propagating (DESIGN.md §17)
        self.peer_errors = 0
        # Fault plane: keys whose fetched bytes failed checksum
        # verification.  A quarantined key reads as a miss everywhere
        # (local get/peek, peer fetch, residency probes — the entry is
        # dropped) until a verified re-fetch puts it back, which clears
        # the mark.  The set holds keys currently poisoned; the counter
        # is cumulative.
        self._quarantined: set = set()
        self.quarantines = 0
        # Pod-death model for the fabric: a dead store refuses probes by
        # raising — this is what a peer fetch against a crashed sibling
        # actually sees, and what PeerFetcher must absorb.
        self.dead = False

    # ------------------------------------------------------------------
    # pricing
    # ------------------------------------------------------------------
    def _price(self, tier: str, nbytes: int, encoding: Optional[str],
               decode_work: Optional[Dict[str, int]]) -> float:
        """Estimated seconds to re-create an entry if evicted.

        encoded      re-fetch over the storage->NIC link
        decoded      re-decode at the encoding's calibrated rate
        prefiltered  re-do the scan's ground-truth decode work
        Decoded/prefiltered entries are floored at the PLAIN rate for
        their own bytes: however the entry was produced, serving it again
        at least re-materializes its output."""
        cm = self.cost_model
        if tier == "encoded":
            return cm.link_model().fetch_seconds(nbytes)
        floor = cm.decode_seconds(nbytes, "plain")
        if decode_work:
            return max(floor, sum(cm.decode_seconds(b, e)
                                  for e, b in decode_work.items()))
        return max(floor, cm.decode_seconds(nbytes, encoding or "plain"))

    # ------------------------------------------------------------------
    # core ops
    # ------------------------------------------------------------------
    def peek(self, key: Hashable) -> Optional[BlockEntry]:
        """Entry lookup without touching LRU order or hit/miss counters."""
        if self.dead:
            raise ConnectionError("block store is dead (pod crashed)")
        return self._entries.get(key)

    def quarantine(self, key: Hashable) -> None:
        """Poison `key` after a checksum failure: drop any resident copy
        and make the key read as a miss until a verified re-fetch puts a
        clean value back (put() clears the mark).  A quarantined page can
        therefore NEVER be decoded — the engine is forced back to
        storage, and the fault plane retries from there."""
        e = self._entries.pop(key, None)
        if e is not None:
            self.used -= e.nbytes
            self._pinned_keys.discard(key)
            self._tier_stats[e.tier].evictions += 1
        self._quarantined.add(key)
        self.quarantines += 1
        if trace._CUR is not None:
            trace.event("quarantine", nbytes=e.nbytes if e else 0)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def touch(self, entry: BlockEntry) -> None:
        entry.seq = next(self._seq)
        self._heap_push(entry)

    def _heap_push(self, entry: BlockEntry) -> None:
        heapq.heappush(self._heap, entry.rank() + (entry.key,))
        # stale records accumulate one per touch; compact when they clearly
        # dominate so the heap stays O(live entries)
        if len(self._heap) > 64 and len(self._heap) > 4 * len(self._entries):
            self._heap = [
                e.rank() + (e.key,) for e in self._entries.values()
            ]
            heapq.heapify(self._heap)

    def get(self, key: Hashable, tier: Optional[str] = None):
        """Counting lookup: a hit is recorded under the entry's tier (plus
        the re-creation seconds it avoided); a miss under `tier` (the tier
        the caller expected to find the key in, 'decoded' by default)."""
        e = self._entries.get(key)
        if e is None:
            self._tier_stats[tier or "decoded"].misses += 1
            return None
        st = self._tier_stats[e.tier]
        st.hits += 1
        st.hit_bytes += e.nbytes
        st.redecode_saved_s += e.redecode_s
        if trace._CUR is not None:  # flight recorder: hit inside a slice
            trace.event("store_hit", tier=e.tier, nbytes=e.nbytes,
                        saved_s=e.redecode_s)
        self.touch(e)
        return e.value

    def put(
        self,
        key: Hashable,
        value: Any,
        tier: str = "decoded",
        encoding: Optional[str] = None,
        decode_work: Optional[Dict[str, int]] = None,
        pin_until: Optional[int] = None,
        ephemeral: bool = False,
        owner: Optional[str] = None,
        demote: Optional[Tuple[Hashable, Any]] = None,
    ) -> bool:
        """Insert or refresh one entry; returns False when the entry could
        not be kept (bigger than the store, or the shortfall is pinned).
        Re-inserting an existing key bills only the size delta, and a
        rejected resize leaves the old entry — the ledger never holds an
        unbilled or over-budget byte."""
        assert tier in TIERS, tier
        # a fresh put IS the verified re-fetch that absolves a poisoned key
        self._quarantined.discard(key)
        value = _owned(value)
        nb = _nbytes(value)
        st = self._tier_stats[tier]
        old = self._entries.get(key)
        need = nb - (old.nbytes if old is not None else 0)
        if nb > self.capacity:
            st.rejected_puts += 1
            return False  # never cache something bigger than the device
        if self.used + need > self.capacity:
            self._evict(self.used + need - self.capacity, exclude=key)
            if self.used + need > self.capacity:  # the rest is pinned
                st.rejected_puts += 1
                return False
        seq = next(self._seq)
        if old is not None:
            self.used += need
            old.value = value
            old.nbytes = nb
            old.tier = tier if not ephemeral else old.tier
            old.encoding = encoding or old.encoding
            old.redecode_s = self._price(old.tier, nb, old.encoding, decode_work)
            old.seq = seq
            old.demote = demote or old.demote
            # promotion clears the ephemeral flag; a window re-pin of a
            # persistent entry never re-taints it
            old.ephemeral = old.ephemeral and ephemeral
            if pin_until is not None:
                old.pin_tick = self.tick
                old.pin_expires = max(old.pin_expires, pin_until)
                old.owner = owner or old.owner
                self._pinned_keys.add(key)
            if owner:
                old.beneficiaries.add(owner)
            self._heap_push(old)
            return True
        entry = BlockEntry(
            key=key, value=value, tier=tier, nbytes=nb, encoding=encoding,
            redecode_s=self._price(tier, nb, encoding, decode_work), seq=seq,
            ephemeral=ephemeral, owner=owner, demote=demote,
        )
        if owner:
            entry.beneficiaries.add(owner)
        if pin_until is not None:
            entry.pin_tick = self.tick
            entry.pin_expires = pin_until
            self._pinned_keys.add(key)
        self._entries[key] = entry
        self.used += nb
        st.puts += 1
        self._heap_push(entry)
        return True

    def _pinned_bytes(self) -> int:
        """Bytes held by live window pins, pruning stale pin bookkeeping as
        it goes.  O(pinned keys), not O(entries) — pins are the handful of
        window-held decodes, entries can be thousands."""
        total = 0
        for key in [k for k in self._pinned_keys]:
            e = self._entries.get(key)
            if e is None or not e.pinned(self.tick):
                self._pinned_keys.discard(key)
            else:
                total += e.nbytes
        return total

    def _evictable_bytes(self, exclude: Optional[Hashable]) -> int:
        total = self.used - self._pinned_bytes()
        ex = self._entries.get(exclude) if exclude is not None else None
        if ex is not None and not ex.pinned(self.tick):
            total -= ex.nbytes
        return total

    def _victims_linear(self, exclude: Optional[Hashable] = None) -> List[BlockEntry]:
        """O(n log n) rank-ordered victim list — the heap's oracle.  Kept
        for the property test in tests/test_torch_blockstore.py (heap and linear
        selection must pick the same victim) and for debugging; production
        eviction goes through `_pop_victim`."""
        return sorted(
            (e for e in self._entries.values()
             if e.key != exclude and not e.pinned(self.tick)),
            key=BlockEntry.rank,
        )

    def _pop_victim(self, exclude: Optional[Hashable] = None) -> Optional[BlockEntry]:
        """Next eviction victim off the lazy heap: skip records orphaned by
        touches/resizes/deletes (seq mismatch), defer records for entries
        that are merely unevictable right now (pinned, or the excluded
        key) so they stay discoverable, and return the first live one —
        identical choice to `_victims_linear()[0]`."""
        deferred: List[Tuple[float, int, Hashable]] = []
        victim = None
        while self._heap:
            rec = heapq.heappop(self._heap)
            e = self._entries.get(rec[2])
            if e is None or e.seq != rec[1]:
                continue  # orphaned: entry gone or re-ranked since pushed
            if rec[2] == exclude or e.pinned(self.tick):
                deferred.append(rec)
                continue
            victim = e
            break
        for rec in deferred:
            heapq.heappush(self._heap, rec)
        return victim

    def _demote(self, victim: BlockEntry) -> int:
        """Re-insert an evicted decoded column as its source encoded
        page(s) — getting it back then costs only the re-decode, not
        re-fetch AND re-decode.  Returns the bytes the demoted entry
        re-occupies (0 when demotion was skipped: no payload, source
        pages still resident, or no footprint shrink).  Ephemeral (raw
        window) victims never demote — raw leaves no persistent state."""
        if victim.tier != "decoded" or not victim.demote or victim.ephemeral:
            return 0
        dkey, dval = victim.demote
        if dkey in self._entries:
            return 0  # the encoded pages are still resident on their own
        nb = _nbytes(dval)
        if nb >= victim.nbytes or self.used + nb > self.capacity:
            return 0
        entry = BlockEntry(
            key=dkey, value=dval, tier="encoded", nbytes=nb,
            encoding=victim.encoding,
            redecode_s=self._price("encoded", nb, victim.encoding, None),
            seq=next(self._seq), owner=victim.owner,
            beneficiaries=set(victim.beneficiaries),
        )
        self._entries[dkey] = entry
        self.used += nb
        self._tier_stats["decoded"].demotions += 1
        self._tier_stats["encoded"].puts += 1
        self._heap_push(entry)
        if trace._CUR is not None:
            trace.event("demote", tier="encoded", nbytes=nb)
        return nb

    def _evict(self, need_bytes: int, exclude: Optional[Hashable] = None) -> None:
        """Free at least `need_bytes` by evicting unpinned entries in
        cost-rank order (lowest re-creation seconds per byte first, LRU
        tie-break) via the lazy-invalidation heap.  Window-pinned blocks
        are never victims — and when the evictable entries cannot cover
        the shortfall, NOTHING is evicted: the caller's put will be
        refused anyway, and a doomed put must not flush the unpinned
        working set on its way out.

        A decoded victim carrying a demote payload falls back to the
        encoded tier instead of dropping to zero; the demoted entry is
        itself unpinned, so coverage is preserved (the shortfall and the
        evictable pool grow by the same re-occupied bytes) and the loop
        still terminates (each demotion strictly shrinks the footprint)."""
        if self._evictable_bytes(exclude) < need_bytes:
            return
        while need_bytes > 0:
            victim = self._pop_victim(exclude)
            if victim is None:  # defensive: coverage said this can't happen
                return
            del self._entries[victim.key]
            self.used -= victim.nbytes
            need_bytes -= victim.nbytes
            self._tier_stats[victim.tier].evictions += 1
            if trace._CUR is not None:  # eviction forced by a traced slice
                trace.event("evict", tier=victim.tier, nbytes=victim.nbytes)
            need_bytes += self._demote(victim)

    def advance_tick(self, tick: int) -> None:
        """Move the window clock: pins whose window ended become evictable,
        and ephemeral (raw-scan) entries among them are dropped outright —
        raw mode leaves no persistent state beyond its hold window."""
        self.tick = tick
        for key in [k for k, e in self._entries.items()
                    if e.ephemeral and e.pin_expires < tick]:
            e = self._entries.pop(key)
            self.used -= e.nbytes
            self._pinned_keys.discard(key)
            self._tier_stats[e.tier].expired += 1

    def clear(self) -> None:
        self._entries.clear()
        self.used = 0
        self._heap = []
        self._pinned_keys.clear()

    # ------------------------------------------------------------------
    # metadata probes (non-mutating — admission control and the policy)
    # ------------------------------------------------------------------
    def plan_fetch(self, keys: List[Hashable],
                   tier: Optional[str] = None) -> Tuple[List[Hashable], List[Hashable]]:
        """Split keys into (resident, missing) without touching LRU order
        or counters; `tier` restricts residency to one tier."""
        def resident(k):
            e = self._entries.get(k)
            return e is not None and (tier is None or e.tier == tier)

        cached = [k for k in keys if resident(k)]
        missing = [k for k in keys if not resident(k)]
        return cached, missing

    def pinned(self, key: Hashable) -> bool:
        """Is `key` a live window-pinned decoded block right now?"""
        e = self._entries.get(key)
        return e is not None and e.tier == "decoded" and e.pinned(self.tick)

    def retention_charges(self) -> Dict[str, Tuple[int, float]]:
        """Per-tenant (pinned bytes, per-tick retention price) over window
        pins held ACROSS a tick boundary.  Each entry's price amortizes
        one full re-creation over its window, so holding a decode for its
        whole hold window costs exactly what re-decoding it would have —
        window retention is paid for in the same WFQ currency it saves.

        The price splits EQUALLY across the entry's observed beneficiaries
        (tenants whose window lookups hit it, decoder included) instead of
        billing only the tenant that happened to decode first: a coalesced
        decode that three tenants reuse costs each a third, not the
        decoder everything and the free-riders nothing."""
        out: Dict[str, Tuple[int, float]] = {}
        for e in self._entries.values():
            if not e.pinned(self.tick) or e.pin_tick >= self.tick:
                continue
            who = sorted(e.beneficiaries) or ([e.owner] if e.owner else [])
            if not who:
                continue
            share = 1.0 / len(who)
            price = e.redecode_s / max(e.pin_expires - e.pin_tick, 1)
            for t in who:
                b, s = out.get(t, (0, 0.0))
                out[t] = (b + int(e.nbytes * share), s + price * share)
        return out

    # ------------------------------------------------------------------
    # windows + reporting
    # ------------------------------------------------------------------
    def window(self, expires_tick: int, max_bytes: Optional[int] = None,
               owner: Optional[str] = None) -> "StoreView":
        return StoreView(self, expires_tick, max_bytes=max_bytes, owner=owner)

    def stats(self) -> dict:
        """Deterministic per-tier ledger (key-sorted, plain types) for
        telemetry snapshots and the blockstore bench sub-report."""
        live: Dict[str, Dict[str, int]] = {
            t: {"entries": 0, "bytes": 0, "pinned_bytes": 0} for t in TIERS
        }
        for e in self._entries.values():
            lv = live[e.tier]
            lv["entries"] += 1
            lv["bytes"] += e.nbytes
            if e.pinned(self.tick):
                lv["pinned_bytes"] += e.nbytes
        tiers = {}
        for t in TIERS:
            d = self._tier_stats[t].as_dict()
            d.update(live[t])
            tiers[t] = dict(sorted(d.items()))
        return {
            "capacity": self.capacity,
            "used": self.used,
            "tick": self.tick,
            "tiers": tiers,
            "window_hits": self.window_hits,
            "window_hit_bytes": self.window_hit_bytes,
            "window_saved_s": self.window_saved_s,
            "peer_hits": self.peer_hits,
            "peer_hit_bytes": self.peer_hit_bytes,
            "peer_hit_seconds": self.peer_hit_seconds,
            "peer_serves": self.peer_serves,
            "peer_serve_bytes": self.peer_serve_bytes,
            "peer_errors": self.peer_errors,
            "quarantines": self.quarantines,
            "quarantined_live": len(self._quarantined),
        }


class PeerFetcher:
    """Peer-to-peer block-store fetch for the scan fabric (DESIGN.md §15).

    Installed on a pod's BlockCache (`cache.peer`); consulted only when a
    COUNTING get misses the local store.  A sibling pod that already holds
    the page/decoded column serves it over the inter-pod link — wider
    and shallower than the storage hop, and a decoded-tier hit also skips
    the decode — and it is installed into the local store at the same
    tier so subsequent lookups are plain local hits.  The fabric's pods
    share one device, so the local entry aliases the sibling's tensor (or
    page buffer): nothing is copied, both ledgers bill its bytes as the
    reference's do, and dropping either entry leaves the other intact.

    Scope rules keeping the fabric bit-identical and honestly priced:
      * only 'page' (encoded) and 'rg' (decoded) keys cross pods — whole
        prefiltered results stay pod-local (their keys carry the pod's
        row-group-subset scan tag, so a cross-pod hit could never match
        a different subset anyway);
      * residency PROBES (`__contains__`, `plan_fetch`) stay local-only:
        the policy and scheduler see exactly what single-node pods see,
        and peer traffic happens only when work actually runs;
      * window-pinned / ephemeral state never transfers — the serving
        side is read via `peek` (non-mutating), the local install is an
        ordinary unpinned put.

    `peers` is a zero-arg callable yielding live (pod_id, BlockStore)
    siblings — the fabric rebinds it on drain so a dead pod's store is
    never consulted."""

    PEER_KINDS = ("page", "rg")

    def __init__(self, pod_id: str, peers, link=None):
        from repro_torch.datapath.netsim import interpod_link

        self.pod_id = pod_id
        self.peers = peers
        self.link = link or interpod_link()

    def fetch(self, key: Hashable, into: BlockStore, stats=None):
        """Probe siblings for `key`; on a hit, bill the hop, install a
        local copy, and return the value.  `stats` (a ScanStats) receives
        the transferred bytes so the scheduler can price THIS request's
        peer traffic into its WFQ reconcile."""
        kind = key[0] if isinstance(key, tuple) and key else None
        if kind not in self.PEER_KINDS:
            return None
        try:
            peers = list(self.peers())
        except Exception:
            # the membership callback itself failed — treat as no peers
            into.peer_errors += 1
            return None
        for pid, store in peers:
            if store is into:
                continue
            try:
                e = store.peek(key)
            except Exception:
                # The sibling died between the fabric's liveness check and
                # this probe.  A cache miss must degrade to the next peer
                # (and ultimately storage), never propagate out of the
                # miss path — the requesting scan did nothing wrong.
                into.peer_errors += 1
                if trace._CUR is not None:
                    trace.event("peer_error", source=pid)
                continue
            if e is None or e.tier == "prefiltered" or e.ephemeral:
                # ephemeral = a raw scan's window-pinned decode; raw mode
                # leaves no persistent state, and peering must not turn
                # another pod's transient window into a durable copy
                continue
            secs = self.link.fetch_seconds(e.nbytes)
            store.peer_serves += 1
            store.peer_serve_bytes += e.nbytes
            into.peer_hits += 1
            into.peer_hit_bytes += e.nbytes
            into.peer_hit_seconds += secs
            if stats is not None:
                stats.peer_bytes += e.nbytes
            if trace._CUR is not None:
                trace.event("peer_fetch", tier=e.tier, nbytes=e.nbytes,
                            source=pid, hop_s=secs)
            into.put(key, e.value, tier=e.tier, encoding=e.encoding)
            return e.value
        return None


class StoreView:
    """Window-scoped view into the store's decoded tier — the scheduler's
    shared decode pool.  Entries it inserts are pinned (evictable only
    after `expires_tick`) and ephemeral (dropped at expiry unless a
    preloaded/prefiltered put promotes them); entries pinned by EARLIER
    windows are visible too, which is exactly how a late-arriving
    coalescing partner reuses retained decodes.

    Budget semantics match the old tick-scoped DecodePool: `used_bytes`
    is the summed nbytes of the entries this view pinned, a re-insert
    bills only the size delta, and a rejected put (view budget or store
    capacity) changes nothing."""

    def __init__(self, store: BlockStore, expires_tick: int,
                 max_bytes: Optional[int] = None, owner: Optional[str] = None):
        self.store = store
        self.expires_tick = expires_tick
        self.max_bytes = max_bytes
        self.owner = owner  # rebindable: run_tick sets it per request
        self._mine: Dict[Hashable, int] = {}  # key -> billed nbytes
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.puts = 0
        self.rejected_puts = 0
        # cross-tick reuse: hits on entries pinned by an EARLIER tick
        self.retained_hits = 0
        self.retained_hit_bytes = 0
        self.retained_saved_s = 0.0

    # -- visibility --------------------------------------------------------
    def _visible(self, key: Hashable) -> Optional[BlockEntry]:
        e = self.store.peek(key)
        if e is None or e.tier != "decoded" or not e.pinned(self.store.tick):
            return None
        return e

    def __contains__(self, key: Hashable) -> bool:
        return self._visible(key) is not None

    def __len__(self) -> int:
        return sum(1 for k in self.store._entries if self._visible(k) is not None)

    def __iter__(self):
        return (k for k in list(self.store._entries) if self._visible(k) is not None)

    def values(self):
        return [self.store._entries[k].value for k in self]

    def __getitem__(self, key: Hashable):
        e = self._visible(key)
        if e is None:
            raise KeyError(key)
        return e.value

    def encoding_of(self, key: Hashable) -> Optional[str]:
        """Source encoding recorded for a visible entry — carried along
        when the engine promotes a pool hit into another store, so the
        promoted decode keeps its honest eviction price."""
        e = self._visible(key)
        return e.encoding if e is not None else None

    # -- counting ops ------------------------------------------------------
    def get(self, key: Hashable, default=None):
        e = self._visible(key)
        if e is None:
            self.misses += 1
            return default
        self.hits += 1
        self.hit_bytes += e.nbytes
        if self.owner:
            # observed beneficiary: retention charges split across every
            # tenant that actually reused this decode, not just its owner
            e.beneficiaries.add(self.owner)
        self.store.window_hits += 1
        self.store.window_hit_bytes += e.nbytes
        self.store.window_saved_s += e.redecode_s
        retained = -1 < e.pin_tick < self.store.tick  # pinned by an earlier tick
        if retained:
            self.retained_hits += 1
            self.retained_hit_bytes += e.nbytes
            self.retained_saved_s += e.redecode_s
        if trace._CUR is not None:  # flight recorder: window-pool hit
            trace.event("store_hit", tier="decoded", window=True,
                        retained=retained, nbytes=e.nbytes,
                        saved_s=e.redecode_s)
        self.store.touch(e)
        return e.value

    def put(self, key: Hashable, value, encoding: Optional[str] = None) -> bool:
        nb = int(value.nbytes)
        delta = nb - self._mine.get(key, 0)
        if (self.max_bytes is not None and delta > 0
                and self.used_bytes + delta > self.max_bytes):
            self.rejected_puts += 1
            return False
        kept = self.store.put(
            key, value, tier="decoded", encoding=encoding,
            pin_until=self.expires_tick, ephemeral=True, owner=self.owner,
        )
        if not kept:
            self.rejected_puts += 1
            return False
        if key not in self._mine:
            self.puts += 1
        self.used_bytes += delta
        self._mine[key] = nb
        return True

    def __setitem__(self, key: Hashable, value) -> None:
        self.put(key, value)


class DecodePool(StoreView):
    """Back-compat shim: the old tick-scoped shared decode pool, now a
    never-expiring window over a private single-purpose BlockStore.  All
    entries are pinned, so the store never evicts — an over-budget put is
    refused with the old entry (and the ledger) untouched, exactly the
    accounting the property suite in tests/test_torch_decode_pool_props.py
    pins down."""

    def __init__(self, max_bytes: int = 1 << 30):
        super().__init__(
            BlockStore(capacity_bytes=max_bytes), NEVER, max_bytes=max_bytes
        )
