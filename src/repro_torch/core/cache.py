"""BlockCache — the paper's "SSD table cache", on the card.

Port of `repro.core.cache`: a thin facade over ONE
`repro_torch.datapath.blockstore.BlockStore`: every entry — encoded pages, decoded
row-group columns, whole pre-filtered ScanResults — lives in ONE
BlockStore with a single byte ledger and cost-aware eviction (victim =
lowest estimated re-creation seconds per byte, LRU tie-break), instead
of the old flat LRU dict.  The engine's key tuples carry the tier tag:

    ("page", path, rg, column)          -> encoded tier
    ("rg",   path, rg, column, route)   -> decoded tier
    ("scan", path, signature, route...) -> prefiltered tier

where `route` is the engine's device type and decode route
(`DatapathEngine.backend_key`, e.g. "cuda/kernels" or "cuda/host").

Metadata and orchestration (which row groups are cached vs must be
fetched and decoded) is exactly the open challenge the paper flags for
the SSD cache; `plan_fetch()` returns the cached/missing split the
engine and the adaptive policy use to route work, now tier-scoped.

The import of the store is lazy, as in the reference: core must stay
importable before repro_torch.datapath finishes initializing.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Tuple

_TIER_BY_TAG = {"scan": "prefiltered", "page": "encoded"}


def _nbytes(obj) -> int:
    """Kept for compatibility; the store owns the billing rules."""
    from repro_torch.datapath.blockstore import _nbytes as impl

    return impl(obj)


class BlockCache:
    def __init__(self, capacity_bytes: int = 2 << 30, store=None):
        if store is None:
            from repro_torch.datapath.blockstore import BlockStore

            store = BlockStore(capacity_bytes=capacity_bytes)
        self.store = store
        # Fabric hook: a blockstore.PeerFetcher consulted when a COUNTING
        # get misses locally — a sibling pod's encoded/decoded tier serves
        # a copy over the inter-pod link.  None on single-node services;
        # probes (__contains__/plan_fetch) never cross pods either way.
        self.peer = None

    @staticmethod
    def _tier(key: Hashable) -> str:
        tag = key[0] if isinstance(key, tuple) and key else None
        return _TIER_BY_TAG.get(tag, "decoded")

    # -- legacy scalar surface (tests and callers read these) --------------
    @property
    def capacity(self) -> int:
        return self.store.capacity

    @property
    def used(self) -> int:
        return self.store.used

    def _total(self, field: str) -> int:
        return sum(getattr(s, field) for s in self.store._tier_stats.values())

    @property
    def hits(self) -> int:
        return self._total("hits")

    @property
    def misses(self) -> int:
        return self._total("misses")

    @property
    def evictions(self) -> int:
        return self._total("evictions")

    # -- ops ---------------------------------------------------------------
    def __contains__(self, key: Hashable) -> bool:
        """Presence check without touching LRU order or hit/miss counters."""
        return key in self.store

    def get(self, key: Hashable, stats=None):
        """Counting lookup.  On a local miss a fabric peer (if installed)
        may serve the block over the inter-pod hop; `stats` (a ScanStats)
        then receives the transferred bytes so the slice that triggered
        the fetch is the one WFQ bills for the hop."""
        v = self.store.get(key, tier=self._tier(key))
        if v is None and self.peer is not None:
            v = self.peer.fetch(key, self.store, stats=stats)
        return v

    def put(
        self,
        key: Hashable,
        value: Any,
        tier: Optional[str] = None,
        encoding: Optional[str] = None,
        decode_work: Optional[Dict[str, int]] = None,
        demote: Optional[Tuple[Hashable, Any]] = None,
    ) -> bool:
        """Persist one entry (never window-pinned, never ephemeral — the
        cache path is the promotion path).  `encoding` prices a decoded
        column's re-decode; `decode_work` prices a prefiltered result by
        the ground-truth work that produced it; `demote` is the (key,
        value) of the encoded pages an evicted decoded column falls back
        to instead of dropping to zero."""
        return self.store.put(
            key, value, tier=tier or self._tier(key),
            encoding=encoding, decode_work=decode_work, demote=demote,
        )

    def promote(self, key: Hashable, value: Any,
                encoding: Optional[str] = None) -> bool:
        """Persist a pool-served decode.  A no-op when the entry is already
        cache-owned (non-ephemeral) in this store — the common case for a
        store-backed pool, where every hit would otherwise re-run the put
        machinery just to clear an already-clear flag.  `encoding` keeps
        the promoted entry's honest eviction price; when absent, a price
        already recorded on the entry wins over the PLAIN fallback."""
        e = self.store.peek(key)
        if e is not None and not e.ephemeral:
            return True
        return self.put(key, value, tier="decoded",
                        encoding=encoding or (e.encoding if e is not None else None))

    def plan_fetch(
        self, keys: List[Hashable], tier: Optional[str] = None
    ) -> Tuple[List[Hashable], List[Hashable]]:
        """Split keys into (cached, missing) without touching LRU order;
        `tier` scopes residency to one tier of the store."""
        return self.store.plan_fetch(keys, tier=tier)

    def clear(self):
        self.store.clear()

    def stats(self) -> dict:
        st = self.store.stats()
        return {
            "entries": sum(t["entries"] for t in st["tiers"].values()),
            "bytes": st["used"],
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "tiers": st["tiers"],
        }
