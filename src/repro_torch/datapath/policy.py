"""Adaptive offload policy: raw vs preloaded vs prefiltered, per request.

The seed engine picked one engine-wide `offload=` mode at construction
time.  On a shared appliance that is wrong for every tenant at once: a
needle-in-a-haystack scan should not evict cache with decoded row groups
it will never revisit, while a scan the service has already answered
should be served straight from the prefiltered cache.  The policy decides
per request from metadata only:

  1. prefiltered  — the exact plan signature was answered recently
                    (cache still holds it, or it has recurred >= `repeat_k`
                    times so caching the result will pay off)
  2. preloaded    — the scan touches row groups whose decoded columns are
                    largely cached already, or it is broad enough
                    (selectivity >= `broad_threshold`) that decoded groups
                    are likely to be reused by coalesced neighbors
  3. raw          — highly selective one-off scans: decode+filter fresh and
                    keep the cache for workloads that reuse it
  4. pre-aggregated — aggregate-pushdown plans that recur: cache the WHOLE
                    accumulator result (a few KB) instead of seeding the
                    decoded tier with value columns pushdown never
                    materializes (DESIGN.md §16)

Port copy of `repro.datapath.policy`, kept in step with it.  It reads
metadata and the store's residency only (the port's engine, zone maps and
BlockStore `plan_fetch(tier=)`), so it decides the same mode as the
reference for the same history.
"""

from __future__ import annotations

import collections
from typing import Dict

from repro_torch.core.engine import DatapathEngine
from repro_torch.core.plan import ScanPlan
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.lakeformat.reader import LakeReader


def coalesce_compatible(a, b) -> bool:
    """Hold-window compatibility: would scheduling `a` and `b` in the SAME
    tick let them share DecodePool entries?  True iff they read the same
    file and their (row group, column) footprints intersect — the pool is
    keyed by (path, row group, column, backend), so any intersection means
    at least one decode is shared.  Both arguments are service ScanRequests
    (duck-typed: .reader.path, .rg_set, .col_set)."""
    return (
        a.reader.path == b.reader.path
        and bool(a.rg_set & b.rg_set)
        and bool(a.col_set & b.col_set)
    )


class AdaptiveOffloadPolicy:
    def __init__(
        self,
        broad_threshold: float = 0.2,
        cached_frac_threshold: float = 0.5,
        repeat_k: int = 2,
        max_signatures: int = 4096,
    ):
        self.broad_threshold = broad_threshold
        self.cached_frac_threshold = cached_frac_threshold
        self.repeat_k = repeat_k
        self.max_signatures = max_signatures
        # LRU-bounded: parameterized workloads (moving time windows) mint a
        # fresh signature per request, and the service is long-lived
        self.seen: "collections.OrderedDict[str, int]" = collections.OrderedDict()
        self.decisions: Dict[str, int] = collections.defaultdict(int)

    def _note(self, sig: str) -> int:
        count = self.seen.get(sig, 0) + 1
        self.seen[sig] = count
        self.seen.move_to_end(sig)
        while len(self.seen) > self.max_signatures:
            self.seen.popitem(last=False)
        return count

    def choose(
        self,
        engine: DatapathEngine,
        reader: LakeReader,
        plan: ScanPlan,
        blooms=None,
        row_groups=None,
        selectivity: float = None,
        scan_tag=None,
    ) -> str:
        """`row_groups`/`selectivity` let the service reuse its admission-time
        metadata walk; without them the policy recomputes from zone maps.
        `scan_tag` is the request's prefiltered-cache disambiguator (fabric
        sub-scans tag with their row-group subset) — the whole-scan reuse
        probe must look up the SAME key the scan would hit."""
        sig = plan.signature()
        seen = self._note(sig)
        mode = self._choose(engine, reader, plan, seen, blooms, row_groups,
                            selectivity, scan_tag)
        self.decisions[mode] += 1
        return mode

    def _choose(self, engine, reader, plan, seen, blooms, row_groups,
                selectivity, scan_tag=None) -> str:
        # 1) whole-scan reuse: cached result, or a recurring signature worth
        #    caching (the key folds in bloom digests, so per-caller semijoin
        #    state can never serve another caller's probe).  Residency is
        #    read straight from the store's prefiltered tier.
        #    Aggregate plans take the fourth mode, 'pre-aggregated': same
        #    whole-result reuse, but what is cached is the (n_groups,)
        #    accumulator set — a few KB answering the entire scan — and the
        #    decoded/page tiers are NOT seeded along the way (pushdown never
        #    materializes the value column, so there is nothing worth
        #    pinning; decode behaves like 'raw').
        scan_key = engine.plan_cache_key(reader, plan, blooms, tag=scan_tag)
        cached, _ = engine.cache.plan_fetch([scan_key], tier="prefiltered")
        if cached or seen >= self.repeat_k:
            return "pre-aggregated" if plan.aggregates else "prefiltered"

        # 2) row-group reuse: are this scan's decoded columns already
        #    resident?  The probe reads the store's DECODED tier directly —
        #    window-pinned decodes from a recent coalescing hold count as
        #    resident (they are reusable right now), prefiltered results
        #    and encoded pages do not.
        if row_groups is None:
            from repro_torch.core.plan import bind_expr

            row_groups = prune_row_groups(reader, bind_expr(plan.predicate, reader))
        rg_keys = [
            engine.rg_cache_key(reader, rg, name)
            for rg in row_groups
            for name in plan.all_columns()
        ]
        if rg_keys:
            hit, _ = engine.cache.plan_fetch(rg_keys, tier="decoded")
            if len(hit) / len(rg_keys) >= self.cached_frac_threshold:
                return "preloaded"

        # 3) broad scans seed the cache; selective one-offs stay raw
        if selectivity is None:
            selectivity = engine.estimate_selectivity(reader, plan)
        return "preloaded" if selectivity >= self.broad_threshold else "raw"


class StaticPolicy:
    """Degenerate policy pinning every request to one mode (the seed
    engine's behavior — kept for A/B comparison in benchmarks)."""

    def __init__(self, mode: str = "raw"):
        assert mode in ("raw", "preloaded", "prefiltered", "pre-aggregated")
        self.mode = mode
        self.decisions: Dict[str, int] = collections.defaultdict(int)

    def choose(self, engine, reader, plan, blooms=None, **_precomputed) -> str:
        self.decisions[self.mode] += 1
        return self.mode
