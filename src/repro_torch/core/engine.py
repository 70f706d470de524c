"""DatapathEngine — the paper's data-processing SmartNIC, on a CUDA card.

Port of `repro.core.engine`:

    footer zone maps ──► row-group pruning (metadata only, host)
         │
    encoded bytes ────► checksum check ──► decode on the card (CUDA kernels)
         │                                        │
         │                             pushed-down predicate (bloom semijoin
         │                             included), or the fused decode + range
         │                             filter on packed words
         ▼                                        ▼
    BlockStore  ◄──── decoded columns + survivor mask + count, or, with
    (encoded pages /  compact=True, the survivors packed to the front, or,
     decoded columns / for a plan with `aggregates`, only the (n_groups,)
     prefiltered      accumulators (operator pushdown, core/agg.py)
     results)                                     ──► consumer

Offload configurations, per engine or per call (the paper's Fig. 1):
  'raw'            decode + filter on every scan
  'preloaded'      decoded row groups served from the store's decoded tier
                   (encoded pages cached too, so an evicted decode still
                   skips the re-fetch)
  'prefiltered'    whole filtered scans served from the prefiltered tier
  'pre-aggregated' an aggregate plan's accumulators cached whole

Backends: 'auto' (the engine's device: the CUDA kernels on the card, their
plain versions on the CPU) and 'host' (numpy decode on the host CPU, the
"the CPU decodes" baseline; the decoded columns are then copied to the
engine's device, where the predicate, compaction and aggregates run).  The
host backend turns off what the reference turns off for it: the fused
decode + filter, the fused decode + aggregate, bucketed batch launches and
the batched bloom probe.

A scan runs sequentially (one launch per fresh (row group, column)) or
batched (`scan(batched=True)`: a slice's pages stacked per (encoding, k,
dtype) bucket, one host-to-device copy and one launch per bucket), with
bit-identical results and accounting but for `kernel_launches`;
`scan_group_batched` stacks several requests' slices into one bucket pass
over a shared decode pool.  The port pads no stack, so `batch_pad_blocks`
stays 0.

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`, which routes every kernel to its plain PyTorch version).
Asking for the card without one raises; nothing falls back to the CPU.
Every ScanStats field is kept, so scans compare field for field with the
JAX engine.

Cached tensors are shared, never written: a prefiltered hit hands the
stored columns to the caller and a preloaded hit hands a stored column to
the predicate and the compaction, none of which writes into its inputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import agg as agg_merge
from repro_torch.core.cache import BlockCache
from repro_torch.core.plan import (
    And,
    BloomProbe,
    Cmp,
    Expr,
    InSet,
    Or,
    ScanPlan,
    bind_expr,
    expr_columns,
    pred_int_bounds,
)
from repro_torch.core.zonemap import estimate_selectivity, prune_row_groups
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import (
    PACK_BLOCK,
    RLE_OUT_BLOCK,
    EncodedColumn,
    Encoding,
    decode_column_host,
    padded_rows,
)
from repro_torch.lakeformat.integrity import CorruptPageError, page_checksum

OFFLOADS = ("raw", "preloaded", "prefiltered", "pre-aggregated")
CACHED = ("preloaded", "prefiltered")  # modes whose decodes persist in the store

_TORCH_DTYPES = {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32}

# Flight-recorder hook: the repro_torch.datapath.trace module, installed by
# whoever traces scans (the engine cannot import datapath: its package
# imports core).  None for untraced use, which then pays one module
# attribute load per span site and nothing else.
TRACE = None


def _tr():
    """The trace module iff a traced slice is executing right now, else
    None.  Every span's kwargs are built only behind this check."""
    t = TRACE
    return t if t is not None and t._CUR is not None else None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resolve_device(device) -> torch.device:
    """The engine's device.  A CUDA device without a card raises
    RuntimeError: the port never continues on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA card is available; "
                "pass device='cpu' to run the plain versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass
class ScanStats:
    """Per-scan accounting, field for field the JAX engine's ScanStats."""

    row_groups_total: int = 0
    row_groups_scanned: int = 0
    encoded_bytes: int = 0
    decoded_bytes: int = 0  # decode output materialized for this scan
    decoded_bytes_fresh: int = 0  # subset actually decoded now (no pool/cache hit)
    # Fresh decode WORK by encoding, in output bytes: materializing decodes
    # AND the fused predicate column (processed at L*width virtual output
    # bytes but never materialized); pool and cache hits do no work.
    decode_work: Dict[str, int] = dataclasses.field(default_factory=dict)
    pool_hits: int = 0  # (rg, column) decodes served by a shared decode pool
    pool_hit_bytes: int = 0
    page_hits: int = 0  # encoded pages served by the store's encoded tier
    page_hit_bytes: int = 0  # encoded bytes that skipped the storage->NIC hop
    rows_total: int = 0
    rows_out: int = 0
    # Bytes the scan's result hands to the consumer: projection columns +
    # survivor mask, or a pushed-down aggregate's (n_groups,) arrays.
    result_bytes: int = 0
    fused: bool = False
    cache_hit: bool = False
    # Dispatches on the decode path only (column decodes, PLAIN device puts,
    # fused scans) and the aggregate launches: one per fresh (row group,
    # column) on the sequential path, one per bucket on the batched path.
    kernel_launches: int = 0
    batch_pad_blocks: int = 0
    peer_bytes: int = 0
    retry_fetches: int = 0
    fetch_timeouts: int = 0
    hedged_fetches: int = 0
    hedge_wins: int = 0
    corrupt_pages: int = 0
    fault_wait_s: float = 0.0


@dataclasses.dataclass
class ScanResult:
    columns: Dict[str, torch.Tensor]  # decoded projection, padded to PACK_BLOCK rows
    mask: torch.Tensor  # (L,) bool — predicate & row validity
    count: torch.Tensor  # scalar int32 — surviving rows
    stats: ScanStats
    # Operator pushdown (plans with `aggregates`): `aggregates` maps each
    # AggSpec.out_name() to its finalized (n_groups,) numpy array, and
    # `agg_partials` keeps the per-row-group ColPartials (core/agg.py).  Both
    # None for row scans; `columns`/`mask` are empty for aggregate scans.
    aggregates: Optional[Dict[str, np.ndarray]] = None
    agg_partials: Optional[Dict[int, dict]] = None


def _expr_blooms(e: Optional[Expr]) -> List[BloomProbe]:
    """Every BloomProbe node in a predicate tree, in document order."""
    if e is None:
        return []
    if isinstance(e, BloomProbe):
        return [e]
    if isinstance(e, (And, Or)):
        out: List[BloomProbe] = []
        for c in e.children:
            out.extend(_expr_blooms(c))
        return out
    return []


def group_domain(reader, column: str) -> int:
    """Dense group-id domain size for a pushed-down GROUP BY column, from
    footer metadata alone.  String DICT columns decode to globally stable
    int codes, so the dictionary length is the domain; int columns use the
    zone-map maximum (values must be small non-negative ids: asserted)."""
    d = reader.string_dicts.get(column)
    if d is not None:
        return max(len(d), 1)
    zms = reader.zonemaps(column)
    lo = min(zm["min"] for zm in zms)
    hi = max(zm["max"] for zm in zms)
    assert lo >= 0, (
        f"group_by column {column!r} has negative values (min {lo}); "
        "pushdown grouping needs a dense non-negative id domain"
    )
    return int(hi) + 1


def agg_windows(n_groups: int) -> range:
    """The first group id of each MAX_GROUPS-wide window of a group
    domain: one aggregate launch per window (ResumableScan._fold_agg)."""
    return range(0, n_groups, ops.MAX_GROUPS)


class DatapathEngine:
    def __init__(
        self,
        device="cuda",
        offload: str = "raw",
        cache: Optional[BlockCache] = None,
        backend: str = "auto",
    ):
        if backend not in ("auto", "host"):
            raise ValueError(f"unknown backend {backend!r}: 'auto' (the device's kernels) "
                             "or 'host' (numpy decode on the host)")
        if offload not in OFFLOADS:
            raise ValueError(f"unknown offload mode {offload!r}")
        self.device = resolve_device(device)
        self.backend = backend
        self.offload = offload
        self.cache = cache if cache is not None else BlockCache()
        # Storage fault plane (ROADMAP.md A.4b's FaultInjector), duck-typed:
        # an object with read(engine, reader, rg, columns, stats).  None =
        # clean reads, still checksum-verified.
        self.faults = None
        self.verify_checksums = True
        # the cache keys' backend component: the device type and the decode
        # route ("kernels" on the device, or the numpy "host" baseline)
        self.backend_key = f"{self.device.type}/{'host' if backend == 'host' else 'kernels'}"

    @property
    def _kernels(self) -> bool:
        """True unless decoding on the host (the reference's device backends)."""
        return self.backend != "host"

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _put(self, buf: np.ndarray) -> torch.Tensor:
        return ops.to_tensor(buf, self.device)

    def _decode_device(self, col: EncodedColumn, L: int) -> torch.Tensor:
        """Decode one encoded column on the engine's device, padded to L
        rows.  Every arm returns a tensor with a buffer of its own, exactly
        L long: a packed page decodes to its L rows, and a shorter output
        (PLAIN, RLE) is padded into a new tensor."""
        e = col.encoding
        if e == Encoding.PLAIN:
            arr = ops.device_put(col.buffers["plain"], self.device)
        elif e == Encoding.BITPACK:
            arr = ops.bitunpack(self._put(col.buffers["packed"]), col.k).reshape(-1)
        elif e == Encoding.DICT:
            d = col.buffers["dictionary"]
            d = d.astype(np.int32) if d.dtype.kind in "iu" else d
            arr = ops.dict_decode(
                self._put(col.buffers["packed"]), self._put(d), col.k
            ).reshape(-1)
        elif e == Encoding.DELTA:
            arr = ops.delta_decode(
                self._put(col.buffers["packed"]),
                self._put(col.buffers["bases"].astype(np.int32)),
                col.k,
            ).reshape(-1)
        elif e == Encoding.RLE:
            arr = ops.rle_decode(
                self._put(col.buffers["rle_values"]),
                self._put(col.buffers["rle_ends"]),
            ).reshape(-1)
        else:
            raise ValueError(e)
        if arr.shape[0] < L:
            arr = torch.nn.functional.pad(arr, (0, L - arr.shape[0]))
        return arr[:L]

    def _decode_host(self, col: EncodedColumn, L: int) -> torch.Tensor:
        """Host (numpy) decode, the "the CPU decodes" baseline, copied to
        the engine's device."""
        arr = decode_column_host(col)
        out = np.zeros(L, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return self._put(out)

    def rg_cache_key(self, reader, rg: int, name: str):
        """Decoded-tier / decode-pool key for one decoded row-group column."""
        return ("rg", reader.path, rg, name, self.backend_key)

    def page_cache_key(self, reader, rg: int, name: str):
        """Encoded-tier key for one column's raw encoded page.  No backend
        component: encoded bytes are the same whatever decodes them."""
        return ("page", reader.path, rg, name)

    @staticmethod
    def _pool_put(pool, key, arr, encoding: Optional[str] = None) -> None:
        """Insert into a shared decode pool: a store-backed view takes the
        source encoding (its eviction price); a plain dict stores the array."""
        put = getattr(pool, "put", None)
        if put is not None:
            put(key, arr, encoding=encoding)
        else:
            pool[key] = arr

    def _decode_column(
        self,
        reader,
        rg: int,
        name: str,
        col: Optional[EncodedColumn],
        L: int,
        offload: Optional[str] = None,
        pool=None,
        stats: Optional[ScanStats] = None,
        precomputed: Optional[torch.Tensor] = None,
    ):
        """Serve one decoded row-group column: a pool hit, a cache hit, or a
        fresh decode.  `precomputed` is the batched path's already-launched
        bucket slice for this (row group, column): it substitutes for the
        kernel call only, and every lookup, counter and put runs as on the
        sequential path.  Returns (tensor, hit)."""
        offload = offload or self.offload
        key = self.rg_cache_key(reader, rg, name)
        if pool is not None:
            hit = pool.get(key)
            if hit is not None:
                if offload in CACHED:
                    # a pool hit still persists: promote the (possibly
                    # window-pinned, ephemeral) entry to a cache-owned one,
                    # with the pool's recorded encoding as its price
                    enc_of = getattr(pool, "encoding_of", None)
                    self.cache.promote(key, hit, encoding=enc_of(key) if enc_of else None)
                if stats is not None:
                    stats.decoded_bytes += _nbytes(hit)
                    stats.pool_hits += 1
                    stats.pool_hit_bytes += _nbytes(hit)
                return hit, True
        if offload in CACHED:
            hit = self.cache.get(key, stats=stats)
            if hit is not None:
                if pool is not None:
                    self._pool_put(pool, key, hit)
                if stats is not None:
                    stats.decoded_bytes += _nbytes(hit)
                return hit, True
        if precomputed is not None:
            arr = precomputed  # the bucket launch is counted by the caller
        else:
            tr = _tr()
            if tr is not None:
                tr.begin("decode_launch", rg=rg, column=name,
                         encoding=col.encoding.value, rows=L)
            arr = self._decode_device(col, L) if self._kernels else self._decode_host(col, L)
            if tr is not None:
                tr.end(name="decode_launch", nbytes=_nbytes(arr))
            if stats is not None:
                stats.kernel_launches += 1
        enc_name = col.encoding.value if col is not None else None
        if offload in CACHED:
            # the demote payload: under pressure the decoded column falls
            # back to its encoded page (a re-decode) instead of to nothing
            # (a re-fetch and a re-decode)
            self.cache.put(
                key, arr, encoding=enc_name,
                demote=(self.page_cache_key(reader, rg, name), col)
                if col is not None else None,
            )
        if pool is not None:
            self._pool_put(pool, key, arr, encoding=enc_name)
        if stats is not None:
            nb = _nbytes(arr)
            stats.decoded_bytes += nb
            stats.decoded_bytes_fresh += nb
            e = col.encoding.value
            stats.decode_work[e] = stats.decode_work.get(e, 0) + nb
        return arr, False

    def _serve_column(self, reader, rg: int, name: str, enc: Dict[str, EncodedColumn],
                      askip: frozenset, L: int, offload, pool, stats: ScanStats,
                      precomputed: Optional[torch.Tensor] = None):
        """One needed column of a fetched row group: an aggregate page the
        fused aggregate kernel unpacks itself (booked, returned undecoded),
        or a decoded column."""
        if name in askip:
            self._charge_agg_page(stats, enc[name], L)
            return enc[name]
        arr, _ = self._decode_column(reader, rg, name, enc[name], L, offload=offload,
                                     pool=pool, stats=stats, precomputed=precomputed)
        return arr

    # ------------------------------------------------------------------
    # predicate evaluation (on decoded device columns)
    # ------------------------------------------------------------------
    def _eval(self, e: Expr, cols: Dict[str, torch.Tensor],
              blooms: Dict[str, torch.Tensor], bmasks: Optional[Dict] = None) -> torch.Tensor:
        # Python constants compare in the column's dtype (float32 columns in
        # float32), as JAX's weakly typed scalars do.
        if isinstance(e, Cmp):
            v = cols[e.column]
            if e.op == "between":
                lo, hi = e.value
                return (v >= lo) & (v <= hi)
            val = e.value
            return {
                "lt": v < val,
                "le": v <= val,
                "gt": v > val,
                "ge": v >= val,
                "eq": v == val,
                "ne": v != val,
            }[e.op]
        if isinstance(e, InSet):
            v = cols[e.column]
            m = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
            for val in e.values:
                m = m | (v == val)
            return m
        if isinstance(e, BloomProbe):
            # the batched pass probes every slice page's keys in ONE stacked
            # launch per filter (`_batch_bloom_probe`) and hands this row
            # group's slice down in `bmasks`: bit-identical, the probe is
            # elementwise
            if bmasks is not None:
                hit = bmasks.get((e.name, e.column))
                if hit is not None:
                    return hit
            # the keys in rows of RLE_OUT_BLOCK, as the probe kernel takes them
            keys = cols[e.column].to(torch.int32)
            L = keys.shape[0]
            pad = (-L) % RLE_OUT_BLOCK
            if pad:
                keys = torch.nn.functional.pad(keys, (0, pad))
            m = ops.bloom_probe(keys.reshape(-1, RLE_OUT_BLOCK), blooms[e.name], e.n_hashes)
            return m.reshape(-1)[:L]
        if isinstance(e, And):
            m = self._eval(e.children[0], cols, blooms, bmasks)
            for c in e.children[1:]:
                m = m & self._eval(c, cols, blooms, bmasks)
            return m
        if isinstance(e, Or):
            m = self._eval(e.children[0], cols, blooms, bmasks)
            for c in e.children[1:]:
                m = m | self._eval(c, cols, blooms, bmasks)
            return m
        raise TypeError(e)

    def _eval_mask(self, pred: Optional[Expr], cols, blooms, L: int, rg: int,
                   bmasks: Optional[Dict] = None) -> torch.Tensor:
        """Predicate mask over L rows in a `filter` span (all true, and no
        span, without a predicate).  `bmasks` maps (bloom name, column) to
        this row group's pre-probed (L,) mask from the batched path."""
        if pred is None:
            return torch.ones((L,), dtype=torch.bool, device=self.device)
        tr = _tr()
        if tr is not None:
            tr.begin("filter", rg=rg, rows=L)
        mask = self._eval(pred, cols, blooms, bmasks)
        if tr is not None:
            tr.end(name="filter")
        return mask

    def _valid(self, mask: torch.Tensor, n: int, L: int) -> torch.Tensor:
        """`mask` and row validity (the first n of L rows)."""
        return mask & (torch.arange(L, device=self.device) < n)

    # ------------------------------------------------------------------
    # fused decode+filter fast path
    # ------------------------------------------------------------------
    @staticmethod
    def _fusable(pred: Optional[Expr], enc: Dict[str, EncodedColumn], projected: List[str]):
        """Single int range/eq predicate on a BITPACK or int-DICT column not in
        the projection -> the filter column need never be materialized.

        For DICT columns the predicate is rewritten onto the *codes*: the
        dictionary is sorted (np.unique), so a value range maps to a code
        range via two host-side binary searches — the decode step then
        operates on packed codes only and the dictionary is never touched.
        """
        if not isinstance(pred, Cmp) or pred.column in projected:
            return None
        col = enc.get(pred.column)
        if col is None or col.encoding not in (Encoding.BITPACK, Encoding.DICT):
            return None
        if col.encoding == Encoding.DICT and col.buffers["dictionary"].dtype.kind not in "iu":
            return None
        bounds = pred_int_bounds(pred)
        if bounds is None:
            return None
        lo, hi = bounds
        if col.encoding == Encoding.DICT:
            d = col.buffers["dictionary"]
            lo = int(np.searchsorted(d, lo, side="left"))
            hi = int(np.searchsorted(d, hi, side="right")) - 1
            if hi < lo:
                lo, hi = 1, 0  # empty range, still valid
        return lo, hi

    @staticmethod
    def _fused_width(reader, rg: int, pred) -> int:
        """Footer dtype width of the fused predicate column: the per-row
        charge for its processed-but-unmaterialized decode work."""
        cm = reader.row_group_meta(rg)["columns"][pred.column]
        return np.dtype(cm["dtype"]).itemsize

    def _charge_fused(self, reader, rg: int, pred, enc, L: int, stats: ScanStats) -> None:
        """Book the fused predicate column's processed-but-unmaterialized
        decode work at its footer dtype width (decode_footprint sizes the
        estimate the same way)."""
        stats.fused = True
        fe = enc[pred.column].encoding.value
        stats.decode_work[fe] = stats.decode_work.get(fe, 0) + L * self._fused_width(reader, rg,
                                                                                    pred)

    def _storage_read(self, reader, rg: int, columns,
                      stats: ScanStats) -> Dict[str, EncodedColumn]:
        """The only path encoded pages take from storage into the engine
        (`_prepare_row_group` and `_serve_resident` both route here).  With
        a fault injector on `self.faults` the read runs its retry / verify /
        quarantine loop.  Without one, pages are still checksum-verified
        against the footer before they can reach a decode kernel; a
        mismatch quarantines the page key in the block store and raises
        CorruptPageError, never returns garbage.  Legacy footers without
        checksums verify trivially."""
        if self.faults is not None:
            return self.faults.read(self, reader, rg, columns, stats)
        got = reader.read_encoded(rg, columns)
        if self.verify_checksums:
            meta = getattr(reader, "page_checksum_meta", None)
            if meta is not None:
                for name, col in got.items():
                    expect = meta(rg, name)
                    if expect is not None and page_checksum(col) != expect:
                        stats.corrupt_pages += 1
                        store = getattr(self.cache, "store", None)
                        if store is not None and hasattr(store, "quarantine"):
                            store.quarantine(self.page_cache_key(reader, rg, name))
                        raise CorruptPageError(
                            f"{reader.path} rg={rg} column={name}: page "
                            "failed checksum verification",
                            table=reader.path, rg=rg, column=name)
        return got

    def _fetch(self, reader, rg: int, names, mode: str, stats: ScanStats):
        """Storage read of `names` in a `fetch` span, booked in
        `encoded_bytes`, the pages put into the encoded tier under a cached
        mode."""
        tr = _tr()
        if tr is not None:
            tr.begin("fetch", rg=rg, columns=len(names))
        got = self._storage_read(reader, rg, names, stats)
        nb = sum(c.encoded_bytes() for c in got.values())
        if tr is not None:
            tr.end(name="fetch", nbytes=nb)
        stats.encoded_bytes += nb
        if mode in CACHED:
            for name, col in got.items():
                self.cache.put(self.page_cache_key(reader, rg, name), col, tier="encoded")
        return got

    def _page_hit(self, reader, rg: int, name: str, stats: ScanStats):
        """The encoded tier's page for (rg, name), booked as a page hit, or None."""
        page = self.cache.get(self.page_cache_key(reader, rg, name), stats=stats)
        if page is not None:
            stats.page_hits += 1
            stats.page_hit_bytes += page.encoded_bytes()
        return page

    def _prepare_row_group(self, reader, rg: int, plan: ScanPlan,
                           pred: Optional[Expr], mode: str, stats: ScanStats, pool=None):
        """The per-row-group front half shared by the sequential and batched
        paths: the fully-resident shortcut, the encoded-page tier and the
        storage fetch, and fusability.

        Returns (n, L, resident, enc, fuse, fetched).  When `resident` the
        rest is empty: no encoded byte moves.  A fusable plan never takes
        the shortcut (its predicate column is never decoded, so never
        resident)."""
        need = plan.all_columns()
        n = reader.row_group_meta(rg)["n"]
        L = padded_rows(n)
        if pool is not None or mode in CACHED:
            keys = [self.rg_cache_key(reader, rg, name) for name in need]
            if (pool is not None and all(k in pool for k in keys)) or (
                    mode in CACHED and all(k in self.cache for k in keys)):
                return n, L, True, {}, None, False
        # the encoded-page tier: a page hit adds nothing to encoded_bytes
        enc: Dict[str, EncodedColumn] = {}
        missing = list(need)
        if mode in CACHED:
            missing = []
            for name in need:
                page = self._page_hit(reader, rg, name, stats)
                if page is None:
                    missing.append(name)
                else:
                    enc[name] = page
        fetched = False
        if missing:
            enc.update(self._fetch(reader, rg, missing, mode, stats))
            fetched = True
        fuse = self._fusable(pred, enc, plan.materialized_columns()) if self._kernels else None
        return n, L, False, enc, fuse, fetched

    def _agg_skip(self, plan: ScanPlan, pred: Optional[Expr],
                  enc: Dict[str, EncodedColumn]) -> frozenset:
        """Aggregate value columns eligible for the fully fused decode ->
        aggregate kernel (ops.fused_agg_batch): BITPACK pages whose decoded
        values nothing else consumes (not projected, not referenced by the
        predicate).  Those pages skip the decode entirely; the unpack
        happens inside the aggregate kernel.  Ungrouped plans only (the
        fused kernel has no group-id input), and not on the host backend,
        which decodes then reduces."""
        if not plan.aggregates or plan.group_by is not None or not self._kernels:
            return frozenset()
        keep = set(plan.columns) | set(expr_columns(pred))
        out = set()
        for spec in plan.aggregates:
            c = spec.column
            if c is None or c in keep:
                continue
            col = enc.get(c)
            if col is not None and col.encoding == Encoding.BITPACK:
                out.add(c)
        return frozenset(out)

    def _agg_skip_meta(self, plan: ScanPlan, pred: Optional[Expr], meta_cols: Dict) -> frozenset:
        """`_agg_skip` predicted from footer metadata alone: the cost
        estimator's mirror (decode_footprint), column for column."""
        if not plan.aggregates or plan.group_by is not None or not self._kernels:
            return frozenset()
        keep = set(plan.columns) | set(expr_columns(pred))
        out = set()
        for spec in plan.aggregates:
            c = spec.column
            if c is None or c in keep:
                continue
            cm = meta_cols.get(c)
            if cm is not None and cm.get("encoding") == "bitpack":
                out.add(c)
        return frozenset(out)

    @staticmethod
    def _charge_agg_page(stats: ScanStats, col: EncodedColumn, L: int) -> None:
        """Book a fused-aggregate page's processed-but-never-materialized
        decode work: the in-kernel unpack, at the decoded int32 width under
        the page's encoding, like the fused predicate column.  No decode
        launch: the aggregate launch is counted where it happens
        (ResumableScan._fold_agg)."""
        e = col.encoding.value
        stats.decode_work[e] = stats.decode_work.get(e, 0) + L * 4

    # ------------------------------------------------------------------
    # metadata hooks (admission control, the offload policy, the cost model)
    # ------------------------------------------------------------------
    def plan_cache_key(self, reader, plan: ScanPlan, blooms: Optional[Dict] = None, tag=None):
        """Prefiltered-tier key for a whole scan: the plan's signature, the
        backend component and a digest of any probe-side bloom filters (a
        caller's own state, which the signature cannot see).  A filter on
        the card is hashed from its bytes copied to the host.  `tag` scopes
        the key further (the fabric's owned row-group subset)."""
        key = ("scan", reader.path, plan.signature(), self.backend_key)
        if blooms:
            digest = tuple(sorted(
                (name, hashlib.sha1(
                    (bits.cpu().numpy() if isinstance(bits, torch.Tensor)
                     else np.asarray(bits)).tobytes()).hexdigest()[:16])
                for name, bits in blooms.items()))
            key += (digest,)
        if tag is not None:
            key += (tag,)
        return key

    def estimate_selectivity(self, reader, plan: ScanPlan) -> float:
        """Estimated fraction of rows surviving the plan's predicate, from
        zone maps alone."""
        return estimate_selectivity(reader, bind_expr(plan.predicate, reader))

    def estimate_scan_bytes(self, reader, plan: ScanPlan, row_groups=None) -> int:
        """Encoded bytes the scan would pull over the storage->NIC hop,
        after zone-map pruning (or over `row_groups`).  Metadata only."""
        if row_groups is None:
            row_groups = prune_row_groups(reader, bind_expr(plan.predicate, reader))
        need = plan.all_columns()
        total = 0
        for rg in row_groups:
            cols = reader.row_group_meta(rg)["columns"]
            total += sum(cols[c]["encoded_bytes"] for c in need if c in cols)
        return total

    def fused_column_meta(self, pred: Optional[Expr], meta_cols: Dict,
                          projected) -> Optional[str]:
        """The predicate column the fused decode + filter would skip
        materializing, from footer metadata alone, or None when the scan
        will not fuse: `_fusable`'s mirror.  `pred` must already be bound."""
        if not self._kernels:
            return None
        if not isinstance(pred, Cmp) or pred.column in projected:
            return None
        cm = meta_cols.get(pred.column)
        if cm is None or cm.get("encoding") not in ("bitpack", "dict"):
            return None
        if cm["encoding"] == "dict" and np.dtype(cm["dtype"]).kind not in "iu":
            return None
        if pred_int_bounds(pred) is None:
            return None
        return pred.column

    def decode_footprint(self, reader, plan: ScanPlan, row_groups, pred=None) -> List[dict]:
        """Per-row-group decode footprint from metadata: what the engine
        will materialize (PACK_BLOCK-padded rows, true dtype widths) and
        what it will merely process.  One dict per row group:
            {"rg", "n", "rows": L, "columns": {name: {
                "nbytes": L * itemsize, "encoded_bytes": int,
                "encoding": str, "materialized": bool, "role": str}}}
        The cost model prices each entry at its encoding's rate plus one
        launch.

        Aggregate plans carry one `agg` entry (L * 4 processed bytes, one
        launch) per decoded value source and per MAX_GROUPS-wide window of
        the group domain, named `agg:{src}` for the first window and
        `agg:{src}@{first group}` for the others: exactly what `_fold_agg`
        books per row group on the sequential path.  The reference prices
        no aggregate work for a domain over MAX_GROUPS, which it reduces on
        the host; the port reduces it on the card in windows, so its
        footprint counts them."""
        if pred is None:
            pred = bind_expr(plan.predicate, reader)
        need = plan.all_columns()
        proj = plan.materialized_columns()
        agg_srcs = agg_merge.agg_sources(plan.aggregates) if plan.aggregates else []
        windows = agg_windows(group_domain(reader, plan.group_by)
                              if plan.aggregates and plan.group_by is not None else 1)
        value_srcs = {s for s in agg_srcs if s is not None}
        out = []
        for rg in row_groups:
            meta = reader.row_group_meta(rg)
            cols = meta["columns"]
            L = padded_rows(meta["n"])
            fused_col = self.fused_column_meta(pred, cols, proj)
            askip = self._agg_skip_meta(plan, pred, cols)
            fp = {}
            for c in need:
                if c not in cols:
                    continue
                cm = cols[c]
                if c == plan.group_by:
                    role = "group-key"
                elif c in value_srcs:
                    role = "agg-source"
                elif c in plan.columns:
                    role = "output"
                else:
                    role = "pred"  # decoded for the mask, dropped before the result
                fp[c] = {
                    "nbytes": L * np.dtype(cm["dtype"]).itemsize,
                    "encoded_bytes": cm.get("encoded_bytes", 0),
                    "encoding": cm.get("encoding", "plain"),
                    # fused predicate columns and fused-aggregate pages are
                    # processed in-kernel, never materialized
                    "materialized": c != fused_col and c not in askip,
                    "role": role,
                }
            for src in agg_srcs:
                if src in askip or (src is not None and src not in cols):
                    continue
                for base in windows:
                    name = f"agg:{src or '*'}" + (f"@{base}" if base else "")
                    fp[name] = {"nbytes": L * 4, "encoded_bytes": 0, "encoding": "agg",
                                "materialized": False, "role": "agg"}
            out.append({"rg": rg, "n": meta["n"], "rows": L, "columns": fp})
        return out

    # ------------------------------------------------------------------
    # scan
    # ------------------------------------------------------------------
    def scan_row_group(
        self,
        reader,
        rg: int,
        plan: ScanPlan,
        pred: Optional[Expr],
        blooms: Dict[str, torch.Tensor],
        stats: ScanStats,
        pool=None,
        offload: Optional[str] = None,
    ):
        """Decode + filter ONE row group.  `pred` must already be bound
        (bind_expr); `blooms` maps each BloomProbe's name to its filter;
        `pool` is an optional decode pool shared across coalesced scans.

        Returns (cols, mask): `cols` maps each needed column to its decoded
        tensor, None for a predicate-only column skipped under fusion, or
        the raw EncodedColumn for an aggregate value page that the fused
        decode -> aggregate kernel consumes undecoded (`_agg_skip`); `mask`
        is (L,) bool including row validity."""
        need = plan.all_columns()
        proj = plan.materialized_columns()
        mode = offload or self.offload
        n, L, resident, enc, fuse, _ = self._prepare_row_group(
            reader, rg, plan, pred, mode, stats, pool=pool)
        if resident:
            # every needed column is in the pool or, under a cached mode, in
            # the store: no encoded fetch at all
            cols = {name: self._decode_column(reader, rg, name, None, L, offload=offload,
                                              pool=pool, stats=stats)[0]
                    for name in need}
            return cols, self._valid(self._eval_mask(pred, cols, blooms, L, rg), n, L)

        askip = self._agg_skip(plan, pred, enc)
        cols: Dict[str, object] = {}
        if fuse is not None:
            self._charge_fused(reader, rg, pred, enc, L, stats)
            lo, hi = fuse
            fcol = enc[pred.column]
            stats.kernel_launches += 1
            tr = _tr()
            if tr is not None:
                tr.begin("decode_launch", rg=rg, encoding=fcol.encoding.value, fused=True,
                         rows=L)
            fmask, _ = ops.fused_scan(self._put(fcol.buffers["packed"]), fcol.k, lo, hi)
            if tr is not None:
                tr.end(name="decode_launch")
            mask = fmask.reshape(-1)[:L]
            for name in proj:
                cols[name] = self._serve_column(reader, rg, name, enc, askip, L, offload,
                                                pool, stats)
        else:
            for name in need:
                cols[name] = self._serve_column(reader, rg, name, enc, askip, L, offload,
                                                pool, stats)
            mask = self._eval_mask(pred, cols, blooms, L, rg)

        mask = self._valid(mask, n, L)
        for name in need:
            cols.setdefault(name, None)  # predicate-only column under fusion
        return cols, mask

    # ------------------------------------------------------------------
    # batched multi-row-group scan (bucketed kernel launches)
    # ------------------------------------------------------------------
    def _phase_a(self, reader, rgs, plan: ScanPlan, pred, mode: str, stats: ScanStats, pool,
                 item: int = 0, pending: Optional[set] = None):
        """The batched paths' front half, in row-group order: residency,
        page tier, fetch and fusability (`_prepare_row_group`, the
        sequential path's own code), then the columns needing a fresh
        decode by a non-mutating residency peek (the counting lookups run at
        finalize, in order).  Fused-aggregate pages never enter a decode
        bucket.

        `pending` (cross-request stacking) holds the keys an earlier request
        decodes in this pass: a row group whose every column is pooled or
        pending is served from the pool at finalize, and a pending column is
        not decoded twice.  Returns (slots, fetched row groups)."""
        need = plan.all_columns()
        proj = plan.materialized_columns()
        slots, fetched = [], []
        for rg in rgs:
            if pending is not None and pool is not None:
                keys = [self.rg_cache_key(reader, rg, name) for name in need]
                if (all(k in pool or k in pending for k in keys)
                        and any(k in pending for k in keys)):
                    n = reader.row_group_meta(rg)["n"]
                    slots.append({"rg": rg, "n": n, "L": padded_rows(n), "resident": True,
                                  "enc": {}, "fuse": None, "askip": frozenset(), "decode": [],
                                  "item": item, "pred": pred, "stats": stats})
                    continue
            n, L, resident, enc, fuse, did_fetch = self._prepare_row_group(
                reader, rg, plan, pred, mode, stats, pool=pool)
            askip = self._agg_skip(plan, pred, enc) if not resident else frozenset()
            slot = {"rg": rg, "n": n, "L": L, "resident": resident, "enc": enc, "fuse": fuse,
                    "askip": askip, "decode": [], "item": item, "pred": pred, "stats": stats}
            slots.append(slot)
            if did_fetch:
                fetched.append(rg)
            if resident:
                continue
            for name in (proj if fuse is not None else need):
                if name in askip:
                    continue
                key = self.rg_cache_key(reader, rg, name)
                if pool is not None and key in pool:
                    continue
                if mode in CACHED and key in self.cache:
                    continue
                if pending is not None:
                    if pool is not None and key in pending:
                        continue  # an earlier request decodes it: a pool hit here
                    pending.add(key)
                slot["decode"].append(name)
        return slots, fetched

    def _finalize(self, reader, slots, plan: ScanPlan, pred, blooms, mode: str, offload,
                  pool, stats: ScanStats, fetched: List[int], decoded, fmasks, bmasks):
        """The batched paths' back half, in row-group order: hits, puts,
        counters and masks through the sequential path's own code, with
        each fresh page's bucket slice substituted for its kernel call."""
        need = plan.all_columns()
        proj = plan.materialized_columns()
        per_rg = []
        for slot in slots:
            rg, n, L, item = slot["rg"], slot["n"], slot["L"], slot["item"]
            if slot["resident"]:
                cols = {name: self._serve_resident(reader, rg, name, L, mode, offload, pool,
                                                   stats, fetched)
                        for name in need}
                per_rg.append((cols, self._valid(self._eval_mask(pred, cols, blooms, L, rg),
                                                 n, L)))
                continue
            enc, askip = slot["enc"], slot["askip"]
            cols = {}
            if slot["fuse"] is not None:
                self._charge_fused(reader, rg, pred, enc, L, stats)
                for name in proj:
                    cols[name] = self._serve_column(reader, rg, name, enc, askip, L, offload,
                                                    pool, stats, decoded.get((item, rg, name)))
                mask = fmasks[(item, rg)]
            else:
                for name in need:
                    cols[name] = self._serve_column(reader, rg, name, enc, askip, L, offload,
                                                    pool, stats, decoded.get((item, rg, name)))
                mask = self._eval_mask(pred, cols, blooms, L, rg,
                                       bmasks=bmasks.get((item, rg)))
            mask = self._valid(mask, n, L)
            for name in need:
                cols.setdefault(name, None)
            per_rg.append((cols, mask))
        return per_rg

    def scan_row_groups_batched(
        self,
        reader,
        rgs,
        plan: ScanPlan,
        pred: Optional[Expr],
        blooms: Dict[str, torch.Tensor],
        stats: ScanStats,
        pool=None,
        offload: Optional[str] = None,
    ):
        """Decode + filter MANY row groups with bucketed batch launches,
        bit-identical to calling `scan_row_group` per group, in order.

        Compatible pages stack along the block axis and decode in ONE
        host-to-device copy and ONE kernel launch per (encoding, k, dtype)
        bucket (`kernels.ops` `*_batch`).  Everything that is not the launch
        (residency, page tier, fetch, checksum, counters, pool and cache
        puts, masks) runs through the sequential code in (row group,
        column) order, so the accounting cannot drift.  (As in the
        reference, every fetch happens before any decoded put, so a cache
        evicting entries that were resident before the slice can shift the
        hit counters; the results stay bit-identical.)

        Returns (per_rg, fetched): `per_rg` is [(cols, mask)] in `rgs` order
        with `scan_row_group`'s contract; `fetched` lists the row groups
        that read encoded bytes from storage."""
        rgs = list(rgs)
        mode = offload or self.offload
        if not self._kernels or len(rgs) <= 1:
            # the host baseline has nothing to launch in buckets, and a
            # single group has nothing to bucket: the sequential path IS the
            # batched path (and kernel_launches stays equal)
            per_rg, fetched = [], []
            for rg in rgs:
                enc0 = stats.encoded_bytes
                per_rg.append(self.scan_row_group(reader, rg, plan, pred, blooms, stats,
                                                  pool=pool, offload=offload))
                if stats.encoded_bytes > enc0:
                    fetched.append(rg)
            return per_rg, fetched
        slots, fetched = self._phase_a(reader, rgs, plan, pred, mode, stats, pool)
        decoded, fmasks = self._launch_buckets(slots)
        # bloom semijoin probes ride the batched pass: one launch per filter
        bmasks = self._batch_bloom_probe(slots, pred, blooms, decoded)
        per_rg = self._finalize(reader, slots, plan, pred, blooms, mode, offload, pool, stats,
                                fetched, decoded, fmasks, bmasks)
        return per_rg, fetched

    def _batch_bloom_probe(self, slots, pred, blooms, decoded) -> Dict[tuple, Dict]:
        """Stack every freshly decoded slice page's keys and probe each
        bloom filter in ONE `ops.bloom_probe` dispatch.  Returns {(item, rg):
        {(name, column): (L,) mask}} for `_eval`; pages served from the pool
        or the cache at finalize are absent and take the per-row-group
        probe, bit-identical either way."""
        if pred is None or not self._kernels or not blooms:
            return {}
        probes = {(p.name, p.column): p for p in _expr_blooms(pred) if p.name in blooms}
        out: Dict[tuple, Dict] = {}
        for (name, column), probe in sorted(probes.items()):
            entries = []  # (item, rg, L, nblk)
            keys = []
            for slot in slots:
                if slot["resident"] or slot["fuse"] is not None:
                    continue
                item = slot["item"]
                arr = decoded.get((item, slot["rg"], column))
                if arr is None:
                    continue
                L = slot["L"]
                entries.append((item, slot["rg"], L, L // RLE_OUT_BLOCK))
                keys.append(arr.to(torch.int32).reshape(-1, RLE_OUT_BLOCK))
            if not entries:
                continue
            m = ops.bloom_probe(torch.cat(keys), blooms[name], probe.n_hashes)
            s = 0
            for item, rg, L, nblk in entries:
                out.setdefault((item, rg), {})[(name, column)] = m[s:s + nblk].reshape(-1)[:L]
                s += nblk
        return out

    def _serve_resident(self, reader, rg, name, L, mode, offload, pool, stats, fetched):
        """Finalize-time lookup for a column that was resident in phase A.
        If the slice's own puts evicted it meanwhile, fall back to the page
        tier or a fetch and a single decode: the sequential path would have
        seen the same miss, so the results stay identical."""
        key = self.rg_cache_key(reader, rg, name)
        still = (pool is not None and key in pool) or (mode in CACHED and key in self.cache)
        col = None
        if not still:
            if mode in CACHED:
                col = self._page_hit(reader, rg, name, stats)
            if col is None:
                col = self._fetch(reader, rg, [name], mode, stats)[name]
                if rg not in fetched:
                    fetched.append(rg)
        arr, _ = self._decode_column(reader, rg, name, col, L, offload=offload, pool=pool,
                                     stats=stats)
        return arr

    def _put_stacked(self, *parts: np.ndarray) -> List[torch.Tensor]:
        """Several 32-bit host buffers in ONE host-to-device copy: their words
        are concatenated (each part padded to 16 bytes, so every view stays
        aligned for vector loads), copied once, and handed back as views of
        their own shapes, with uint32 words as int32 and float32 as float32."""
        words = []
        for p in parts:
            assert p.dtype.itemsize == 4, p.dtype
            w = np.ascontiguousarray(p).reshape(-1).view(np.int32)
            words.append(w)
            if w.size % 4:
                words.append(np.zeros(4 - w.size % 4, np.int32))
        flat = self._put(np.concatenate(words))
        out, s = [], 0
        for p in parts:
            t = flat[s:s + p.size]
            if p.dtype == np.float32:
                t = t.view(torch.float32)
            out.append(t.reshape(p.shape))
            s += -(-p.size // 4) * 4
        return out

    def _launch_buckets(self, slots):
        """Group every pending (row group, column) page by its launch
        signature and decode each bucket in ONE copy and ONE dispatch.
        Returns ({(item, rg, name): decoded (L,) tensor}, {(item, rg): fused
        mask}).

        A slot carries its request's `item`, `pred` and `stats`: the
        cross-request pass stacks many requests' pages into the same
        buckets, and a bucket's launch is charged to the stats of its first
        contributing request."""
        buckets: Dict[tuple, List[dict]] = {}
        fused_items: Dict[int, List[dict]] = {}
        for slot in slots:
            if slot["resident"]:
                continue
            rg, L, item = slot["rg"], slot["L"], slot["item"]
            spred, sstats = slot["pred"], slot["stats"]
            if slot["fuse"] is not None:
                col = slot["enc"][spred.column]
                lo, hi = slot["fuse"]
                fused_items.setdefault(col.k, []).append(
                    {"rg": rg, "L": L, "packed": col.buffers["packed"], "lo": lo, "hi": hi,
                     "item": item, "stats": sstats})
            for name in slot["decode"]:
                col = slot["enc"][name]
                e = col.encoding
                if e == Encoding.PLAIN:
                    bkey = ("plain", str(col.buffers["plain"].dtype))
                elif e == Encoding.BITPACK:
                    bkey = ("bitpack", col.k)
                elif e == Encoding.DICT:
                    d = col.buffers["dictionary"]
                    bkey = ("dict", col.k, "int32" if d.dtype.kind in "iu" else str(d.dtype))
                elif e == Encoding.DELTA:
                    bkey = ("delta", col.k)
                else:
                    bkey = ("rle", str(col.buffers["rle_values"].dtype))
                buckets.setdefault(bkey, []).append({"rg": rg, "name": name, "col": col,
                                                     "L": L, "item": item, "stats": sstats})

        decoded: Dict[tuple, torch.Tensor] = {}
        for bkey, items in buckets.items():
            bstats = items[0]["stats"]
            tr = _tr()
            if tr is not None:
                launches0 = bstats.kernel_launches
                tr.begin("decode_launch", bucket="/".join(str(p) for p in bkey),
                         pages=len(items))
            decoded.update(self._decode_bucket(bkey, items, bstats))
            if tr is not None:
                tr.end(name="decode_launch", launches=bstats.kernel_launches - launches0,
                       pad_blocks=0)
        fmasks: Dict[tuple, torch.Tensor] = {}
        for k, items in sorted(fused_items.items()):
            bstats = items[0]["stats"]
            tr = _tr()
            if tr is not None:
                tr.begin("decode_launch", bucket=f"fused/k{k}", pages=len(items), fused=True)
            blocks = [it["packed"].shape[0] for it in items]
            lohi = np.stack([
                np.concatenate([np.full(b, it[key], np.int32) for b, it in zip(blocks, items)])
                for key in ("lo", "hi")])
            packed, lohi = self._put_stacked(
                np.concatenate([it["packed"] for it in items], axis=0), lohi)
            mask = ops.fused_scan_batch(packed, k, lohi[0], lohi[1])
            bstats.kernel_launches += 1
            s = 0
            for b, it in zip(blocks, items):
                fmasks[(it["item"], it["rg"])] = mask[s:s + b].reshape(-1)[: it["L"]]
                s += b
            if tr is not None:
                tr.end(name="decode_launch", launches=1, pad_blocks=0)
        return decoded, fmasks

    @staticmethod
    def _split_flat(out: torch.Tensor, items, blocks) -> Dict[tuple, torch.Tensor]:
        """Slice one bucket's stacked decode back into per-page (L,) columns,
        with the sequential path's pad-to-L / truncate-to-L."""
        res = {}
        s = 0
        for b, it in zip(blocks, items):
            flat = out[s:s + b].reshape(-1)
            L = it["L"]
            if flat.shape[0] < L:
                flat = torch.nn.functional.pad(flat, (0, L - flat.shape[0]))
            res[(it["item"], it["rg"], it["name"])] = flat[:L]
            s += b
        return res

    def _decode_bucket(self, bkey, items, stats) -> Dict[tuple, torch.Tensor]:
        """One bucket: its pages concatenated on the host, ONE counted
        host-to-device copy, ONE launch, split back per page (as views of
        the bucket's output; the store copies what it keeps)."""
        kind = bkey[0]
        stats.kernel_launches += 1
        if kind == "plain":
            # plain has no kernel: the stacked buffer's device put is the
            # bucket's one counted dispatch
            total = sum(it["L"] for it in items)
            buf = np.zeros((total,), dtype=np.dtype(bkey[1]))
            s = 0
            for it in items:
                v = it["col"].buffers["plain"]
                buf[s:s + v.shape[0]] = v
                s += it["L"]
            out = ops.device_put(buf, self.device)
            res, s = {}, 0
            for it in items:
                res[(it["item"], it["rg"], it["name"])] = out[s:s + it["L"]]
                s += it["L"]
            return res
        bufs = [it["col"].buffers for it in items]
        if kind == "rle":
            blocks = [b["rle_values"].shape[0] for b in bufs]
            values, ends = self._put_stacked(
                np.concatenate([b["rle_values"] for b in bufs], axis=0),
                np.concatenate([b["rle_ends"] for b in bufs], axis=0))
            return self._split_flat(ops.rle_decode_batch(values, ends), items, blocks)
        k = bkey[1]
        blocks = [b["packed"].shape[0] for b in bufs]
        packed = np.concatenate([b["packed"] for b in bufs], axis=0)
        if kind == "bitpack":
            (packed,) = self._put_stacked(packed)
            out = ops.bitunpack_batch(packed, k)
        elif kind == "dict":
            dicts_np = [d.astype(np.int32) if d.dtype.kind in "iu" else d
                        for d in (b["dictionary"] for b in bufs)]
            dicts = np.zeros((len(items), max(d.shape[0] for d in dicts_np)),
                             dtype=np.dtype(bkey[2]))
            sizes = np.zeros((len(items),), np.int32)
            for i, d in enumerate(dicts_np):
                dicts[i, : d.shape[0]] = d
                sizes[i] = d.shape[0]
            page = np.concatenate([np.full(b, i, np.int32) for i, b in enumerate(blocks)])
            packed, dicts, sizes, page = self._put_stacked(packed, dicts, sizes, page)
            out = ops.dict_decode_batch(packed, dicts, sizes, page, k)
        else:  # delta
            packed, bases = self._put_stacked(
                packed, np.concatenate([b["bases"].astype(np.int32) for b in bufs]))
            out = ops.delta_decode_batch(packed, bases, k)
        return self._split_flat(out, items, blocks)

    # ------------------------------------------------------------------
    # cross-request bucket stacking
    # ------------------------------------------------------------------
    def scan_group_batched(self, items, pool=None):
        """Decode the slices of SEVERAL coalesced scans over one table in a
        single bucketed launch pass.

        Each item is one request's slice: {"reader", "rgs", "plan", "pred",
        "blooms", "stats", "offload", "owner", "trace"}, the state
        `ResumableScan.advance_batched` would pass to
        `scan_row_groups_batched`.  Returns [(per_rg, fetched)] aligned with
        `items`, each carrying that request's own columns, masks and fetched
        row groups, for `ResumableScan.ingest_batched`.

        Every request's pages stack into ONE set of buckets, and a page two
        requests need decodes once: the later request skips it in phase A
        and serves it as a pool hit at its finalize, which is the accounting
        the sequential order gives.  `pool.owner` and the trace slice
        context are rebound per item around its phase-A and finalize work; a
        stacked bucket's launch is charged to its first contributor."""
        tr_mod = TRACE

        def _ctx(it):
            if tr_mod is not None:
                t = it.get("trace")
                tr_mod.set_slice(*(t if t else (None, None)))

        def _owner(it):
            if pool is not None and hasattr(pool, "owner"):
                pool.owner = it.get("owner", pool.owner)

        if not self._kernels:
            # the host baseline has no launches to stack: each request
            # through the batched entry (sequential on host), sharing the pool
            out = []
            for it in items:
                _owner(it)
                _ctx(it)
                out.append(self.scan_row_groups_batched(
                    it["reader"], it["rgs"], it["plan"], it["pred"], it["blooms"],
                    it["stats"], pool=pool, offload=it["offload"]))
            if tr_mod is not None:
                tr_mod.set_slice(None, None)
            return out

        # phase A per item, in order: residency / page tier / fetch
        slots_by_item, fetched_by_item = [], []
        pending: set = set()  # keys an EARLIER item decodes in this pass
        for i, it in enumerate(items):
            _owner(it)
            _ctx(it)
            slots, fetched = self._phase_a(
                it["reader"], it["rgs"], it["plan"], it["pred"], it["offload"] or self.offload,
                it["stats"], pool, item=i, pending=pending)
            slots_by_item.append(slots)
            fetched_by_item.append(fetched)

        # phase B: ONE bucket pass across every request's pages (its spans
        # go to the first traced item)
        if tr_mod is not None:
            first = next((it.get("trace") for it in items if it.get("trace")), None)
            tr_mod.set_slice(*(first if first else (None, None)))
        decoded, fmasks = self._launch_buckets([s for ss in slots_by_item for s in ss])

        # finalize per item, in order: hits, puts, counters, masks (each
        # request's bloom probes per row group, as the reference's)
        out = []
        for i, it in enumerate(items):
            _owner(it)
            _ctx(it)
            per_rg = self._finalize(
                it["reader"], slots_by_item[i], it["plan"], it["pred"], it["blooms"],
                it["offload"] or self.offload, it["offload"], pool, it["stats"],
                fetched_by_item[i], decoded, fmasks, {})
            out.append((per_rg, fetched_by_item[i]))
        if tr_mod is not None:
            tr_mod.set_slice(None, None)
        return out

    def scan(
        self,
        reader,
        plan: ScanPlan,
        blooms: Optional[Dict[str, torch.Tensor]] = None,
        offload: Optional[str] = None,
        pool=None,
        row_groups=None,
        batched: bool = False,
    ) -> ScanResult:
        """Full pushed-down scan, as a ResumableScan driven to completion in
        one shot.  `blooms` maps each BloomProbe's name to its (n_bits,)
        uint8 filter on the engine's device; `offload` overrides the
        engine's mode for this call; `pool` is a decode pool shared across
        coalesced scans; `row_groups` skips re-pruning when the caller
        already pruned.  `batched=True` routes the row-group work through
        `scan_row_groups_batched` (one launch per bucket) instead of one
        launch per (row group, column)."""
        rs = ResumableScan(self, reader, plan, blooms=blooms, offload=offload,
                           row_groups=row_groups)
        if rs.result is None:
            if batched:
                rs.advance_batched(tuple(rs.pending), pool=pool)
            else:
                rs.advance(tuple(rs.pending), pool=pool)
        return rs.result

    def resumable_scan(
        self,
        reader,
        plan: ScanPlan,
        blooms: Optional[Dict[str, torch.Tensor]] = None,
        offload: Optional[str] = None,
        row_groups=None,
    ) -> "ResumableScan":
        """A scan that can be advanced a few row groups at a time."""
        return ResumableScan(self, reader, plan, blooms=blooms, offload=offload,
                             row_groups=row_groups)

    def _compact(self, cols: Dict[str, torch.Tensor], mask: torch.Tensor):
        """Global stream compaction: each column compacted per block by
        `ops.filter_compact`, then the blocks stitched by an exclusive scan of
        their counts.  Returns (columns with the survivors packed to the
        front and zeros after them, the mask of the first `total` rows,
        total as an int32 scalar)."""
        L = mask.shape[0]
        nblk = L // RLE_OUT_BLOCK
        m2 = mask.reshape(nblk, RLE_OUT_BLOCK)
        slot = torch.arange(RLE_OUT_BLOCK, device=mask.device)[None, :]
        out = {}
        for name, arr in cols.items():
            comp, counts = ops.filter_compact(arr.reshape(nblk, RLE_OUT_BLOCK), m2)
            offs = torch.cumsum(counts, 0) - counts
            # slots past a block's count go to a spare element that is cut off
            # (the reference's scatter with mode="drop")
            tgt = torch.where(slot < counts[:, None], offs[:, None] + slot, L)
            flat = torch.zeros((L + 1,), dtype=arr.dtype, device=arr.device)
            flat.index_put_((tgt.reshape(-1),), comp.reshape(-1))
            out[name] = flat[:L]
        total = counts.sum(dtype=torch.int32)
        return out, torch.arange(L, device=mask.device) < total, total


class ResumableScan:
    """One pushed-down scan, resumable at row-group granularity.

    `advance(next_row_groups)` scans and folds a few row groups at a time,
    `advance_batched` does the same through the bucketed batch path, and
    `ingest_batched` folds a slice that `scan_group_batched` scanned; once
    the last one lands, `result` holds the assembled ScanResult, the same
    as a one-shot `DatapathEngine.scan`.  `result` is set right after
    construction when no row-group work is needed: a prefiltered (or
    pre-aggregated) cache hit, or every row group pruned."""

    def __init__(self, engine: DatapathEngine, reader, plan: ScanPlan,
                 blooms: Optional[Dict[str, torch.Tensor]] = None,
                 offload: Optional[str] = None, row_groups=None, scan_tag=None):
        if offload not in (None,) + OFFLOADS:
            raise ValueError(f"unknown offload mode {offload!r}")
        self.engine = engine
        self.reader = reader
        self.plan = plan
        self.offload = offload or engine.offload
        self.blooms = blooms or {}
        # the prefiltered key's scope beyond the plan (plan_cache_key `tag`)
        self.scan_tag = scan_tag
        self.stats = ScanStats(row_groups_total=reader.n_row_groups, rows_total=reader.n_rows)
        self.result: Optional[ScanResult] = None

        # operator pushdown: the scan reduces to per-group accumulators
        # instead of rows.  A group domain over the kernels' MAX_GROUPS
        # ceiling is reduced in MAX_GROUPS-wide windows (`_fold_agg`).
        self._agg = bool(plan.aggregates)
        if self._agg:
            assert not plan.compact, "aggregate scans return no rows to compact"
            self._n_groups = (group_domain(reader, plan.group_by)
                              if plan.group_by is not None else 1)
            # src -> {rg: ColPartial}; the None source is a bare count(*)
            self._agg_parts: Dict[Optional[str], Dict[int, agg_merge.ColPartial]] = {}
        if self.offload in ("prefiltered", "pre-aggregated"):
            hit = engine.cache.get(self._cache_key())
            if hit is not None:
                self.stats.cache_hit = True
                self.stats.rows_out = int(hit.count)
                self.stats.result_bytes = hit.stats.result_bytes
                self._pending: List[int] = []
                self.result = ScanResult(hit.columns, hit.mask, hit.count, self.stats,
                                         aggregates=hit.aggregates,
                                         agg_partials=hit.agg_partials)
                return

        self.pred = bind_expr(plan.predicate, reader)
        rgs = list(row_groups) if row_groups is not None else prune_row_groups(reader, self.pred)
        self.stats.row_groups_scanned = len(rgs)
        self._rgs = rgs
        self._pending = list(rgs)
        self._need = plan.all_columns()
        self._per_rg_cols: Dict[str, List[Optional[torch.Tensor]]] = {c: [] for c in self._need}
        self._per_rg_mask: List[torch.Tensor] = []
        if not self._pending:  # everything pruned: assemble the empty result
            self._finish()

    def _cache_key(self):
        return self.engine.plan_cache_key(self.reader, self.plan, self.blooms, tag=self.scan_tag)

    @property
    def pending(self) -> tuple:
        """Row groups not yet scanned, in scan order."""
        return tuple(self._pending)

    def _take(self, row_groups) -> List[int]:
        """Check that `row_groups` are the next pending groups, in order,
        and mark them taken."""
        assert self.result is None, "scan already complete"
        rgs = list(row_groups)
        for rg in rgs:
            if not self._pending or rg != self._pending[0]:
                raise ValueError(
                    f"row group {rg} dispatched out of order (next is "
                    f"{self._pending[0] if self._pending else None})")
            self._pending.pop(0)
        return rgs

    def advance(self, row_groups, pool=None) -> Optional[ScanResult]:
        """Scan the given row groups (must be the next groups in order) one
        at a time and fold them into the accumulated partial result.  `pool`
        is the tick's shared decode pool.  Returns the final ScanResult once
        the last group is folded in, else None."""
        assert self.result is None, "scan already complete"
        for rg in row_groups:
            self._take([rg])
            cols, mask = self.engine.scan_row_group(
                self.reader, rg, self.plan, self.pred, self.blooms, self.stats,
                pool=pool, offload=self.offload)
            self._fold([rg], [(cols, mask)])
        if not self._pending:
            self._finish()
        return self.result

    def advance_batched(self, row_groups, pool=None):
        """`advance`, through the engine's bucketed batch path: the slice's
        pages are bucketed by (encoding, k, dtype) and decoded in one launch
        per bucket, with a bit-identical fold.  Returns (result-or-None,
        fetched): the row groups that read encoded bytes."""
        rgs = self._take(row_groups)
        per_rg, fetched = self.engine.scan_row_groups_batched(
            self.reader, rgs, self.plan, self.pred, self.blooms, self.stats,
            pool=pool, offload=self.offload)
        self._fold(rgs, per_rg)
        if not self._pending:
            self._finish()
        return self.result, fetched

    def ingest_batched(self, row_groups, per_rg):
        """Fold in a slice that `scan_group_batched` scanned for this scan
        (the groups must be the next pending ones, in order).  Returns the
        final result once complete."""
        rgs = self._take(row_groups)
        self._fold(rgs, per_rg)
        if not self._pending:
            self._finish()
        return self.result

    def _fold(self, rgs: List[int], per_rg) -> None:
        """Fold one advanced slice into the accumulated partial result.  Row
        scans stash decoded columns and masks per row group; pushed-down
        aggregates reduce the slice to (n_groups,) partials here and keep
        nothing row-shaped."""
        if self._agg:
            self._fold_agg(rgs, per_rg)
            return
        for cols, mask in per_rg:
            for name in self._need:
                self._per_rg_cols[name].append(cols[name])
            self._per_rg_mask.append(mask)

    def _fold_agg(self, rgs: List[int], per_rg) -> None:
        """Reduce an advanced slice to per-row-group ColPartials: ONE
        aggregate launch per value source and window per call (and one per
        k for the fused pages).  `advance` passes single row groups, the
        batched paths whole slices; splitting the stacked planes back per
        row group before folding keeps the canonical per-row-group fold, so
        both cadences give bit-identical partials."""
        dev = self.engine.device
        tr = _tr()
        metas = []  # (nblk, gids (nblk, 4096) int32, mask (nblk, 4096) bool)
        for cols, mask in per_rg:
            nblk = int(mask.shape[0]) // PACK_BLOCK
            if self.plan.group_by is not None:
                gids = cols[self.plan.group_by].to(torch.int32).reshape(nblk, PACK_BLOCK)
            else:
                gids = torch.zeros((nblk, PACK_BLOCK), dtype=torch.int32, device=dev)
            metas.append((nblk, gids, mask.reshape(nblk, PACK_BLOCK)))
        for src in agg_merge.agg_sources(self.plan.aggregates):
            # decoded pages (and the gids-as-values bare count) stack into one
            # grouped launch per window; never-decoded BITPACK pages
            # (`_agg_skip`) into one unpack-in-kernel launch per k.  Blocks
            # reduce independently, so stacking changes no per-block row.
            dec: List[int] = []
            fused: Dict[int, List[int]] = {}
            for i, (cols, _m) in enumerate(per_rg):
                v = cols[src] if src is not None else None
                if isinstance(v, EncodedColumn):
                    fused.setdefault(v.k, []).append(i)
                else:
                    dec.append(i)
            planes_by_i: Dict[int, tuple] = {}
            is_float: Dict[int, bool] = {}
            if dec:
                vals = torch.cat([
                    (per_rg[i][0][src] if src is not None else metas[i][1])
                    .reshape(metas[i][0], PACK_BLOCK) for i in dec])
                gids = torch.cat([metas[i][1] for i in dec])
                m2 = torch.cat([metas[i][2] for i in dec])
                if tr is not None:
                    tr.begin("agg_launch", source=src or "*", pages=len(dec),
                             rows=int(vals.shape[0]) * PACK_BLOCK)
                # one launch per MAX_GROUPS-wide window of the group domain,
                # ids shifted into it (rows of other windows count as out of
                # range).  A group's cells depend on its own rows only, so the
                # windows side by side are the whole domain's planes, bit for bit.
                windows = []
                for base in agg_windows(self._n_groups):
                    windows.append(ops.grouped_agg_batch(
                        vals, gids - base if base else gids, m2,
                        min(ops.MAX_GROUPS, self._n_groups - base)))
                    self.stats.kernel_launches += 1
                planes = tuple(torch.cat(p, dim=1).cpu().numpy()  # 5 small copies back
                               for p in zip(*windows))
                if tr is not None:
                    tr.end(name="agg_launch", launches=len(windows))
                s = 0
                for i in dec:
                    planes_by_i[i] = tuple(p[s:s + metas[i][0]] for p in planes)
                    is_float[i] = vals.dtype.is_floating_point
                    s += metas[i][0]
                    # each launch processes the decoded values once more:
                    # booked as 'agg' work (decode_footprint's agg entries)
                    self.stats.decode_work["agg"] = (
                        self.stats.decode_work.get("agg", 0)
                        + len(windows) * metas[i][0] * PACK_BLOCK * 4)
            for k, idxs in sorted(fused.items()):
                (packed,) = self.engine._put_stacked(np.concatenate(
                    [per_rg[i][0][src].buffers["packed"] for i in idxs], axis=0))
                m2 = torch.cat([metas[i][2] for i in idxs])
                if tr is not None:
                    tr.begin("agg_launch", source=src, pages=len(idxs), fused=True,
                             rows=int(packed.shape[0]) * PACK_BLOCK)
                planes = ops.fused_agg_batch(packed, k, m2)
                self.stats.kernel_launches += 1
                planes = tuple(p.cpu().numpy() for p in planes)
                if tr is not None:
                    tr.end(name="agg_launch")
                s = 0
                for i in idxs:
                    planes_by_i[i] = tuple(p[s:s + metas[i][0]] for p in planes)
                    is_float[i] = False
                    s += metas[i][0]
            parts = self._agg_parts.setdefault(src, {})
            for i, rg in enumerate(rgs):
                parts[rg] = agg_merge.fold_blocks(planes_by_i[i], is_float[i])

    def _finish(self) -> None:
        if self._agg:
            self._finish_agg()
            return
        proj = self.plan.columns
        dev = self.engine.device
        if not self._rgs:  # everything pruned — nothing scanned, nothing cached
            # empty columns keep the schema's decoded dtypes
            empty = {
                c: torch.zeros((0,), dtype=_TORCH_DTYPES[self.reader.decoded_dtype(c)],
                               device=dev)
                for c in proj
            }
            z = torch.zeros((0,), dtype=torch.bool, device=dev)
            self.result = ScanResult(
                empty, z, torch.zeros((), dtype=torch.int32, device=dev), self.stats)
            return
        out_cols = {
            c: torch.cat(v)
            for c, v in self._per_rg_cols.items()
            if v[0] is not None and c in proj
        }
        mask = torch.cat(self._per_rg_mask)
        count = mask.sum(dtype=torch.int32)
        if self.plan.compact:
            tr = _tr()
            if tr is not None:
                tr.begin("filter", compact=True, rows=int(mask.shape[0]))
            out_cols, mask, count = self.engine._compact(out_cols, mask)
            if tr is not None:
                tr.end(name="filter")
        # result-DMA size: the projected columns + survivor mask handed to
        # the consumer (predicate-only columns were dropped above)
        self.stats.result_bytes = sum(_nbytes(a) for a in out_cols.values()) + _nbytes(mask)
        self.stats.rows_out = int(count)
        self.result = ScanResult(out_cols, mask, count, self.stats)
        if self.offload == "prefiltered":
            # the entry's eviction price is the ground-truth work behind it
            self.engine.cache.put(self._cache_key(), self.result, tier="prefiltered",
                                  decode_work=dict(self.stats.decode_work))

    def _finish_agg(self) -> None:
        """Assemble an aggregate scan's result: merge per-row-group partials
        in global row-group order (the canonical fold), finalize to
        (n_groups,) arrays, and hand over only the accumulators."""
        sources = agg_merge.agg_sources(self.plan.aggregates)
        if not self._rgs:
            # everything pruned: the merge identity of each source
            parts_by_rg: Dict[int, dict] = {}
            merged = {
                src: agg_merge.identity_partial(
                    self._n_groups,
                    self.reader.decoded_dtype(src) if src is not None else np.int32)
                for src in sources
            }
        else:
            parts_by_rg = {rg: {src: self._agg_parts[src][rg] for src in sources}
                           for rg in self._rgs}
            merged = {src: agg_merge.merge_partials([self._agg_parts[src][rg]
                                                     for rg in self._rgs])
                      for src in sources}
        aggs = agg_merge.finalize(self.plan.aggregates, merged, self._n_groups)
        count = int(next(iter(merged.values())).cnt.sum())
        self.stats.rows_out = count
        self.stats.result_bytes = sum(int(a.nbytes) for a in aggs.values())
        dev = self.engine.device
        self.result = ScanResult(
            {}, torch.zeros((0,), dtype=torch.bool, device=dev),
            torch.tensor(count, dtype=torch.int32, device=dev), self.stats,
            aggregates=aggs, agg_partials=parts_by_rg)
        if self.offload in ("prefiltered", "pre-aggregated"):
            # the whole accumulator result: a few KB answering a scan that
            # would otherwise re-read and re-reduce every row group
            self.engine.cache.put(self._cache_key(), self.result, tier="prefiltered",
                                  decode_work=dict(self.stats.decode_work))
