"""DatapathEngine — the paper's data-processing SmartNIC, on a CUDA card.

Port of `repro.core.engine` with the `raw` offload mode:

    footer zone maps ──► row-group pruning (metadata only, host)
         │
    encoded bytes ────► checksum check ──► decode on the card (CUDA kernels)
         │                                        │
         │                             pushed-down predicate (bloom semijoin
         │                             included), or the fused decode + range
         │                             filter on packed words
         ▼                                        ▼
    consumer ◄──── decoded columns + survivor mask + count, or, with
                   compact=True, the survivors packed to the front, or,
                   for a plan with `aggregates`, only the (n_groups,)
                   accumulators (operator pushdown, core/agg.py)

A scan runs sequentially (one launch per fresh (row group, column)) or
batched (`scan(batched=True)`: a slice's pages stacked per (encoding, k,
dtype) bucket, one host-to-device copy and one launch per bucket), with
bit-identical results and accounting but for `kernel_launches`.  The port
pads no stack, so `batch_pad_blocks` stays 0.

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`, which routes every kernel to its plain PyTorch version).
Asking for the card without one raises; nothing falls back to the CPU.

What later slices bring raises NotImplementedError naming its ROADMAP.md
item: other offload modes, a block cache, decode pools, cross-request
bucket stacking, the cost model's footprint mirrors and the `host` backend.
Every ScanStats field is kept, so scans compare field for field with the
JAX engine; the fields of the unported features stay 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import agg as agg_merge
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
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import (
    PACK_BLOCK,
    RLE_OUT_BLOCK,
    EncodedColumn,
    Encoding,
    padded_rows,
)
from repro_torch.lakeformat.integrity import CorruptPageError, page_checksum

# the ROADMAP.md section A item that the NotImplementedError messages name
SERVICE = "A.4 datapath service and BlockCache/BlockStore"

_TORCH_DTYPES = {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32}


def _later(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


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
    # bytes but never materialized).
    decode_work: Dict[str, int] = dataclasses.field(default_factory=dict)
    pool_hits: int = 0
    pool_hit_bytes: int = 0
    page_hits: int = 0
    page_hit_bytes: int = 0
    rows_total: int = 0
    rows_out: int = 0
    # Bytes the scan's result hands to the consumer: projection columns +
    # survivor mask.
    result_bytes: int = 0
    fused: bool = False
    cache_hit: bool = False
    # Dispatches on the decode path only (column decodes, PLAIN device puts,
    # fused scans): one per fresh (row group, column) on this sequential path.
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


class DatapathEngine:
    def __init__(
        self,
        device="cuda",
        offload: str = "raw",
        cache=None,
        backend: str = "auto",
    ):
        if backend == "host":
            raise _later("the host (numpy) decode backend", SERVICE)
        if backend != "auto":
            raise ValueError(f"unknown backend {backend!r}: the port routes by device")
        if offload in ("preloaded", "prefiltered", "pre-aggregated"):
            raise _later(f"offload={offload!r}", SERVICE)
        if offload != "raw":
            raise ValueError(f"unknown offload mode {offload!r}")
        if cache is not None:
            raise _later("a block cache", SERVICE)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _put(self, buf: np.ndarray) -> torch.Tensor:
        return ops.to_tensor(buf, self.device)

    def _decode_device(self, col: EncodedColumn, L: int) -> torch.Tensor:
        """Decode one encoded column on the engine's device, padded to L rows."""
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

    def _decode_column(self, col: EncodedColumn, L: int, stats: ScanStats,
                       precomputed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Serve one decoded row-group column, booked in `stats`.
        `precomputed` is the batched path's already-launched bucket slice
        for this (row group, column): it substitutes for the kernel call
        only, and every byte counter runs as on the sequential path."""
        if precomputed is not None:
            arr = precomputed  # the bucket launch is counted by the caller
        else:
            arr = self._decode_device(col, L)
            stats.kernel_launches += 1
        nb = _nbytes(arr)
        stats.decoded_bytes += nb
        stats.decoded_bytes_fresh += nb
        e = col.encoding.value
        stats.decode_work[e] = stats.decode_work.get(e, 0) + nb
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

    def _eval_mask(self, pred: Optional[Expr], cols, blooms, L: int,
                   bmasks: Optional[Dict] = None) -> torch.Tensor:
        """Predicate mask over L rows (all true without a predicate).
        `bmasks` maps (bloom name, column) to this row group's pre-probed
        (L,) membership mask from the batched path's stacked probe."""
        if pred is None:
            return torch.ones((L,), dtype=torch.bool, device=self.device)
        return self._eval(pred, cols, blooms, bmasks)

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

    def _storage_read(self, reader, rg: int, columns,
                      stats: ScanStats) -> Dict[str, EncodedColumn]:
        """The only path encoded pages take from storage into the engine.
        Pages are checksum-verified against the footer before they can reach
        a decode kernel; a mismatch raises CorruptPageError, never returns
        garbage.  Legacy footers without checksums verify trivially."""
        got = reader.read_encoded(rg, columns)
        for name, col in got.items():
            expect = reader.page_checksum_meta(rg, name)
            if expect is not None and page_checksum(col) != expect:
                stats.corrupt_pages += 1
                raise CorruptPageError(
                    f"{reader.path} rg={rg} column={name}: page "
                    "failed checksum verification",
                    table=reader.path, rg=rg, column=name)
        return got

    def _prepare_row_group(self, reader, rg: int, plan: ScanPlan,
                           pred: Optional[Expr], stats: ScanStats):
        """Fetch one row group's encoded pages and decide fusability.
        Returns (n, L, enc, fuse)."""
        need = plan.all_columns()
        n = reader.row_group_meta(rg)["n"]
        L = padded_rows(n)
        enc = self._storage_read(reader, rg, need, stats)
        stats.encoded_bytes += sum(c.encoded_bytes() for c in enc.values())
        fuse = self._fusable(pred, enc, plan.materialized_columns())
        return n, L, enc, fuse

    def _agg_skip(self, plan: ScanPlan, pred: Optional[Expr],
                  enc: Dict[str, EncodedColumn]) -> frozenset:
        """Aggregate value columns eligible for the fully fused decode ->
        aggregate kernel (ops.fused_agg_batch): BITPACK pages whose decoded
        values nothing else consumes (not projected, not referenced by the
        predicate).  Those pages skip the decode entirely; the unpack
        happens inside the aggregate kernel.  Ungrouped plans only: the
        fused kernel has no group-id input."""
        if not plan.aggregates or plan.group_by is not None:
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

    def _agg_skip_meta(self, plan: ScanPlan, pred: Optional[Expr], meta_cols: Dict):
        """`_agg_skip` from footer metadata: the cost model's mirror."""
        raise _later("the cost model's footprint mirror _agg_skip_meta", SERVICE)

    def decode_footprint(self, reader, plan: ScanPlan, row_groups, pred=None):
        """Per-row-group decode footprint from metadata: the cost model's input."""
        raise _later("decode_footprint, the cost model's footprint", SERVICE)

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
    ):
        """Decode + filter ONE row group.  `pred` must already be bound
        (bind_expr); `blooms` maps each BloomProbe's name to its filter.

        Returns (cols, mask): `cols` maps each needed column to its decoded
        tensor, None for a predicate-only column skipped under fusion, or
        the raw EncodedColumn for an aggregate value page that the fused
        decode -> aggregate kernel consumes undecoded (`_agg_skip`); `mask`
        is (L,) bool including row validity."""
        need = plan.all_columns()
        proj = plan.materialized_columns()
        n, L, enc, fuse = self._prepare_row_group(reader, rg, plan, pred, stats)
        askip = self._agg_skip(plan, pred, enc)
        cols: Dict[str, Optional[torch.Tensor]] = {}
        if fuse is not None:
            stats.fused = True
            lo, hi = fuse
            fcol = enc[pred.column]
            fe = fcol.encoding.value
            stats.decode_work[fe] = (
                stats.decode_work.get(fe, 0) + L * self._fused_width(reader, rg, pred)
            )
            stats.kernel_launches += 1
            fmask, _ = ops.fused_scan(self._put(fcol.buffers["packed"]), fcol.k, lo, hi)
            mask = fmask.reshape(-1)[:L]
            for name in proj:
                cols[name] = self._serve_column(enc[name], name, askip, L, stats)
        else:
            for name in need:
                cols[name] = self._serve_column(enc[name], name, askip, L, stats)
            mask = self._eval_mask(pred, cols, blooms, L)

        mask = mask & (torch.arange(L, device=self.device) < n)  # row validity
        for name in need:
            cols.setdefault(name, None)  # predicate-only column under fusion
        return cols, mask

    def _serve_column(self, col: EncodedColumn, name: str, askip: frozenset, L: int,
                      stats: ScanStats, precomputed: Optional[torch.Tensor] = None):
        """One needed column of a row group: an aggregate page the fused
        aggregate kernel unpacks itself (booked, returned undecoded), or a
        decoded column."""
        if name in askip:
            self._charge_agg_page(stats, col, L)
            return col
        return self._decode_column(col, L, stats, precomputed)

    # ------------------------------------------------------------------
    # batched multi-row-group scan (bucketed kernel launches)
    # ------------------------------------------------------------------
    def scan_row_groups_batched(
        self,
        reader,
        rgs,
        plan: ScanPlan,
        pred: Optional[Expr],
        blooms: Dict[str, torch.Tensor],
        stats: ScanStats,
    ):
        """Decode + filter MANY row groups with bucketed batch launches,
        bit-identical to calling `scan_row_group` per group, in order.

        Compatible pages stack along the block axis and decode in ONE
        host-to-device copy and ONE kernel launch per (encoding, k, dtype)
        bucket (`kernels.ops` `*_batch`).  Everything that is not the launch
        (fetch, checksum, stats, masks) runs through the sequential code in
        row-group order, so the accounting cannot drift.

        Returns (per_rg, fetched): `per_rg` is [(cols, mask)] in `rgs` order
        with `scan_row_group`'s contract; `fetched` lists the row groups
        that read encoded bytes from storage (all of them: no cache yet)."""
        rgs = list(rgs)
        if len(rgs) <= 1:
            # a single group has nothing to bucket: the sequential path IS
            # the batched path (and kernel_launches stays equal)
            per_rg = [self.scan_row_group(reader, rg, plan, pred, blooms, stats)
                      for rg in rgs]
            return per_rg, rgs
        need = plan.all_columns()
        proj = plan.materialized_columns()

        # phase A: fetch, checksum, fusability, in row-group order (the
        # front half is _prepare_row_group, the sequential path's own code)
        slots = []
        for rg in rgs:
            n, L, enc, fuse = self._prepare_row_group(reader, rg, plan, pred, stats)
            askip = self._agg_skip(plan, pred, enc)
            # fused-aggregate pages (`askip`) never enter a decode bucket:
            # the aggregate kernel unpacks them in registers
            decode = [c for c in (proj if fuse is not None else need) if c not in askip]
            slots.append({"rg": rg, "n": n, "L": L, "enc": enc, "fuse": fuse,
                          "askip": askip, "decode": decode})

        # phase B: bucket compatible pages, one copy and one launch per bucket
        decoded, fmasks = self._launch_buckets(slots, pred, stats)
        # bloom semijoin probes ride the batched pass: one launch per filter
        bloom_by_rg = self._batch_bloom_probe(slots, pred, blooms, decoded)

        # finalize, in row-group order: stats and masks
        per_rg = []
        for slot in slots:
            rg, n, L, enc, askip = slot["rg"], slot["n"], slot["L"], slot["enc"], slot["askip"]
            cols: Dict[str, object] = {}
            if slot["fuse"] is not None:
                stats.fused = True
                fe = enc[pred.column].encoding.value
                stats.decode_work[fe] = (
                    stats.decode_work.get(fe, 0) + L * self._fused_width(reader, rg, pred))
                for name in proj:
                    cols[name] = self._serve_column(enc[name], name, askip, L, stats,
                                                    decoded.get((rg, name)))
                mask = fmasks[rg]
            else:
                for name in need:
                    cols[name] = self._serve_column(enc[name], name, askip, L, stats,
                                                    decoded.get((rg, name)))
                mask = self._eval_mask(pred, cols, blooms, L, bmasks=bloom_by_rg.get(rg))
            mask = mask & (torch.arange(L, device=self.device) < n)
            for name in need:
                cols.setdefault(name, None)
            per_rg.append((cols, mask))
        return per_rg, rgs

    def _batch_bloom_probe(self, slots, pred, blooms, decoded) -> Dict[int, Dict]:
        """Stack every slice page's keys and probe each bloom filter in ONE
        `ops.bloom_probe` dispatch.  Returns {rg: {(name, column): (L,)
        mask}} for `_eval` to consume."""
        if pred is None or not blooms:
            return {}
        probes = {(p.name, p.column): p for p in _expr_blooms(pred) if p.name in blooms}
        out: Dict[int, Dict] = {}
        for (name, column), probe in sorted(probes.items()):
            entries = []  # (rg, L, nblk)
            keys = []
            for slot in slots:
                arr = decoded.get((slot["rg"], column))
                if slot["fuse"] is not None or arr is None:
                    continue
                L = slot["L"]
                entries.append((slot["rg"], L, L // RLE_OUT_BLOCK))
                keys.append(arr.to(torch.int32).reshape(-1, RLE_OUT_BLOCK))
            if not entries:
                continue
            m = ops.bloom_probe(torch.cat(keys), blooms[name], probe.n_hashes)
            s = 0
            for rg, L, nblk in entries:
                out.setdefault(rg, {})[(name, column)] = m[s:s + nblk].reshape(-1)[:L]
                s += nblk
        return out

    def _launch_buckets(self, slots, pred, stats):
        """Group every pending (row group, column) page by its launch
        signature and decode each bucket in ONE copy and ONE dispatch.
        Returns ({(rg, name): decoded (L,) tensor}, {rg: fused mask})."""
        buckets: Dict[tuple, List[dict]] = {}
        fused_items: Dict[int, List[dict]] = {}
        for slot in slots:
            rg, L = slot["rg"], slot["L"]
            if slot["fuse"] is not None:
                col = slot["enc"][pred.column]
                lo, hi = slot["fuse"]
                fused_items.setdefault(col.k, []).append(
                    {"rg": rg, "L": L, "packed": col.buffers["packed"], "lo": lo, "hi": hi})
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
                buckets.setdefault(bkey, []).append({"rg": rg, "name": name, "col": col, "L": L})

        decoded: Dict[tuple, torch.Tensor] = {}
        for bkey, items in buckets.items():
            decoded.update(self._decode_bucket(bkey, items, stats))
        fmasks: Dict[int, torch.Tensor] = {}
        for k, items in sorted(fused_items.items()):
            blocks = [it["packed"].shape[0] for it in items]
            lohi = np.stack([
                np.concatenate([np.full(b, it[key], np.int32) for b, it in zip(blocks, items)])
                for key in ("lo", "hi")])
            packed, lohi = self._put_stacked(
                np.concatenate([it["packed"] for it in items], axis=0), lohi)
            mask = ops.fused_scan_batch(packed, k, lohi[0], lohi[1])
            stats.kernel_launches += 1
            s = 0
            for b, it in zip(blocks, items):
                fmasks[it["rg"]] = mask[s:s + b].reshape(-1)[: it["L"]]
                s += b
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
            res[(it["rg"], it["name"])] = flat[:L]
            s += b
        return res

    def _decode_bucket(self, bkey, items, stats) -> Dict[tuple, torch.Tensor]:
        """One bucket: its pages concatenated on the host, ONE counted
        host-to-device copy, ONE launch, split back per page."""
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
                res[(it["rg"], it["name"])] = out[s:s + it["L"]]
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

    def scan_group_batched(self, items):
        """Cross-request bucket stacking over a shared decode pool."""
        raise _later("scan_group_batched (cross-request stacking over a shared pool)",
                     SERVICE)

    def scan(
        self,
        reader,
        plan: ScanPlan,
        blooms: Optional[Dict[str, torch.Tensor]] = None,
        pool: Optional[Dict] = None,
        batched: bool = False,
    ) -> ScanResult:
        """Full pushed-down scan, as a ResumableScan driven to completion in
        one shot.  `blooms` maps each BloomProbe's name to its (n_bits,)
        uint8 filter on the engine's device.  `batched=True` routes the
        row-group work through `scan_row_groups_batched` (one launch per
        bucket) instead of one launch per (row group, column).  A shared
        decode `pool` belongs to a later slice."""
        if pool is not None:
            raise _later("shared decode pools", SERVICE)
        rs = ResumableScan(self, reader, plan, blooms=blooms)
        if rs.result is None:
            if batched:
                rs.advance_batched(tuple(rs.pending))
            else:
                rs.advance(tuple(rs.pending))
        return rs.result

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
    `advance_batched` does the same through the bucketed batch path; once
    the last one lands, `result` holds the assembled ScanResult, the same
    as a one-shot `DatapathEngine.scan`.  `result` is set right after
    construction when every row group was pruned."""

    def __init__(self, engine: DatapathEngine, reader, plan: ScanPlan,
                 blooms: Optional[Dict[str, torch.Tensor]] = None):
        self.engine = engine
        self.reader = reader
        self.plan = plan
        self.blooms = blooms or {}
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

        self.pred = bind_expr(plan.predicate, reader)
        rgs = prune_row_groups(reader, self.pred)
        self.stats.row_groups_scanned = len(rgs)
        self._rgs = rgs
        self._pending = list(rgs)
        self._need = plan.all_columns()
        self._per_rg_cols: Dict[str, List[Optional[torch.Tensor]]] = {c: [] for c in self._need}
        self._per_rg_mask: List[torch.Tensor] = []
        if not self._pending:  # everything pruned: assemble the empty result
            self._finish()

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

    def advance(self, row_groups) -> Optional[ScanResult]:
        """Scan the given row groups (must be the next groups in order) one
        at a time and fold them into the accumulated partial result.
        Returns the final ScanResult once the last group is folded in, else
        None."""
        assert self.result is None, "scan already complete"
        for rg in row_groups:
            self._take([rg])
            cols, mask = self.engine.scan_row_group(
                self.reader, rg, self.plan, self.pred, self.blooms, self.stats)
            self._fold([rg], [(cols, mask)])
        if not self._pending:
            self._finish()
        return self.result

    def advance_batched(self, row_groups):
        """`advance`, through the engine's bucketed batch path: the slice's
        pages are bucketed by (encoding, k, dtype) and decoded in one launch
        per bucket, with a bit-identical fold.  Returns (result-or-None,
        fetched): the row groups that read encoded bytes."""
        rgs = self._take(row_groups)
        per_rg, fetched = self.engine.scan_row_groups_batched(
            self.reader, rgs, self.plan, self.pred, self.blooms, self.stats)
        self._fold(rgs, per_rg)
        if not self._pending:
            self._finish()
        return self.result, fetched

    def ingest_batched(self, row_groups, per_rg):
        """Fold in a slice that `scan_group_batched` scanned for this scan."""
        raise _later("ingest_batched (cross-request stacking over a shared pool)", SERVICE)

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
        aggregate launch per value source per call (and one per k for the
        fused pages).  `advance` passes single row groups, the batched path
        whole slices; splitting the stacked planes back per row group before
        folding keeps the canonical per-row-group fold, so both cadences
        give bit-identical partials."""
        dev = self.engine.device
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
            # grouped launch; never-decoded BITPACK pages (`_agg_skip`) into
            # one unpack-in-kernel launch per k.  Blocks reduce independently,
            # so stacking changes no per-block accumulator row.
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
                # one launch per MAX_GROUPS-wide window of the group domain,
                # ids shifted into it (rows of other windows count as out of
                # range).  A group's cells depend on its own rows only, so the
                # windows side by side are the whole domain's planes, bit for bit.
                windows = []
                for base in range(0, self._n_groups, ops.MAX_GROUPS):
                    windows.append(ops.grouped_agg_batch(
                        vals, gids - base if base else gids, m2,
                        min(ops.MAX_GROUPS, self._n_groups - base)))
                    self.stats.kernel_launches += 1
                planes = tuple(torch.cat(p, dim=1).cpu().numpy()  # 5 small copies back
                               for p in zip(*windows))
                s = 0
                for i in dec:
                    planes_by_i[i] = tuple(p[s:s + metas[i][0]] for p in planes)
                    is_float[i] = vals.dtype.is_floating_point
                    s += metas[i][0]
                    # each launch processes the decoded values once more:
                    # booked as 'agg' work, as the reference does
                    self.stats.decode_work["agg"] = (
                        self.stats.decode_work.get("agg", 0)
                        + len(windows) * metas[i][0] * PACK_BLOCK * 4)
            for k, idxs in sorted(fused.items()):
                (packed,) = self.engine._put_stacked(np.concatenate(
                    [per_rg[i][0][src].buffers["packed"] for i in idxs], axis=0))
                m2 = torch.cat([metas[i][2] for i in idxs])
                planes = ops.fused_agg_batch(packed, k, m2)
                self.stats.kernel_launches += 1
                planes = tuple(p.cpu().numpy() for p in planes)
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
        if not self._rgs:  # everything pruned — nothing scanned
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
            out_cols, mask, count = self.engine._compact(out_cols, mask)
        # result-DMA size: the projected columns + survivor mask handed to
        # the consumer (predicate-only columns were dropped above)
        self.stats.result_bytes = sum(_nbytes(a) for a in out_cols.values()) + _nbytes(mask)
        self.stats.rows_out = int(count)
        self.result = ScanResult(out_cols, mask, count, self.stats)

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
