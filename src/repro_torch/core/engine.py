"""DatapathEngine — the paper's data-processing SmartNIC, on a CUDA card.

Port of `repro.core.engine`, sequential scan with the `raw` offload mode:

    footer zone maps ──► row-group pruning (metadata only, host)
         │
    encoded bytes ────► checksum check ──► decode on the card (CUDA kernels)
         │                                        │
         │                             pushed-down predicate (bloom semijoin
         │                             included), or the fused decode + range
         │                             filter on packed words
         ▼                                        ▼
    consumer ◄──── decoded columns + survivor mask + count, or, with
                   compact=True, the survivors packed to the front

The engine runs on the card unless the caller asks for the CPU
(`device="cpu"`, which routes every kernel to its plain PyTorch version).
Asking for the card without one raises; nothing falls back to the CPU.

What later slices bring raises NotImplementedError naming its ROADMAP.md
item: other offload modes, a block cache, decode pools, batched decode,
aggregate pushdown and the `host` backend.  Every ScanStats field is kept,
so scans compare field for field with the JAX engine; the fields of the
unported features stay 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.plan import (
    And,
    BloomProbe,
    Cmp,
    Expr,
    InSet,
    Or,
    ScanPlan,
    bind_expr,
    pred_int_bounds,
)
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import (
    RLE_OUT_BLOCK,
    EncodedColumn,
    Encoding,
    padded_rows,
)
from repro_torch.lakeformat.integrity import CorruptPageError, page_checksum

# ROADMAP.md section A items that the NotImplementedError messages name
BATCHED = "A.2 batched decode"
PUSHDOWN = "A.3 operator pushdown"
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

    def _decode_column(self, col: EncodedColumn, L: int, stats: ScanStats) -> torch.Tensor:
        """A fresh decode of one row-group column, booked in `stats`."""
        arr = self._decode_device(col, L)
        nb = _nbytes(arr)
        stats.kernel_launches += 1
        stats.decoded_bytes += nb
        stats.decoded_bytes_fresh += nb
        e = col.encoding.value
        stats.decode_work[e] = stats.decode_work.get(e, 0) + nb
        return arr

    # ------------------------------------------------------------------
    # predicate evaluation (on decoded device columns)
    # ------------------------------------------------------------------
    def _eval(self, e: Expr, cols: Dict[str, torch.Tensor],
              blooms: Dict[str, torch.Tensor]) -> torch.Tensor:
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
            # the keys in rows of RLE_OUT_BLOCK, as the probe kernel takes them
            keys = cols[e.column].to(torch.int32)
            L = keys.shape[0]
            pad = (-L) % RLE_OUT_BLOCK
            if pad:
                keys = torch.nn.functional.pad(keys, (0, pad))
            m = ops.bloom_probe(keys.reshape(-1, RLE_OUT_BLOCK), blooms[e.name], e.n_hashes)
            return m.reshape(-1)[:L]
        if isinstance(e, And):
            m = self._eval(e.children[0], cols, blooms)
            for c in e.children[1:]:
                m = m & self._eval(c, cols, blooms)
            return m
        if isinstance(e, Or):
            m = self._eval(e.children[0], cols, blooms)
            for c in e.children[1:]:
                m = m | self._eval(c, cols, blooms)
            return m
        raise TypeError(e)

    def _eval_mask(self, pred: Optional[Expr], cols, blooms, L: int) -> torch.Tensor:
        """Predicate mask over L rows (all true without a predicate)."""
        if pred is None:
            return torch.ones((L,), dtype=torch.bool, device=self.device)
        return self._eval(pred, cols, blooms)

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
        tensor, or None for a predicate-only column skipped under fusion;
        `mask` is (L,) bool including row validity."""
        need = plan.all_columns()
        proj = plan.materialized_columns()
        n, L, enc, fuse = self._prepare_row_group(reader, rg, plan, pred, stats)
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
                cols[name] = self._decode_column(enc[name], L, stats)
        else:
            for name in need:
                cols[name] = self._decode_column(enc[name], L, stats)
            mask = self._eval_mask(pred, cols, blooms, L)

        mask = mask & (torch.arange(L, device=self.device) < n)  # row validity
        for name in need:
            cols.setdefault(name, None)  # predicate-only column under fusion
        return cols, mask

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
        uint8 filter on the engine's device.  A shared decode `pool` and
        `batched=True` belong to later slices."""
        if batched:
            raise _later("batched=True", BATCHED)
        if pool is not None:
            raise _later("shared decode pools", SERVICE)
        rs = ResumableScan(self, reader, plan, blooms=blooms)
        if rs.result is None:
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

    `advance(next_row_groups)` scans and folds a few row groups at a time;
    once the last one lands, `result` holds the assembled ScanResult, the
    same as a one-shot `DatapathEngine.scan`.  `result` is set right after
    construction when every row group was pruned."""

    def __init__(self, engine: DatapathEngine, reader, plan: ScanPlan,
                 blooms: Optional[Dict[str, torch.Tensor]] = None):
        if plan.aggregates:
            raise _later("aggregate pushdown", PUSHDOWN)
        self.engine = engine
        self.reader = reader
        self.plan = plan
        self.blooms = blooms or {}
        self.stats = ScanStats(row_groups_total=reader.n_row_groups, rows_total=reader.n_rows)
        self.result: Optional[ScanResult] = None

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

    def advance(self, row_groups) -> Optional[ScanResult]:
        """Scan the given row groups (must be the next groups in order) and
        fold them into the accumulated partial result.  Returns the final
        ScanResult once the last group is folded in, else None."""
        assert self.result is None, "scan already complete"
        for rg in row_groups:
            if not self._pending or rg != self._pending[0]:
                raise ValueError(
                    f"row group {rg} dispatched out of order (next is "
                    f"{self._pending[0] if self._pending else None})")
            self._pending.pop(0)
            cols, mask = self.engine.scan_row_group(
                self.reader, rg, self.plan, self.pred, self.blooms, self.stats)
            self._fold([(cols, mask)])
        if not self._pending:
            self._finish()
        return self.result

    def _fold(self, per_rg) -> None:
        """Stash one advanced slice's decoded columns and masks."""
        for cols, mask in per_rg:
            for name in self._need:
                self._per_rg_cols[name].append(cols[name])
            self._per_rg_mask.append(mask)

    def _finish(self) -> None:
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
