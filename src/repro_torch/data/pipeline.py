"""TokenPipeline — the datapath-offloaded training input pipeline.

Port of `repro/data/pipeline.py`.  Three ingestion modes reproducing the
paper's configurations on the LM workload (benchmarks/pipeline_bench.py):

  'host'   traditional: the host CPU decodes + filters every row group with
           numpy, then copies int32 tokens to the device
  'engine' datapath: the DatapathEngine decodes + quality-filters row
           groups on the device (`bitunpack` for the tokens, `rle_decode`
           for the quality column, `filter_compact` under a threshold);
           host work is a memcpy of encoded bytes (decode amortized across
           epochs by the BlockCache)
  'fused'  zero-host-work: raw bit-packed blocks are sliced straight out
           of the file and handed to the training step, which decodes them
           with the `bitunpack` kernel as its first op
           (models/model.py:unpack_tokens) — quality pushdown happens at
           row-group granularity via zone maps

The pipeline runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a card it raises.  Batches are tensors on that
device: {"tokens": (B, S) int32}, or {"packed": (B, nb, k, 128) int32}, the
int32 view of the file's words.  Engine mode copies each row group's
survivors back to the host pool, as the reference does, so `stats` count
the reference's bytes.

The pipeline is deterministic and resumable: its cursor (shard, row group,
pool offset, epoch) is part of the training checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import DatapathEngine, resolve_device
from repro_torch.core.plan import Cmp, ScanPlan
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import PACK_BLOCK, decode_column_host
from repro_torch.lakeformat.reader import LakeReader

MODES = ("host", "engine", "fused")


@dataclasses.dataclass
class PipelineState:
    shard: int = 0
    row_group: int = 0
    epoch: int = 0
    pool_off: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: int(v) for k, v in d.items()})


class TokenPipeline:
    def __init__(
        self,
        paths: List[str],
        batch_size: int,
        seq_len: int,
        mode: str = "engine",
        quality_min: Optional[int] = None,
        engine: Optional[DatapathEngine] = None,
        state: Optional[PipelineState] = None,
        device="cuda",
    ):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
        self.device = resolve_device(device)
        self.paths = paths
        self.readers = [LakeReader(p) for p in paths]
        self.B, self.S = batch_size, seq_len
        self.mode = mode
        self.quality_min = quality_min
        self.engine = engine or DatapathEngine(device=self.device, offload="preloaded")
        if self.engine.device != self.device:
            raise ValueError(f"the engine runs on {self.engine.device}, the pipeline on "
                             f"{self.device}")
        self.state = state or PipelineState()
        self._pool_np: Optional[np.ndarray] = None
        self.stats = {"host_bytes_decoded": 0, "dma_bytes": 0, "rowgroups_pruned": 0,
                      "rowgroups_read": 0}
        if mode == "fused":
            self._k = self.readers[0].footer["row_groups"][0]["columns"]["token"]["k"]

    # ------------------------------------------------------------------
    def _predicate(self):
        if self.quality_min is None:
            return None
        return Cmp("quality", "ge", int(self.quality_min))

    def _advance(self):
        st = self.state
        st.row_group += 1
        if st.row_group >= self.readers[st.shard].n_row_groups:
            st.row_group = 0
            st.shard += 1
            if st.shard >= len(self.readers):
                st.shard = 0
                st.epoch += 1

    def _next_rowgroup_tokens(self) -> Optional[np.ndarray]:
        """One row group's surviving tokens (None if the row group is pruned)."""
        st = self.state
        reader = self.readers[st.shard]
        pred = self._predicate()
        keep_rgs = prune_row_groups(reader, pred)
        if st.row_group not in keep_rgs:
            self.stats["rowgroups_pruned"] += 1
            self._advance()
            return None
        self.stats["rowgroups_read"] += 1

        if self.mode == "host":
            enc = reader.read_encoded(st.row_group, ["token", "quality"])
            toks = decode_column_host(enc["token"])
            self.stats["host_bytes_decoded"] += toks.nbytes
            if pred is not None:
                q = decode_column_host(enc["quality"])
                toks = toks[q >= self.quality_min]
            self.stats["dma_bytes"] += toks.nbytes
            self._advance()
            return toks

        # engine mode: decode + filter + compact on the device
        plan = ScanPlan("corpus", ["token"], pred, compact=pred is not None)
        res = self._scan_one(reader, st.row_group, plan)
        encoded = reader.read_encoded(st.row_group, plan.all_columns())
        self.stats["dma_bytes"] += sum(c.encoded_bytes() for c in encoded.values())
        self._advance()
        n = int(res.count)
        return res.columns["token"][:n].cpu().numpy()

    def _scan_one(self, reader, rg, plan):
        """Engine scan restricted to one row group (pipeline granularity)."""
        return self.engine.scan(_SingleRG(reader, rg), plan)

    # ------------------------------------------------------------------
    def next_batch(self) -> Dict[str, torch.Tensor]:
        B, S = self.B, self.S
        if self.mode == "fused":
            return self._next_batch_fused()
        need = B * S + 1
        buf = self._pool_np if self._pool_np is not None else np.zeros(0, np.int32)
        while buf.shape[0] - self.state.pool_off < need:
            toks = self._next_rowgroup_tokens()
            if toks is None:
                continue
            buf = np.concatenate([buf[self.state.pool_off:], toks.astype(np.int32)])
            self.state.pool_off = 0
        start = self.state.pool_off
        flat = buf[start : start + need]
        self.state.pool_off = start + B * S
        self._pool_np = buf
        return {"tokens": ops.to_tensor(flat[: B * S].reshape(B, S), self.device)}

    def _next_batch_fused(self) -> Dict[str, torch.Tensor]:
        """Slice raw bit-packed blocks; decode happens inside the step.

        state.pool_off doubles as the block cursor within the current row
        group so no block is skipped between batches; DMA is charged once
        per row group, on load."""
        B, S = self.B, self.S
        nb = -(-S // PACK_BLOCK)
        blocks_needed = B * nb
        out = []
        while len(out) < blocks_needed:
            st = self.state
            reader = self.readers[st.shard]
            pred = self._predicate()
            keep = prune_row_groups(reader, pred)
            if st.row_group not in keep:
                self.stats["rowgroups_pruned"] += 1
                st.pool_off = 0
                self._advance()
                continue
            enc = reader.read_encoded(st.row_group, ["token"])["token"]
            packed = enc.buffers["packed"]  # (nblocks, k, 128) raw file bytes
            if st.pool_off == 0:
                self.stats["rowgroups_read"] += 1
                self.stats["dma_bytes"] += packed.nbytes
            while st.pool_off < packed.shape[0] and len(out) < blocks_needed:
                out.append(packed[st.pool_off])
                st.pool_off += 1
            if st.pool_off >= packed.shape[0]:
                st.pool_off = 0
                self._advance()
        arr = np.stack(out).reshape(B, nb, self._k, 128)
        return {"packed": ops.to_tensor(arr, self.device)}

    # ------------------------------------------------------------------
    def checkpoint_state(self) -> dict:
        return self.state.as_dict()

    def restore_state(self, d: dict):
        self.state = PipelineState.from_dict(d)
        self._pool_np = None


class _SingleRG:
    """Reader view exposing exactly one row group (keeps ScanPlan static)."""

    def __init__(self, reader: LakeReader, rg: int):
        self._r = reader
        self._rg = rg
        self.path = f"{reader.path}#{rg}"
        self.n_row_groups = 1
        self.n_rows = reader.row_group_meta(rg)["n"]
        self.string_dicts = reader.string_dicts

    def zonemaps(self, column):
        return [self._r.zonemaps(column)[self._rg]]

    def row_group_meta(self, rg):
        return self._r.row_group_meta(self._rg)

    def read_encoded(self, rg, columns=None):
        return self._r.read_encoded(self._rg, columns)

    def string_code(self, column, value):
        return self._r.string_code(column, value)
