"""ServeEngine — batched serving with slot-based continuous batching.

Port of `repro/serve/engine.py` with its semantics, without `jit`:

  - incoming requests queue up; free slots are filled by running prefill
    on the new prompt and splicing its KV into the batch cache at the slot
    index,
  - every engine tick = one decode_step for ALL active slots, at ONE shared
    position, the largest of the active slots' (`step`), as the reference
    does,
  - finished slots (EOS / max_new_tokens / a full cache) free immediately.

The engine runs on the card unless the caller passes `device="cpu"`; it
raises `RuntimeError` when asked for a card there is none of, or when the
parameters lie on another device.  Caches are updated in place.  Each
prefill gets the reference's stub inputs: a VLM's `embeds` (which prefill
does not read) and an enc-dec model's `enc_embeds`, zeros in bfloat16, so
whisper is served from 1,500 frames of zeros, as in the reference.  Every
family serves under a mesh; a prompt's batch of one stays whole on every
rank.

Under a mesh (`ctx`) the engine serves on DTensor parameters (plain ones
are placed by `sharding.shard_params`) and keeps its batched caches as
DTensors, the slots sharded over the data axis (the SSM's conv and state
as the attention caches): a prefill's cache is
written into its slot on the ranks that hold that slot
(`sharding.write_at`), and the argmax over vocab-sharded logits takes each
shard's first maximum, then the first shard holding the largest, which is
the reference's first index over the padded vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import (
    ShardingCtx,
    constrain,
    from_local,
    local_ctx,
    local_range,
    placements_for,
    shard_params,
    spec_for,
    write_at,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # prompt token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, n_slots: int = 4,
                 max_len: int = 512, ctx: Optional[ShardingCtx] = None,
                 greedy: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine(device='cuda'): no CUDA card is available")
        for leaf in _leaves(params):
            if leaf.device.type != self.device.type or (
                    self.device.index is not None and leaf.device != self.device):
                raise RuntimeError(f"parameters lie on {leaf.device}, the engine on {self.device}")
        self.cfg = cfg
        self.ctx = ctx or local_ctx()
        self.params = shard_params(params, cfg, self.ctx)
        self.n_slots = n_slots
        self.max_len = max_len
        self.greedy = greedy  # argmax either way, as in the reference
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.caches = None
        self.last_tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        self.steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            prompt = torch.from_numpy(np.asarray(req.tokens, np.int32)[None, :])
            batch = {"tokens": prompt.to(self.device)}
            # the reference's stub inputs, zeros: no image and no sound; under a
            # mesh DTensors whose one row stays whole on every rank
            if self.cfg.family == "vlm":
                batch["embeds"] = self._stub(self.cfg.vision_tokens)
            if self.cfg.is_encdec:
                batch["enc_embeds"] = self._stub(self.cfg.encoder_seq)
            logits, cache1 = prefill(self.params, batch, self.cfg, self.ctx,
                                     cache_len=self.max_len)
            tok = int(argmax(logits)[0])
            req.out.append(tok)
            if self.caches is None:
                # first admission defines the batched cache: leaves are
                # (L, B=1, ...) stacked per segment -> batch axis is 1
                self.caches = [{k: _batched_zeros(c, self.n_slots, self.ctx)
                                for k, c in seg.items()} for seg in cache1]
            _splice_slot(self.caches, cache1, slot)
            self.slot_pos[slot] = prompt.shape[1]
            self.slots[slot] = req
            self.last_tokens[slot, 0] = tok

    def _stub(self, n: int) -> torch.Tensor:
        zeros = torch.zeros((1, n, self.cfg.d_model), dtype=torch.bfloat16, device=self.device)
        return constrain(zeros, ("batch", None, None), self.ctx)

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick.  Returns number of active slots stepped."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        pos = int(self.slot_pos[active].max())  # conservative shared pos
        logits, self.caches = decode_step(self.params, self.last_tokens, self.caches, pos,
                                          self.cfg, self.ctx)
        toks = argmax(logits).to(torch.int32).cpu().numpy()
        for slot in active:
            req = self.slots[slot]
            tok = int(toks[slot])
            req.out.append(tok)
            self.slot_pos[slot] += 1
            self.last_tokens[slot, 0] = tok
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.out) >= req.max_new_tokens or \
                    self.slot_pos[slot] >= self.max_len - 1:
                req.done = True
                self.slots[slot] = None
        self.steps += 1
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        ticks = 0
        while (self.queue or any(s is not None for s in self.slots)) and ticks < max_ticks:
            before = [s for s in self.slots]
            self.step()
            ticks += 1
            for r in before:
                if r is not None and r.done:
                    done.append(r)
        return done


def argmax(logits: torch.Tensor) -> torch.Tensor:
    """(B,) first index of each row's largest logit, on every rank.  Over
    vocab-sharded logits: each shard's first maximum, then the first shard
    (the lowest ids) that holds the largest."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)
    mesh = logits.device_mesh
    place = [p if isinstance(p, Shard) and p.dim == 1 else Replicate() for p in logits.placements]
    logits = logits.redistribute(mesh, place)  # every row on every rank, vocab still sharded
    local = logits.to_local()
    ix = torch.argmax(local, dim=-1, keepdim=True)
    best = torch.gather(local, -1, ix)
    ix = ix + local_range(logits, 1)[0]
    n = local_range(logits, 1)[1]
    shards = logits.shape[1] // n

    def gathered(t):  # (B, 1) per shard -> (B, shards) in vocab order
        return from_local(t, mesh, place, (t.shape[0], shards)).full_tensor()

    best, ix = gathered(best), gathered(ix)
    return torch.gather(ix, -1, torch.argmax(best, dim=-1, keepdim=True))[:, 0]


def _batched_zeros(c: torch.Tensor, n_slots: int, ctx: ShardingCtx) -> torch.Tensor:
    """Zeros for `n_slots` of a (L, B=1, ...) cache leaf, in its dtype; under
    a mesh in its layout, the slots sharded as the decode step's batch."""
    if not isinstance(c, DTensor):
        return torch.zeros_like(c).repeat_interleave(n_slots, dim=1)
    mesh = c.device_mesh
    shape = (c.shape[0], n_slots, *c.shape[2:])
    place = list(c.placements)
    batch = placements_for(spec_for((None, "batch"), ctx, shape[:2], activation=True), mesh)
    if all(isinstance(b, Replicate) or isinstance(p, Replicate) for b, p in zip(batch, place)):
        place = [b if isinstance(b, Shard) else p for b, p in zip(batch, place)]
    # every dim but the slots as c's own shard holds it (flash-decode's
    # uneven slots among them)
    local = list(c.to_local().shape)
    local[1] = n_slots
    for m, p in enumerate(place):
        if isinstance(p, Shard) and p.dim == 1:
            local[1] //= mesh.size(m)
    return from_local(torch.zeros(local, dtype=c.dtype, device=c.to_local().device), mesh, place,
                      shape)


def _splice_slot(batched, single, slot: int):
    """Write a prefill cache (B=1) into slot `slot` of the batched cache, in
    place; leaves are (L, B, ...) stacked per segment."""
    for bseg, sseg in zip(batched, single):
        for k, b in bseg.items():
            write_at(b, 1, slot, sseg[k])
    return batched
