"""Mixture-of-Experts FFN on one device.

Port of the single-device path of `repro/models/moe.py`: `_capacity`,
`_routed_local` and `moe_ffn` with its Switch-style load-balance loss and
the shared experts.  The routed experts:

  1. sort the (token, expert, gate) triples by expert id (one stable
     argsort, as `jnp.argsort` is stable: which tokens exceed an expert's
     capacity depends on that order),
  2. for each expert e, take a capacity-C segment of the sorted order
     starting at e's first entry, the start clamped to len - C as
     `lax.dynamic_slice_in_dim` clamps it (near the end of the order the
     segment then begins before e's entries, and `valid` masks those),
     gather its tokens, run the expert GLU, and add the gated outputs back.

Entries past an expert's C are dropped (standard).  The segment starts and
indices are computed on the device for all experts at once, so the loop
over experts never waits for the card.  The expert-parallel paths
(`_routed_2d` and the `shard_map` branches) come with ROADMAP.md item A.6:
`moe_ffn` under a mesh raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import DISTRIBUTED, ShardingCtx, constrain
from repro_torch.models.config import ModelConfig, not_ported
from repro_torch.models.layers import glu_mlp


def _capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    c = int(factor * n_tokens * k / n_experts)
    return max(8, -(-c // 8) * 8)


def _routed_local(x, ids, gates, wg, wu, wo, *, k: int, n_experts: int, capacity: float,
                  act: str):
    """Routed-expert compute.  x (B,S,D); ids/gates (B,S,k); wg/wu (E,D,F),
    wo (E,F,D)."""
    B, S, D = x.shape
    N = B * S
    E = wg.shape[0]
    dev = x.device
    xf = x.reshape(N, D)
    flat_ids = ids.reshape(-1)  # (N*k,)
    flat_gates = gates.reshape(-1)
    tok = torch.arange(N * k, dtype=torch.int64, device=dev) // k
    order = torch.argsort(flat_ids, stable=True)
    s_ids = flat_ids[order]
    s_tok = tok[order]
    s_gate = flat_gates[order]
    C = min(_capacity(N, k, n_experts, capacity), N * k)
    experts = torch.arange(E, dtype=s_ids.dtype, device=dev)
    starts = torch.searchsorted(s_ids, experts).clamp(max=N * k - C)  # (E,)
    seg = starts[:, None] + torch.arange(C, device=dev)  # (E, C)
    seg_ids, seg_tok, seg_gate = s_ids[seg], s_tok[seg], s_gate[seg]
    valid = seg_ids == experts[:, None]  # (E, C)
    out = torch.zeros((N, D), dtype=torch.float32, device=dev)
    for e in range(E):
        v = valid[e].to(x.dtype)
        xs = xf[seg_tok[e]] * v[:, None]
        hg = xs @ wg[e]
        hu = xs @ wu[e]
        a = F.silu(hg) if act == "swiglu" else F.gelu(hg, approximate="tanh")
        ys = (a * hu) @ wo[e]
        w = (seg_gate[e] * valid[e].float())[:, None]
        # one index_add_ per expert, in expert order: within one expert only
        # distinct tokens carry a nonzero weight (the rest add +0.0), so the
        # card's atomic adds leave every sum in the reference's order
        out.index_add_(0, seg_tok[e], ys.float() * w)
    return out.reshape(B, S, D).to(x.dtype)


def route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """(probs (B,S,E) float32, gates (B,S,k) float32 renormalized, ids
    (B,S,k) int32): the top k of the router softmax, ties to the lower
    expert id as `lax.top_k` breaks them (a stable descending sort)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    gates, ids = vals[..., :k], idx[..., :k].to(torch.int32)
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    return probs, gates, ids


def moe_ffn(x: torch.Tensor, params: dict, cfg: ModelConfig,
            ctx: ShardingCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (out (B,S,D), aux_loss float32 scalar).

    params: router (D,E), e_wg/e_wu (E,D,F), e_wo (E,F,D),
            optional shared_wg/shared_wu (D, n_shared*F), shared_wo.
    """
    if ctx.enabled:
        raise not_ported("the expert-parallel moe_ffn (under a mesh)", DISTRIBUTED)
    E = cfg.moe_experts
    probs, gates, ids = route(x, params["router"], cfg)

    # Switch-style load-balance loss
    one_hot = F.one_hot(ids[..., 0].long(), E).float()
    f = torch.mean(one_hot, dim=(0, 1))
    p = torch.mean(probs, dim=(0, 1))
    aux = E * torch.sum(f * p) * cfg.moe_aux_weight

    routed = _routed_local(x, ids, gates, params["e_wg"], params["e_wu"], params["e_wo"],
                           k=cfg.moe_top_k, n_experts=E, capacity=cfg.moe_capacity,
                           act=cfg.act)
    if cfg.moe_shared:
        routed = routed + glu_mlp(x, params["shared_wg"], params["shared_wu"],
                                  params["shared_wo"], cfg.act, ctx)
    return constrain(routed, ("batch", None, None), ctx), aux
