"""Architecture assembly: segments of stacked layers (the dense kind).

Port of `repro/models/transformer.py` for the dense family (qwen3, gemma,
mistral, granite): `Segment`, `build_segments`, the attention and MLP
sub-blocks and the dense layer's training, prefill and decode step.
Parameters stay stacked on a leading layer axis as in the reference, and a
Python loop over the layer index takes the place of `lax.scan`; each layer
reads views `w[i]` of the stacked leaves, through which autograd carries its
gradients into the stacked `(L, ...)` parameter.  With `cfg.remat` each
training layer runs under `torch.utils.checkpoint` (the reference's
`jax.checkpoint`).  Caches are per-segment
dictionaries of (L, B, Smax, KV, hd) tensors; the decode step writes its new
key and value into them in place (the reference returns updated copies),
which saves a copy of the whole cache per token.  The other layer kinds
raise `NotImplementedError` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.distributed.sharding import constrain
from repro_torch.models.config import LM_REST, ModelConfig, not_ported
from repro_torch.models.layers import attention, glu_mlp, rmsnorm, rotary


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int
    window: Optional[int] = None  # hybrid SWA segments


def build_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family != "dense" or cfg.moe_experts:
        raise not_ported(f"the {cfg.family!r} family", LM_REST)
    return [Segment("dense", cfg.n_layers)]


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------


def _proj_qkv(x, p, cfg: ModelConfig, positions, ctx):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    if positions is not None:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(h, p, cfg, ctx, positions):
    """Causal self-attention over the whole sequence; returns (h, (k, v))."""
    x = rmsnorm(h, p["ln1"], cfg.norm_eps, cfg.norm_plus_one)
    q, k, v = _proj_qkv(x, p, cfg, positions, ctx)
    o = attention(q, k, v, ctx, causal=True, scale=cfg.attn_scale, chunk=cfg.attn_block)
    B, S = h.shape[:2]
    out = o.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return h + constrain(out, ("batch", None, None), ctx), (k, v)


def attn_decode(h, p, cfg, ctx, pos: int, kcache, vcache):
    """h (B,1,D); kcache/vcache (B,Smax,KV,hd), written in place at `pos`
    (clamped into the cache as `dynamic_update_slice` clamps it)."""
    B = h.shape[0]
    x = rmsnorm(h, p["ln1"], cfg.norm_eps, cfg.norm_plus_one)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q, k, v = _proj_qkv(x, p, cfg, positions, ctx)
    Smax = kcache.shape[1]
    write_at = min(max(pos, 0), Smax - 1)
    kcache[:, write_at] = k[:, 0].to(kcache.dtype)
    vcache[:, write_at] = v[:, 0].to(vcache.dtype)
    o = attention(q, kcache, vcache, ctx, causal=False, scale=cfg.attn_scale,
                  kv_valid_len=pos + 1)
    out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return h + out, kcache, vcache


def mlp_block(h, p, cfg, ctx):
    x = rmsnorm(h, p["ln2"], cfg.norm_eps, cfg.norm_plus_one)
    if cfg.act not in ("swiglu", "geglu"):
        raise not_ported(f"the {cfg.act!r} MLP", LM_REST)
    y = glu_mlp(x, p["wg"], p["wu"], p["wo2"], cfg.act, ctx)
    return h + y


# ---------------------------------------------------------------------------
# per-kind layer application (prefill / decode)
# ---------------------------------------------------------------------------


def layer_train(kind: str, h, lp, cfg, ctx, positions, want_cache: bool = False,
                cache_len: Optional[int] = None):
    """Returns (h, aux, cache_entry); aux is 0 for a dense layer."""
    if kind != "dense":
        raise not_ported(f"the {kind!r} layer", LM_REST)
    cache: Dict[str, Any] = {}
    h, (k, v) = attn_train(h, lp, cfg, ctx, positions)
    if want_cache:
        cache = {"k": _to_cache(k, cache_len), "v": _to_cache(v, cache_len)}
    h = mlp_block(h, lp, cfg, ctx)
    return h, 0.0, cache


def _to_cache(k: torch.Tensor, cache_len: Optional[int]) -> torch.Tensor:
    """Pad with zeros, or keep the last `cache_len` positions of, a
    (B,S,KV,hd) tensor.  (Ring caches of sliding-window layers come with the
    hybrid family.)"""
    S = k.shape[1]
    if cache_len is None or S == cache_len:
        return k
    if S < cache_len:
        return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, cache_len - S))
    return k[:, S - cache_len:]


def layer_decode(kind: str, h, lp, cfg, ctx, pos: int, cache):
    """One-token step.  Returns (h, cache) with the cache updated in place."""
    if kind != "dense":
        raise not_ported(f"the {kind!r} layer", LM_REST)
    h, kc, vc = attn_decode(h, lp, cfg, ctx, pos, cache["k"], cache["v"])
    h = mlp_block(h, lp, cfg, ctx)
    return h, {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# segment execution
# ---------------------------------------------------------------------------


def _layer(sp: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's parameters: a view of each stacked leaf."""
    return {k: w[i] for k, w in sp.items()}


def _save_dots(ctx, op, *args, **kwargs):
    """`remat_policy="dots"`: keep the outputs of the non-batched matmuls
    (`aten.mm`: the projections and the MLP, the counterpart of
    `dots_with_no_batch_dims_saveable`) and recompute the rest, the
    attention's batched products included."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _train_layer(kind, h, lp, cfg, ctx, positions):
    h, aux, _ = layer_train(kind, h, lp, cfg, ctx, positions)
    return h, aux


def run_segments_train(params_segs, segs, h, cfg, ctx, positions):
    """Every layer's forward for training; returns (h, aux), aux the
    float32 sum of the layers' auxiliary losses (0 for dense layers)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for seg, sp in zip(segs, params_segs):
        for i in range(seg.count):
            args = (seg.kind, h, _layer(sp, i), cfg, ctx, positions)
            if cfg.remat:
                kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}
                h, aux = checkpoint(_train_layer, *args, use_reentrant=False, **kw)
            else:
                h, aux = _train_layer(*args)
            aux_total = aux_total + aux
    return h, aux_total


def run_segments_prefill(params_segs, segs, h, cfg, ctx, positions, cache_len):
    caches = []
    for seg, sp in zip(segs, params_segs):
        entries = []
        for i in range(seg.count):
            h, _, cache = layer_train(seg.kind, h, _layer(sp, i), cfg, ctx, positions,
                                      want_cache=True, cache_len=cache_len)
            entries.append(cache)
        caches.append({k: torch.stack([e[k] for e in entries]) for k in entries[0]})
    return h, caches


def run_segments_decode(params_segs, segs, h, cfg, ctx, pos: int, caches):
    for seg, sp, sc in zip(segs, params_segs, caches):
        for i in range(seg.count):
            h, _ = layer_decode(seg.kind, h, _layer(sp, i), cfg, ctx, pos,
                                {k: c[i] for k, c in sc.items()})
    return h, caches
