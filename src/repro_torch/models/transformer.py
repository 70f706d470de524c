"""Architecture assembly: segments of stacked layers.

Port of `repro/models/transformer.py`: `Segment`, `build_segments`, the
attention, MLP and MoE sub-blocks, and the training, prefill and decode step
of the layer kinds

  dense     attn + GLU-MLP                      (qwen3/gemma/mistral/granite/llava)
  moe       attn + routed-expert FFN            (deepseek-moe tail)
  moe_pair  dense layer then MoE layer          (llama4 interleaved stack)
  ssm       Mamba2 SSD block                    (mamba2)
  hybrid    parallel attn + SSM heads, then MLP (hymba; window/global per segment)
  enc       bidirectional attn + MLP            (whisper encoder)
  decx      causal self-attn + cross-attn + MLP (whisper decoder)

Parameters stay stacked on a leading layer axis as in the reference, and a
Python loop over the layer index takes the place of `lax.scan`; each layer
reads views `w[i]` of the stacked leaves, through which autograd carries its
gradients into the stacked `(L, ...)` parameter.  With `cfg.remat` each
training layer runs under `torch.utils.checkpoint` (the reference's
`jax.checkpoint`), the encoder's output passed in as an argument so that its
gradient flows back through every cross-attention.  Caches are per-segment
dictionaries of (L, B, ...) tensors: keys and values (L, B, Smax, KV, hd),
the cross-attention's `ck`/`cv` (L, B, Se, KV, hd) over the encoder's
frames, the SSM's conv history (L, B, W-1, di+2N) and float32 state
(L, B, H, P, N).  Sliding-window segments keep ring buffers of `window`
slots (token t at slot t % window).  The decode step writes its caches in
place (the reference returns updated copies), which saves a copy of every
cache per token.  Under a mesh the parameters, activations and caches are
DTensors; a prefill's keys and values (a hybrid's ring caches, whose roll
gathers the slots first, and the cross-attention's `ck`/`cv` among them)
are kept in the decode step's layout (`layers.attn_dims`), so the step's
constraint moves nothing, and the step writes its slot into each rank's
own shard (`sharding.write_at`) and its SSM states into the shards the
engine placed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.distributed.sharding import (
    DuplicateSpecError,
    constrain,
    from_local,
    gather_dim,
    on_shards,
    write_at,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import attention, attn_dims, glu_mlp, rmsnorm, rotary
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import ssm_decode_step, ssm_forward


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int
    window: Optional[int] = None  # hybrid SWA segments


def build_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.family == "ssm":
        return [Segment("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        segs: List[Segment] = []
        prev = 0
        for g in sorted(set(cfg.global_layers)):
            if g > prev:
                segs.append(Segment("hybrid", g - prev, window=cfg.window))
            segs.append(Segment("hybrid", 1, window=None))
            prev = g + 1
        if prev < cfg.n_layers:
            segs.append(Segment("hybrid", cfg.n_layers - prev, window=cfg.window))
        return segs
    if cfg.moe_experts:
        segs = []
        if cfg.moe_first_dense:
            segs.append(Segment("dense", cfg.moe_first_dense))
        if cfg.moe_period == 2:
            segs.append(Segment("moe_pair", (cfg.n_layers - cfg.moe_first_dense) // 2))
        else:
            segs.append(Segment("moe", cfg.n_layers - cfg.moe_first_dense))
        return segs
    return [Segment("dense", cfg.n_layers)]


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------


def _split_heads(t: torch.Tensor, B: int, S: int, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor whose last dim is sharded
    over more ranks than n divides by (n_kv 2 on 4 model ranks) is gathered
    on that dim first (`sharding.gather_dim`)."""
    return gather_dim(t, -1, pieces=n).reshape(B, S, n, hd)


def _proj_qkv(x, p, cfg: ModelConfig, positions, ctx, prefix=""):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = _split_heads(x @ p[prefix + "wq"], B, S, H, hd)
    k = _split_heads(x @ p[prefix + "wk"], B, S, KV, hd)
    v = _split_heads(x @ p[prefix + "wv"], B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p[prefix + "qn"], cfg.norm_eps)
        k = rmsnorm(k, p[prefix + "kn"], cfg.norm_eps)
    if positions is not None:
        q = rotary(q, positions, cfg.rope_theta)
        k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(h, p, cfg, ctx, positions, *, causal=True, window=None, prefix="",
               src=None):
    """Self-attention over the whole sequence, or cross-attention when `src`
    (B,Se,D) is given: keys and values from `src`, without rotary.  Returns
    (h, (k, v))."""
    x = rmsnorm(h, p[prefix + "ln1"], cfg.norm_eps, cfg.norm_plus_one)
    if src is None:
        q, k, v = _proj_qkv(x, p, cfg, positions, ctx, prefix)
    else:
        B, S = x.shape[:2]
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
        q = _split_heads(x @ p[prefix + "wq"], B, S, H, hd)
        k = _split_heads(src @ p[prefix + "wk"], B, src.shape[1], KV, hd)
        v = _split_heads(src @ p[prefix + "wv"], B, src.shape[1], KV, hd)
    o = attention(q, k, v, ctx, causal=causal, window=window, scale=cfg.attn_scale,
                  chunk=cfg.attn_block)
    out = _out_proj(o, p[prefix + "wo"])
    return h + constrain(out, ("batch", None, None), ctx), (k, v)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """A whole sequence's attention output o (B,S,H,hd) through `wo`.  The
    sequence-parallel arm returns o sharded on its sequence as well as its
    batch, and the card's torch 2.11 cannot flatten the two for the
    product: the sequence is made whole first, as the residual stream
    holds it."""
    o = gather_dim(o, 1)
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ wo


def _cached_attention(q, k, v, kcache, vcache, cfg, ctx, pos: int, ring: bool):
    """Write one step's k, v (B,1,KV,hd) into the caches in place and attend
    over them: at `pos % Smax` with min(pos + 1, Smax) valid slots for a
    ring, else at `pos` (clamped into the cache as `dynamic_update_slice`
    clamps it) with pos + 1."""
    Smax = kcache.shape[1]
    at = pos % Smax if ring else min(max(pos, 0), Smax - 1)
    write_at(kcache, 1, at, k)
    write_at(vcache, 1, at, v)
    valid = min(pos + 1, Smax) if ring else pos + 1
    return attention(q, kcache, vcache, ctx, causal=False, scale=cfg.attn_scale,
                     kv_valid_len=valid)


def attn_decode(h, p, cfg, ctx, pos: int, kcache, vcache, *, prefix=""):
    """h (B,1,D); kcache/vcache (B,Smax,KV,hd), written in place."""
    B = h.shape[0]
    x = rmsnorm(h, p[prefix + "ln1"], cfg.norm_eps, cfg.norm_plus_one)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q, k, v = _proj_qkv(x, p, cfg, positions, ctx, prefix)
    o = _cached_attention(q, k, v, kcache, vcache, cfg, ctx, pos, ring=False)
    out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p[prefix + "wo"]
    # made whole on its rows here, as attn_train's output is: a partial sum
    # over the model axis left in the residual stream would take the next
    # products' weights (the MLP's, the next q, k and v, the head) whole
    return h + constrain(out, ("batch", None, None), ctx), kcache, vcache


def mlp_block(h, p, cfg, ctx, prefix=""):
    x = rmsnorm(h, p[prefix + "ln2"], cfg.norm_eps, cfg.norm_plus_one)
    if cfg.act == "gelu":  # non-gated (whisper)
        y = F.gelu(x @ p[prefix + "w1"], approximate="tanh") @ p[prefix + "w2"]
        y = constrain(y, ("batch", None, None), ctx)
    else:
        y = glu_mlp(x, p[prefix + "wg"], p[prefix + "wu"], p[prefix + "wo2"], cfg.act, ctx)
    return h + y


def moe_block(h, p, cfg, ctx):
    x = rmsnorm(h, p["ln2"], cfg.norm_eps, cfg.norm_plus_one)
    y, aux = moe_ffn(x, p, cfg, ctx)
    return h + y, aux


def _hybrid_mix(h, attn_out, y, lp, cfg, ctx):
    """h plus the mean of the normed attention and SSM outputs; under a mesh
    the attention's output (a partial sum over the head shards after `wo`)
    is first made whole on its batch rows, as the SSM's is."""
    attn_out = constrain(attn_out, ("batch", None, None), ctx)
    mix = 0.5 * (rmsnorm(attn_out, lp["na"], cfg.norm_eps) * lp["beta_a"]
                 + rmsnorm(y, lp["ns"], cfg.norm_eps) * lp["beta_s"])
    return h + constrain(mix.to(h.dtype), ("batch", None, None), ctx)


# ---------------------------------------------------------------------------
# per-kind layer application (train / prefill / decode)
# ---------------------------------------------------------------------------


def layer_train(kind: str, h, lp, cfg, ctx, positions, window=None, enc_kv=None,
                want_cache: bool = False, cache_len: Optional[int] = None):
    """Returns (h, aux, cache_entry); aux is 0 but for MoE layers."""
    aux = 0.0
    cache: Dict[str, Any] = {}
    if kind in ("dense", "moe"):
        h, (k, v) = attn_train(h, lp, cfg, ctx, positions)
        if want_cache:
            cache = {"k": _cache(k, cfg, ctx, cache_len), "v": _cache(v, cfg, ctx, cache_len)}
        if kind == "dense":
            h = mlp_block(h, lp, cfg, ctx)
        else:
            h, aux = moe_block(h, lp, cfg, ctx)
    elif kind == "moe_pair":
        h, (k1, v1) = attn_train(h, lp, cfg, ctx, positions, prefix="a_")
        h = mlp_block(h, lp, cfg, ctx, prefix="a_")
        h, (k2, v2) = attn_train(h, lp, cfg, ctx, positions, prefix="b_")
        h, aux = moe_block(h, _sub(lp, "b_"), cfg, ctx)
        if want_cache:
            cache = {"k": _cache(k1, cfg, ctx, cache_len), "v": _cache(v1, cfg, ctx, cache_len),
                     "k2": _cache(k2, cfg, ctx, cache_len), "v2": _cache(v2, cfg, ctx, cache_len)}
    elif kind == "ssm":
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        if want_cache:
            y, (cs, ss) = ssm_forward(x, lp, cfg, ctx, return_state=True)
            cache = {"conv": cs, "state": ss}
        else:
            y = ssm_forward(x, lp, cfg, ctx)
        h = h + y
        h = mlp_block(h, lp, cfg, ctx) if cfg.d_ff else h
    elif kind == "hybrid":
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = _proj_qkv(x, lp, cfg, positions, ctx)
        o = attention(q, k, v, ctx, causal=True, window=window, scale=cfg.attn_scale,
                      chunk=cfg.attn_block)
        attn_out = _out_proj(o, lp["wo"])
        if want_cache:
            y, (cs, ss) = ssm_forward(x, _sub(lp, "s_"), cfg, ctx, return_state=True)
            clen = window if window is not None else cache_len
            ring = window is not None
            cache = {"k": _cache(k, cfg, ctx, clen, ring), "v": _cache(v, cfg, ctx, clen, ring),
                     "conv": cs, "state": ss}
        else:
            y = ssm_forward(x, _sub(lp, "s_"), cfg, ctx)
        h = _hybrid_mix(h, attn_out, y, lp, cfg, ctx)
        h = mlp_block(h, lp, cfg, ctx)
    elif kind == "enc":
        h, _ = attn_train(h, lp, cfg, ctx, positions, causal=False)
        h = mlp_block(h, lp, cfg, ctx)
    elif kind == "decx":
        h, (k, v) = attn_train(h, lp, cfg, ctx, positions)
        if want_cache:
            cache = {"k": _cache(k, cfg, ctx, cache_len), "v": _cache(v, cfg, ctx, cache_len)}
        h, (ck, cv) = attn_train(h, lp, cfg, ctx, None, causal=False, prefix="x_",
                                 src=enc_kv)
        if want_cache:
            cache["ck"], cache["cv"] = _cache(ck, cfg, ctx, None), _cache(cv, cfg, ctx, None)
        h = mlp_block(h, lp, cfg, ctx)
    else:
        raise ValueError(kind)
    return h, aux, cache


def _cache(k: torch.Tensor, cfg, ctx, cache_len: Optional[int], ring: bool = False):
    """A prefill's keys or values as a decode cache: `_to_cache`, in the
    decode step's layout under a mesh (ring caches and the cross-attention's
    `ck`/`cv` included)."""
    k = _to_cache(k, cache_len, ring)
    try:
        return constrain(k, attn_dims(cfg.n_heads, cfg.n_kv, 1, ctx)[1], ctx)
    except DuplicateSpecError:
        # fsdp's step layout names `model` twice (the widened batch and the
        # flash-decode slots): the step raises, as the reference's does, but
        # the prefill serves, as the reference's does
        return constrain(k, ("batch", None, None, None), ctx)


def _to_cache(k: torch.Tensor, cache_len: Optional[int], ring: bool = False) -> torch.Tensor:
    """Pad with zeros, or keep the last `cache_len` positions of, a
    (B,S,KV,hd) tensor.  Ring caches place token t at slot t % W, so a
    trimmed window is rolled into ring phase before handoff to decode."""
    S = k.shape[1]
    if cache_len is None or S == cache_len and not (ring and S > cache_len):
        return k
    if S < cache_len:
        # on each rank's shard, the slots whole (the card's torch 2.11 fails
        # to place a DTensor `pad` of a cache sharded on its heads)
        k = gather_dim(k, 1)
        padded = F.pad(k.to_local() if isinstance(k, DTensor) else k,
                       (0, 0, 0, 0, 0, cache_len - S))
        if not isinstance(k, DTensor):
            return padded
        return from_local(padded, k.device_mesh, k.placements,
                          (k.shape[0], cache_len, *k.shape[2:]))
    trimmed = k[:, S - cache_len:]
    if ring:  # a DTensor's slots are gathered first, then each rank rolls its shard
        trimmed = on_shards(lambda t: torch.roll(t, S % cache_len, dims=1),
                            gather_dim(trimmed, 1))
    return trimmed


def _sub(lp: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in lp.items() if k.startswith(prefix)}


def layer_decode(kind: str, h, lp, cfg, ctx, pos: int, cache, window=None):
    """One-token step.  Returns (h, cache) with the cache updated in place."""
    if kind in ("dense", "moe"):
        h, kc, vc = attn_decode(h, lp, cfg, ctx, pos, cache["k"], cache["v"])
        if kind == "dense":
            h = mlp_block(h, lp, cfg, ctx)
        else:
            h, _ = moe_block(h, lp, cfg, ctx)
        return h, {"k": kc, "v": vc}
    if kind == "moe_pair":
        h, kc1, vc1 = attn_decode(h, lp, cfg, ctx, pos, cache["k"], cache["v"], prefix="a_")
        h = mlp_block(h, lp, cfg, ctx, prefix="a_")
        h, kc2, vc2 = attn_decode(h, lp, cfg, ctx, pos, cache["k2"], cache["v2"], prefix="b_")
        h, _ = moe_block(h, _sub(lp, "b_"), cfg, ctx)
        return h, {"k": kc1, "v": vc1, "k2": kc2, "v2": vc2}
    if kind == "ssm":
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        y, states = ssm_decode_step(x, lp, cfg, ctx, cache["conv"], cache["state"])
        _store(cache, states)
        h = h + y
        h = mlp_block(h, lp, cfg, ctx) if cfg.d_ff else h
        return h, cache
    if kind == "hybrid":
        x = rmsnorm(h, lp["ln1"], cfg.norm_eps)
        B = h.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
        q, k, v = _proj_qkv(x, lp, cfg, positions, ctx)
        o = _cached_attention(q, k, v, cache["k"], cache["v"], cfg, ctx, pos,
                              ring=window is not None)
        attn_out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ lp["wo"]
        y, states = ssm_decode_step(x, _sub(lp, "s_"), cfg, ctx, cache["conv"], cache["state"])
        _store(cache, states)
        h = _hybrid_mix(h, attn_out, y, lp, cfg, ctx)
        h = mlp_block(h, lp, cfg, ctx)
        return h, cache
    if kind == "decx":
        h, _, _ = attn_decode(h, lp, cfg, ctx, pos, cache["k"], cache["v"])
        # the reference's cross-attention norm here takes no (1 + w), unlike
        # attn_train's; whisper's plain norms make the two the same
        x = rmsnorm(h, lp["x_ln1"], cfg.norm_eps)
        B = h.shape[0]
        q = _split_heads(x @ lp["x_wq"], B, 1, cfg.n_heads, cfg.head_dim)
        o = attention(q, cache["ck"], cache["cv"], ctx, causal=False, scale=cfg.attn_scale)
        h = h + constrain(o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ lp["x_wo"],
                          ("batch", None, None), ctx)
        h = mlp_block(h, lp, cfg, ctx)
        return h, cache
    raise ValueError(kind)


def _store(cache, states):
    """Copy a decode step's new (conv, state) into the cache's own tensors;
    under a mesh each rank into its own shards of those the engine placed
    (the step's states come in their placements, or are placed so first)."""
    for name, new in zip(("conv", "state"), states):
        if isinstance(cache[name], DTensor):
            place = tuple(cache[name].placements)
            if tuple(new.placements) != place:
                new = new.redistribute(new.device_mesh, place)
            cache[name].to_local().copy_(new.to_local())
        else:
            cache[name].copy_(new)


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


def _train_layer(kind, h, lp, cfg, ctx, positions, window, enc_kv):
    h, aux, _ = layer_train(kind, h, lp, cfg, ctx, positions, window=window, enc_kv=enc_kv)
    return h, aux


def run_segments_train(params_segs, segs, h, cfg, ctx, positions, enc_kv=None):
    """Every layer's forward for training; returns (h, aux), aux the
    float32 sum of the layers' auxiliary losses (the MoE layers' Switch
    losses; 0 for the other kinds).  `enc_kv` (B,Se,D) is the encoder's
    output that the `decx` layers attend to."""
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for seg, sp in zip(segs, params_segs):
        for i in range(seg.count):
            args = (seg.kind, h, _layer(sp, i), cfg, ctx, positions, seg.window, enc_kv)
            if cfg.remat:
                kw = {"context_fn": _dots_contexts} if cfg.remat_policy == "dots" else {}
                h, aux = checkpoint(_train_layer, *args, use_reentrant=False, **kw)
            else:
                h, aux = _train_layer(*args)
            aux_total = aux_total + aux
    return h, aux_total


def run_segments_prefill(params_segs, segs, h, cfg, ctx, positions, cache_len, enc_kv=None):
    caches = []
    for seg, sp in zip(segs, params_segs):
        entries = []
        for i in range(seg.count):
            h, _, cache = layer_train(seg.kind, h, _layer(sp, i), cfg, ctx, positions,
                                      window=seg.window, enc_kv=enc_kv, want_cache=True,
                                      cache_len=cache_len)
            entries.append(cache)
        caches.append({k: torch.stack([e[k] for e in entries]) for k in entries[0]})
    return h, caches


def run_segments_decode(params_segs, segs, h, cfg, ctx, pos: int, caches):
    for seg, sp, sc in zip(segs, params_segs, caches):
        for i in range(seg.count):
            h, _ = layer_decode(seg.kind, h, _layer(sp, i), cfg, ctx, pos,
                                {k: c[i] for k, c in sc.items()}, window=seg.window)
    return h, caches
