"""Model API: parameter shapes, dims and init, the datapath token unpack,
the training entry point (`forward_train`, `loss_fn`) and the serving entry
points (`prefill`, `decode_step`).

Port of `repro/models/model.py` for every family (dense, moe, ssm, hybrid,
audio enc-dec, vlm).  Parameters are plain dictionaries with the reference's
keys, each layer leaf stacked on a leading layer axis: {"embed", "final_ln",
["lm_head"], ["enc_final_ln"], ["vis_proj"], "segments": [{leaf: (L, ...)}]}.
`init_params` draws them on the card (or the CPU) from a seed with the
reference's distributions but torch's generator, so its numbers are not the
reference's; `params_from_reference` carries the reference's own arrays
across, each leaf in its own dtype (the SSM's `A_log` and `dt_bias` are
float32 in a bfloat16 model), which is how the tests compare the two
packages leaf for leaf.

Batches and prompts may arrive bit-packed (`{"packed": (B, nb, k, 128)}`
words at k = ceil(log2 vocab) bits): `forward_train` and `prefill` unpack
them with the `bitunpack` kernel (`kernels.ops.bitunpack`) as their first
op, the datapath offload as stage 0 of the step.  The backward is autograd
over the same plain operations (the reference has no custom gradient); the
MoE layers' Switch losses join the loss as in the reference.

The enc-dec family (whisper) runs its encoder segment over
`batch["enc_embeds"]` (B, Se, D), the stub frontend's frames, at positions
0..Se-1, and its `decx` layers attend to the normed encoder output; the
encoder segment's cache is `{}`.  The VLM family (llava) prepends
`batch["embeds"] @ vis_proj` to the token stream in `forward_train` only:
`prefill`, like the reference's, never reads `embeds`.

Under a mesh (`ctx` with a DeviceMesh) `prefill`, `decode_step` and
`forward_train` run every family on DTensor parameters
(`sharding.shard_params`): the inputs (tokens, an enc-dec model's frames, a
VLM's vision embeddings) become DTensors at their first constraint, and
packed tokens are unpacked by `bitunpack` on each rank's own shard of the
words, a plain tensor.  `forward_train`'s loss is then a replicated DTensor
scalar, and autograd gives each parameter's gradient as a DTensor
(`train/loop.py` places it as the parameter is stored).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import (
    ShardingCtx,
    constrain,
    from_local,
    like,
    local_ctx,
)
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import LANES, PACK_BLOCK, bits_needed
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed_lookup, lm_head_logits, rmsnorm, softmax_xent
from repro_torch.models.transformer import (
    Segment,
    build_segments,
    run_segments_decode,
    run_segments_prefill,
    run_segments_train,
)

# ---------------------------------------------------------------------------
# parameter shapes / dims / init
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig, prefix: str = "") -> Dict[str, Tuple]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = {
        prefix + "ln1": ((D,), (None,)),
        prefix + "wq": ((D, H * hd), ("d", "heads")),
        prefix + "wk": ((D, KV * hd), ("d", "heads")),
        prefix + "wv": ((D, KV * hd), ("d", "heads")),
        prefix + "wo": ((H * hd, D), ("heads", "d")),
    }
    if cfg.qk_norm:
        s[prefix + "qn"] = ((hd,), (None,))
        s[prefix + "kn"] = ((hd,), (None,))
    return s


def _mlp_shapes(cfg: ModelConfig, prefix: str = "") -> Dict[str, Tuple]:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.act == "gelu":
        return {
            prefix + "ln2": ((D,), (None,)),
            prefix + "w1": ((D, F), ("d", "ff")),
            prefix + "w2": ((F, D), ("ff", "d")),
        }
    return {
        prefix + "ln2": ((D,), (None,)),
        prefix + "wg": ((D, F), ("d", "ff")),
        prefix + "wu": ((D, F), ("d", "ff")),
        prefix + "wo2": ((F, D), ("ff", "d")),
    }


def _moe_shapes(cfg: ModelConfig, prefix: str = "") -> Dict[str, Tuple]:
    D, E, F = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    s = {
        prefix + "ln2": ((D,), (None,)),
        prefix + "router": ((D, E), ("d", None)),
        prefix + "e_wg": ((E, D, F), ("experts", None, "fsdp")),
        prefix + "e_wu": ((E, D, F), ("experts", None, "fsdp")),
        prefix + "e_wo": ((E, F, D), ("experts", "fsdp", None)),
    }
    if cfg.moe_shared:
        Fs = cfg.moe_shared * F
        s[prefix + "shared_wg"] = ((D, Fs), ("d", "ff"))
        s[prefix + "shared_wu"] = ((D, Fs), ("d", "ff"))
        s[prefix + "shared_wo"] = ((Fs, D), ("ff", "d"))
    return s


def _ssm_shapes(cfg: ModelConfig, prefix: str = "") -> Dict[str, Tuple]:
    D, di, N, H, W = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_width
    cc = di + 2 * N
    s = {
        prefix + "in_proj": ((D, 2 * di + 2 * N + H), ("d", "inner")),
        prefix + "conv_w": ((W, cc), (None, None)),
        prefix + "conv_b": ((cc,), (None,)),
        prefix + "A_log": ((H,), (None,)),
        prefix + "D_skip": ((H,), (None,)),
        prefix + "dt_bias": ((H,), (None,)),
        prefix + "norm_y": ((di,), (None,)),
        prefix + "out_proj": ((di, D), ("inner", "d")),
    }
    if prefix == "":
        s["ln1"] = ((D,), (None,))
    return s


def _layer_shapes(kind: str, cfg: ModelConfig) -> Dict[str, Tuple]:
    D = cfg.d_model
    if kind == "dense":
        return {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
    if kind == "moe":
        return {**_attn_shapes(cfg), **_moe_shapes(cfg)}
    if kind == "moe_pair":
        a = {**_attn_shapes(cfg, "a_"), **_mlp_shapes(cfg, "a_")}
        b = {**_attn_shapes(cfg, "b_"), **_moe_shapes(cfg, "b_")}
        return {**a, **b}
    if kind == "ssm":
        s = _ssm_shapes(cfg)
        if cfg.d_ff:
            s.update(_mlp_shapes(cfg))
        return s
    if kind == "hybrid":
        s = {**_attn_shapes(cfg), **_ssm_shapes(cfg, "s_"), **_mlp_shapes(cfg)}
        s.update({
            "na": ((D,), (None,)),
            "ns": ((D,), (None,)),
            "beta_a": ((D,), (None,)),
            "beta_s": ((D,), (None,)),
        })
        return s
    if kind == "enc":
        return {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
    if kind == "decx":
        return {**_attn_shapes(cfg), **_attn_shapes(cfg, "x_"), **_mlp_shapes(cfg)}
    raise ValueError(kind)


def _top_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    D, Vp = cfg.d_model, cfg.vocab_padded
    s = {
        "embed": ((Vp, D), ("vocab", "d")),
        "final_ln": ((D,), (None,)),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ((D, Vp), ("d", "vocab"))
    if cfg.is_encdec:
        s["enc_final_ln"] = ((D,), (None,))
    if cfg.family == "vlm":
        s["vis_proj"] = ((D, D), ("d", None))
    return s


def model_segments(cfg: ModelConfig) -> List[Segment]:
    """`build_segments`; an enc-dec model's encoder segment first, then a
    `decx` segment for each dense one."""
    segs = build_segments(cfg)
    if cfg.is_encdec:
        segs = [Segment("enc", cfg.encoder_layers)] + [
            Segment("decx", s.count, s.window) for s in segs if s.kind == "dense"]
    return segs


def param_shapes(cfg: ModelConfig):
    """(shapes pytree, dims pytree), as the reference's."""
    segs = model_segments(cfg)
    shapes: Dict[str, Any] = {}
    dims: Dict[str, Any] = {}
    for name, (shp, dm) in _top_shapes(cfg).items():
        shapes[name] = shp
        dims[name] = dm
    seg_shapes, seg_dims = [], []
    for seg in segs:
        ls = _layer_shapes(seg.kind, cfg)
        seg_shapes.append({k: (seg.count, *s) for k, (s, _) in ls.items()})
        seg_dims.append({k: (None, *d) for k, (_, d) in ls.items()})
    shapes["segments"] = seg_shapes
    dims["segments"] = seg_dims
    return shapes, dims


def param_dims(cfg: ModelConfig):
    return param_shapes(cfg)[1]


_NORM_KEYS = ("ln1", "ln2", "final_ln", "enc_final_ln", "norm_y", "na", "ns",
              "qn", "kn", "D_skip", "beta_a", "beta_s", "conv_b")
_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _TORCH_DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r} is not one of {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[cfg.dtype]


def _uniform(gen, shape, lo: float, hi: float, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (hi - lo) + lo


def _init_leaf(gen: torch.Generator, name: str, shape, cfg: ModelConfig, device):
    """The distributions of the reference's `_init_leaf` (`model.py:186-202`),
    keyed by the leaf's name less its `a_`/`b_`/`s_`/`x_` prefix: norm
    weights, `D_skip`, `beta_*` and `conv_b` 1 (0 for gemma's (1 + w)
    norms); `A_log` log U(1, 16) and `dt_bias` log(expm1(U(1e-3, 0.1))), both
    float32 whatever the model's dtype; every other leaf normal with std
    0.02, or 0.02 / sqrt(2 L) for the output projections, drawn in float32
    and rounded to the model's dtype."""
    base = name.split("_", 1)[-1] if name[:2] in ("a_", "b_", "s_", "x_") else name
    dt = _dtype(cfg)
    if base in _NORM_KEYS or name in _NORM_KEYS:
        if name.endswith(("ln1", "ln2", "final_ln")) and cfg.norm_plus_one:
            return torch.zeros(shape, dtype=dt, device=device)
        return torch.ones(shape, dtype=dt, device=device)
    if base == "A_log":
        return torch.log(_uniform(gen, shape, 1.0, 16.0, device))
    if base == "dt_bias":
        return torch.log(torch.expm1(_uniform(gen, shape, 1e-3, 0.1, device)))
    std = 0.02
    if base in ("wo", "wo2", "w2", "out_proj", "shared_wo"):
        std = 0.02 / math.sqrt(2 * cfg.n_layers)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dt)  # in place: an expert stack's float32 draw is 21 GB


def init_params(cfg: ModelConfig, seed: int, device="cuda"):
    """Random parameters from `seed`, drawn leaf by leaf in `param_shapes`
    order from one torch.Generator on `device` (the card unless the caller
    asks for the CPU)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes, _ = param_shapes(cfg)
    out: Dict[str, Any] = {}
    for name, shp in shapes.items():
        if name == "segments":
            out["segments"] = [{k: _init_leaf(gen, k, s, cfg, device) for k, s in seg.items()}
                               for seg in shp]
        else:
            out[name] = _init_leaf(gen, name, shp, cfg, device)
    return out


def _from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, which torch cannot read directly
        bits = np.array(a.view(np.uint16))
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(np_params, device="cuda"):
    """The reference's parameters (its pytree with every leaf as a numpy
    array, bfloat16 as ml_dtypes') as the port's, bit for bit, on `device`."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _from_numpy(x, device)
    return conv(np_params)


# ---------------------------------------------------------------------------
# datapath token decode (stage 0 of prefill)
# ---------------------------------------------------------------------------


def token_bits(cfg: ModelConfig) -> int:
    return bits_needed(cfg.vocab - 1)


def packed_token_shape(cfg: ModelConfig, B: int, S: int) -> Tuple[int, int, int, int]:
    nb = -(-S // PACK_BLOCK)
    return (B, nb, token_bits(cfg), LANES)


def unpack_tokens(packed: torch.Tensor, S: int, cfg: ModelConfig) -> torch.Tensor:
    """(B, nb, k, 128) int32 views of the packed words -> (B, S) int32 tokens,
    through `ops.bitunpack` (the kernel on the card)."""
    B, nb, k, _ = packed.shape
    flat = ops.bitunpack(packed.reshape(B * nb, k, LANES), k)
    return flat.reshape(B, nb * PACK_BLOCK)[:, :S]


def _tokens_from_batch(batch, cfg, ctx):
    if "packed" not in batch:
        return constrain(batch["tokens"], ("batch", None), ctx)
    S = batch["packed"].shape[1] * PACK_BLOCK  # shapes are block-aligned by design
    if not ctx.enabled:
        return unpack_tokens(batch["packed"], S, cfg)
    # each rank unpacks its own rows of the words: the kernel sees a plain tensor
    packed = constrain(batch["packed"], ("batch", None, None, None), ctx)
    tokens = unpack_tokens(packed.to_local(), S, cfg)
    tokens = from_local(tokens, ctx.mesh, packed.placements, (packed.shape[0], S))
    return constrain(tokens, ("batch", None), ctx)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def encode(params, enc_embeds: torch.Tensor, cfg: ModelConfig,
           ctx: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The enc-dec encoder: its segment over the frames (B, Se, D), cast to
    the embedding's dtype, at positions 0..Se-1, then `enc_final_ln`."""
    ctx = ctx or local_ctx()
    # the frames as the tokens: batch rows under a mesh before the first
    # product with a DTensor parameter
    enc_h = constrain(enc_embeds.to(params["embed"].dtype), ("batch", None, None), ctx)
    B, Se = enc_h.shape[:2]
    enc_pos = torch.arange(Se, dtype=torch.int32, device=enc_h.device).expand(B, Se)
    enc_h, _ = run_segments_train(params["segments"][:1], model_segments(cfg)[:1], enc_h, cfg,
                                  ctx, enc_pos)
    return rmsnorm(enc_h, params["enc_final_ln"], cfg.norm_eps, cfg.norm_plus_one)


def _decoder(params, batch, cfg, ctx):
    """(the decoder's segments, their parameters, the encoder output or None)."""
    segs, seg_params = model_segments(cfg), params["segments"]
    if not cfg.is_encdec:
        return segs, seg_params, None
    return segs[1:], seg_params[1:], encode(params, batch["enc_embeds"], cfg, ctx)


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  ctx: Optional[ShardingCtx] = None):
    """Returns (loss + aux, {"loss", "aux_loss", "tokens"}): the mean
    next-token cross-entropy of {"tokens": (B, S) int32} or {"packed":
    (B, nb, k, 128) int32}, labels tokens[:, 1:], with an enc-dec model's
    "enc_embeds" (B, Se, D).  A VLM batch's "embeds" (B, n_vis, D) go
    through `vis_proj` in front of the tokens, and every token is a label,
    the first predicted from the last vision position."""
    ctx = ctx or local_ctx()
    tokens = _tokens_from_batch(batch, cfg, ctx)
    B, S = tokens.shape
    h = embed_lookup(params["embed"], tokens, ctx, scale=cfg.embed_scale)
    segs, seg_params, enc_out = _decoder(params, batch, cfg, ctx)
    n_vis = 0
    if cfg.family == "vlm" and "embeds" in batch:
        embeds = constrain(batch["embeds"].to(h.dtype), ("batch", None, None), ctx)
        vis = constrain(embeds @ params["vis_proj"], ("batch", None, None), ctx)
        h = torch.cat([vis, h], dim=1)
        n_vis = vis.shape[1]
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device).expand(
        B, h.shape[1])
    h, aux = run_segments_train(seg_params, segs, h, cfg, ctx, positions, enc_kv=enc_out)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps, cfg.norm_plus_one)
    if n_vis:
        pred_h, labels = h[:, n_vis - 1:n_vis + S - 1], tokens
    else:
        pred_h, labels = h[:, :-1], tokens[:, 1:]
    logits = lm_head_logits(pred_h, _head(params, cfg), ctx)
    loss = softmax_xent(logits, labels, cfg.vocab)
    if isinstance(loss, DTensor):  # one replicated value; the Switch losses a plain one
        loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
        aux = like(aux, loss)
    tokens_seen = torch.tensor(B * S, dtype=torch.int32, device=h.device)
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": tokens_seen}


def loss_fn(params, batch, cfg, ctx=None):
    return forward_train(params, batch, cfg, ctx)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[ShardingCtx] = None, cache_len: Optional[int] = None):
    """Process a prompt, build caches.  batch: {"tokens": (B, S) int32} or
    {"packed": (B, nb, k, 128) int32}, with an enc-dec model's "enc_embeds"
    (B, Se, D); a VLM's "embeds" are not read, as in the reference.  Returns
    (last-token logits (B, Vp), caches: one dict of (L, B, ...) tensors per
    segment, {"k", "v"} of (L, B, cache_len, KV, hd) for attention; `{}` for
    the encoder segment and `ck`/`cv` of (L, B, Se, KV, hd) beside "k", "v"
    for `decx`)."""
    ctx = ctx or local_ctx()
    tokens = _tokens_from_batch(batch, cfg, ctx)
    B, S = tokens.shape
    cache_len = cache_len or S
    h = embed_lookup(params["embed"], tokens, ctx, scale=cfg.embed_scale)
    segs, seg_params, enc_out = _decoder(params, batch, cfg, ctx)
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    h, caches = run_segments_prefill(seg_params, segs, h, cfg, ctx, positions, cache_len,
                                     enc_kv=enc_out)
    if cfg.is_encdec:
        caches = [{}] + caches  # the encoder segment carries no decode cache
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps, cfg.norm_plus_one)
    logits = lm_head_logits(h[:, -1:], _head(params, cfg), ctx)[:, 0]
    return logits, caches


def decode_step(params, token: torch.Tensor, caches, pos: int, cfg: ModelConfig,
                ctx: Optional[ShardingCtx] = None):
    """One token in, one distribution out.  token (B,1) int32; pos the
    position it takes.  Writes its keys and values into `caches` in place
    and returns (logits (B, Vp), caches)."""
    ctx = ctx or local_ctx()
    segs, seg_params, dec_caches = model_segments(cfg), params["segments"], caches
    if cfg.is_encdec:  # the encoder ran at prefill: its segment is skipped
        segs, seg_params, dec_caches = segs[1:], seg_params[1:], caches[1:]
    token = constrain(token, ("batch", None), ctx)
    h = embed_lookup(params["embed"], token, ctx, scale=cfg.embed_scale)
    h, _ = run_segments_decode(seg_params, segs, h, cfg, ctx, int(pos), dec_caches)
    h = rmsnorm(h, params["final_ln"], cfg.norm_eps, cfg.norm_plus_one)
    logits = lm_head_logits(h, _head(params, cfg), ctx)[:, 0]
    return logits, caches


def build_model(cfg: ModelConfig):
    """Convenience bundle; "init" takes a seed and a device."""
    return {
        "init": lambda seed, device="cuda": init_params(cfg, seed, device),
        "train": lambda p, b, ctx=None: forward_train(p, b, cfg, ctx),
        "prefill": lambda p, b, ctx=None, cache_len=None: prefill(p, b, cfg, ctx, cache_len),
        "decode": lambda p, t, c, pos, ctx=None: decode_step(p, t, c, pos, cfg, ctx),
        "segments": model_segments(cfg),
        "config": cfg,
    }
