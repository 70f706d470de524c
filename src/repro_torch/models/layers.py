"""Shared model layers: norms, rotary, GQA attention (TP- or SP-parallel),
GLU MLPs, embeddings.

Port of `repro/models/layers.py` (its `rmsnorm`, `rotary`, `attention`,
`glu_mlp`, `embed_lookup`, `lm_head_logits` and `softmax_xent`) in plain
PyTorch, with the reference's (B, S, H, hd) layout.  Attention keeps the
reference's q-chunked form, which caps the live score tensor at
(B, H, chunk, Skv), and its rule for a length that the chunk does not
divide; the chunks run in a Python loop where the reference scans.
Training differentiates these plain operations with autograd, as the
reference differentiates its `jnp` code with `jax.value_and_grad`.

Under a mesh the tensors are DTensors and the constraints redistribute
them (distributed/sharding.py).  Attention parallelism is
divisibility-driven, as in the reference:
  - head-parallel (Megatron TP) when n_heads and n_kv divide the model axis,
  - sequence-parallel otherwise (q sharded on Sq, K/V replicated),
  - decode (Sq == 1, tp > 1) outside head-parallel shards the KV cache on
    Skv (flash-decode); where the model axis does not divide Skv (whisper's
    1,500 frames on 16 ranks), in DTensor's uneven shards, which the
    reference drops to the batch alone.
After the reference's constraints, each rank attends over its own shards
(the body of a `shard_map`): heads and batch rows are independent, a q
shard shifts its causal positions by its first row, and flash-decode
combines the shards' softmax statistics with an all-reduce of the row
maxima and of the sums over the mesh dims that shard the keys.  In training
autograd runs through the bodies: the head-parallel arm shards q, k and v
alike, and the sequence-parallel arm declares k's and v's gradients
`Partial` over the q shards (`sharding.local_grad`).  Flash-decode is
decode-only and has no backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (
    ShardingCtx,
    constrain,
    constrain_rows,
    from_local,
    like,
    local_grad,
    local_range,
    shard_groups,
)

# ---------------------------------------------------------------------------
# norms / rotary
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if plus_one else w.float()
    return (xf * scale).to(dt)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    ang = positions.float()[:, :, None] * freqs[None, None, :]  # (B,S,half)
    cos = like(torch.cos(ang)[:, :, None, :], x)
    sin = like(torch.sin(ang)[:, :, None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _chunk_for(Sq: int, chunk: int) -> int:
    """The reference's q-chunk (`layers.py:123-129`): for a length over the
    chunk that it does not divide (whisper's 1500 frames, llava's 4672
    stream), the largest divisor of Sq that fits the chunk budget, or Sq
    itself when that divisor is 64 or less."""
    if Sq > chunk and Sq % chunk:
        c = chunk
        while c > 1 and Sq % c:
            c -= 1
        chunk = c if c > 64 else Sq
    return chunk


def _attn_parallelism(n_heads: int, n_kv: int, ctx: ShardingCtx) -> str:
    tp = ctx.tp
    if tp == 1 or ctx.strategy in ("fsdp", "fsdp_ep"):
        return "none"  # ZeRO: attention fully local per batch shard
    return "head" if (n_heads % tp == 0 and n_kv % tp == 0) else "seq"


_BATCH = ("batch", None, None, None)


def attn_dims(n_heads: int, n_kv: int, Sq: int, ctx: ShardingCtx):
    """(q's, k's and v's) logical dims under the reference's three
    constrained arms; batch alone elsewhere.  A decode cache is kept in its
    step's k layout (`attn_dims(H, KV, 1, ctx)[1]`)."""
    par = _attn_parallelism(n_heads, n_kv, ctx)
    if par == "head":
        return ("batch", None, "heads", None), ("batch", None, "kv", None)
    if Sq == 1 and ctx.tp > 1:  # decode under any strategy: flash-decode
        return _BATCH, ("batch", "seq_tp", None, None)
    if par == "seq" and Sq > 1:
        return ("batch", "seq_tp", None, None), _BATCH
    return _BATCH, _BATCH


def attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,
    ctx: ShardingCtx,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    chunk: int = 1024,
    q_offset: int = 0,
    kv_valid_len: Optional[int] = None,  # decode: current cache fill
) -> torch.Tensor:
    """Grouped-query attention, q-chunked.  Returns (B, Sq, H, hd) in q's
    dtype; scores and softmax in float32, masked scores -1e30."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    kw = dict(causal=causal, window=window, scale=scale, chunk=chunk, kv_valid_len=kv_valid_len)
    if not ctx.enabled:
        return _attend(q, k, v, q_offset=q_offset, **kw)
    qd, kd = attn_dims(q.shape[2], k.shape[2], q.shape[1], ctx)
    # flash-decode's slots in uneven shards where the model axis does not
    # divide them (`transformer._cache` places the caches so)
    q, k, v = constrain(q, qd, ctx), constrain(k, kd, ctx, True), constrain(v, kd, ctx, True)
    q0, _ = local_range(q, 1)
    k0, _ = local_range(k, 1)
    # sequence-parallel: each rank's q rows read all of the replicated k and
    # v, whose local gradients are then partial sums over the q shards
    ql, kl, vl = q.to_local(), local_grad(k, q), local_grad(v, q)
    groups = shard_groups(k, 1)
    if groups:  # flash-decode: this rank's keys start at k0
        out = _attend(ql, kl, vl, q_offset=q_offset + q0, k_offset=k0, groups=groups, **kw)
    else:
        out = _attend(ql, kl, vl, q_offset=q_offset + q0, **kw)
    return from_local(out, q.device_mesh, q.placements, q.shape)


def _attend(q, k, v, *, causal, window, scale, chunk, q_offset, kv_valid_len,
            k_offset: int = 0, groups=()):
    """The attention of plain tensors; `k_offset` is the position of k's
    first key, and with `groups` the keys are one shard of those that the
    ranks of `groups` hold together: the softmax takes the row maxima and
    sums over all of them."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV

    qg = q.reshape(B, Sq, KV, rep, hd).permute(0, 2, 3, 1, 4)  # (B,KV,rep,Sq,hd)
    kg = k.permute(0, 2, 1, 3).float()  # (B,KV,Skv,hd)
    vg = v.permute(0, 2, 1, 3).float()
    k_pos = (k_offset + torch.arange(Skv, dtype=torch.int32, device=q.device))[None, :]

    def attend(qc: torch.Tensor, qc_start: int) -> torch.Tensor:
        # qc: (B,KV,rep,C,hd)
        C = qc.shape[3]
        s = torch.einsum("bkrcd,bksd->bkrcs", qc.float(), kg) * scale
        q_pos = (qc_start + torch.arange(C, dtype=torch.int32, device=q.device)
                 + q_offset)[:, None]
        m = torch.ones((C, Skv), dtype=torch.bool, device=q.device)
        if causal:
            m = m & (k_pos <= q_pos)
        if window is not None:
            m = m & (k_pos > q_pos - window)
        if kv_valid_len is not None:
            m = m & (k_pos < kv_valid_len)
        s = torch.where(m[None, None, None], s, -1e30)
        if not groups:
            p = torch.softmax(s, dim=-1)
            return torch.einsum("bkrcs,bksd->bkrcd", p, vg)
        # a rank whose uneven shard of the keys is empty (60 frames on 16
        # ranks: 15 shards of 4) takes no part in the maximum
        mx = (torch.amax(s, dim=-1, keepdim=True) if Skv else
              torch.full((*s.shape[:-1], 1), -1e30, device=s.device))
        for g in groups:
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
        p = torch.exp(s - mx)
        den = torch.sum(p, dim=-1, keepdim=True)
        num = torch.einsum("bkrcs,bksd->bkrcd", p, vg)
        for g in groups:
            dist.all_reduce(den, group=g)
            dist.all_reduce(num, group=g)
        return num / den

    chunk = _chunk_for(Sq, chunk)
    if Sq <= chunk:
        out = attend(qg, 0)
    else:
        out = torch.cat([attend(qg[:, :, :, i:i + chunk], i) for i in range(0, Sq, chunk)],
                        dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP / embeddings
# ---------------------------------------------------------------------------


def glu_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor, act: str,
            ctx: ShardingCtx) -> torch.Tensor:
    h_g = constrain(x @ wg, ("batch", None, "ff"), ctx)
    h_u = constrain(x @ wu, ("batch", None, "ff"), ctx)
    a = F.silu(h_g) if act == "swiglu" else F.gelu(h_g, approximate="tanh")
    return constrain_rows((a * h_u) @ wo, ctx)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, ctx: ShardingCtx,
                 scale: bool = False) -> torch.Tensor:
    """Rows of `embed` for `tokens`, ids clipped into [0, Vp) as the
    reference's `mode="clip"` does.  Gathered with `F.embedding`, whose
    CPU backward adds each row's gradients in a fixed order (plain
    indexing's backward accumulates from threads in any order).  A DTensor
    table is read shard by shard (`_sharded_lookup`)."""
    if isinstance(embed, DTensor):
        out = _sharded_lookup(embed, tokens)
    else:
        out = F.embedding(tokens.long().clamp(0, embed.shape[0] - 1), embed)
    if scale:  # the factor rounded to the table's dtype first, as JAX's weak float is
        out = out * torch.tensor(math.sqrt(embed.shape[1]), dtype=out.dtype, device=out.device)
    return constrain(out, ("batch", None, None), ctx)


def _sharded_lookup(embed: DTensor, tokens: torch.Tensor) -> DTensor:
    """The lookup on each rank's shard of a (Vp, D) table: every rank takes
    all the ids, reads the rows its vocab shard holds and zeros the others.
    The result is a partial sum over the mesh dims that shard the vocab
    (one shard holds each row; the others add exact zeros) and sharded on D
    as the table is."""
    idx = tokens.full_tensor() if isinstance(tokens, DTensor) else tokens
    v0, nv = local_range(embed, 0)
    i = idx.long().clamp(0, embed.shape[0] - 1) - v0
    hit = (i >= 0) & (i < nv)
    out = F.embedding(i.clamp(0, nv - 1), embed.to_local())
    out = torch.where(hit[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    place = [Partial() if isinstance(p, Shard) and p.dim == 0 else
             Shard(idx.ndim) if isinstance(p, Shard) else p for p in embed.placements]
    return from_local(out, embed.device_mesh, place, (*idx.shape, embed.shape[1]))


def lm_head_logits(h: torch.Tensor, w: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """h (B,S,D) @ w (D,Vp) -> logits (B,S,Vp)."""
    return constrain(h @ w, ("batch", None, "vocab"), ctx)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab_real: int,
                 label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE in float32; the padded vocab rows (ids >=
    vocab_real) take part in the partition at -1e30, as the reference adds
    its bias, so their gradient is the reference's exp(-1e30 - lse) = 0.
    On vocab-sharded DTensor logits the gathered gold logit is a masked
    partial sum; it is reduced before its last dim is dropped (DTensor's
    mask does not follow that reshape)."""
    Vp = logits.shape[-1]
    lf = logits.float()
    if Vp > vocab_real:
        pad = torch.arange(Vp, device=lf.device) >= vocab_real
        lf = lf + like(torch.where(pad, -1e30, 0.0), lf)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())
    if isinstance(gold, DTensor) and any(p.is_partial() for p in gold.placements):
        gold = gold.redistribute(gold.device_mesh, [Replicate() if p.is_partial() else p
                                                    for p in gold.placements])
    nll = lse - gold[..., 0]
    if label_mask is not None:
        nll = nll * label_mask
        return torch.sum(nll) / torch.clamp(torch.sum(label_mask), min=1.0)
    return torch.mean(nll)
