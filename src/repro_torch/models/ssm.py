"""Mamba2 (SSD — state-space duality) in chunked-parallel PyTorch form.

Port of `repro/models/ssm.py`.  Train/prefill use the chunkwise-parallel
SSD decomposition (arXiv:2405.21060): within a chunk of Q tokens the
quadratic masked-decay form runs as batched products; states are carried
across chunks by a Python loop over the chunks, where the reference runs
`lax.scan`.  Decode is the O(1) recurrent update.  All state math in
float32; input and output in the model's dtype, as in the reference.

One departure, which gives the reference's values wherever they are
finite: the intra-chunk decay exp(clog_i - clog_j) is taken only on the
causal triangle (j <= i) and is 0 above it.  The reference takes the exp of
the whole square and multiplies the upper triangle by 0; there clog_i -
clog_j is the positive sum of |A dt| over (i, j], whose exp overflows to inf
once it passes ~88 within a chunk (a head with A = -16 and dt = 0.1 does so
after 56 steps of a 256-step chunk), and inf * 0 is NaN.

Under a mesh the reference constrains `in_proj`'s output on `inner` and
lets GSPMD carry the rest.  Here the mixer (the cut into z, x, B, C and dt,
the conv, the scan and the gated norm) is the body of a `shard_map` over
each rank's batch rows: its input is gathered whole on its last dim first
(`sharding.gather_dim`; the cut's offsets straddle the `inner` shards), the
replicated leaves read through `sharding.local_grad`.  Under the `tp`
strategy, where the model axis has more than one rank and divides the
heads, model rank r then takes its own block of heads out of the gathered
projection (`_Share`): its channels of z and x, its heads of dt, and B and
C whole, the leaves sliced alike.  It runs the conv on its x channels plus
B and C, the scan and the state update on its heads alone, and the gated
norm over the whole d_inner with its sum of squares all-reduced over the
model axis; `y @ out_proj`'s local rows (stored ("inner", "d")) are its
partial sum, reduced by the output's constraint as the reference's is.  The
SSM state is placed by its rows and its heads on the model axis; the conv
state, a shift of the whole [conv state, conv input], by its rows alone.
Elsewhere (`fsdp`, whose rows already spread over the model axis; a model
axis of one rank; heads that the model axis does not divide, as hymba's 25
at 16) every model rank of a row runs every head, and both states are placed
by their rows.  A decode step runs the body on the rows of the caches'
shards that the engine placed, and under `tp` cuts `in_proj`'s columns over
the model axis before its product where the parameter's spec leaves them
whole (`_inner_cols`), so that each model rank runs its own columns.

Layer params:
  in_proj (D, 2*di + 2*N + H)   -> [z, x, B, C, dt]
  conv_w (W, di + 2*N), conv_b  -> causal depthwise conv on (x, B, C)
  A_log (H,), D_skip (H,), dt_bias (H,)
  norm_y (di,)                  -> gated RMSNorm before out_proj
  out_proj (di, D)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.collectives import all_reduce_sum, copy_to
from repro_torch.distributed.sharding import (
    ShardingCtx,
    as_dtensor,
    constrain,
    constrain_rows,
    from_local,
    gather_dim,
    local_grad,
    to_spec,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, log(1 + e^x) = logaddexp(x, 0), with no linear
    branch (`F.softplus` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di, N, N, H], dim=-1)


def _history(x: torch.Tensor, state: Optional[torch.Tensor], W: int) -> torch.Tensor:
    """[state, x] along the sequence: the conv's input with its W-1 steps of
    history (zeros without a state)."""
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return torch.cat([state, x], dim=1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x (B,S,C), w (W,C) depthwise causal; state (B,W-1,C) carries history.
    Returns (y, new_state); y accumulates in x's dtype, tap by tap."""
    W = w.shape[0]
    xp = _history(x, state, W)
    y = torch.zeros_like(x)
    S = x.shape[1]
    for i in range(W):  # static tiny loop (W=4)
        y = y + xp[:, i:i + S, :] * w[i][None, None, :]
    return y + b[None, None, :], xp[:, xp.shape[1] - (W - 1):, :]


def ssd_scan(
    xh: torch.Tensor,  # (B,S,H,P) conv'd inputs, head-split
    Bc: torch.Tensor,  # (B,S,N)
    Cc: torch.Tensor,  # (B,S,N)
    dt: torch.Tensor,  # (B,S,H) post-softplus
    A: torch.Tensor,  # (H,) negative
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B,S,H,P) float32, final_state (B,H,P,N) float32)."""
    B_, S, H, Pd = xh.shape
    N = Bc.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q

    dtf = dt.float()
    xf = xh.float() * dtf[..., None]
    la = A.float()[None, None, :] * dtf  # log decay (B,S,H)

    def chunked(t):  # (B,S,...) -> (nc,B,Q,...)
        return t.reshape(B_, nc, Q, *t.shape[2:]).transpose(0, 1)

    xc = chunked(xf)  # (nc,B,Q,H,P)
    bc = chunked(Bc.float())  # (nc,B,Q,N)
    cc = chunked(Cc.float())
    lac = chunked(la)  # (nc,B,Q,H)

    state = (init_state.float() if init_state is not None
             else torch.zeros((B_, H, Pd, N), dtype=torch.float32, device=xh.device))
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    ys = []
    for c in range(nc):
        xq, bq, cq, laq = xc[c], bc[c], cc[c], lac[c]  # (B,Q,...)
        clog = torch.cumsum(laq, dim=1)  # (B,Q,H) inclusive
        # intra-chunk: M[b,i,j,h] = (C_i . B_j) * exp(clog_i - clog_j), j <= i
        cb = torch.einsum("bin,bjn->bij", cq, bq)  # (B,Q,Q)
        seg = clog[:, :, None, :] - clog[:, None, :, :]  # (B,i,j,H)
        dec = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
        m = cb[:, :, :, None] * dec
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xq)
        # inter-chunk from the carried state
        y_inter = torch.einsum("bin,bhpn,bih->bihp", cq, state, torch.exp(clog))
        # new state
        tail = torch.exp(clog[:, -1:, :] - clog)  # decay from j to chunk end
        s_new = torch.einsum("bjn,bjhp,bjh->bhpn", bq, xq, tail)
        state = state * torch.exp(clog[:, -1, :])[:, :, None, None] + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys).transpose(0, 1).reshape(B_, S, H, Pd)
    return y, state


_LEAVES = ("conv_w", "conv_b", "A_log", "D_skip", "dt_bias", "norm_y")  # replicated


@dataclasses.dataclass(frozen=True)
class _Share:
    """A model rank's own block of the SSM heads: block `r` of `n` along
    the model axis (mesh dim `m`, whose ranks form `group`).  Head block r
    is channel block r of d_inner (`di`), so one cut serves both."""

    r: int
    n: int
    m: int
    group: Any
    di: int

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """Block r of t's last dim (its heads, or its channels)."""
        w = t.shape[-1] // self.n
        return t[..., self.r * w:(self.r + 1) * w]

    def conv(self, t: torch.Tensor) -> torch.Tensor:
        """The conv's channels [x, B, C] cut to the rank's x channels, B and
        C whole."""
        return torch.cat([self.own(t[..., :self.di]), t[..., self.di:]], dim=-1)

    def leaves(self, p: dict) -> dict:
        return {k: self.conv(v) if k.startswith("conv") else self.own(v) for k, v in p.items()}


def _share(cfg: ModelConfig, ctx: ShardingCtx) -> Optional[_Share]:
    """This rank's block of heads under the `tp` strategy, where the model
    axis has more than one rank and divides the heads; else None, the
    whole-heads arm."""
    n = ctx.tp
    if ctx.strategy != "tp" or n == 1 or cfg.ssm_heads % n:
        return None
    mesh = ctx.mesh
    return _Share(r=mesh.get_local_rank(ctx.tp_axis), n=n,
                  m=list(mesh.mesh_dim_names).index(ctx.tp_axis),
                  group=mesh.get_group(ctx.tp_axis), di=cfg.d_inner)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor, eps: float,
                share: Optional[_Share] = None) -> torch.Tensor:
    """rmsnorm(y * silu(z)) over d_inner.  With a share, y and z are the
    rank's channels: the mean takes every rank's float32 sum of squares,
    all-reduced over the model axis (a replicated sum that each rank uses
    for its own channels: `copy_to` adds the ranks' gradients of it)."""
    if share is None:
        return rmsnorm(y * F.silu(z), w, eps)
    dt = y.dtype
    xf = (y * F.silu(z)).float()
    ss = copy_to(all_reduce_sum(torch.sum(xf * xf, dim=-1, keepdim=True), share.group),
                 share.group)
    return (xf * torch.rsqrt(ss / share.di + eps) * w.float()).to(dt)


def _mixer(proj, p, cfg: ModelConfig, dtype, conv_state=None, ssm_state=None,
           share: Optional[_Share] = None):
    """The SSD mixer on plain tensors: proj (B,S,2di+2N+H) cut into z, x, B,
    C and dt, the causal conv, the chunked scan and the gated norm.  Returns
    (y (B,S,di) in `dtype`, conv state, float32 SSM state).  With a share,
    `p`'s leaves are the rank's (`_Share.leaves`) and `ssm_state` its heads:
    y and the SSM state are the rank's channels and heads, the conv state
    whole."""
    B, S = proj.shape[:2]
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    if share is None:
        conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv_state)
    else:  # the conv on the rank's x channels, B and C; its history whole
        xp = _history(conv_in, conv_state, cfg.conv_width)
        new_conv = xp[:, xp.shape[1] - (cfg.conv_width - 1):]
        conv_out, _ = _causal_conv(share.conv(conv_in), p["conv_w"], p["conv_b"],
                                   None if conv_state is None else share.conv(conv_state))
        z, dt = share.own(z), share.own(dt)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [conv_out.shape[-1] - 2 * N, N, N], dim=-1)
    dtp = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, S, -1, Pd)
    # ragged tail: pad to a chunk multiple with dt=0 steps (decay=exp(0)=1,
    # update=dt*x=0 -> exactly zero-effect on state and outputs)
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        dtp = F.pad(dtp, (0, 0, 0, pad))
    y, state = ssd_scan(xh, Bc, Cc, dtp, A, Q, ssm_state)
    if pad:
        y = y[:, :S]
        xh = xh[:, :S]
    y = y + xh.float() * p["D_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, -1).to(dtype)
    return _gated_norm(y, z, p["norm_y"], cfg.norm_eps, share), new_conv, state.float()


def _decode_mixer(proj, p, cfg: ModelConfig, dtype, conv_state, ssm_state,
                  share: Optional[_Share] = None):
    """One recurrent step of the mixer on plain tensors: proj (B,1,...),
    conv_state (B,W-1,di+2N), ssm_state (B,H,P,N) float32.  Returns (y
    (B,1,di) in `dtype`, conv state, SSM state), the states new tensors;
    with a share as `_mixer`'s."""
    B = proj.shape[0]
    N, Pd = cfg.ssm_state, cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)  # (B,1,C)
    xp = torch.cat([conv_state, conv_in], dim=1)  # (B,W,C)
    new_conv = xp[:, 1:, :]
    if share is not None:  # the rank's x channels, B and C; its heads
        xp, z, dt = share.conv(xp), share.own(z), share.own(dt)
    y = torch.einsum("bwc,wc->bc", xp.float(), p["conv_w"].float())
    y = F.silu(y + p["conv_b"].float())[:, None, :].to(dtype)
    xin, Bc, Cc = torch.split(y, [y.shape[-1] - 2 * N, N, N], dim=-1)
    dtp = _softplus(dt.float() + p["dt_bias"].float())  # (B,1,H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(A[None, :] * dtp[:, 0])  # (B,H)
    xh = xin.reshape(B, -1, Pd).float() * dtp[:, 0, :, None]
    upd = torch.einsum("bn,bhp->bhpn", Bc[:, 0].float(), xh)
    state = ssm_state * a[:, :, None, None] + upd
    yh = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), state)
    yh = yh + xin.reshape(B, -1, Pd).float() * p["D_skip"].float()[None, :, None]
    yf = yh.reshape(B, 1, -1).to(dtype)
    return _gated_norm(yf, z, p["norm_y"], cfg.norm_eps, share), new_conv, state


def _rows(proj: torch.Tensor, like_rows: Optional[torch.Tensor] = None) -> DTensor:
    """proj's batch rows as the mixer's body reads them: its last dim whole
    on every rank (the split's pieces straddle the `inner` shards), its
    batch sharded as `like_rows`' (a state placed by its rows, as the engine
    places a cache's slots) or as it is.  The rows are placed first, the
    columns kept where they lie, so that a partial sum over the weight's `d`
    shards is reduced onto the rows before the columns are gathered."""
    if like_rows is not None:
        mesh, last = proj.device_mesh, proj.ndim - 1
        place = [q if isinstance(q, Shard) and q.dim == 0
                 else c if isinstance(c, Shard) and c.dim == last else Replicate()
                 for q, c in zip(as_dtensor(like_rows, mesh).placements, proj.placements)]
        if list(proj.placements) != place:
            proj = proj.redistribute(mesh, place)
    return gather_dim(proj, -1)


def _placements(rows: Sequence, share: Optional[_Share], dim: int) -> tuple:
    """`rows` (the body's rows' placements), and with a share of the heads
    tensor dim `dim` (heads, or channels) sharded over the model axis too:
    the layout of the body's y (dim 2) and of the SSM state (dim 1), a
    prefill's and a decode step's alike."""
    place = list(rows)
    if share is not None:
        place[share.m] = Shard(dim)
    return tuple(place)


def _placed(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """t's local tensor in `place` (a state that another layout placed, as
    a cache restored elsewhere, is redistributed first)."""
    t = as_dtensor(t, mesh)
    if tuple(t.placements) != tuple(place):
        t = t.redistribute(mesh, place)
    return t.to_local()


def _on_rows(mixer, proj, p: dict, cfg: ModelConfig, ctx: ShardingCtx, dtype,
             conv_state, ssm_state):
    """`mixer` as the body of a `shard_map` over proj's rows (placed as
    `conv_state`'s where there is one): the rows and the replicated leaves
    read for the rank's own share, their gradients `Partial` on the mesh
    dims that shard the rows (`sharding.local_grad`) and, with a share of
    the heads, on the model axis.  Returns (y, conv state, SSM state) as
    DTensors."""
    mesh = ctx.mesh
    rows = _rows(proj, conv_state)
    share = _share(cfg, ctx)
    also = () if share is None else (share.m,)
    leaves = {k: local_grad(to_spec(p[k], (None,) * p[k].ndim, mesh), rows, also)
              for k in _LEAVES}
    if share is not None:
        leaves = share.leaves(leaves)
    y_place, s_place = (_placements(rows.placements, share, d) for d in (2, 1))
    y, new_conv, state = mixer(
        local_grad(rows, rows, also), leaves, cfg, dtype,
        None if conv_state is None else _placed(conv_state, mesh, rows.placements),
        None if ssm_state is None else _placed(ssm_state, mesh, s_place), share=share)
    B = proj.shape[0]
    return (from_local(y, mesh, y_place, (B, y.shape[1], cfg.d_inner)),
            from_local(new_conv, mesh, rows.placements, (B, *new_conv.shape[1:])),
            from_local(state, mesh, s_place, (B, cfg.ssm_heads, *state.shape[2:])))


def ssm_forward(
    h: torch.Tensor,  # (B,S,D) pre-normed input
    p: dict,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    conv_state: Optional[torch.Tensor] = None,
    ssm_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Full-sequence SSM branch (train / prefill).  Under a mesh the mixer
    is the body of a `shard_map` over each rank's batch rows, on the rank's
    own heads where the model axis divides them (module docstring)."""
    proj = constrain(h @ p["in_proj"], ("batch", None, "inner"), ctx)
    if not ctx.enabled:
        y, new_conv, state = _mixer(proj, p, cfg, h.dtype, conv_state, ssm_state)
    else:
        y, new_conv, state = _on_rows(_mixer, proj, p, cfg, ctx, h.dtype, conv_state, ssm_state)
    # with a share of the heads, y's channels times out_proj's local rows:
    # a partial sum over the model axis, reduced here, and its gradient too,
    # so that out_proj's backward products run on the rank's channels
    out = constrain_rows(y @ p["out_proj"], ctx)
    if return_state:
        return out, (new_conv, state)
    return out


def _inner_cols(w: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """`in_proj` with its columns over the model axis under `tp`, as the
    reference's `inner` places the product: a local slice where the
    parameter's spec leaves them replicated there (it drops `inner` where
    the model axis does not divide it, as hymba's 6,457 at 16).  Left so, a
    decode step's product is placed by DTensor's cost model alone, which
    for a large weight moves the step's few rows onto the weight's `d`
    shards rather than gather the weight: every model rank then runs every
    column of the whole batch.  (A prefill's rows outweigh the weight, and
    DTensor gathers it and cuts the columns itself.)"""
    if not isinstance(w, DTensor) or ctx.strategy != "tp":
        return w
    mesh = w.device_mesh
    m = list(mesh.mesh_dim_names).index(ctx.tp_axis)
    if mesh.size(m) == 1 or not isinstance(w.placements[m], Replicate):
        return w
    place = list(w.placements)
    place[m] = Shard(w.ndim - 1)
    return w.redistribute(mesh, place)


def ssm_decode_step(
    h: torch.Tensor,  # (B,1,D)
    p: dict,
    cfg: ModelConfig,
    ctx: ShardingCtx,
    conv_state: torch.Tensor,  # (B,W-1,di+2N)
    ssm_state: torch.Tensor,  # (B,H,P,N) float32
):
    """O(1) recurrent step.  Returns (out (B,1,D), (conv_state, ssm_state)),
    both states new tensors.  Under a mesh each rank steps its own slots:
    the rows that its shards of the caches hold (and, where the model axis
    divides the heads, its own heads of them)."""
    proj = h @ _inner_cols(p["in_proj"], ctx)
    if not ctx.enabled:
        y, new_conv, state = _decode_mixer(proj, p, cfg, h.dtype, conv_state, ssm_state)
    else:  # the engine places both states by their slots
        y, new_conv, state = _on_rows(_decode_mixer, proj, p, cfg, ctx, h.dtype, conv_state,
                                      ssm_state)
    # whole on its rows, as ssm_forward's output and attn_decode's are
    out = constrain_rows(y @ p["out_proj"], ctx)
    return out, (new_conv, state)
