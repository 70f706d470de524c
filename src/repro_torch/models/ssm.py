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
the conv, the scan and the gated norm) is the body of a `shard_map`: its
input is gathered whole on its last dim, since the cut's offsets straddle
the `inner` shards, and each rank runs the body on its own batch rows with
every head, the replicated leaves read through `sharding.local_grad`.  A
decode step runs it on the rows of the caches' shards that the engine
placed.

Layer params:
  in_proj (D, 2*di + 2*N + H)   -> [z, x, B, C, dt]
  conv_w (W, di + 2*N), conv_b  -> causal depthwise conv on (x, B, C)
  A_log (H,), D_skip (H,), dt_bias (H,)
  norm_y (di,)                  -> gated RMSNorm before out_proj
  out_proj (di, D)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import (
    ShardingCtx,
    as_dtensor,
    constrain,
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


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """x (B,S,C), w (W,C) depthwise causal; state (B,W-1,C) carries history.
    Returns (y, new_state); y accumulates in x's dtype, tap by tap."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros_like(x)
    S = x.shape[1]
    for i in range(W):  # static tiny loop (W=4)
        y = y + xp[:, i:i + S, :] * w[i][None, None, :]
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return y + b[None, None, :], new_state


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


def _mixer(proj, p, cfg: ModelConfig, dtype, conv_state=None, ssm_state=None):
    """The SSD mixer on plain tensors: proj (B,S,2di+2N+H) cut into z, x, B,
    C and dt, the causal conv, the chunked scan and the gated norm.  Returns
    (y (B,S,di) in `dtype`, conv state, float32 SSM state)."""
    B, S = proj.shape[:2]
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"], conv_state)
    conv_out = F.silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)
    dtp = _softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(B, S, H, Pd)
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
    y = y.reshape(B, S, di).to(dtype)
    y = rmsnorm(y * F.silu(z), p["norm_y"], cfg.norm_eps)
    return y, new_conv, state.float()


def _decode_mixer(proj, p, cfg: ModelConfig, dtype, conv_state, ssm_state):
    """One recurrent step of the mixer on plain tensors: proj (B,1,...),
    conv_state (B,W-1,di+2N), ssm_state (B,H,P,N) float32.  Returns (y
    (B,1,di) in `dtype`, conv state, SSM state), the states new tensors."""
    B = proj.shape[0]
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = cfg.ssm_head_dim
    z, xin, Bc, Cc, dt = _split_proj(cfg, proj)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)  # (B,1,C)
    xp = torch.cat([conv_state, conv_in], dim=1)  # (B,W,C)
    y = torch.einsum("bwc,wc->bc", xp.float(), p["conv_w"].float())
    y = F.silu(y + p["conv_b"].float())[:, None, :].to(dtype)
    new_conv = xp[:, 1:, :]
    xin, Bc, Cc = torch.split(y, [di, N, N], dim=-1)
    dtp = _softplus(dt.float() + p["dt_bias"].float())  # (B,1,H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(A[None, :] * dtp[:, 0])  # (B,H)
    xh = xin.reshape(B, H, Pd).float() * dtp[:, 0, :, None]
    upd = torch.einsum("bn,bhp->bhpn", Bc[:, 0].float(), xh)
    state = ssm_state * a[:, :, None, None] + upd
    yh = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), state)
    yh = yh + xin.reshape(B, H, Pd).float() * p["D_skip"].float()[None, :, None]
    yf = yh.reshape(B, 1, di).to(dtype)
    yf = rmsnorm(yf * F.silu(z), p["norm_y"], cfg.norm_eps)
    return yf, new_conv, state


def _rows(proj: torch.Tensor, like_rows: Optional[torch.Tensor] = None) -> DTensor:
    """proj's batch rows as the mixer's body reads them: its last dim whole
    on every rank (the split's pieces straddle the `inner` shards), its
    batch sharded as `like_rows`' (a state placed by its rows, as the engine
    places a cache's slots) or as it is."""
    proj = gather_dim(proj, -1)
    if like_rows is None:
        return proj
    mesh = proj.device_mesh
    place = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
             for q in as_dtensor(like_rows, mesh).placements]
    return proj if list(proj.placements) == place else proj.redistribute(mesh, place)


def _placed_as_rows(state: torch.Tensor, rows: DTensor) -> DTensor:
    """A state placed as `rows` are: its batch rows sharded alike, every
    other dim whole (a cache sharded on another dim too, as the dry run's
    specs place one, is gathered there first)."""
    state = as_dtensor(state, rows.device_mesh)
    place = tuple(rows.placements)
    return state if tuple(state.placements) == place else state.redistribute(
        rows.device_mesh, place)


def _body_leaves(p: dict, rows: DTensor) -> dict:
    """The replicated leaves as a body over `rows`' local shards reads them,
    their gradients `Partial` on the mesh dims that shard the rows
    (`sharding.local_grad`)."""
    mesh = rows.device_mesh
    return {k: local_grad(to_spec(p[k], (None,) * p[k].ndim, mesh), rows) for k in _LEAVES}


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
    is the body of a `shard_map`: each rank runs it on its own batch rows,
    with every head (the model ranks of a row repeat it)."""
    proj = constrain(h @ p["in_proj"], ("batch", None, "inner"), ctx)
    if not ctx.enabled:
        y, new_conv, state = _mixer(proj, p, cfg, h.dtype, conv_state, ssm_state)
    else:
        rows = _rows(proj, conv_state)
        states = [None if t is None else as_dtensor(t, ctx.mesh).to_local()
                  for t in (conv_state, ssm_state)]
        y, new_conv, state = _mixer(rows.to_local(), _body_leaves(p, rows), cfg, h.dtype,
                                    *states)
        y, new_conv, state = (from_local(t, ctx.mesh, rows.placements, (proj.shape[0],
                                                                       *t.shape[1:]))
                              for t in (y, new_conv, state))
    out = constrain(y @ p["out_proj"], ("batch", None, None), ctx)
    if return_state:
        return out, (new_conv, state)
    return out


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
    the rows that its shards of the caches hold."""
    proj = h @ p["in_proj"]
    if not ctx.enabled:
        y, new_conv, state = _decode_mixer(proj, p, cfg, h.dtype, conv_state, ssm_state)
    else:
        mesh = ctx.mesh
        rows = _rows(proj, conv_state)  # the engine places both states by their slots
        y, new_conv, state = _decode_mixer(rows.to_local(), _body_leaves(p, rows), cfg, h.dtype,
                                           _placed_as_rows(conv_state, rows).to_local(),
                                           _placed_as_rows(ssm_state, rows).to_local())
        y, new_conv, state = (from_local(t, mesh, rows.placements, (proj.shape[0],
                                                                   *t.shape[1:]))
                              for t in (y, new_conv, state))
    # whole on its rows, as ssm_forward's output and attn_decode's are
    out = constrain(y @ p["out_proj"], ("batch", None, None), ctx)
    return out, (new_conv, state)
