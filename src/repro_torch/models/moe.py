"""Mixture-of-Experts FFN, with expert parallelism (EP) over the model axis.

Port of `repro/models/moe.py`: `_capacity`, `_routed_local`, `_row_index`,
`_routed_2d` and `moe_ffn` with its Switch-style load-balance loss and the
shared experts.  The routed experts of `_routed_local`:

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
over experts never waits for the card.

Under a mesh `moe_ffn` takes the reference's three arms.  Each `shard_map`
of the reference is a body over each rank's own shards (`to_local`), with
the same in and out specs, and its collectives run on the mesh dims'
process groups; capacities follow the body's local shapes, as in the
reference:
  - `fsdp_ep` (E and the batch divide): `_routed_2d`, tokens sent to their
    expert's owner column with an all-to-all over the model axis; the
    expert weights either resident on their column or F-sharded over the
    data rows (then the tokens are gathered along the rows and the partial
    outputs reduce-scattered back);
  - E divisible by the model axis otherwise: `_routed_local` on this
    rank's E / tp experts (from expert e0) over its data shard of the
    batch, then an all-reduce over the model axis;
  - else `_routed_global`: the reference routes over the global batch
    there, so the capacity counts every token; each rank gathers the
    tokens and runs its shard of the experts' ff (the data axis, as the
    parameters are stored), and the partial sums are reduce-scattered back
    to the rows.
The router's top k runs on each rank's own tokens (a per-token function)
and the auxiliary loss sums over the ranks.  The bodies train: their
collectives are the differentiable ones of `distributed/collectives.py`
(an all-reduce whose sum every rank uses has the identity as its backward,
an all-to-all is its own transpose, an all-gather and a reduce-scatter are
each other's), and each input that a body takes through `to_local` declares
its gradient `Partial` on the mesh dims where the input is replicated but
the body's tokens are sharded (`sharding.local_grad`).  In the EP arm every
model rank routes the same tokens but runs only its own experts: the tokens
and gates enter the experts through `collectives.copy_to` (backward: the
model ranks' partial gradients summed), and the routed sum leaves through
`collectives.all_reduce_sum` (backward: the identity), so the router and
the Switch loss see one replicated gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (
    ShardingCtx,
    as_dtensor,
    constrain,
    from_local,
    local_grad,
    spec_for,
    to_spec,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import glu_mlp

# expert blocks of at most this many bytes per owner column live resident on
# that column under `fsdp_ep` (the reference's 512 MB)
RESIDENT_BYTES = 512 << 20


def _capacity(n_tokens: int, k: int, n_experts: int, factor: float) -> int:
    c = int(factor * n_tokens * k / n_experts)
    return max(8, -(-c // 8) * 8)


def _routed_local(x, ids, gates, wg, wu, wo, *, k: int, n_experts: int, capacity: float,
                  act: str, e0: int = 0, reduce=None):
    """Routed-expert compute.  x (B,S,D); ids/gates (B,S,k); wg/wu (E,D,F),
    wo (E,F,D): experts e0 .. e0 + E - 1 of `n_experts`.  `reduce` maps the
    float32 (N, D) sum before its cast to x's dtype (the model axis's
    all-reduce, or `_routed_global`'s sum over the ff shards onto this
    rank's rows)."""
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
    experts = torch.arange(e0, e0 + E, dtype=s_ids.dtype, device=dev)
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
    if reduce is not None:
        out = reduce(out)
    return out.reshape(-1, S, D).to(x.dtype)


def _glu(xs, wg, wu, wo, act):
    hg = xs @ wg
    hu = xs @ wu
    a = F.silu(hg) if act == "swiglu" else F.gelu(hg, approximate="tanh")
    return (a * hu) @ wo


# ---------------------------------------------------------------------------
# 2D expert parallelism: tokens all-to-all'd along the model axis to their
# expert's owner column, broadcast along the data axis (expert F dims are
# data-sharded so every row computes a 1/dp slice), partial outputs
# reduce-scattered over data, then all-to-all'd back.
# ---------------------------------------------------------------------------


def _row_index(row_axes, mesh) -> int:
    """This rank's index among the rows (the dp axes, major to minor)."""
    if isinstance(row_axes, str):
        return mesh.get_local_rank(row_axes)
    idx = mesh.get_local_rank(row_axes[0])
    for a in row_axes[1:]:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def _row_group(row_axes, mesh):
    """The process group of the rows: one dp axis's, or the flattened
    (pod, data) dims' on the multi-pod mesh (ranks in `_row_index` order)."""
    if isinstance(row_axes, str):
        return mesh.get_group(row_axes)
    return mesh[tuple(row_axes)]._flatten().get_group()


def _routed_2d(x, ids, gates, wg, wu, wo, *, e_local: int, k: int, capacity: float, act: str,
               tp: int, model_group, row_group, resident: bool = False):
    """Per-shard body of the 2D arm.  x (Nl_b, S, D) wide-batch block.

    resident=False: wg/wu (El, D, F/dp), wo (El, F/dp, D) — F row-sharded,
      tokens gathered along rows, partials reduce-scattered (400B scale).
    resident=True: full-F expert weights live on the owner column — no row
      broadcast, no reduction: tokens only all-to-all along the model axis."""
    Bl, S, D = x.shape
    N = Bl * S
    dev = x.device
    xf = x.reshape(N, D)

    # 1) bucket tokens by destination column (expert owner)
    flat_ids = ids.reshape(-1).long()  # (N*k,) global expert ids
    owner = flat_ids // e_local  # destination column
    tok = torch.arange(N * k, dtype=torch.int64, device=dev) // k
    order = torch.argsort(owner, stable=True)
    s_owner, s_tok = owner[order], tok[order]
    s_gate = gates.reshape(-1)[order]
    s_eid = (flat_ids % e_local)[order]  # expert index within the column
    C = max(8, -(-int(capacity * N * k / tp) // 8) * 8)
    C = min(C, N * k)
    cols = torch.arange(tp, dtype=owner.dtype, device=dev)
    starts = torch.searchsorted(s_owner, cols).clamp(max=N * k - C)
    seg = starts[:, None] + torch.arange(C, device=dev)  # (tp, C)
    valid = s_owner[seg] == cols[:, None]
    send_tok = s_tok[seg]  # stays local (return scatter)
    send_x = xf[send_tok] * valid[..., None].to(x.dtype)  # (tp, C, D)
    send_eid = torch.where(valid, s_eid[seg], e_local)
    send_w = (s_gate[seg] * valid)[..., None].float()

    # 2) all-to-all along model: tokens reach their owner column
    rx = coll.all_to_all(send_x, model_group)
    re = coll.all_to_all(send_eid, model_group)
    if resident:
        gx, ge = rx.reshape(-1, D), re.reshape(-1)  # (tp*C, D): this row's tokens only
    else:
        # 3) broadcast along the data rows (F is row-sharded)
        gx = coll.all_gather(rx, row_group).reshape(-1, D)  # (dp*tp*C, D)
        ge = coll.all_gather(re, row_group).reshape(-1)

    # 4) local expert compute on the F/dp slice
    order2 = torch.argsort(ge, stable=True)
    t_ids = ge[order2]
    Tall = gx.shape[0]
    C2 = min(Tall, max(8, -(-int(capacity * Tall / max(e_local, 1)) // 8) * 8))
    experts = torch.arange(e_local, dtype=t_ids.dtype, device=dev)
    starts2 = torch.searchsorted(t_ids, experts).clamp(max=Tall - C2)
    seg2 = starts2[:, None] + torch.arange(C2, device=dev)  # (El, C2)
    seg_pos = order2[seg2]
    valid2 = t_ids[seg2] == experts[:, None]
    out_partial = torch.zeros((Tall, D), dtype=torch.float32, device=dev)
    for j in range(e_local):
        xs = gx[seg_pos[j]] * valid2[j, :, None].to(x.dtype)
        ys = _glu(xs, wg[j], wu[j], wo[j], act)  # (C2, D), partial over the F slice
        out_partial.index_add_(0, seg_pos[j], ys.float() * valid2[j, :, None].float())

    # 5) combine F slices: the reduce-scatter hands each row its own chunk
    if resident:
        mine = out_partial  # (tp*C, D): already complete (full F)
    else:
        mine = coll.reduce_scatter(out_partial, row_group)  # (tp*C, D)

    # 6) all-to-all back + gated scatter into source tokens
    back = coll.all_to_all(mine.reshape(tp, C, D), model_group)
    out = torch.zeros((N, D), dtype=torch.float32, device=dev)
    for j in range(tp):
        out.index_add_(0, send_tok[j], back[j].float() * send_w[j])
    return out.reshape(Bl, S, D).to(x.dtype)


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
        return _moe_ffn_mesh(x, params, cfg, ctx)
    E = cfg.moe_experts
    # the router and the experts read x through one alias, as the mesh arms
    # read it through `to_local`: autograd then adds x's gradients in the
    # same order on both paths (router and experts first, then the shared
    # experts), which keeps a one-rank mesh bit for bit with one device
    xl = x.view_as(x)
    probs, gates, ids = route(xl, params["router"], cfg)
    aux = _aux(ids, probs, cfg)
    routed = _routed_local(xl, ids, gates, params["e_wg"], params["e_wu"], params["e_wo"],
                           k=cfg.moe_top_k, n_experts=E, capacity=cfg.moe_capacity,
                           act=cfg.act)
    if cfg.moe_shared:
        routed = routed + glu_mlp(x, params["shared_wg"], params["shared_wu"],
                                  params["shared_wo"], cfg.act, ctx)
    return constrain(routed, ("batch", None, None), ctx), aux


def _routed_global(xs, xl, ids, gates, params, ctx: ShardingCtx, **kw):
    """The arm without expert parallelism (E does not divide the model
    axis, or one model rank), the reference's GSPMD `_routed_local`: the
    dispatch runs over the global tokens (the capacity counts every token
    and the stable sort orders them all, as there), each rank on its shard
    of the experts' ff.  xs (B, S, D) is x on its batch rows, xl its local
    tensor (the one the router read: autograd then adds x's gradients in
    the order of one device) and ids/gates this rank's rows' routing;
    returns this rank's rows of the routed sum.

    The expert weights keep their parameters' placements (`experts`, with
    the ff on `fsdp`: the data axis).  On each mesh dim of more than one
    rank: where the rows are sharded, the tokens, ids and gates are
    gathered (backward: a reduce-scatter) and the output is
    reduce-scattered back to the rows where the ff is sharded too (the sum
    over the ff shards; backward: an all-gather), or cut to the rank's rows
    where it is not; where only the ff is sharded, the replicated tokens
    and gates enter through `copy_to` and the output leaves through
    `all_reduce_sum`.  Each weight's local gradient is then its own
    shard's, summed over the rows' mesh dims that do not shard it
    (`local_grad` on xs)."""
    mesh = xs.device_mesh
    wd = [to_spec(params[n], spec_for(dims, ctx, params[n].shape), mesh) for n, dims in (
        ("e_wg", ("experts", None, "fsdp")), ("e_wu", ("experts", None, "fsdp")),
        ("e_wo", ("experts", "fsdp", None)))]
    w = [local_grad(t, xs) for t in wd]
    rows = [m for m, p in enumerate(xs.placements) if p.is_shard()]  # major to minor
    ff = {m for m, p in enumerate(wd[0].placements) if p.is_shard()}
    for m in ff.difference(rows):
        xl, gates = coll.copy_to(xl, mesh.get_group(m)), coll.copy_to(gates, mesh.get_group(m))
    for m in reversed(rows):  # minor first: the gathered rows end in mesh order
        g = mesh.get_group(m)
        xl, ids, gates = coll.all_gather(xl, g), coll.all_gather(ids, g), coll.all_gather(gates, g)

    def reduce(o):  # (N, D) float32, the global tokens in batch order
        for m in ff.difference(rows):
            o = coll.all_reduce_sum(o, mesh.get_group(m))
        for m in rows:  # major first
            if m in ff:
                o = coll.reduce_scatter(o, mesh.get_group(m))
            else:
                n = o.shape[0] // mesh.size(m)
                o = o.narrow(0, mesh.get_local_rank(m) * n, n)
        return o

    return _routed_local(xl, ids, gates, *w, reduce=reduce, **kw)


def _aux(ids, probs, cfg: ModelConfig, groups=(), n_tokens: int = 0):
    """Switch-style load-balance loss; with `groups`, these are this rank's
    tokens of `n_tokens`, and the groups' ranks hold the others."""
    E = cfg.moe_experts
    one_hot = F.one_hot(ids[..., 0].long(), E).float()
    if not groups:
        f = torch.mean(one_hot, dim=(0, 1))
        p = torch.mean(probs, dim=(0, 1))
    else:
        f, p = torch.sum(one_hot, dim=(0, 1)), torch.sum(probs, dim=(0, 1))
        for g in groups:  # every rank goes on with the sums: the identity backward
            f = coll.all_reduce_sum(f, g)
            p = coll.all_reduce_sum(p, g)
        f, p = f / n_tokens, p / n_tokens
    return E * torch.sum(f * p) * cfg.moe_aux_weight


def _moe_ffn_mesh(x, params, cfg: ModelConfig, ctx: ShardingCtx):
    """The reference's mesh arms; the routed output and the shared experts'
    as DTensors, the aux loss a plain float32 scalar on every rank."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    mesh, tp = ctx.mesh, ctx.tp
    x = as_dtensor(x, mesh)
    B, S = x.shape[:2]
    wide = tuple(ctx.dp_axes) + (ctx.tp_axis,)
    ep = tp > 1 and E % tp == 0
    use_2d = (ep and ctx.strategy == "fsdp_ep" and B % ctx.axis_size(wide) == 0
              and cfg.moe_d_ff % ctx.axis_size(ctx.fsdp_axis) == 0)
    dp_spec = ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]
    if use_2d:
        x_spec = (wide, None, None)
    else:
        # a batch the data axis does not divide stays whole on every row,
        # where the reference's shard_map refuses it (ROADMAP C)
        x_spec = (dp_spec if B % ctx.dp == 0 else None, None, None)
    xs = to_spec(x, x_spec, mesh)
    xl = xs.to_local()
    router = local_grad(to_spec(params["router"], (None, None), mesh), xs)
    probs, gates, ids = route(xl, router, cfg)
    groups = [mesh.get_group(m) for m, p in enumerate(xs.placements) if p.is_shard()]
    aux = _aux(ids, probs, cfg, groups, B * S)
    kw = dict(k=k, capacity=cfg.moe_capacity, act=cfg.act)
    if use_2d:
        # small expert blocks live resident on their owner column: tokens
        # all-to-all only, no row-axis collectives
        resident = (E // tp) * 3 * cfg.d_model * cfg.moe_d_ff * 2 <= RESIDENT_BYTES
        f_ax = None if resident else ctx.fsdp_axis
        w = [local_grad(to_spec(params[n], spec, mesh), xs) for n, spec in (
            ("e_wg", (ctx.tp_axis, None, f_ax)), ("e_wu", (ctx.tp_axis, None, f_ax)),
            ("e_wo", (ctx.tp_axis, f_ax, None)))]
        out = _routed_2d(xl, ids, gates, *w, e_local=E // tp, tp=tp,
                         model_group=mesh.get_group(ctx.tp_axis),
                         row_group=_row_group(dp_spec, mesh), resident=resident, **kw)
    elif ep:
        w = [local_grad(to_spec(params[n], (ctx.tp_axis, None, None), mesh), xs)
             for n in ("e_wg", "e_wu", "e_wo")]
        e0 = mesh.get_local_rank(ctx.tp_axis) * (E // tp)  # this rank's first expert
        model_group = mesh.get_group(ctx.tp_axis)
        out = _routed_local(coll.copy_to(xl, model_group), ids, coll.copy_to(gates, model_group),
                            *w, n_experts=E, e0=e0,
                            reduce=lambda o: coll.all_reduce_sum(o, model_group), **kw)
    else:
        out = _routed_global(xs, xl, ids, gates, params, ctx, n_experts=E, **kw)
    routed = from_local(out, mesh, xs.placements, xs.shape)
    if cfg.moe_shared:
        routed = routed + glu_mlp(x, params["shared_wg"], params["shared_wu"],
                                  params["shared_wo"], cfg.act, ctx)
    return constrain(routed, ("batch", None, None), ctx), aux

