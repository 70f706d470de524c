"""Sharding rules: logical tensor dims -> mesh placements, plus the scan
fabric's consistent-hash ring (`HashRing`) mapping row groups to pods.

Port of `repro/distributed/sharding.py`.  Every tensor is described by
*logical* dims ('batch', 'seq', 'd', 'ff', 'heads', 'vocab', 'experts',
...).  `spec_for` maps them onto the mesh's dims (pod, data, model) with the
reference's rules, entry for entry as its `PartitionSpec`:

  batch    -> (pod, data)   pure DP across pods + DP within a pod
  vocab/ff/heads/experts -> model   (TP / EP)
  d/hd_out -> data          (FSDP: parameters sharded over the data axis,
                             gathered at use)
  seq      -> model ONLY when requested ('seq_tp': sequence-parallel
              attention / flash-decode KV sharding)

The reference's GSPMD only annotates and keeps the math global; its torch
counterpart is DTensor.  `placements_for` turns a spec into one DTensor
placement per mesh dim (a tuple entry shards one tensor dim over several
mesh dims, major to minor in mesh order, as `NamedSharding` does),
`shard_params` places parameters by `param_dims`, and `constrain`
redistributes an activation to the strategy-aware spec
(`activation=True`).  `gather_dim` makes one dim whole on every rank before
an op that cuts it where DTensor cannot follow a shard, and `on_shards`
applies an op that DTensor has no strategy for to each rank's shard.
`local_grad` hands a local body a parameter's shard with the gradient
placements that the body's tokens give it (training under a mesh), and
`constrain_cotangent` constrains a gradient as the reference's constraint
does its cotangent (where DTensor would pass a partial sum back).  A plain
tensor given to `constrain` is taken as a replicated value.  The reference
requires annotated dims to divide the axis size, so every rule is guarded:
a non-divisible dim degrades to replicated, and `placements_for` refuses an
uneven shard, which DTensor itself would allow.  A spec that names one mesh axis twice raises
`DuplicateSpecError`, as `NamedSharding` does.

`rg_key` and `HashRing` map row groups to the fabric's pods
(`datapath/fabric.py`), key for key as the reference's do: both hash with
sha1, so the two packages route every row group to the same pod.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)

# logical dim -> mesh axis role
_TP_DIMS = frozenset({"vocab", "ff", "heads", "kv", "experts", "moe_ff", "inner", "seq_tp",
                      "state_tp"})
_FSDP_DIMS = frozenset({"d", "fsdp"})
_DP_DIMS = frozenset({"batch"})

Spec = Tuple[Any, ...]  # one entry per tensor dim: None, an axis name or a tuple of names


class DuplicateSpecError(ValueError):
    """A spec maps one mesh axis to two tensor dims (JAX's error of the same
    name)."""


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Optional[Any] = None  # a DeviceMesh (anything with a `.shape` mapping for the rules)
    dp_axes: Tuple[str, ...] = ("data",)  # ('pod','data') on the multi-pod mesh
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    # Activation-sharding strategy (params always stay sharded):
    #  'tp'      Megatron: activations TP-sharded on ff/heads, per-layer
    #            all-reduces of (B_local, S, D)   [baseline]
    #  'fsdp'    ZeRO-3: batch sharded over (dp x model), weights gathered
    #            per layer, NO activation all-reduces
    #  'fsdp_ep' as 'fsdp' but batch stays on dp only (MoE: the model axis
    #            carries expert parallelism)
    strategy: str = "tp"

    @property
    def enabled(self) -> bool:
        return self.mesh is not None

    def axis_size(self, axes) -> int:
        if self.mesh is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        sizes = _axis_sizes(self.mesh)
        n = 1
        for a in axes:
            n *= sizes[a]
        return n

    @property
    def dp(self) -> int:
        return self.axis_size(self.dp_axes)

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}: a DeviceMesh's named dims, or the `.shape` mapping
    of a JAX-style mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    return dict(zip(names, mesh.shape)) if names else mesh.shape


def local_ctx() -> ShardingCtx:
    """No-mesh context: one device."""
    return ShardingCtx(mesh=None)


def _axis_for(dim: Optional[str], ctx: ShardingCtx, activation: bool = False):
    """Mesh axis (or candidate tuple list for batch) for a logical dim.

    Params (activation=False) always keep storage sharding regardless of
    strategy; activation constraints are strategy-dependent."""
    if dim is None:
        return None
    if dim in _DP_DIMS:
        if activation and ctx.strategy in ("fsdp", "fsdp_ep"):
            # widest-first candidates; spec_for picks the first divisible
            return [tuple(ctx.dp_axes) + (ctx.tp_axis,), tuple(ctx.dp_axes),
                    (ctx.dp_axes[-1],)]
        return [tuple(ctx.dp_axes), (ctx.dp_axes[-1],)]
    if dim in _TP_DIMS:
        if activation and ctx.strategy in ("fsdp", "fsdp_ep") and dim != "seq_tp":
            return None  # ZeRO: no TP activation sharding (caches keep seq_tp)
        return ctx.tp_axis
    if dim in _FSDP_DIMS:
        return ctx.fsdp_axis
    return None


def spec_for(dims: Sequence[Optional[str]], ctx: ShardingCtx,
             shape: Optional[Sequence[int]] = None, activation: bool = False) -> Spec:
    """The reference's PartitionSpec entries for logical dims, dropping
    non-divisible annotations; () without a mesh."""
    if not ctx.enabled:
        return ()
    entries = []
    for i, dim in enumerate(dims):
        ax = _axis_for(dim, ctx, activation)
        if isinstance(ax, list):  # candidate tuples, widest first
            chosen = None
            for cand in ax:
                if shape is None or shape[i] % ctx.axis_size(cand) == 0:
                    chosen = cand if len(cand) > 1 else cand[0]
                    break
            ax = chosen
        elif ax is not None and shape is not None:
            if shape[i] % ctx.axis_size(ax) != 0:
                ax = None  # degrade to replicated
        entries.append(ax)
    return tuple(entries)


def placements_for(spec: Spec, mesh, shape: Optional[Sequence[int]] = None
                   ) -> Tuple[Placement, ...]:
    """One DTensor placement per mesh dim for a spec: `Shard(i)` on every
    mesh dim of more than one rank that tensor dim i's entry names (a mesh
    dim of one rank holds the whole tensor either way, and DTensor cannot
    squeeze a size-1 dim that it counts as sharded).  A tuple entry must
    list its axes in mesh order (DTensor shards over mesh dims major to
    minor in that order, as the reference's tuple does).  With `shape`, an uneven shard
    raises, as the reference's NamedSharding does."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out: List[Placement] = [Replicate()] * len(names)
    used = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
        n = 1
        for a, m in zip(axes, where):
            if a in used:
                raise DuplicateSpecError(
                    f"spec {spec} has duplicate entries for mesh axis {a!r}: a mesh axis "
                    "can shard at most one tensor dim")
            used.add(a)
            if sizes[a] > 1:  # one shard is the whole: replicated, the same layout
                out[m] = Shard(i)
            n *= sizes[a]
        if shape is not None and shape[i] % n:
            raise ValueError(f"spec {spec}: dim {i} of {tuple(shape)} does not divide into {n} "
                             "shards")
    return tuple(out)


def sharding_for(dims, ctx: ShardingCtx, shape=None, activation: bool = False
                 ) -> Optional[Tuple[Placement, ...]]:
    """The placements of a tensor with logical `dims` (the reference's
    NamedSharding), or None without a mesh."""
    if not ctx.enabled:
        return None
    return placements_for(spec_for(dims, ctx, shape, activation), ctx.mesh, shape)


def _is_dims(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_shardings(param_dims, ctx: ShardingCtx, param_shapes):
    """A tree (dicts and lists) of logical-dims tuples and the matching tree
    of shapes (tuples, or anything with a `.shape`) -> the same tree of
    `sharding_for`'s placements (None in every leaf without a mesh)."""
    if _is_dims(param_dims):
        shape = getattr(param_shapes, "shape", param_shapes)
        return sharding_for(param_dims, ctx, tuple(shape))
    if isinstance(param_dims, dict):
        return {k: tree_shardings(v, ctx, param_shapes[k]) for k, v in param_dims.items()}
    return [tree_shardings(d, ctx, s) for d, s in zip(param_dims, param_shapes, strict=True)]


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """`x` as a DTensor on `mesh`: a plain tensor is taken as a replicated
    value (every rank holds all of it)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def from_local(t: torch.Tensor, mesh, placements, shape: Sequence[int]) -> DTensor:
    """This rank's shard `t` of a tensor of `shape` with `placements`, as a
    contiguous DTensor (no communication)."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                              shape=tuple(shape), stride=stride)


def like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A plain tensor `t` made fit to combine with `x`: replicated on x's
    mesh when x is a DTensor, else t itself."""
    return as_dtensor(t, x.device_mesh) if isinstance(x, DTensor) else t


def to_spec(x: torch.Tensor, spec: Spec, mesh) -> DTensor:
    """`x` (a plain tensor: a replicated value) redistributed to `spec`."""
    x = as_dtensor(x, mesh)
    want = placements_for(spec, mesh, x.shape)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def constrain(x: torch.Tensor, dims: Sequence[Optional[str]], ctx: ShardingCtx) -> torch.Tensor:
    """The reference's sharding constraint on logical dims: the identity
    without a mesh, else `x` redistributed to the strategy-aware spec."""
    if not ctx.enabled:
        return x
    return to_spec(x, spec_for(dims, ctx, x.shape, activation=True), ctx.mesh)


class _CotangentAs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def constrain_cotangent(x: torch.Tensor) -> torch.Tensor:
    """x, whose gradient is redistributed to x's own placements before it
    flows back into the op that made x (a plain tensor, or one that needs
    no gradient, is x itself): the transpose of the reference's
    `with_sharding_constraint`, which constrains the cotangent as it does
    the value.  DTensor's own redistribution passes a `Partial` gradient
    back unreduced wherever its forward input was `Partial`.

    The constraint that takes it is the one at a GLU MLP's output
    (`layers.glu_mlp`: the dense MLP and the MoE's shared experts).  Its
    forward reduces the down projection's partial sums over the ff shards;
    in training the gradient reaching it is `Partial` on the model axis.
    The head's backward starts that partial sum (dh = dlogits w^T, a
    contraction over the vocab shards), the products at each layer's
    input add to it (the MLP's dx = dh_g wg^T + dh_u wu^T over the ff
    shards, the attention's over the head shards), and the norms' backward
    and the residual stream carry it from layer to layer unreduced.
    Passed back unreduced, DTensor pairs it with the down projection's
    gathered weight and hidden state, and both backward products of
    (a h_u) wo run at the whole ff on every rank; reduced here, they run on
    the rank's ff shard.  The other constraints keep DTensor's own
    backward: constraining the cotangents of the residual stream
    everywhere hands the q, k and v projections' head-sharded views
    gradients sharded on their last dim that do not unflatten into heads
    which the model axis does not divide (DTensor raises), and their
    gradients are not partial sums over a dim that a product contracts."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _CotangentAs.apply(x)


def shard_params(params, cfg, ctx: ShardingCtx):
    """Every parameter as a DTensor placed by `spec_for(param_dims(cfg))`
    (the reference's `tree_shardings` and `device_put`).  Each rank is taken
    to hold the same full values (drawn from one seed, or converted) and
    keeps its own shard without communication; a leaf that is already a
    DTensor is left as it is."""
    if not ctx.enabled:
        return params
    from repro_torch.models.model import param_dims

    def put(p, dims):
        if isinstance(p, DTensor):
            return p
        place = placements_for(spec_for(dims, ctx, p.shape), ctx.mesh, p.shape)
        return distribute_tensor(p, ctx.mesh, place, src_data_rank=None)

    def walk(p, d):
        if isinstance(p, dict):
            return {k: walk(v, d[k]) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v, dv) for v, dv in zip(p, d)]
        return put(p, d)

    return walk(params, param_dims(cfg))


def local_grad(t: DTensor, x: DTensor) -> torch.Tensor:
    """t's local tensor, for a body that runs on x's local shards.  Its
    gradient is declared `Partial` on each mesh dim where t is replicated
    but x is sharded (each rank's own tokens add their share to the
    gradient), and as t's own placements on the others."""
    grad = [Partial() if isinstance(p, Replicate) and q.is_shard() else p
            for p, q in zip(t.placements, x.placements)]
    return t.to_local(grad_placements=grad)


def local_range(x: DTensor, dim: int) -> Tuple[int, int]:
    """(start, length) of this rank's shard along tensor dim `dim` of x
    (even shards, major to minor over the mesh dims that shard it)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, n = 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n //= mesh.size(m)
            start += coord[m] * n
    return start, n


def shard_groups(x: DTensor, dim: int) -> List[Any]:
    """The process groups of the mesh dims that shard tensor dim `dim`."""
    return [x.device_mesh.get_group(m) for m, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def gather_dim(t: torch.Tensor, dim: int, pieces: Optional[int] = None) -> torch.Tensor:
    """t with tensor dim `dim` whole on every rank, for an op that cuts that
    dim where DTensor cannot follow a shard (GSPMD reshards on its own): a
    split into unequal pieces (the SSM's z, x, B, C and dt), a roll, a
    reshape into heads that the shards do not divide.  A DTensor is gathered
    along the mesh dims that shard `dim`; with `pieces`, only along those
    whose size does not divide `pieces` (a reshape into `pieces` equal heads
    keeps the others).  A plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh, dim = t.device_mesh, dim % t.ndim
    place = [Replicate() if isinstance(q, Shard) and q.dim == dim
             and (pieces is None or pieces % mesh.size(m)) else q
             for m, q in enumerate(t.placements)]
    return t if place == list(t.placements) else t.redistribute(mesh, place)


def on_shards(fn, t: torch.Tensor) -> torch.Tensor:
    """fn(t) for an op that keeps t's shape and mixes values only along
    dims that no mesh dim shards: on a DTensor each rank applies it to its
    own shard, the result placed as t is (for an op that DTensor has no
    strategy for, such as `torch.roll` on the card's torch 2.11)."""
    if not isinstance(t, DTensor):
        return fn(t)
    return from_local(fn(t.to_local()), t.device_mesh, t.placements, t.shape)


def write_at(dst: torch.Tensor, dim: int, index: int, src: torch.Tensor) -> None:
    """dst[index] along `dim` = src (size 1 along `dim`), in place, cast to
    dst's dtype.  For a DTensor each rank writes its own shard: src is
    brought to dst's placements but replicated along `dim`, and the rank
    that holds `index` copies it into its local tensor."""
    if not isinstance(dst, DTensor):
        dst.narrow(dim, index, 1).copy_(src.to(dst.dtype))
        return
    mesh = dst.device_mesh
    place = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
             for p in dst.placements]
    src = as_dtensor(src, mesh)
    if tuple(src.placements) != tuple(place):
        src = src.redistribute(mesh, place)
    start, n = local_range(dst, dim)
    if start <= index < start + n:
        dst.to_local().narrow(dim, index - start, 1).copy_(src.to_local().to(dst.dtype))


def rg_key(path: str, rg: int) -> str:
    """Canonical ring key for a row group: ownership is per (table file,
    row group), so one table's groups spread across the whole fleet."""
    return f"{path}#rg{rg}"


class HashRing:
    """Consistent-hash ring mapping keys -> node ids (fabric pods).

    Each node is hashed onto the ring at `replicas` virtual points
    (sha1 of "node#i" — never Python `hash()`, which is salted per
    process and would re-shuffle ownership on every restart).  A key
    is owned by the first virtual point clockwise from its hash.

    Properties the fabric relies on (tests/test_torch_fabric_parts.py):
      * deterministic: same nodes -> same ownership, any process
      * minimal movement: removing a node re-homes only the arcs that
        node owned; adding one steals only the arcs it now owns —
        every other key keeps its owner (the drain/replay path re-hashes
        a dead pod's row groups without touching survivors' caches)
      * balanced: virtual points smooth per-node load to ~1/N
    """

    def __init__(self, nodes: Iterable[str] = (), replicas: int = 64):
        assert replicas >= 1
        self.replicas = replicas
        self._points: List[int] = []  # sorted virtual-point hashes
        self._owner_at: Dict[int, str] = {}  # point hash -> node id
        self.nodes: List[str] = []
        for n in nodes:
            self.add_node(n)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")

    def _vpoints(self, node: str) -> List[int]:
        return [self._hash(f"{node}#{i}") for i in range(self.replicas)]

    def add_node(self, node: str) -> None:
        if node in self.nodes:
            return
        self.nodes.append(node)
        for h in self._vpoints(node):
            # sha1 collisions across 8 bytes are not a practical concern;
            # last-add wins keeps the structure consistent regardless
            if h not in self._owner_at:
                bisect.insort(self._points, h)
            self._owner_at[h] = node

    def remove_node(self, node: str) -> None:
        if node not in self.nodes:
            return
        self.nodes.remove(node)
        for h in self._vpoints(node):
            if self._owner_at.get(h) == node:
                del self._owner_at[h]
                i = bisect.bisect_left(self._points, h)
                if i < len(self._points) and self._points[i] == h:
                    del self._points[i]

    def owner(self, key: str) -> str:
        if not self._points:
            raise ValueError("HashRing has no nodes")
        h = self._hash(key)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0  # wrap: first point clockwise
        return self._owner_at[self._points[i]]

    def owners(self, keys: Iterable[str]) -> Dict[str, str]:
        return {k: self.owner(k) for k in keys}
