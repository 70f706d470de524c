"""Optimizers from scratch: AdamW and Adafactor, with warmup + cosine
schedules, global-norm clipping, and weight-decay masks.

Port of `repro/train/optimizer.py`.  The state keeps the reference's layout
(`{"m", "v", "step"}` or `{"vr", "vc", "step"}`, trees shaped like the
parameters, `step` an int32 scalar tensor on the parameters' device), so a
checkpoint carries over key for key.  The schedule, the bias corrections
and the update run in float32 tensors in the reference's order of
operations: Python doubles would differ from JAX's float32 in the last
bits.  `apply_updates` writes the new parameters and moments into their
tensors in place (the counterpart of the reference's `donate_argnums`),
each rounded back to its tensor's dtype.

On DTensor parameters (training under a mesh) the moments are DTensors that
inherit their parameter's placements, as the reference's docstring says
GSPMD gives them; Adafactor's factored `vr` / `vc` take the placements of
the parameter's dims that they keep.  The step, the schedule and the bias
corrections stay plain 0-dim tensors, which DTensor takes as replicated
scalars.  `global_norm` sums each rank's squares and reduces them once, and
comes out as a plain tensor, the same on every rank.

moments_dtype='bfloat16' halves Adam state at <0.1% update error.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"  # bfloat16 halves Adam state
    # adafactor
    factored_min_size: int = 128
    decay_adafactor: float = 0.8


_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of parameter-shaped trees (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's order (`jax.tree.leaves`: dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup, then cosine down to lr * min_lr_ratio; float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, prog) * prog))
    return _f32(cfg.lr, warm) * warm * (cfg.min_lr_ratio + _f32(1 - cfg.min_lr_ratio, cos) * cos)


def _decay_mask(params) -> Any:
    """Weight decay on >=2D params only (skip norms/scales/biases)."""
    return tree_map(lambda p: p.ndim >= 2, params)


def _factored(shape, min_size: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_size and shape[-2] >= min_size


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def plain(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on every rank, else x."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _kept(dims, drop: Tuple[int, ...]):
    """`dims` (a placement's tensor dims or logical dims) without the
    indices in `drop`, renumbered."""
    return tuple(d for i, d in enumerate(dims) if i not in drop)


def _zeros(p: torch.Tensor, shape, drop: Tuple[int, ...] = ()) -> torch.Tensor:
    """float32 zeros of `shape`, p's dims less `drop`; for a DTensor p,
    placed as p's placements place the dims that stay (a dim that goes
    leaves its mesh dims replicated)."""
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    keep = [i for i in range(p.ndim) if i not in drop]
    place = [Shard(keep.index(q.dim)) if isinstance(q, Shard) and q.dim in keep
             else Replicate() for q in p.placements]
    return dtensor_zeros(tuple(shape), dtype=torch.float32, device_mesh=p.device_mesh,
                         placements=place)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    if cfg.name == "adamw":
        mdt = _MOMENT_DTYPES[cfg.moments_dtype]
        # zeros_like keeps a DTensor parameter's placements
        return {
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
            "step": step,
        }
    if cfg.name == "adafactor":
        def vrow(p):
            if _factored(p.shape, cfg.factored_min_size):
                return _zeros(p, p.shape[:-1], (p.ndim - 1,))
            return _zeros(p, p.shape)

        def vcol(p):
            if _factored(p.shape, cfg.factored_min_size):
                return _zeros(p, p.shape[:-2] + p.shape[-1:], (p.ndim - 2,))
            return _zeros(p, (1,), tuple(range(p.ndim)))  # a placeholder, replicated

        return {"vr": tree_map(vrow, params), "vc": tree_map(vcol, params), "step": step}
    raise ValueError(cfg.name)


def opt_state_dims(param_dims, params, cfg: OptConfig) -> Dict[str, Any]:
    """The logical dims of `init_opt_state(params, cfg)`'s leaves, for
    placing a restored state on a mesh: each moment its parameter's dims
    (Adafactor's factored ones those of the dims they keep), the step None
    (a plain tensor)."""
    if cfg.name == "adamw":
        return {"m": param_dims, "v": param_dims, "step": None}
    if cfg.name == "adafactor":
        def vrow(p, dm):
            return _kept(dm, (p.ndim - 1,)) if _factored(p.shape, cfg.factored_min_size) else dm

        def vcol(p, dm):
            if _factored(p.shape, cfg.factored_min_size):
                return _kept(dm, (p.ndim - 2,))
            return (None,)

        return {"vr": tree_map(vrow, params, param_dims), "vc": tree_map(vcol, params, param_dims),
                "step": None}
    raise ValueError(cfg.name)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves added
    in the reference's order; for DTensor leaves each rank adds its own
    shards' squares and one reduction follows (the sum in another order)."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(leaf.float() ** 2)
    return plain(torch.sqrt(total))


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), src first placed as dst is when both are DTensors."""
    if isinstance(dst, DTensor) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (params, new_state, stats); the parameter and moment tensors
    are updated in place."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        scale = 1.0
    mask = _decay_mask(params)
    stats = {"lr": lr, "grad_norm": gnorm}

    def newp(p, delta, do_wd):
        if do_wd:
            delta = delta + cfg.weight_decay * p.float()
        _store(p, (p.float() - lr * delta).to(p.dtype))

    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - torch.pow(_f32(b1, step), step.float())
        bc2 = 1 - torch.pow(_f32(b2, step), step.float())

        def upd(p, g, m, v, do_wd):
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * g * g
            mhat = m32 / bc1
            vhat = v32 / bc2
            newp(p, mhat / (torch.sqrt(vhat) + cfg.eps), do_wd)
            _store(m, m32)
            _store(v, v32)

        tree_map(upd, params, grads, state["m"], state["v"], mask)
        return params, {"m": state["m"], "v": state["v"], "step": step}, stats

    if cfg.name == "adafactor":
        decay = 1.0 - (step.float() + 1) ** -cfg.decay_adafactor

        def upd(p, g, vr, vc, do_wd):
            g = g.float() * scale
            g2 = g * g + 1e-30
            if _factored(p.shape, cfg.factored_min_size):
                vr32 = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
                vc32 = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
                denom = torch.clamp(torch.mean(vr32, dim=-1, keepdim=True), min=1e-30)
                vhat = (vr32[..., None] * vc32[..., None, :]) / denom[..., None]
                _store(vc, vc32)
            else:
                vr32 = decay * vr + (1 - decay) * g2
                vhat = vr32
            delta = g / torch.clamp(torch.sqrt(vhat), min=1e-12)
            # update clipping (RMS <= 1), Adafactor-style
            rms = torch.sqrt(torch.mean(delta ** 2) + 1e-30)
            newp(p, delta / torch.clamp(rms, min=1.0), do_wd)
            _store(vr, vr32)

        tree_map(upd, params, grads, state["vr"], state["vc"], mask)
        return params, {"vr": state["vr"], "vc": state["vc"], "step": step}, stats

    raise ValueError(cfg.name)
