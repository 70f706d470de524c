"""Training loop: datapath batches -> microbatched grad accumulation ->
optimizer -> checkpoint/resume, with straggler instrumentation.

Port of `repro/train/loop.py`.  The step's first op on a 'fused'-mode
batch is the bit-unpack of the token blocks (models/model.py), the
`bitunpack` kernel on the card: the paper's decode offload as stage 0 of
the training step.  Gradients come from autograd over the model's plain
operations, as the reference's come from `jax.value_and_grad`; the update
runs in place.

Under a mesh (`ctx` with a DeviceMesh) the parameters and moments are
DTensors (`train` places the drawn parameters with `shard_params` before
`init_opt_state`, where the reference has GSPMD place them inside `jit`).
Every rank reads the same global batch, and `forward_train` keeps each
rank's rows.  Autograd gives each gradient in whatever placement its last
op left (a `Partial` sum, say); `shard_grads`, the reference's
`_shard_grads`, then redistributes it to its parameter's storage
placements: a partial gradient is reduce-scattered onto a sharded parameter
and all-reduced onto a replicated one.  Microbatches accumulate first and are placed once, as in
the reference.  The loss and the gradient norm come out as plain tensors,
the same value on every rank.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.distributed.sharding import ShardingCtx, local_ctx, shard_params, sharding_for
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward_train, init_params, param_dims
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (
    OptConfig,
    apply_updates,
    init_opt_state,
    opt_state_dims,
    plain,
    tree_leaves,
    tree_map,
)


def _grads(params, loss: torch.Tensor):
    """d loss / d every leaf, as a tree shaped like `params`, each grad in
    its parameter's dtype."""
    leaves = []
    tree_map(leaves.append, params)
    grads = iter(torch.autograd.grad(loss, leaves))
    return tree_map(lambda _: next(grads), params)


def _requires_grad(params, on: bool):
    tree_map(lambda p: p.requires_grad_(on), params)


def _placed(g: torch.Tensor, place) -> torch.Tensor:
    """g redistributed to `place` (a DTensor gradient), or g itself."""
    if not isinstance(g, DTensor) or tuple(g.placements) == tuple(place):
        return g
    return g.redistribute(g.device_mesh, place)


def shard_grads(grads, cfg: ModelConfig, ctx: ShardingCtx):
    """Each gradient placed as its parameter is stored (`sharding_for(
    param_dims)`, the reference's `_shard_grads`): a partial sum is
    reduce-scattered onto a sharded parameter rather than gathered whole."""
    if not ctx.enabled:
        return grads
    return tree_map(lambda g, dm: _placed(g, sharding_for(dm, ctx, tuple(g.shape))),
                    grads, param_dims(cfg))


def make_train_step(cfg: ModelConfig, optcfg: OptConfig,
                    ctx: Optional[ShardingCtx] = None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, {"loss", "lr",
    "grad_norm"}); params and moments are updated in place."""
    ctx = ctx or local_ctx()
    m = cfg.microbatches

    def train_step(params, opt_state, batch):
        _requires_grad(params, True)
        if m == 1:
            loss, _ = forward_train(params, batch, cfg, ctx)
            grads = shard_grads(_grads(params, loss), cfg, ctx)
        else:
            grads = None
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(m):
                mb = {k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
                      for k, x in batch.items()}
                l, _ = forward_train(params, mb, cfg, ctx)
                g = _grads(params, l)
                if grads is None:  # zeros of the gradients' own placements
                    grads = tree_map(lambda b: torch.zeros_like(b, dtype=torch.float32), g)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + plain(l.detach())
            grads = shard_grads(tree_map(lambda g: g / m, grads), cfg, ctx)
            loss = loss / m
        _requires_grad(params, False)  # plain tensors again, as init_params made them
        params, opt_state, stats = apply_updates(params, grads, opt_state, optcfg)
        return params, opt_state, {"loss": plain(loss.detach()), **stats}

    return train_step


def train(
    cfg: ModelConfig,
    optcfg: OptConfig,
    pipeline,
    steps: int,
    ctx: Optional[ShardingCtx] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    seed: int = 0,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    device="cuda",
) -> Dict[str, Any]:
    """Runs `steps` steps on `device` (the card unless the caller asks for
    the CPU); resumes from the latest checkpoint in `ckpt_dir` if present.
    Under a mesh every rank calls it with the same arguments and reads the
    same batches; the moments are restored by their parameters' dims (the
    reference passes `None` there and raises: ROADMAP.md C)."""
    ctx = ctx or local_ctx()
    params = shard_params(init_params(cfg, seed, device), cfg, ctx)
    opt_state = init_opt_state(params, optcfg)
    start_step = 0

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None:
        dims = None
        if ctx.enabled:
            pdims = param_dims(cfg)
            dims = {"params": pdims, "opt": opt_state_dims(pdims, params, optcfg)}
        restored, manifest = manager.restore_latest({"params": params, "opt": opt_state}, ctx,
                                                    dims)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = manifest["meta"].get("step", 0)
            if "pipeline" in manifest["meta"]:
                pipeline.restore_state(manifest["meta"]["pipeline"])
            log_fn(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, optcfg, ctx)
    straggler = StragglerDetector()
    history = []
    t_total = time.time()
    for step in range(start_step, steps):
        batch = pipeline.next_batch()
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # waits for the step's kernels
        dt = time.time() - t0
        straggler.record("host0", step, dt)
        history.append(loss)
        if step % log_every == 0:
            log_fn(f"[train] step {step} loss {loss:.4f} "
                   f"lr {float(metrics.get('lr', 0)):.2e} {dt*1000:.0f}ms")
        if manager is not None and (step + 1) % ckpt_every == 0:
            manager.save(
                step + 1,
                {"params": params, "opt": opt_state},
                meta={"step": step + 1, "pipeline": pipeline.checkpoint_state()},
            )
    return {
        "params": params,
        "opt_state": opt_state,
        "losses": history,
        "wall_s": time.time() - t_total,
        "stragglers": straggler.report(),
    }
