"""Training under a device mesh (ROADMAP A.6b-i) on 4 gloo ranks on the CPU,
against the JAX package under 4 host devices and against the port without a
mesh: the collectives, gradients through DTensor and the expert-parallel
MoE, `make_train_step`, and checkpoints re-meshed by `train`.

One spawn serves every case, as in tests/test_torch_distributed.py: 4 ranks
through `torch.multiprocessing`, their process group rendezvousing on a
`FileStore` in a temporary directory, a (data=2, model=2) mesh from
`distributed.compat.make_mesh(device="cpu")`, a (pod=2, data=2) mesh for
the collectives and a (data=1, model=4) mesh for the re-mesh.  The
reference runs meanwhile under `tests.util.run_with_devices(n_devices=4)`
on plain `jax.sharding.Mesh`es (Auto axes).  Parameters are drawn once by
the reference's `init_params` (the smoke configs at 2 layers, float32) and
carried to the port by `params_from_reference`; the batch is 4 x 32 tokens.
The join has a timeout, so a collective that deadlocks fails the fixture.

Tolerances: gradients by relative L2 per leaf within 1e-5 (float32 sums in
other orders: the mesh's partial products and reductions on both sides);
losses within 2e-5 absolute and the gradient norm within 1e-5 relative;
`hierarchical_psum` exact on integer-valued floats; `quantize_int8` bit for
bit against the reference run op by op (under `jax.jit` XLA fuses the
error's `comb - q * scale` into one multiply-add, which rounds once: q and
the scale stay bit for bit, the error within 1e-6); `compressed_psum`'s sum
within rtol 1e-6, and within 1e-6 of its largest element where the ranks'
terms cancel (jit fuses that dot product too); the error-feedback
sum within 1% (the reference test's bound).  The port's mesh step against
its no-mesh step: the loss within 2e-5, the parameters after one AdamW step
within 1e-4 absolute: AdamW's first update is lr g / (|g| + eps), which a
gradient's rounding moves by up to lr/10 where |g| is within a few eps
(1e-8) of 0, and by far less elsewhere; a wrong gradient moves whole
leaves by lr (5e-4 at the first step).  The checkpoint: restored bit for
bit; a run resumed on another mesh continues the uninterrupted run's losses
within 2e-5.  `train` reads its batches from `_Batches`, seeded token
batches whose cursor resumes exactly (the host and engine pipelines drop
the rest of their pool on a resume, in both packages: ROADMAP C).
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import os
import pickle
import threading
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tests.util import run_with_devices

RANKS = 4
JOIN_S = 420  # the spawn's bound: a deadlocked collective fails the fixture
GRAD_REL = 1e-5
LOSS_ATOL = 2e-5
NORM_REL = 1e-5
PARAM_ATOL = 1e-4
B, S = 4, 32
SEED = 1
SMALL = {"dtype": "float32", "n_layers": 2}  # the smoke configs cut from 3 layers to 2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)  # test_system.py's
# (name, strategy): head-parallel and ZeRO attention, the sequence-parallel
# arm (n_kv 1), EP through _routed_local (tp) and _routed_2d (fsdp_ep), and
# 5 experts without EP (`moe._routed_global`, the ff on the data axis)
GRAD_CASES = [("qwen3", "tp"), ("qwen3", "fsdp"), ("qwen3_kv1", "tp"), ("deepseek", "tp"),
              ("deepseek", "fsdp_ep"), ("deepseek_e5", "tp")]
# where the reference's mesh step agrees with its own one-device step
STEP_CASES = [("qwen3", "tp"), ("qwen3", "fsdp"), ("qwen3_kv1", "tp"), ("deepseek", "fsdp_ep")]
TRAIN_STEPS, RESUME_AT = 3, 1
EF_STEPS = 20
# Adafactor with every leaf of 16 x 16 or more factored (the smoke widths
# are under its default 128): its vr / vc placed by the dims they keep
ADAFACTOR = dict(name="adafactor", factored_min_size=16)

REFERENCE = r'''
import dataclasses, os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_smoke_config
from repro.distributed.collectives import (compressed_psum, hierarchical_psum,
                                           make_compressed_dp_fn, quantize_int8)
from repro.distributed.compat import shard_map
from repro.distributed.sharding import ShardingCtx
from repro.models.model import forward_train
from repro.train.checkpoint import CheckpointManager
from repro.train.loop import make_train_step, train
from repro.train.optimizer import OptConfig, global_norm, init_opt_state


def config(spec):
    arch, changes = spec
    return dataclasses.replace(get_smoke_config(arch), **changes)


t0 = time.monotonic()  # the test process is still drawing the inputs
while not os.path.exists(D + "/inputs.pkl"):
    if os.path.exists(D + "/inputs.failed") or time.monotonic() - t0 > 600:
        raise SystemExit("the inputs were not written")
    time.sleep(0.05)
with open(D + "/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
mesh = jax.sharding.Mesh(devs, ("data", "model"))
pods = jax.sharding.Mesh(devs, ("pod", "data"))
rows = P(("pod", "data"), None)
out = {}

# the collectives, each rank's rows of a (pod, data)-sharded array
out["hier"] = np.asarray(jax.jit(shard_map(
    lambda v: hierarchical_psum(v, "data", "pod"), mesh=pods, in_specs=rows,
    out_specs=rows))(jnp.asarray(inp["hier"])))
out["quantize"] = [np.asarray(a) for a in jax.jit(quantize_int8)(
    jnp.asarray(inp["q_x"]), jnp.asarray(inp["q_err"]))]
tot, new_err = jax.jit(shard_map(
    lambda g, e: compressed_psum(g, e, "pod"), mesh=pods, in_specs=(rows, rows),
    out_specs=(rows, rows)))(jnp.asarray(inp["cps_g"]), jnp.asarray(inp["cps_err"]))
out["compressed"] = (np.asarray(tot), np.asarray(new_err))
dp = make_compressed_dp_fn(lambda b: {"w": jnp.sum(b, 0), "v": [b[0, 0] * 3.0]}, pods, "pod")
zeros = {"w": jnp.zeros(inp["dp_batch"].shape[1:]), "v": [jnp.zeros(inp["dp_batch"].shape[-1])]}
sums, _ = jax.jit(dp)(jnp.asarray(inp["dp_batch"]), zeros)
out["dp"] = jax.tree.map(np.asarray, sums)

# gradients of forward_train under the same mesh and strategy
batch = {"tokens": jnp.asarray(inp["tokens"])}
for name, strategy in GRAD_CASES:
    spec, params = inp[name]
    cfg = config(spec)
    ctx = ShardingCtx(mesh=mesh, strategy=strategy)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: forward_train(p, b, cfg, ctx), has_aux=True))(params, batch)
    out["grads", name, strategy] = (float(loss), jax.tree.map(np.asarray, grads),
                                    float(global_norm(grads)))

# make_train_step with two microbatches (a scan of value_and_grad)
optcfg = OptConfig(**OPT)
spec, params = inp["qwen3"]
cfg = dataclasses.replace(config(spec), microbatches=2)
_, _, m = jax.jit(make_train_step(cfg, optcfg, ShardingCtx(mesh=mesh)))(
    params, init_opt_state(params, optcfg), batch)
out["step mb2"] = (float(m["loss"]), float(m["grad_norm"]))

# train() resuming under a mesh: restore_latest(..., {"opt": None}) raises
ckpt = D + "/reference_ckpt"
cfg = config(spec)
CheckpointManager(ckpt).save(1, {"params": params, "opt": init_opt_state(params, optcfg)},
                             meta={"step": 1})
try:
    train(cfg, optcfg, None, steps=2, ctx=ShardingCtx(mesh=mesh), ckpt_dir=ckpt,
          log_fn=lambda s: None)
    out["resume"] = None
except Exception as e:
    out["resume"] = (type(e).__name__, str(e)[:200])
with open(D + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
'''


def _inputs(d):
    """The reference's parameters (numpy leaves), the batch, the
    collectives' inputs and the corpus, made in this process."""
    import dataclasses

    import jax

    from repro.configs import get_smoke_config
    from repro.models.model import init_params

    def draw(spec):
        cfg = dataclasses.replace(get_smoke_config(spec[0]), **spec[1])
        return spec, jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(SEED)))

    rng = np.random.default_rng(0)
    vocab = get_smoke_config("qwen3-1.7b").vocab
    inp = {"qwen3": draw(("qwen3-1.7b", SMALL)),
           "qwen3_kv1": draw(("qwen3-1.7b", dict(SMALL, n_kv=1))),
           "deepseek": draw(("deepseek-moe-16b", SMALL)),
           "deepseek_e5": draw(("deepseek-moe-16b", dict(SMALL, moe_experts=5))),
           "tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           # 5 rows a rank: the intra dim's reduce-scatter pads to 6
           "hier": rng.integers(-50, 50, (RANKS * 5, 6)).astype(np.float32),
           "q_x": (rng.standard_normal((8, 128)) * 3).astype(np.float32),
           "q_err": (rng.standard_normal((8, 128)) * 0.01).astype(np.float32),
           "cps_g": rng.standard_normal((RANKS, 128)).astype(np.float32),
           "cps_err": (rng.standard_normal((RANKS, 128)) * 0.01).astype(np.float32),
           "ef_g": rng.standard_normal((RANKS, 128)).astype(np.float32),
           "dp_batch": rng.standard_normal((2, 3, 8)).astype(np.float32)}
    with open(os.path.join(d, "inputs.tmp"), "wb") as f:
        pickle.dump(inp, f)
    os.replace(os.path.join(d, "inputs.tmp"), os.path.join(d, "inputs.pkl"))


class _Batches:
    """A pipeline for `train`: token batches drawn from seed 100 + i for
    the i-th batch, so that a restored cursor resumes exactly."""

    def __init__(self, vocab: int):
        self.vocab, self.i = vocab, 0

    def next_batch(self):
        rng = np.random.default_rng(100 + self.i)
        self.i += 1
        return {"tokens": torch.from_numpy(rng.integers(0, self.vocab, (B, S)).astype(np.int32))}

    def checkpoint_state(self) -> dict:
        return {"i": self.i}

    def restore_state(self, d: dict) -> None:
        self.i = d["i"]


def _wait_for_inputs(d):
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(d, "inputs.pkl")):
        if os.path.exists(os.path.join(d, "inputs.failed")) or time.monotonic() - t0 > 600:
            raise RuntimeError("the inputs were not written")
        time.sleep(0.05)


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().numpy()


def _tree_np(tree):
    from repro_torch.train.optimizer import tree_map

    return tree_map(_np, tree)


def _placements(tree, dims, ctx):
    """Every leaf's placements against `sharding_for(dims)`: the leaves'
    keys where they differ."""
    from repro_torch.distributed.sharding import sharding_for

    bad = []

    def walk(t, dm, key):
        if dm is None:  # left unplaced (the optimizer's step)
            return
        if isinstance(t, dict):
            for k in t:
                walk(t[k], dm[k], f"{key}/{k}")
        elif isinstance(t, list):
            for i, (a, b) in enumerate(zip(t, dm)):
                walk(a, b, f"{key}/{i}")
        else:
            place = sharding_for(dm, ctx, tuple(t.shape))
            if tuple(t.placements) != place:
                bad.append((key, str(t.placements), str(place)))

    walk(tree, dims, "")
    return bad


def _collectives(inp, out):
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.compat import make_mesh

    rank = dist.get_rank()
    pods = make_mesh((2, 2), ("pod", "data"), device="cpu")
    x = torch.from_numpy(inp["hier"][rank * 5:(rank + 1) * 5])
    flat = x.clone()
    dist.all_reduce(flat)
    out["hier"] = (coll.hierarchical_psum(x, "data", "pod", pods).numpy(), flat.numpy())
    out["quantize"] = [a.numpy() for a in coll.quantize_int8(torch.from_numpy(inp["q_x"]),
                                                             torch.from_numpy(inp["q_err"]))]
    tot, new_err = coll.compressed_psum(torch.from_numpy(inp["cps_g"][rank]),
                                        torch.from_numpy(inp["cps_err"][rank]), "pod", pods)
    out["compressed"] = (tot.numpy(), new_err.numpy())
    # the reference test's error feedback, over all four ranks as one pod dim
    ring = make_mesh((RANKS,), ("pod",), device="cpu")
    g = torch.from_numpy(inp["ef_g"][rank])
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g, dtype=torch.float64)
    for _ in range(EF_STEPS):
        s, err = coll.compressed_psum(g, err, "pod", ring)
        acc += s.double()
    exact = EF_STEPS * inp["ef_g"].astype(np.float64).sum(0)
    out["ef rel"] = float(np.abs(acc.numpy() - exact).max() / np.abs(exact).max())
    # make_compressed_dp_fn: each rank passes its pod's batch rows and its own error
    dp = coll.make_compressed_dp_fn(lambda b: {"w": b.sum(0), "v": [b[0, 0] * 3.0]}, pods, "pod")
    batch = torch.from_numpy(inp["dp_batch"][pods.get_local_rank("pod")][None])
    zeros = {"w": torch.zeros(batch.shape[1:]), "v": [torch.zeros(batch.shape[-1])]}
    sums, errs = dp(batch, zeros)
    out["dp"] = ({"w": sums["w"].numpy(), "v": [sums["v"][0].numpy()]},
                 {"w": errs["w"].numpy(), "v": [errs["v"][0].numpy()]})
    # the differentiable collectives: each backward is its forward's transpose
    out["transposes"] = _transposes(pods.get_group("data"))


def _transposes(group):
    """<w, f(x)> == <f^T(w), x> for each differentiable collective, each
    side summed over the group's ranks.  A replicated value (the sum's
    output gradient w, copy_to's input x) is the same on every rank and
    counts once."""
    from repro_torch.distributed import collectives as coll

    n = dist.get_world_size(group)
    res = {}
    for name, fn, shape, same_x, same_w in (
            ("all_to_all", coll.all_to_all, (n * 2, 3), False, False),
            ("all_gather", coll.all_gather, (2, 3), False, False),
            ("reduce_scatter", coll.reduce_scatter, (n * 2, 3), False, False),
            ("all_reduce_sum", coll.all_reduce_sum, (2, 3), False, True),
            ("copy_to", coll.copy_to, (2, 3), True, False)):
        gx_, gw_ = (torch.Generator().manual_seed(10 + (0 if same else dist.get_rank()))
                    for same in (same_x, same_w))
        x = torch.randn(shape, generator=gx_, dtype=torch.float64, requires_grad=True)
        y = fn(x, group)
        w = torch.randn(y.shape, generator=gw_, dtype=torch.float64)
        (gx,) = torch.autograd.grad(y, x, w)
        pair = torch.stack([torch.sum(w * y.detach()) / (n if same_w else 1),
                            torch.sum(gx * x.detach()) / (n if same_x else 1)])
        dist.all_reduce(pair, group=group)
        res[name] = pair.tolist()
    return res


def _cases(d):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardingCtx, shard_params
    from repro_torch.models import layers, model
    from repro_torch.models.model import param_dims, params_from_reference
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import CheckpointManager, _flatten
    from repro_torch.train.optimizer import (
        OptConfig,
        init_opt_state,
        opt_state_dims,
        tree_leaves,
    )

    def config(spec, **kw):
        return dataclasses.replace(get_smoke_config(spec[0]), **spec[1], **kw)

    torch.set_num_threads(1)
    _wait_for_inputs(d)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    _collectives(inp, out)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    batch = {"tokens": torch.from_numpy(inp["tokens"])}

    # gradients: _grads + shard_grads under the mesh, gathered; the
    # placements of each gradient that reaches a GLU MLP's down projection
    # through the output's constraint, partial or not on each mesh dim
    constrain_rows = layers.constrain_rows
    for name, strategy in GRAD_CASES:
        spec, params_np = inp[name]
        cfg = config(spec)
        ctx = ShardingCtx(mesh=mesh, strategy=strategy)
        params = shard_params(params_from_reference(params_np, device="cpu"), cfg, ctx)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        cotangents = []

        def spy(x, ctx):
            if x.requires_grad:
                x.register_hook(lambda g: cotangents.append([q.is_partial() for q in g.placements]))
            return constrain_rows(x, ctx)

        layers.constrain_rows = spy
        try:
            loss, _ = model.forward_train(params, batch, cfg, ctx)
            grads = loop.shard_grads(loop._grads(params, loss), cfg, ctx)
        finally:
            layers.constrain_rows = constrain_rows
        out["grads", name, strategy] = (float(loss.full_tensor()), _tree_np(grads),
                                        _placements(grads, param_dims(cfg), ctx),
                                        str(loss.placements))
        out["mlp cotangents", name, strategy] = cotangents

    # steps: the mesh step against the no-mesh step, from the same parameters
    for name, strategy in STEP_CASES + [("qwen3 mb2", "tp"), ("qwen3 adafactor", "tp")]:
        spec, params_np = inp[name.split()[0]]
        cfg = config(spec, microbatches=2 if name.endswith("mb2") else 1)
        ctx = ShardingCtx(mesh=mesh, strategy=strategy)
        optcfg = OptConfig(**OPT, **(ADAFACTOR if name.endswith("adafactor") else {}))
        res = {}
        for label, c in (("mesh", ctx), ("none", None)):
            params = params_from_reference(params_np, device="cpu")
            if c is not None:
                params = shard_params(params, cfg, c)
            state = init_opt_state(params, optcfg)
            params, state, m = loop.make_train_step(cfg, optcfg, c)(params, state, batch)
            res[label] = (float(m["loss"]), float(m["grad_norm"]), _tree_np(params),
                          type(m["loss"]).__name__, type(m["grad_norm"]).__name__)
            if c is not None:
                res["moment placements"] = _placements(
                    state, opt_state_dims(param_dims(cfg), params, optcfg), c)
        out["step", name, strategy] = res

    # checkpoints: train() under (2, 2) saves; restore and resume on (1, 4)
    optcfg = OptConfig(**OPT)
    spec, _ = inp["qwen3"]
    cfg = config(spec)
    tp = ShardingCtx(mesh=mesh, strategy="tp")
    wide = ShardingCtx(mesh=make_mesh((1, 4), ("data", "model"), device="cpu"), strategy="tp")
    quiet = dict(seed=SEED, log_every=10**9, log_fn=lambda s: None, device="cpu")

    def pipe():
        return _Batches(cfg.vocab)

    whole_dir, resume_dir = os.path.join(d, "ckpt_whole"), os.path.join(d, "ckpt_resume")
    whole = loop.train(cfg, optcfg, pipe(), steps=TRAIN_STEPS, ctx=tp, ckpt_dir=whole_dir,
                       ckpt_every=RESUME_AT, **quiet)["losses"]
    if dist.get_rank() == 0:  # the step-2 checkpoint alone, for the resumed run
        import shutil

        name = f"step_{RESUME_AT:08d}"
        shutil.copytree(os.path.join(whole_dir, name), os.path.join(resume_dir, name))
    dist.barrier()
    manager = CheckpointManager(resume_dir)
    template = {"params": model.init_params(cfg, 0, device="cpu")}
    template["opt"] = init_opt_state(template["params"], optcfg)
    dims = {"params": param_dims(cfg),
            "opt": opt_state_dims(param_dims(cfg), template["params"], optcfg)}
    restored, manifest = manager.restore_latest(template, wide, dims)
    stored, _ = manager._load_step(RESUME_AT, template)
    out["restored"] = {
        "step": manifest["meta"]["step"],
        "equal": all(np.array_equal(_np(leaf), stored[key]) for key, leaf in _flatten(restored)),
        "step leaf": type(restored["opt"]["step"]).__name__,
        "placements": _placements(restored, dims, wide),
        "arrays": {key: _np(leaf) for key, leaf in _flatten(restored)},
        "keys": sorted(stored),
    }
    logs = []
    resumed = loop.train(cfg, optcfg, pipe(), steps=TRAIN_STEPS, ctx=wide,
                         ckpt_dir=resume_dir, ckpt_every=10**9,
                         **dict(quiet, log_fn=logs.append))["losses"]
    out["train"] = {"whole": whole, "resumed": resumed, "logs": logs,
                    "resume dir": resume_dir}
    return out


def _rank(rank, d):
    out = None
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), RANKS),
                                rank=rank, world_size=RANKS)
        out = _cases(d)
    except Exception:
        out = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _join(procs, timeout_s: float):
    """Join the spawned ranks within `timeout_s`, or kill them and fail."""
    t0 = time.monotonic()
    while not procs.join(timeout=5):
        if time.monotonic() - t0 > timeout_s:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
            raise AssertionError(f"the ranks did not finish within {timeout_s} s (a collective "
                                 "that never met?)")


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train_mesh"))
    code = (REFERENCE.replace("D + ", repr(d) + " + ")
            .replace("GRAD_CASES", repr(GRAD_CASES)).replace("OPT)", repr(OPT) + ")"))
    ref_error = []

    def reference():
        try:
            assert "REFERENCE_OK" in run_with_devices(code, n_devices=RANKS, timeout=JOIN_S)
        except Exception as e:  # read below, in the test process
            ref_error.append(e)

    t = threading.Thread(target=reference)
    t.start()
    procs = mp.start_processes(_rank, args=(d,), nprocs=RANKS, start_method="spawn",
                               join=False)
    try:
        try:
            _inputs(d)
        except BaseException:
            open(os.path.join(d, "inputs.failed"), "w").close()
            raise
    finally:
        try:
            _join(procs, JOIN_S)
        finally:
            t.join(timeout=JOIN_S + 60)
    assert not t.is_alive(), "the reference run did not finish"
    if ref_error:
        raise ref_error[0]
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for r in ranks:
        assert "error" not in r, r["error"]
    with open(os.path.join(d, "reference.pkl"), "rb") as f:
        ref = pickle.load(f)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    return ranks, ref, inp


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_equal(r[key], first)
    return first


def _rel(got, want) -> float:
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves

    return tree_leaves(tree)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def test_hierarchical_psum_is_exact_and_equals_a_flat_all_reduce(mesh_results):
    ranks, ref, _ = mesh_results
    for rank, r in enumerate(ranks):
        got, flat = r["hier"]
        np.testing.assert_array_equal(got, ref["hier"][rank * 5:(rank + 1) * 5])
        np.testing.assert_array_equal(got, flat)


def _bits(a):
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


def test_quantize_int8_bit_for_bit(mesh_results):
    """q, the scale and the error against the reference run op by op, bit
    for bit; against its jitted run (the error's multiply-add fused), q and
    the scale bit for bit and the error within 1e-6."""
    import jax.numpy as jnp

    from repro.distributed.collectives import quantize_int8 as jquantize_int8

    ranks, ref, inp = mesh_results
    q, scale, err = _same_on_every_rank(ranks, "quantize")
    assert q.dtype == np.int8 and scale.dtype == err.dtype == np.float32
    eager = jquantize_int8(jnp.asarray(inp["q_x"]), jnp.asarray(inp["q_err"]))
    for got, want in zip((q, scale, err), eager):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    jq, jscale, jerr = ref["quantize"]
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(scale), _bits(jscale))
    np.testing.assert_allclose(err, jerr, rtol=0, atol=1e-6)


def test_compressed_psum_matches_the_reference(mesh_results):
    ranks, ref, _ = mesh_results
    tot_ref, err_ref = ref["compressed"]
    for rank, r in enumerate(ranks):
        tot, err = r["compressed"]
        # the two ranks' dequantized terms added in one rounding under jit:
        # within 1e-6 of the sum's scale where they cancel
        np.testing.assert_allclose(tot, tot_ref[rank], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(tot_ref[rank]).max()))
        np.testing.assert_allclose(err, err_ref[rank], rtol=0, atol=1e-6)  # jit's fused error


def test_compressed_psum_error_feedback_converges(mesh_results):
    """tests/test_distributed.py's 20 steps on the port: the accumulated
    int8 sums stay within 1% of the exact ones."""
    ranks, _, _ = mesh_results
    assert _same_on_every_rank(ranks, "ef rel") < 0.01


def test_compressed_dp_fn_sums_each_pods_gradients(mesh_results):
    """Each rank passes its pod's batch rows and its own error tree; the
    sums are the reference's, and each rank keeps its own error."""
    ranks, ref, _ = mesh_results
    for r in ranks:
        sums, errs = r["dp"]
        np.testing.assert_allclose(sums["w"], ref["dp"]["w"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(sums["v"][0], ref["dp"]["v"][0], rtol=1e-6, atol=1e-7)
    assert not np.array_equal(ranks[0]["dp"][1]["w"], ranks[2]["dp"][1]["w"])  # pods differ
    np.testing.assert_array_equal(ranks[0]["dp"][1]["w"], ranks[1]["dp"][1]["w"])  # one pod


@pytest.mark.parametrize("name", ["all_to_all", "all_gather", "reduce_scatter",
                                  "all_reduce_sum", "copy_to"])
def test_each_collectives_backward_is_its_transpose(mesh_results, name):
    """<w, f(x)> = <f'(w), x> summed over each data dim group of the
    (pod, data) mesh, in float64."""
    ranks, _, _ = mesh_results
    for r in ranks:
        lhs, rhs = r["transposes"][name]
        assert lhs == pytest.approx(rhs, rel=1e-12)


# ---------------------------------------------------------------------------
# gradients and steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,strategy", GRAD_CASES)
def test_gradients_match_the_reference_under_the_same_mesh(mesh_results, name, strategy):
    """The port's `_grads` + `shard_grads`, gathered, against `jax.grad` of
    the reference's forward_train under the same mesh and strategy, leaf by
    leaf; each gradient placed as its parameter is stored."""
    ranks, ref, _ = mesh_results
    loss, grads, bad, loss_place = _same_on_every_rank(ranks, ("grads", name, strategy))
    want_loss, want, _ = ref["grads", name, strategy]
    assert loss == pytest.approx(want_loss, abs=LOSS_ATOL)
    assert bad == [] and loss_place == "(Replicate(), Replicate())"
    got_l, want_l = _leaves(grads), _leaves(want)
    assert len(got_l) == len(want_l)
    worst = max(_rel(g, w) for g, w in zip(got_l, want_l))
    assert worst <= GRAD_REL, worst


@pytest.mark.parametrize("name", ["qwen3", "deepseek"])
def test_mlp_cotangent_reaches_wo_reduced_on_the_model_axis(mesh_results, name):
    """Under tp the gradient that reaches a GLU MLP's down projection (the
    dense MLPs, and deepseek's shared experts) is reduced on the model axis
    at the MLP's output (`sharding.constrain_rows`, as the transpose
    of the reference's constraint), never `Partial` there, so wo's products
    run on the rank's ff shard; the gradients of wo and wg equal the
    reference's under the same mesh."""
    ranks, ref, _ = mesh_results
    model_dim = 1  # the (data, model) mesh
    cotangents = _same_on_every_rank(ranks, ("mlp cotangents", name, "tp"))
    assert cotangents and not any(partial[model_dim] for partial in cotangents), cotangents
    _, grads, _, _ = ranks[0]["grads", name, "tp"]
    _, want, _ = ref["grads", name, "tp"]
    checked = 0
    for got_seg, want_seg in zip(grads["segments"], want["segments"]):
        for key in ("wo2", "wg", "shared_wo", "shared_wg"):
            if key in want_seg:
                assert _rel(got_seg[key], want_seg[key]) <= GRAD_REL, key
                checked += 1
    assert checked >= 2


@pytest.mark.parametrize("name,strategy", STEP_CASES)
def test_mesh_step_matches_the_reference_and_no_mesh(mesh_results, name, strategy):
    """make_train_step under the mesh: its loss and grad norm (plain
    tensors, the same on every rank) against the reference's; its loss and
    parameters after one AdamW step against the port's no-mesh step; the
    moments placed as their parameters."""
    ranks, ref, _ = mesh_results
    res = _same_on_every_rank(ranks, ("step", name, strategy))
    want_loss, _, want_norm = ref["grads", name, strategy]
    loss, norm, params, loss_t, norm_t = res["mesh"]
    assert (loss_t, norm_t) == ("Tensor", "Tensor")
    assert loss == pytest.approx(want_loss, abs=LOSS_ATOL)
    assert norm == pytest.approx(want_norm, rel=NORM_REL)
    loss1, norm1, params1, _, _ = res["none"]
    assert loss == pytest.approx(loss1, abs=LOSS_ATOL)
    assert norm == pytest.approx(norm1, rel=NORM_REL)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(_leaves(params), _leaves(params1)))
    assert diff <= PARAM_ATOL, diff
    assert res["moment placements"] == []


def test_adafactor_mesh_step_matches_no_mesh(mesh_results):
    """Adafactor under tp (its factored second moments placed by the dims
    they keep, the updates stored back into each parameter's placements)
    against the port's no-mesh Adafactor step, which tests/test_torch_
    optimizer.py holds to the reference."""
    ranks, _, _ = mesh_results
    res = _same_on_every_rank(ranks, ("step", "qwen3 adafactor", "tp"))
    loss, norm, params, _, _ = res["mesh"]
    loss1, norm1, params1, _, _ = res["none"]
    assert loss == pytest.approx(loss1, abs=LOSS_ATOL)
    assert norm == pytest.approx(norm1, rel=NORM_REL)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(_leaves(params), _leaves(params1)))
    assert diff <= PARAM_ATOL, diff
    assert res["moment placements"] == []


def test_microbatched_mesh_step_matches_the_reference(mesh_results):
    """microbatches=2: the gradients accumulate from DTensor zeros and are
    placed once; the loss and grad norm against the reference's scanned
    step, the parameters against the port's no-mesh step."""
    ranks, ref, _ = mesh_results
    res = _same_on_every_rank(ranks, ("step", "qwen3 mb2", "tp"))
    want_loss, want_norm = ref["step mb2"]
    loss, norm, params, _, _ = res["mesh"]
    assert loss == pytest.approx(want_loss, abs=LOSS_ATOL)
    assert norm == pytest.approx(want_norm, rel=NORM_REL)
    loss1, _, params1, _, _ = res["none"]
    assert loss == pytest.approx(loss1, abs=LOSS_ATOL)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(_leaves(params), _leaves(params1)))
    assert diff <= PARAM_ATOL, diff


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------


def test_checkpoint_restores_onto_another_mesh_bit_for_bit(mesh_results):
    """train() under (data 2, model 2) saved step 1; restore_latest onto
    (data 1, model 4) gives the stored arrays bit for bit, every leaf placed
    by spec_for on the new mesh (the step a plain tensor)."""
    ranks, _, _ = mesh_results
    for r in ranks:
        got = r["restored"]
        assert got["step"] == RESUME_AT and got["equal"] and got["placements"] == []
        assert got["step leaf"] == "Tensor"
    for r in ranks[1:]:
        for key, a in r["restored"]["arrays"].items():
            np.testing.assert_array_equal(a, ranks[0]["restored"]["arrays"][key])


def test_reference_reads_the_ports_mesh_checkpoint(mesh_results):
    import jax

    from repro.configs import get_smoke_config as jget_smoke
    from repro.models.model import init_params as jinit_params
    from repro.train.checkpoint import CheckpointManager as JManager
    from repro.train.checkpoint import _flatten as jflatten
    from repro.train.optimizer import OptConfig as JOptConfig
    from repro.train.optimizer import init_opt_state as jinit_opt_state

    ranks, _, inp = mesh_results
    import dataclasses

    cfg = dataclasses.replace(jget_smoke("qwen3-1.7b"), **SMALL)
    params = jinit_params(cfg, jax.random.PRNGKey(0))
    template = {"params": params, "opt": jinit_opt_state(params, JOptConfig(**OPT))}
    tree, manifest = JManager(ranks[0]["train"]["resume dir"]).restore_latest(template)
    assert manifest["meta"]["step"] == RESUME_AT
    arrays = ranks[0]["restored"]["arrays"]
    flat = jflatten(tree)
    assert sorted(k for k, _ in flat) == sorted(arrays) == ranks[0]["restored"]["keys"]
    for key, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), arrays[key])


def test_resumed_train_on_another_mesh_continues_the_losses(mesh_results):
    ranks, _, _ = mesh_results
    got = _same_on_every_rank(ranks, "train")
    assert f"[train] resumed from step {RESUME_AT}" in got["logs"]
    assert len(got["whole"]) == TRAIN_STEPS and len(got["resumed"]) == TRAIN_STEPS - RESUME_AT
    np.testing.assert_allclose(got["resumed"], got["whole"][RESUME_AT:], atol=LOSS_ATOL, rtol=0)


def test_reference_train_cannot_resume_under_a_mesh(mesh_results):
    """A reference trait (ROADMAP C): its train() passes the optimizer
    state's dims as None (`repro/train/loop.py:205-209`), and `reshard`'s
    `jax.tree.map` raises there.  The port places the moments by their
    parameters' dims instead (above)."""
    _, ref, _ = mesh_results
    name, msg = ref["resume"]
    assert name == "ValueError" and "Expected dict, got None" in msg
