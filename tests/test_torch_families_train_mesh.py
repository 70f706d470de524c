"""The SSM, hybrid, enc-dec and VLM families trained under a device mesh
(ROADMAP A.6b-ii) on 4 gloo ranks on the CPU, against the JAX package under
4 host devices and against the port without a mesh: gradients through the
SSD mixer's batch-row body, the hybrid's mix, the encoder and the
cross-attention, llava's vision prefix; `make_train_step`; a hybrid
checkpoint re-meshed.

The pattern of tests/test_torch_train_mesh.py: one spawn of 4 ranks on a
`FileStore` in a temporary directory, a (data=2, model=2) mesh from
`distributed.compat.make_mesh(device="cpu")`; the reference meanwhile under
`tests.util.run_with_devices(n_devices=4)` on a plain `jax.sharding.Mesh`
(Auto axes).  Parameters are drawn once by the reference's `init_params`
(the smoke configs at float32 as in tests/test_torch_families_mesh.py:
mamba2 and llava at 2 layers, hymba at 2 with one global and one windowed
segment, and its sequence-parallel variant, whisper's 2 + 2) and carried to
the port by `params_from_reference`.  The batch is 4 x 40 tokens (past
hymba's window of 32), with whisper's 4 x 48 frames and llava's 4 x 16
vision embeddings.  The join has a timeout, so a collective that deadlocks
fails the fixture.

Tolerances, those of tests/test_torch_train_mesh.py: gradients by relative
L2 per leaf within 1e-5; losses within 2e-5 absolute and the gradient norm
within 1e-5 relative; the parameters after one AdamW step within 1e-4 of the
port's no-mesh step (AdamW's first update lr g / (|g| + eps) moves by up to
lr/10 where |g| is within a few eps of 0; a wrong gradient moves whole
leaves by lr).  The checkpoint restored bit for bit.
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses
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
B, S = 4, 40
SEED = 1
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)  # test_system.py's
F32 = {"dtype": "float32"}
FAMILIES = {
    "mamba2": ("mamba2-370m", dict(F32, n_layers=2)),
    "hymba": ("hymba-1.5b", dict(F32, n_layers=2, global_layers=(0,))),
    "hymba_seq": ("hymba-1.5b", dict(F32, n_layers=2, global_layers=(0,), n_heads=5, n_kv=1,
                                     ssm_heads=5)),
    "whisper": ("whisper-base", F32),
    "llava": ("llava-next-34b", dict(F32, n_layers=2)),
}
STEP_CASES = [(n, s) for n in ("mamba2", "hymba", "whisper", "llava") for s in ("tp", "fsdp")]
# the steps' cases, and hymba's sequence-parallel arm (with its replicated inner)
GRAD_CASES = STEP_CASES + [("hymba_seq", "tp")]

REFERENCE = r'''
import dataclasses, os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.distributed.sharding import ShardingCtx
from repro.models.model import forward_train
from repro.train.optimizer import global_norm


t0 = time.monotonic()  # the test process is still drawing the inputs
while not os.path.exists(D + "/inputs.pkl"):
    if os.path.exists(D + "/inputs.failed") or time.monotonic() - t0 > 600:
        raise SystemExit("the inputs were not written")
    time.sleep(0.05)
with open(D + "/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for name, strategy in GRAD_CASES:
    (arch, changes), params = inp[name]
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    ctx = ShardingCtx(mesh=mesh, strategy=strategy)
    batch = {k: jnp.asarray(v) for k, v in inp["batch", name].items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: forward_train(p, b, cfg, ctx), has_aux=True))(params, batch)
    out["grads", name, strategy] = (float(loss), jax.tree.map(np.asarray, grads),
                                    float(global_norm(grads)))
with open(D + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
'''


def _config(spec):
    from repro.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(spec[0]), **spec[1])


def _batch(cfg, rng) -> dict:
    """B x S tokens, with an enc-dec model's frames or a VLM's vision
    embeddings (float32)."""
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def _inputs(d):
    """The reference's parameters (numpy leaves) and the batches, made in
    this process."""
    import jax

    from repro.models.model import init_params

    rng = np.random.default_rng(0)
    inp = {}
    for name, spec in FAMILIES.items():
        cfg = _config(spec)
        inp[name] = (spec, jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(SEED))))
        inp["batch", name] = _batch(cfg, rng)
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


def _cases(d):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardingCtx, shard_params
    from repro_torch.models import model
    from repro_torch.models.model import param_dims, params_from_reference
    from repro_torch.train import loop
    from repro_torch.train.checkpoint import CheckpointManager, _flatten
    from repro_torch.train.optimizer import OptConfig, init_opt_state, opt_state_dims, tree_leaves

    def config(spec):
        return dataclasses.replace(get_smoke_config(spec[0]), **spec[1])

    torch.set_num_threads(1)
    _wait_for_inputs(d)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    ctxs = {s: ShardingCtx(mesh=mesh, strategy=s) for s in ("tp", "fsdp")}

    def batch_of(name):
        return {k: torch.from_numpy(v) for k, v in inp["batch", name].items()}

    # gradients: _grads + shard_grads under the mesh, gathered
    for name, strategy in GRAD_CASES:
        spec, params_np = inp[name]
        cfg, ctx = config(spec), ctxs[strategy]
        params = shard_params(params_from_reference(params_np, device="cpu"), cfg, ctx)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = model.forward_train(params, batch_of(name), cfg, ctx)
        grads = loop.shard_grads(loop._grads(params, loss), cfg, ctx)
        out["grads", name, strategy] = (float(loss.full_tensor()), _tree_np(grads),
                                        _placements(grads, param_dims(cfg), ctx),
                                        str(loss.placements))

    # steps: the mesh step against the no-mesh step, from the same parameters
    optcfg = OptConfig(**OPT)
    for name, strategy in STEP_CASES:
        spec, params_np = inp[name]
        cfg, ctx = config(spec), ctxs[strategy]
        res = {}
        for label, c in (("mesh", ctx), ("none", None)):
            params = params_from_reference(params_np, device="cpu")
            if c is not None:
                params = shard_params(params, cfg, c)
            state = init_opt_state(params, optcfg)
            params, state, m = loop.make_train_step(cfg, optcfg, c)(params, state, batch_of(name))
            res[label] = (float(m["loss"]), float(m["grad_norm"]), _tree_np(params))
            if c is not None:
                res["moment placements"] = _placements(
                    state, opt_state_dims(param_dims(cfg), params, optcfg), c)
        out["step", name, strategy] = res

    # a hybrid checkpoint: train() under tp saves step 1; restored under fsdp
    cfg = config(FAMILIES["hymba"])
    ckpt = os.path.join(d, "ckpt")
    loop.train(cfg, optcfg, _Batches(cfg.vocab), steps=1, ctx=ctxs["tp"], ckpt_dir=ckpt,
               ckpt_every=1, seed=SEED, log_every=10**9, log_fn=lambda s: None, device="cpu")
    dist.barrier()
    manager = CheckpointManager(ckpt)
    template = {"params": model.init_params(cfg, 0, device="cpu")}
    template["opt"] = init_opt_state(template["params"], optcfg)
    dims = {"params": param_dims(cfg),
            "opt": opt_state_dims(param_dims(cfg), template["params"], optcfg)}
    restored, manifest = manager.restore_latest(template, ctxs["fsdp"], dims)
    stored, _ = manager._load_step(1, template)
    out["restored"] = {
        "step": manifest["meta"]["step"],
        "equal": all(np.array_equal(_np(leaf), stored[key]) for key, leaf in _flatten(restored)),
        "keys": sorted(key for key, _ in _flatten(restored)) == sorted(stored),
        "placements": _placements(restored, dims, ctxs["fsdp"]),
        "sharded": sorted({str(leaf.placements) for _, leaf in _flatten(restored)
                           if hasattr(leaf, "placements")}),
    }
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
    d = str(tmp_path_factory.mktemp("families_train_mesh"))
    code = REFERENCE.replace("D + ", repr(d) + " + ").replace("GRAD_CASES", repr(GRAD_CASES))
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
    return ranks, ref


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


@pytest.mark.parametrize("name,strategy", GRAD_CASES)
def test_gradients_match_the_reference_under_the_same_mesh(mesh_results, name, strategy):
    """The port's `_grads` + `shard_grads`, gathered, against `jax.grad` of
    the reference's forward_train under the same mesh and strategy, leaf by
    leaf (the SSM's replicated leaves, `vis_proj` and `enc_final_ln`
    among them); each gradient placed as its parameter is stored."""
    ranks, ref = mesh_results
    loss, grads, bad, loss_place = _same_on_every_rank(ranks, ("grads", name, strategy))
    want_loss, want, _ = ref["grads", name, strategy]
    assert loss == pytest.approx(want_loss, abs=LOSS_ATOL)
    assert bad == [] and loss_place == "(Replicate(), Replicate())"
    got_l, want_l = _leaves(grads), _leaves(want)
    assert len(got_l) == len(want_l)
    worst = max(_rel(g, w) for g, w in zip(got_l, want_l))
    assert worst <= GRAD_REL, worst


@pytest.mark.parametrize("name,strategy", STEP_CASES)
def test_mesh_step_matches_the_reference_and_no_mesh(mesh_results, name, strategy):
    """make_train_step under the mesh: its loss and grad norm against the
    reference's under the same mesh; its loss and parameters after one
    AdamW step against the port's no-mesh step; the moments placed as their
    parameters."""
    ranks, ref = mesh_results
    res = _same_on_every_rank(ranks, ("step", name, strategy))
    want_loss, _, want_norm = ref["grads", name, strategy]
    loss, norm, params = res["mesh"]
    assert loss == pytest.approx(want_loss, abs=LOSS_ATOL)
    assert norm == pytest.approx(want_norm, rel=NORM_REL)
    loss1, norm1, params1 = res["none"]
    assert loss == pytest.approx(loss1, abs=LOSS_ATOL)
    assert norm == pytest.approx(norm1, rel=NORM_REL)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(_leaves(params), _leaves(params1)))
    assert diff <= PARAM_ATOL, diff
    assert res["moment placements"] == []


def test_hybrid_checkpoint_saved_under_tp_restores_under_fsdp_bit_for_bit(mesh_results):
    """train() on hymba under (data 2, model 2) tp saved step 1; restored
    onto the same ranks under fsdp, every leaf (the `s_` SSM leaves, `na`,
    `ns`, `beta_*` among them) equals the stored array bit for bit, placed
    by spec_for under fsdp (a parameter's placements follow its dims
    whatever the strategy)."""
    ranks, _ = mesh_results
    for r in ranks:
        got = r["restored"]
        assert got["step"] == 1 and got["equal"] and got["keys"] and got["placements"] == []
        # the stacked (L, D, ...) projections: D over data, heads or inner over model
        assert "(Shard(dim=1), Shard(dim=2))" in got["sharded"]
