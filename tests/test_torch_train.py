"""The port's training slice (`repro_torch.models.model.forward_train`,
`layers.softmax_xent`, `repro_torch.train.loop`, `repro_torch.launch.train`)
against the JAX package's, on parameters converted by
`params_from_reference`: the loss, packed ≡ tokens, gradients, whole train
steps (1 and 2 microbatches; whisper's and llava's on batches that carry
frames or vision embeddings), remat, the smoke train step of the four dense
architectures, `tests/test_system.py::test_train_e2e_with_datapath`, a
resume of the JAX package's training run by the port, and the launcher.

Tolerances:
  * float32 loss and logits: atol 2e-5 (the serving slice's bound: XLA and
    torch sum in other orders; measured ~1e-6);
  * bf16 loss: 5e-2 (tests/test_models.py's bound for bf16 paths);
  * float32 gradients: relative L2 <= 1e-5 per leaf (the same float32
    rounding carried through the backward; measured <= 1e-6);
  * parameters after whole AdamW steps: relative L2 <= 1e-4 per leaf.  The
    first Adam step moves every element by lr * sign(g), so an element
    whose gradient lies within rounding of 0 may step by lr the other way:
    one such element moves its leaf by 2 lr = 6e-4 against a norm of ~4,
    1.5e-4 relative at worst and far less for most leaves (measured <=
    5.3e-7 at these seeds, no flip); grads and the optimizer on identical
    grads are compared tightly elsewhere (test_torch_optimizer.py);
  * the resumed run's losses: relative 1e-5 (the same parameters, moments
    and batches, rounded apart by a few ulps per step).
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data.corpus import write_corpus as jwrite_corpus
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.lakeformat.encodings import bitpack_encode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train.loop import make_train_step as jmake_train_step
from repro.train.loop import train as jtrain
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro_torch.configs import get_smoke_config
from repro_torch.data.corpus import write_corpus
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.kernels import ops
from repro_torch.models import layers, model
from repro_torch.train.loop import make_train_step, train
from repro_torch.train.optimizer import OptConfig, init_opt_state, tree_leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ["qwen3-1.7b", "granite-3-8b", "gemma-7b", "mistral-large-123b"]
F32_ATOL = 2e-5
BF16_ATOL = 5e-2
GRAD_REL = 1e-5
PARAM_REL = 1e-4
RESUME_REL = 1e-5
B, S = 2, 64


def _configs(arch, **kw):
    cj, ct = jget_smoke(arch), get_smoke_config(arch)
    return dataclasses.replace(cj, **kw), dataclasses.replace(ct, **kw)


def _params(cj, seed):
    pj = jmodel.init_params(cj, jax.random.PRNGKey(seed))
    return pj, model.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _pairs(port_tree, ref_tree):
    """(port leaf as float32 numpy, reference leaf) in the reference's order."""
    return [(t.detach().float().numpy(), np.asarray(j, np.float32))
            for t, j in zip(tree_leaves(port_tree), jax.tree.leaves(ref_tree))]


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_with_a_padded_vocab(masked):
    """Vp 640 over a real vocab of 515: value and gradient, the padded
    rows' gradient 0 on both sides."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 17, 640)) * 4).astype(np.float32)
    labels = rng.integers(0, 515, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.7).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want, jg = jax.value_and_grad(lambda lg: jlayers.softmax_xent(
        lg, jnp.asarray(labels), 515, jm))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = layers.softmax_xent(lt, torch.from_numpy(labels), 515, tm)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(want), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), atol=1e-7, rtol=1e-5)
    assert not lt.grad[..., 515:].any() and not np.asarray(jg)[..., 515:].any()


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma-7b"])
def test_forward_train_against_reference(arch, dtype):
    cj, ct = _configs(arch, dtype=dtype)
    pj, pt = _params(cj, 0)
    toks = _tokens(cj, 1)
    lj, mj = jmodel.forward_train(pj, {"tokens": jnp.asarray(toks)}, cj)
    lt, mt = model.forward_train(pt, {"tokens": torch.from_numpy(toks)}, ct)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(float(lt), float(lj), atol=atol, rtol=0)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), atol=atol, rtol=0)
    assert float(mt["aux_loss"]) == float(mj["aux_loss"]) == 0.0
    assert int(mt["tokens"]) == int(mj["tokens"]) == B * S
    assert mt["tokens"].dtype == torch.int32 and lt.dtype == torch.float32


def test_packed_batch_equals_tokens_bit_for_bit():
    """A bit-packed batch (k = 9 for vocab 512) goes through one bitunpack
    and gives the tokens' loss and gradients bit for bit; the reference's
    packed loss agrees within the float32 bound."""
    cj, ct = _configs("qwen3-1.7b", dtype="float32")
    pj, pt = _params(cj, 2)
    s = 4096  # block-aligned
    toks = _tokens(cj, 2, b=B, s=s)
    k = model.token_bits(ct)
    packed = np.stack([bitpack_encode(toks[i].astype(np.int64), k) for i in range(B)])
    assert model.packed_token_shape(ct, B, s) == packed.shape

    def loss_and_grads(batch):
        tree_map(lambda p: p.requires_grad_(True), pt)
        loss, _ = model.forward_train(pt, batch, ct)
        return loss, torch.autograd.grad(loss, tree_leaves(pt))

    ops.reset_dispatch_count()
    l_packed, g_packed = loss_and_grads({"packed": torch.from_numpy(packed.view(np.int32))})
    assert ops.dispatch_count() == 1
    l_tokens, g_tokens = loss_and_grads({"tokens": torch.from_numpy(toks)})
    assert torch.equal(l_packed, l_tokens)
    assert all(torch.equal(a, b) for a, b in zip(g_packed, g_tokens))
    lj, _ = jmodel.forward_train(pj, {"packed": jnp.asarray(packed)}, cj)
    np.testing.assert_allclose(float(l_packed.detach()), float(lj), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-8b"])
def test_grads_against_jax_grad(arch):
    """float32 gradients of every leaf, the tied embedding and granite's
    odd vocab (515 padded to 2,048) included."""
    cj, ct = _configs(arch, dtype="float32")
    pj, pt = _params(cj, 3)
    toks = _tokens(cj, 3)
    gj = jax.grad(lambda p: jmodel.forward_train(p, {"tokens": jnp.asarray(toks)}, cj)[0])(pj)
    tree_map(lambda p: p.requires_grad_(True), pt)
    lt, _ = model.forward_train(pt, {"tokens": torch.from_numpy(toks)}, ct)
    gt = torch.autograd.grad(lt, tree_leaves(pt))
    assert len(gt) == len(jax.tree.leaves(gj))
    for got, want in zip(gt, jax.tree.leaves(gj)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= GRAD_REL
    # padded vocab rows receive no gradient
    assert not gt[0][cj.vocab:].any() and not np.asarray(jax.tree.leaves(gj)[0])[cj.vocab:].any()


def test_grads_are_the_parameters_dtype():
    _, ct = _configs("qwen3-1.7b")
    params = model.init_params(ct, 0, device="cpu")
    tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = model.forward_train(params, {"tokens": torch.from_numpy(_tokens(ct, 0))}, ct)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert all(g.dtype == torch.bfloat16 for g in grads)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_against_reference(microbatches):
    cj, ct = _configs("qwen3-1.7b", dtype="float32", microbatches=microbatches)
    pj, pt = _params(cj, 4)
    optkw = dict(lr=3e-4, warmup_steps=1, total_steps=10)
    toks = _tokens(cj, 4, b=4)
    jstep = jax.jit(jmake_train_step(cj, JOptConfig(**optkw), None))
    tstep = make_train_step(ct, OptConfig(**optkw))
    js, ts = jinit_opt_state(pj, JOptConfig(**optkw)), init_opt_state(pt, OptConfig(**optkw))
    for i in range(2):
        pj, js, mj = jstep(pj, js, {"tokens": jnp.asarray(toks)})
        pt, ts, mt = tstep(pt, ts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    for got, want in _pairs(pt, pj):
        assert _rel(got, want) <= PARAM_REL


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_train_step_with_family_inputs_against_reference(arch):
    """Two microbatches of 2 on batches that carry whisper's frames
    (`enc_embeds`) or llava's vision embeddings (`embeds`), bfloat16 inputs
    to a float32 model as tests/test_models.py makes them: `make_train_step`
    splits every batch key by microbatch as the reference's does, and two
    steps match `jax.jit(make_train_step)`'s loss (F32_ATOL), grad norm and
    parameters (PARAM_REL)."""
    cj, ct = _configs(arch, dtype="float32", microbatches=2)
    pj, pt = _params(cj, 8)
    optkw = dict(lr=3e-4, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(8)
    toks = _tokens(cj, 8, b=4)
    key = "enc_embeds" if cj.is_encdec else "embeds"
    n = cj.encoder_seq if cj.is_encdec else cj.vision_tokens
    extra = rng.standard_normal((4, n, cj.d_model)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), key: jnp.asarray(extra, jnp.bfloat16)}
    tbatch = {"tokens": torch.from_numpy(toks), key: torch.from_numpy(extra).bfloat16()}
    jstep = jax.jit(jmake_train_step(cj, JOptConfig(**optkw), None))
    tstep = make_train_step(ct, OptConfig(**optkw))
    js, ts = jinit_opt_state(pj, JOptConfig(**optkw)), init_opt_state(pt, OptConfig(**optkw))
    for _ in range(2):
        pj, js, mj = jstep(pj, js, jbatch)
        pt, ts, mt = tstep(pt, ts, tbatch)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
    for got, want in _pairs(pt, pj):
        assert _rel(got, want) <= PARAM_REL


def test_microbatches_accumulate_the_whole_batch():
    """2 microbatches of 2 against 1 batch of 4: the mean of the two halves'
    mean losses is the whole batch's, and so are the averaged grads."""
    _, c1 = _configs("qwen3-1.7b", dtype="float32")
    c2 = dataclasses.replace(c1, microbatches=2)
    optcfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    toks = torch.from_numpy(_tokens(c1, 5, b=4))
    out = []
    for cfg in (c1, c2):
        params = model.init_params(cfg, 5, device="cpu")
        state = init_opt_state(params, optcfg)
        out.append(make_train_step(cfg, optcfg)(params, state, {"tokens": toks}))
    np.testing.assert_allclose(float(out[1][2]["loss"]), float(out[0][2]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(out[1][2]["grad_norm"]), float(out[0][2]["grad_norm"]),
                               rtol=1e-5)


@pytest.mark.parametrize("remat_policy", ["full", "dots"])
def test_remat_is_bit_identical(remat_policy):
    """On the CPU recomputation repeats the same operations: the loss and
    every gradient equal the run without remat bit for bit, and "dots"
    equals "full"."""
    _, ct = _configs("qwen3-1.7b", dtype="float32")
    toks = torch.from_numpy(_tokens(ct, 6))
    out = []
    for cfg in (ct, dataclasses.replace(ct, remat=True, remat_policy=remat_policy)):
        params = model.init_params(cfg, 6, device="cpu")
        tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = model.forward_train(params, {"tokens": toks}, cfg)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("remat_policy", ["full", "dots"])
def test_remat_carries_gradients_to_the_encoder(remat_policy):
    """whisper smoke at float32: the encoder's output enters every
    checkpointed decoder layer as an argument, so with remat the loss and
    every gradient, the encoder's leaves and `enc_final_ln` included, equal
    the run without remat bit for bit, and the encoder's are not zero."""
    _, ct = _configs("whisper-base", dtype="float32")
    rng = np.random.default_rng(7)
    batch = {"tokens": torch.from_numpy(_tokens(ct, 7)),
             "enc_embeds": torch.from_numpy(
                 rng.standard_normal((B, ct.encoder_seq, ct.d_model)).astype(np.float32))}
    out = []
    for cfg in (ct, dataclasses.replace(ct, remat=True, remat_policy=remat_policy)):
        params = model.init_params(cfg, 7, device="cpu")
        tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = model.forward_train(params, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((loss, dict(zip(map(id, tree_leaves(params)), grads)), params))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1].values(), out[1][1].values()))
    grads, params = out[1][1], out[1][2]
    for leaf in (params["enc_final_ln"], *params["segments"][0].values()):  # the encoder's
        assert grads[id(leaf)].abs().max() > 0


def test_dots_policy_saves_only_the_unbatched_matmuls():
    from repro_torch.models import transformer

    assert transformer._save_dots(None, torch.ops.aten.mm.default).name == "MUST_SAVE"
    for op in (torch.ops.aten.bmm.default, torch.ops.aten.softmax.int,
               torch.ops.aten.mul.Tensor):
        assert transformer._save_dots(None, op).name == "PREFER_RECOMPUTE"


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_and_train_step(arch):
    """tests/test_models.py's smoke train step, on the port (bf16)."""
    cfg = get_smoke_config(arch)
    params = model.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 0))}
    loss, _ = model.forward_train(params, batch, cfg)
    assert torch.isfinite(loss), arch
    assert 3.0 < float(loss) < 12.0, (arch, float(loss))  # ~uniform over vocab at init
    optcfg = OptConfig(warmup_steps=1, total_steps=10)
    embed0 = params["embed"].float().clone()
    _, _, m = make_train_step(cfg, optcfg)(params, init_opt_state(params, optcfg), batch)
    assert torch.isfinite(m["loss"])
    assert not any(p.requires_grad for p in tree_leaves(params))  # as init_params left them
    assert float((params["embed"].float() - embed0).abs().max()) > 0, arch


@pytest.fixture
def one_rank_mesh():
    """A (data 1, model 1) mesh over a gloo process group of one rank in
    this process, torn down after."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import make_mesh

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_mesh_train_step_equals_no_mesh_bit_for_bit(arch, one_rank_mesh):
    """Two float32 steps at 2 layers under a (1, 1) mesh (DTensor parameters
    and moments, shard_grads, the loss and grad norm plain) against two
    without it: the same losses, grad norms and parameters, bit for bit (4
    ranks: tests/test_torch_train_mesh.py; bf16 at full width: chip_smoke
    phase D)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import shard_params

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", n_layers=2)
    optcfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 3))}
    runs = {}
    for label, ctx in (("mesh", ShardingCtx(mesh=one_rank_mesh)), ("none", None)):
        params = model.init_params(cfg, 0, device="cpu")
        if ctx is not None:
            params = shard_params(params, cfg, ctx)
        state = init_opt_state(params, optcfg)
        step = make_train_step(cfg, optcfg, ctx)
        metrics = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            assert not isinstance(m["loss"], DTensor) and not isinstance(m["grad_norm"], DTensor)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if ctx is not None:
            assert all(isinstance(x, DTensor) for x in tree_leaves(state["m"]))
        runs[label] = metrics, [p.full_tensor() if isinstance(p, DTensor) else p
                                for p in tree_leaves(params)]
    assert runs["mesh"][0] == runs["none"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs["mesh"][1], runs["none"][1]))


def test_training_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train(get_smoke_config("qwen3-1.7b"), OptConfig(), None, steps=1)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def test_train_e2e_with_datapath(tmp_path):
    """tests/test_system.py's case on the port: corpus in the lake -> fused
    bit-packed batches -> loss goes down -> checkpoint -> resume."""
    cfg = get_smoke_config("qwen3-1.7b")
    paths = write_corpus(str(tmp_path / "c"), n_tokens=120_000, vocab=cfg.vocab,
                         n_shards=1, row_group_size=32768)
    pipe = TokenPipeline(paths, batch_size=1, seq_len=4096, mode="fused", device="cpu")
    optcfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
    out = train(cfg, optcfg, pipe, steps=4, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                log_every=10, log_fn=lambda s: None, device="cpu")
    assert out["losses"][-1] < out["losses"][0]
    assert out["stragglers"]["host0"]["n"] == 4
    pipe2 = TokenPipeline(paths, batch_size=1, seq_len=4096, mode="fused", device="cpu")
    logs = []
    out2 = train(cfg, optcfg, pipe2, steps=5, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                 log_every=10, log_fn=logs.append, device="cpu")
    assert len(out2["losses"]) == 1 and "[train] resumed from step 4" in logs
    assert pipe2.checkpoint_state() != {"shard": 0, "row_group": 0, "epoch": 0, "pool_off": 0}


def test_port_resumes_the_reference_training_run(tmp_path):
    """The JAX package's train writes a step-2 checkpoint of qwen3 smoke at
    float32 (host-mode batches of 2 x 512); the JAX run and the port's
    train(device="cpu") each resume from it, parameters, moments and the
    pipeline's cursor, to step 4, and their steps 2-3 losses agree
    (RESUME_REL)."""
    cj, ct = _configs("qwen3-1.7b", dtype="float32")
    paths = jwrite_corpus(str(tmp_path / "c"), n_tokens=40_000, vocab=cj.vocab,
                          n_shards=1, row_group_size=8192)
    optkw = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
    quiet = dict(ckpt_every=2, log_every=10, log_fn=lambda s: None)
    jtrain(cj, JOptConfig(**optkw), JPipeline(paths, 2, 512, mode="host"), steps=2,
           ckpt_dir=str(tmp_path / "j"), **quiet)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    want = jtrain(cj, JOptConfig(**optkw), JPipeline(paths, 2, 512, mode="host"), steps=4,
                  ckpt_dir=str(tmp_path / "j"), **quiet)["losses"]
    logs = []
    got = train(ct, OptConfig(**optkw), TokenPipeline(paths, 2, 512, mode="host", device="cpu"),
                steps=4, ckpt_dir=str(tmp_path / "t"), ckpt_every=2, log_every=10,
                log_fn=logs.append, device="cpu")["losses"]
    assert "[train] resumed from step 2" in logs
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=RESUME_REL, atol=0)


def test_launcher_trains_on_the_cpu(tmp_path):
    cfg = get_smoke_config("qwen3-1.7b")
    write_corpus(str(tmp_path), n_tokens=40_000, vocab=cfg.vocab, n_shards=1,
                 row_group_size=8192)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
           "--corpus", str(tmp_path), "--steps", "2", "--batch", "1", "--seq", "512",
           "--mesh", "none", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
           "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[launch.train] done: 2 steps" in proc.stdout
    assert os.path.isdir(tmp_path / "ck" / "step_00000002")


@pytest.mark.parametrize("mesh,ranks", [("single", 256), ("multi", 512)])
def test_launcher_meshes_need_their_ranks(tmp_path, mesh, ranks, one_rank_mesh):
    """--mesh single|multi build the production mesh, which needs 256 or
    512 ranks in the process group: with one it raises RuntimeError, as the
    reference raises without that many devices."""
    from repro_torch.launch import train as launcher

    with pytest.raises(RuntimeError, match=f"needs {ranks} ranks, found 1 in the process group"):
        launcher.main(["--arch", "qwen3-1.7b", "--corpus", str(tmp_path), "--mesh", mesh,
                       "--device", "cpu"])
