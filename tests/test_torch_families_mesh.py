"""The SSM, hybrid, enc-dec and VLM families served under a device mesh
(ROADMAP A.6b-ii) on 4 gloo ranks on the CPU, against the JAX package under
4 host devices and against the port without a mesh.

The pattern of tests/test_torch_distributed.py: one spawn serves every case,
4 ranks through `torch.multiprocessing` on a `FileStore` in a temporary
directory, a (data=2, model=2) mesh from `distributed.compat.make_mesh(
device="cpu")`; the reference meanwhile under `tests.util.run_with_devices(
n_devices=4)` on a plain `jax.sharding.Mesh` (Auto axes: ROADMAP C).
Parameters are drawn once by the reference's `init_params` and carried to
the port by `params_from_reference`.  The smoke configs at float32:
mamba2-370m at 2 layers (`in_proj` 292 wide, `inner` sharded over `model`);
hymba-1.5b at 2 layers, one global segment and one windowed one, its
prompts longer than its window of 32 so that the ring wraps (4 heads, 2 KV:
the head-parallel arm), and a variant with 5 heads, 1 KV and 5 SSM heads
(the sequence-parallel arm and flash-decode, an `in_proj` of 341 that the
model axis does not divide, as full-width hymba's 25 heads, 5 KV and 6,457
do); whisper-base (2 encoder and 2 decoder layers over 48 frames);
llava-next-34b at 2 layers.

Tolerances: prefill logits within atol/rtol 1e-5 (float32 sums in other
orders: the mesh's partial products and all-reduces); tokens, ticks,
placements and the packed prefill exact.
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
JOIN_S = 420  # the spawn's bound: a collective that never meets fails the fixture
ATOL = RTOL = 1e-5
PROMPTS = (36, 40, 36, 40)  # past hymba's smoke window of 32; two lengths, two compiles
NEW_TOKENS = 5
SLOTS, MAX_LEN = 4, 64
PREFILL_B, PREFILL_LEN, PREFILL_CACHE = 2, 40, 48
PACKED_LEN = 4096  # one packed block
F32 = {"dtype": "float32"}
FAMILIES = {
    "mamba2": ("mamba2-370m", dict(F32, n_layers=2)),
    "hymba": ("hymba-1.5b", dict(F32, n_layers=2, global_layers=(0,))),
    "hymba_seq": ("hymba-1.5b", dict(F32, n_layers=2, global_layers=(0,), n_heads=5, n_kv=1,
                                     ssm_heads=5)),
    "whisper": ("whisper-base", F32),
    "llava": ("llava-next-34b", dict(F32, n_layers=2)),
}
FSDP_RAISES = ("hymba", "whisper")  # their decode's flash-decode spec names `model` twice
FSDP_WIDE, WIDE_B = ("hymba", "llava"), 4  # prefills of a batch that (data, model) divides

REFERENCE = r'''
import dataclasses, os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.distributed.sharding import ShardingCtx
from repro.models import model
from repro.serve.engine import Request, ServeEngine


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
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}


def served(params, cfg, ctx):
    eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=ctx)
    for i, p in enumerate(inp["prompts"]):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=NEW_TOKENS))
    return eng, {r.rid: r.out for r in eng.run_until_drained()}


tp = ShardingCtx(mesh=mesh, strategy="tp")
for name in FAMILY_NAMES:
    spec, params = inp[name]
    cfg = config(spec)
    eng, outs = served(params, cfg, tp)
    out[name, "served"] = (outs, eng.steps)
    batch = {k: jnp.asarray(v) for k, v in inp["prefill", name].items()}
    logits, _ = jax.jit(lambda p, b: model.prefill(p, b, cfg, tp, cache_len=PREFILL_CACHE))(
        params, batch)
    out[name, "prefill"] = np.asarray(logits)
fsdp = ShardingCtx(mesh=mesh, strategy="fsdp")
for name in FSDP_RAISES:
    spec, params = inp[name]
    try:
        served(params, config(spec), fsdp)
        out[name, "fsdp decode"] = None
    except Exception as e:
        out[name, "fsdp decode"] = (type(e).__name__, str(e)[:300])
with open(D + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
'''


def _config(spec):
    from repro.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(spec[0]), **spec[1])


def _extra(cfg, rng, B: int) -> dict:
    """An enc-dec batch's frames, a VLM's vision embeddings (float32)."""
    out = {}
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)
    return out


def _inputs(d):
    """The reference's parameters (numpy leaves) and numpy inputs, drawn in
    this process and pickled for both sides."""
    import jax

    from repro.models.model import init_params

    rng = np.random.default_rng(0)
    inp = {}
    for name, spec in FAMILIES.items():
        cfg = _config(spec)
        inp[name] = (spec, jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(1))))
        inp["prefill", name] = {"tokens": rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_LEN))
                                .astype(np.int32), **_extra(cfg, rng, PREFILL_B)}
        inp["packed", name] = (rng.integers(0, cfg.vocab, (2, PACKED_LEN)).astype(np.int64),
                               _extra(cfg, rng, 2))
        inp["fsdp wide", name] = {"tokens": rng.integers(0, cfg.vocab, (WIDE_B, PREFILL_LEN))
                                  .astype(np.int32)}
    vocab = _config(FAMILIES["mamba2"]).vocab  # every smoke config's
    inp["prompts"] = [rng.integers(0, vocab, (n,)) for n in PROMPTS]
    with open(os.path.join(d, "inputs.tmp"), "wb") as f:
        pickle.dump(inp, f)
    os.replace(os.path.join(d, "inputs.tmp"), os.path.join(d, "inputs.pkl"))


def _wait_for_inputs(d):
    """The ranks start while the test process draws the inputs."""
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(d, "inputs.pkl")):
        if os.path.exists(os.path.join(d, "inputs.failed")) or time.monotonic() - t0 > 600:
            raise RuntimeError("the inputs were not written")
        time.sleep(0.05)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _served(eng, prompts):
    from repro_torch.serve.engine import Request

    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=NEW_TOKENS))
    return {r.rid: r.out for r in eng.run_until_drained()}, eng.steps


def _cases(d):
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardingCtx, shard_params
    from repro_torch.lakeformat.encodings import bitpack_encode
    from repro_torch.models import model
    from repro_torch.models.model import params_from_reference
    from repro_torch.serve.engine import ServeEngine

    def config(spec):
        return dataclasses.replace(get_smoke_config(spec[0]), **spec[1])

    def tensors(batch):
        return {k: torch.from_numpy(v) for k, v in batch.items()}

    torch.set_num_threads(1)
    _wait_for_inputs(d)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tp = ShardingCtx(mesh=mesh, strategy="tp")
    fsdp = ShardingCtx(mesh=mesh, strategy="fsdp")
    out = {}
    for name, (spec, params_np) in ((n, inp[n]) for n in FAMILIES):
        cfg = config(spec)
        params = params_from_reference(params_np, device="cpu")
        eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=tp, device="cpu")
        out[name, "served"] = _served(eng, inp["prompts"])
        out[name, "cache placements"] = [{k: str(c.placements) for k, c in seg.items()}
                                         for seg in eng.caches]
        batch = tensors(inp["prefill", name])
        logits, _ = model.prefill(eng.params, batch, cfg, tp, cache_len=PREFILL_CACHE)
        out[name, "prefill"] = _full(logits).numpy()

        # a packed prompt under the mesh: each data rank unpacks its own row
        toks, extra = inp["packed", name]
        k = model.token_bits(cfg)
        packed = np.stack([bitpack_encode(t, k) for t in toks]).view(np.int32)
        extra = tensors(extra)
        l_p, c_p = model.prefill(eng.params, {"packed": torch.from_numpy(packed), **extra}, cfg,
                                 tp)
        l_t, c_t = model.prefill(eng.params, {"tokens": torch.from_numpy(toks.astype(np.int32)),
                                              **extra}, cfg, tp)
        out[name, "packed"] = (torch.equal(_full(l_p), _full(l_t)),
                               all(torch.equal(_full(c_p[i][n]), _full(c_t[i][n]))
                                   for i, seg in enumerate(c_t) for n in seg))
        del eng, c_p, c_t

        if name == "mamba2":  # no attention: its decode serves under fsdp
            one = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, device="cpu")
            out[name, "unsharded"] = _served(one, inp["prompts"])
            eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=fsdp, device="cpu")
            out[name, "fsdp served"] = _served(eng, inp["prompts"])
            out[name, "fsdp cache placements"] = [{k: str(c.placements) for k, c in seg.items()}
                                                  for seg in eng.caches]
            l_f, _ = model.prefill(eng.params, batch, cfg, fsdp, cache_len=PREFILL_CACHE)
            l_n, _ = model.prefill(params, batch, cfg, cache_len=PREFILL_CACHE)
            out[name, "fsdp prefill"] = (_full(l_f).numpy(), l_n.numpy())
        if name in FSDP_WIDE:  # a batch that (data, model) divides: the step's layout fails
            wide = tensors(inp["fsdp wide", name])
            l_w, c_w = model.prefill(shard_params(params, cfg, fsdp), wide, cfg, fsdp,
                                     cache_len=PREFILL_CACHE)
            l_n, c_n = model.prefill(params, wide, cfg, cache_len=PREFILL_CACHE)
            out[name, "fsdp wide"] = (
                _full(l_w).numpy(), l_n.numpy(),
                [{k: str(c.placements) for k, c in seg.items()} for seg in c_w],
                all(torch.equal(_full(c_w[i][k]), c_n[i][k]) for i, seg in enumerate(c_n)
                    for k in seg if k in ("conv", "state")))
        if name in FSDP_RAISES:
            eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=fsdp, device="cpu")
            try:
                _served(eng, inp["prompts"])
                out[name, "fsdp decode"] = None
            except sharding.DuplicateSpecError as e:
                out[name, "fsdp decode"] = (type(e).__name__, str(e), eng.steps)
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
    d = str(tmp_path_factory.mktemp("families_mesh"))
    code = (REFERENCE.replace("D + ", repr(d) + " + ")
            .replace("FAMILY_NAMES", repr(tuple(FAMILIES)))
            .replace("FSDP_RAISES", repr(FSDP_RAISES))
            .replace("SLOTS", str(SLOTS)).replace("MAX_LEN", str(MAX_LEN))
            .replace("NEW_TOKENS", str(NEW_TOKENS)).replace("PREFILL_CACHE", str(PREFILL_CACHE)))
    ref_error = []

    def reference():
        try:
            assert "REFERENCE_OK" in run_with_devices(code, n_devices=RANKS, timeout=JOIN_S)
        except Exception as e:  # read below, in the test process
            ref_error.append(e)

    # the reference and the ranks start up while this process draws the inputs
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


@pytest.mark.parametrize("name", list(FAMILIES))
def test_serve_engine_under_the_mesh_gives_the_references_tokens(mesh_results, name):
    """A 4-slot engine under 2x2 tp: the same tokens and ticks as the JAX
    engine under its 2x2 mesh (hymba's ring wrapped by every prompt)."""
    ranks, ref = mesh_results
    served = _same_on_every_rank(ranks, (name, "served"))
    assert served == ref[name, "served"]
    assert len(served[0]) == len(PROMPTS) and served[1] > 0


@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_logits_under_the_mesh_match_the_reference(mesh_results, name):
    ranks, ref = mesh_results
    np.testing.assert_allclose(_same_on_every_rank(ranks, (name, "prefill")),
                               ref[name, "prefill"], atol=ATOL, rtol=RTOL)


# each cache leaf of the engine, (L, slots, ...): the slots over `data`, and
# the keys and values in the decode step's layout, `attn_dims(H, KV, 1)`:
# the KV heads over `model` in the head-parallel arm, the slots over `model`
# (flash-decode) where the heads do not divide; the SSM's conv and state by
# their slots alone
_SLOTS = "(Shard(dim=1), Replicate())"
_HEADS = "(Shard(dim=1), Shard(dim=3))"
_FLASH = "(Shard(dim=1), Shard(dim=2))"
CACHE_PLACEMENTS = {
    "mamba2": [{"conv": _SLOTS, "state": _SLOTS}],
    "hymba": [{"k": _HEADS, "v": _HEADS, "conv": _SLOTS, "state": _SLOTS}] * 2,
    "hymba_seq": [{"k": _FLASH, "v": _FLASH, "conv": _SLOTS, "state": _SLOTS}] * 2,
    "whisper": [{}, {"k": _HEADS, "v": _HEADS, "ck": _HEADS, "cv": _HEADS}],
    "llava": [{"k": _HEADS, "v": _HEADS}],
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_caches_are_placed_in_the_decode_steps_layout(mesh_results, name):
    """hymba's ring caches (its windowed segment's 32 slots), whisper's
    cross-attention `ck`/`cv` over the 48 frames and the SSM states among
    them."""
    ranks, _ = mesh_results
    assert _same_on_every_rank(ranks, (name, "cache placements")) == CACHE_PLACEMENTS[name]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_packed_prompts_under_the_mesh_equal_tokens(mesh_results, name):
    """2 x 4,096 tokens bit-packed: logits and every cache leaf bit for bit
    as the tokens prefill's under the mesh (whisper over its frames)."""
    ranks, _ = mesh_results
    assert _same_on_every_rank(ranks, (name, "packed")) == (True, True)


def test_mamba2_serves_under_fsdp_as_without_a_mesh(mesh_results):
    """No attention, so no flash-decode constraint: the widened batch
    shards the slots over both axes, and the engine gives the tokens and
    ticks of the port without a mesh (which are the reference's under tp);
    prefill within 1e-5."""
    ranks, ref = mesh_results
    served = _same_on_every_rank(ranks, ("mamba2", "fsdp served"))
    assert served == ranks[0]["mamba2", "unsharded"] == ref["mamba2", "served"]
    both = "(Shard(dim=1), Shard(dim=1))"
    assert _same_on_every_rank(ranks, ("mamba2", "fsdp cache placements")) == [
        {"conv": both, "state": both}]
    got, want = _same_on_every_rank(ranks, ("mamba2", "fsdp prefill"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", FSDP_WIDE)
def test_fsdp_prefill_of_a_wide_batch_keeps_its_caches_in_the_batch_layout(mesh_results, name):
    """A port fault found in this slice (ROADMAP C): under fsdp a batch of 4
    rows takes `model` on its widened batch, and the decode step's layout
    would put `model` on the flash-decode slots too, a duplicate spec; the
    prefill's caches, dense attention's among them, keep the batch layout
    instead, and the prefill serves as the reference's does (logits within
    1e-5 of no mesh; the SSM states bit for bit)."""
    ranks, _ = mesh_results
    got, want, places, states = _same_on_every_rank(ranks, (name, "fsdp wide"))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    wide = "(Shard(dim=1), Shard(dim=1))"  # (L, B, ...): B over (data, model)
    assert all(p == wide for seg in places for p in seg.values()) and places[0]
    assert states


@pytest.mark.parametrize("name", FSDP_RAISES)
def test_decode_under_fsdp_raises_as_the_reference_does(mesh_results, name):
    """A reference trait (ROADMAP C): hymba's and whisper's decode put
    `model` on the widened batch and on the flash-decode seq_tp at once; the
    prefills admit, the first decode raises."""
    ranks, ref = mesh_results
    assert ref[name, "fsdp decode"] is not None
    assert ref[name, "fsdp decode"][0] == "DuplicateSpecError"
    for r in ranks:
        err, msg, steps = r[name, "fsdp decode"]
        assert err == "DuplicateSpecError" and "'model'" in msg and steps == 0
