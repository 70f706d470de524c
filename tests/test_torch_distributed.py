"""Serving under a device mesh (ROADMAP A.6a) on 4 gloo ranks on the CPU,
against the JAX package under 4 host devices and against the port without a
mesh.

One spawn serves every case: 4 ranks through `torch.multiprocessing`, their
process group rendezvousing on a `FileStore` in a temporary directory (no
TCP port, so parallel test workers cannot collide), a (data=2, model=2)
mesh built by `distributed.compat.make_mesh(device="cpu")`.  The reference
side runs meanwhile under `tests.util.run_with_devices(n_devices=4)`, its
mesh a plain `jax.sharding.Mesh` (Auto axes; `repro.distributed.compat.
make_mesh` builds Explicit axes on jax 0.9, under which its sharding
constraints assert: ROADMAP C).  Parameters are drawn once by the
reference's `init_params` and carried to the port by
`params_from_reference`.  The module fixture returns every rank's results
and each test reads its part; every rank must report the same.

Tolerances: float32 within atol/rtol 1e-5 (sums in other orders: the
mesh's partial products, all-reduces and the flash-decode softmax
statistics); bfloat16 MoE outputs by the reference test's own rule
(tests/test_distributed.py), the fraction of |d| > 1e-2 under 6%; tokens,
ticks, placements and the packed prefill exact.
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
ATOL = RTOL = 1e-5
BF16_FRAC = 0.06
PROMPTS = (10, 14, 10, 14)  # two prompt lengths: the JAX engine compiles a prefill for each
NEW_TOKENS = 5
SLOTS, MAX_LEN = 4, 64
PREFILL_LEN, PREFILL_CACHE = 24, 32
MOE_B, MOE_S = 4, 16
SMALL = {"dtype": "float32", "n_layers": 2}  # the smoke configs cut from 3 layers to 2
# moe_ffn without expert parallelism, (rows, expert ff): the rows and the ff
# both sharded on the data axis, the rows alone (45 does not divide it), the
# ff alone (3 rows do not)
MOE_GLOBAL = ((MOE_B, 48), (MOE_B, 45), (3, 48))

REFERENCE = r'''
import dataclasses, os, pickle, time
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.compat import make_mesh, use_mesh
from repro.distributed.sharding import ShardingCtx
from repro.models import model
from repro.models.moe import moe_ffn
from repro.serve.engine import Request, ServeEngine
from repro.configs import get_smoke_config


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
for strategy in ("tp", "fsdp_ep"):
    ctx = ShardingCtx(mesh=mesh, strategy=strategy)
    for dt, shared in (("float32", 0), ("bfloat16", 0), ("bfloat16", 2)):
        spec, lp, x = inp["moe", dt, shared]
        cfg = config(spec)
        y, aux = jax.jit(lambda x, p: moe_ffn(x, p, cfg, ctx))(jnp.asarray(x), lp)
        out["moe", strategy, dt, shared] = (np.asarray(y.astype(jnp.float32)), float(aux))
# the same call on the reference's own make_mesh (Explicit axes on jax 0.9)
explicit = make_mesh((2, 2), ("data", "model"))
out["explicit axes"] = [t.name for t in explicit.axis_types]
spec, lp, x = inp["moe", "bfloat16", 2]
try:
    with use_mesh(explicit):  # as tests/test_distributed.py calls it
        jax.jit(lambda x, p: moe_ffn(x, p, config(spec), ShardingCtx(mesh=explicit)))(
            jnp.asarray(x), lp)
    out["explicit moe"] = None
except Exception as e:
    out["explicit moe"] = (type(e).__name__, str(e)[:200])
ctx = ShardingCtx(mesh=mesh, strategy="tp")
for name in ("qwen3", "qwen3_kv1"):
    spec, params = inp[name]
    cfg = config(spec)
    eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=ctx)
    for i, p in enumerate(inp["prompts"]):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=NEW_TOKENS))
    out[name, "served"] = ({r.rid: r.out for r in eng.run_until_drained()}, eng.steps)
    logits, _ = jax.jit(lambda p, b: model.prefill(p, b, cfg, ctx, cache_len=PREFILL_CACHE))(
        params, {"tokens": jnp.asarray(inp["prompt"])})
    out[name, "prefill"] = np.asarray(logits)
spec, params = inp["qwen3"]
cfg = config(spec)
ctx = ShardingCtx(mesh=mesh, strategy="fsdp")
eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=ctx)
for i, p in enumerate(inp["prompts"]):
    eng.submit(Request(rid=i, tokens=p, max_new_tokens=NEW_TOKENS))
try:
    eng.run_until_drained()
    out["fsdp decode"] = None
except Exception as e:
    out["fsdp decode"] = (type(e).__name__, str(e)[:300])
with open(D + "/reference.pkl", "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
'''


def _inputs(d):
    """The reference's parameters (numpy leaves) and numpy inputs, drawn in
    this process and pickled for both sides."""
    import dataclasses

    import jax

    from repro.configs import get_smoke_config
    from repro.models.model import init_params

    def draw(spec):
        cfg = dataclasses.replace(get_smoke_config(spec[0]), **spec[1])
        return spec, jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(1)))

    rng = np.random.default_rng(0)
    vocab = get_smoke_config("qwen3-1.7b").vocab
    inp = {"qwen3": draw(("qwen3-1.7b", SMALL)),
           "qwen3_kv1": draw(("qwen3-1.7b", dict(SMALL, n_kv=1))),
           "deepseek": draw(("deepseek-moe-16b", SMALL)),
           "prompts": [rng.integers(0, vocab, (n,)) for n in PROMPTS],
           "prompt": rng.integers(0, vocab, (1, PREFILL_LEN)).astype(np.int32),
           "packed_tokens": rng.integers(0, vocab, (2, 4096)).astype(np.int64)}
    x = (rng.standard_normal((MOE_B, MOE_S, 64)) * 0.3).astype(np.float32)
    moe_layer = {k: v[0] for k, v in inp["deepseek"][1]["segments"][1].items()}
    for dt, shared in (("float32", 0), ("bfloat16", 0), ("bfloat16", 2)):
        # the deepseek smoke model's first MoE layer, its shared experts
        # dropped for moe_shared=0, rounded to bf16 as init_params rounds
        lp = {k: v.astype(dt) for k, v in moe_layer.items()
              if shared or not k.startswith("shared_")}
        xs = x.astype(jax.numpy.bfloat16) if dt == "bfloat16" else x
        inp["moe", dt, shared] = (("deepseek-moe-16b", dict(SMALL, dtype=dt, moe_shared=shared)),
                                  lp, xs)
    rng_a = np.random.default_rng(1)
    for arm, (B, Sq, H, KV, Skv) in {"head": (2, 24, 4, 2, 24), "seq": (2, 24, 4, 1, 24),
                                     "flash_decode": (2, 1, 4, 1, 32)}.items():
        inp["attn", arm] = tuple(rng_a.standard_normal(s).astype(np.float32)
                                 for s in ((B, Sq, H, 16), (B, Skv, KV, 16), (B, Skv, KV, 16)))
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


def _layer_on_mesh(cfg, lp, ctx):
    """A MoE layer's parameters placed by their logical dims."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import sharding_for
    from repro_torch.models.model import _layer_shapes

    dims = {k: d for k, (_, d) in _layer_shapes("moe", cfg).items()}
    return {k: distribute_tensor(v, ctx.mesh, sharding_for(dims[k], ctx, v.shape),
                                 src_data_rank=None) for k, v in lp.items()}


def _moe_without_ep(inp, mesh, ctx, config):
    """moe_ffn's arm without expert parallelism (5 experts do not divide the
    model axis) under `ctx`, and one device's, which routes the same global
    tokens: the output, the Switch loss and the gradients of x and of every
    parameter, for each case of `MOE_GLOBAL` (the first layer of the
    float32 smoke model cut to 5 experts, its expert ff to `ff` and its
    batch to `rows`)."""
    import dataclasses

    from repro_torch.distributed.sharding import as_dtensor, local_ctx
    from repro_torch.models import moe

    spec, lp, x = inp["moe", "float32", 0]
    res = {}
    for rows, ff in MOE_GLOBAL:
        cfg = dataclasses.replace(config(spec), moe_experts=5, moe_d_ff=ff)
        cut = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in (
            ("router", lp["router"][:, :5]), ("e_wg", lp["e_wg"][:5, :, :ff]),
            ("e_wu", lp["e_wu"][:5, :, :ff]), ("e_wo", lp["e_wo"][:5, :ff]))}
        for label in ("mesh", "one"):
            xt = torch.from_numpy(x[:rows]).requires_grad_(True)
            if label == "mesh":
                p = {k: v.requires_grad_() for k, v in _layer_on_mesh(cfg, cut, ctx).items()}
                y, aux = moe.moe_ffn(as_dtensor(xt, mesh), p, cfg, ctx)
                total = (y.float() ** 2).sum().full_tensor() + aux
            else:
                p = {k: v.clone().requires_grad_(True) for k, v in cut.items()}
                y, aux = moe.moe_ffn(xt, p, cfg, local_ctx())
                total = (y.float() ** 2).sum() + aux
            grads = torch.autograd.grad(total, [xt, *p.values()])
            res[rows, ff, label] = [_full(y).detach().numpy(), float(aux)] + [
                _full(g).numpy() for g in grads]
    return res


def _cases(d):
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding
    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import ShardingCtx, local_ctx
    from repro_torch.lakeformat.encodings import bitpack_encode
    from repro_torch.models import layers, model, moe
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import params_from_reference
    from repro_torch.serve.engine import ServeEngine

    def config(spec):
        return dataclasses.replace(get_smoke_config(spec[0]), **spec[1])

    torch.set_num_threads(1)
    _wait_for_inputs(d)
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tp = ShardingCtx(mesh=mesh, strategy="tp")
    out = {"coordinate": tuple(mesh.get_coordinate())}

    # placements: a round trip bit for bit, and each rank's shard where the
    # reference's major-to-minor tuple puts it
    g = torch.Generator().manual_seed(7)
    full = torch.randn((8, 8, 4), generator=g)
    for spec in ((("data", "model"), None, None), ("model", "data", None), (None, None, "model"),
                 (None, ("data", "model"), None)):
        dt = distribute_tensor(full, mesh, sharding.placements_for(spec, mesh, full.shape))
        got = [sharding.local_range(dt, i) for i in range(3)]
        local = full[tuple(slice(s, s + n) for s, n in got)]
        out["placement", spec] = (torch.equal(dt.full_tensor(), full),
                                  torch.equal(dt.to_local(), local), got)

    # attention's three constrained arms against the port without a mesh
    for arm, kw in (("head", dict(causal=True)), ("seq", dict(causal=True, window=8)),
                    ("flash_decode", dict(causal=False, kv_valid_len=20))):
        q, k, v = (torch.from_numpy(a) for a in inp["attn", arm])
        want = layers.attention(q, k, v, local_ctx(), chunk=8, **kw)
        got = layers.attention(q, k, v, tp, chunk=8, **kw)
        out["attn", arm] = (_full(got).numpy(), want.numpy(), str(got.placements))

    # moe_ffn's mesh arms; the row-sharded 2D arm with the resident budget at 0
    for strategy in ("tp", "fsdp_ep"):
        ctx = ShardingCtx(mesh=mesh, strategy=strategy)
        for dt, shared in (("float32", 0), ("bfloat16", 0), ("bfloat16", 2)):
            spec, lp, x = inp["moe", dt, shared]
            cfg = config(spec)
            lp = _layer_on_mesh(cfg, params_from_reference(lp, device="cpu"), ctx)
            xt = params_from_reference(x, device="cpu")
            y, aux = moe.moe_ffn(xt, lp, cfg, ctx)
            out["moe", strategy, dt, shared] = (_full(y).float().numpy(), float(aux))
            if strategy == "tp":
                lp1 = {k: v.full_tensor() for k, v in lp.items()}
                y1, aux1 = moe.moe_ffn(xt, lp1, cfg, local_ctx())
                out["moe single", dt, shared] = (y1.float().numpy(), float(aux1))
    ctx = ShardingCtx(mesh=mesh, strategy="fsdp_ep")
    spec, lp, x = inp["moe", "float32", 0]
    cfg = config(spec)
    lp = _layer_on_mesh(cfg, params_from_reference(lp, device="cpu"), ctx)
    moe.RESIDENT_BYTES = 0
    out["moe rows"] = _full(moe.moe_ffn(torch.from_numpy(x), lp, cfg, ctx)[0]).numpy()
    out["moe global"] = _moe_without_ep(inp, mesh, tp, config)
    out["row index"] = (moe._row_index("data", mesh), dist.get_rank(moe._row_group("data", mesh)),
                        mesh.get_local_rank("data"))

    # the slice: ServeEngine under the mesh
    for name in ("qwen3", "qwen3_kv1", "deepseek"):
        spec, params = inp[name]
        cfg = config(spec)
        params = params_from_reference(params, device="cpu")
        eng = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, ctx=tp, device="cpu")
        out[name, "served"] = _served(eng, inp["prompts"])
        out[name, "cache placements"] = [str(c.placements) for c in eng.caches[-1].values()]
        if name == "deepseek":
            one = ServeEngine(params, cfg, n_slots=SLOTS, max_len=MAX_LEN, device="cpu")
            out[name, "unsharded"] = _served(one, inp["prompts"])
            continue
        batch = {"tokens": torch.from_numpy(inp["prompt"])}
        logits, _ = model.prefill(eng.params, batch, cfg, tp, cache_len=PREFILL_CACHE)
        out[name, "prefill"] = _full(logits).numpy()
        if name == "qwen3":
            for strategy in ("fsdp", "fsdp_ep"):
                ctx = ShardingCtx(mesh=mesh, strategy=strategy)
                l_s, _ = model.prefill(sharding.shard_params(params, cfg, ctx), batch, cfg, ctx,
                                       cache_len=PREFILL_CACHE)
                out[name, "prefill", strategy] = _full(l_s).numpy()
            out[name, "prefill", "none"] = model.prefill(params, batch, cfg,
                                                         cache_len=PREFILL_CACHE)[0].numpy()

    # packed prompts under the mesh: each data rank unpacks its own row
    spec, params = inp["qwen3"]
    cfg = config(spec)
    params = sharding.shard_params(params_from_reference(params, device="cpu"), cfg, tp)
    toks = inp["packed_tokens"]
    k = model.token_bits(cfg)
    packed = np.stack([bitpack_encode(t, k) for t in toks]).view(np.int32)
    l_p, c_p = model.prefill(params, {"packed": torch.from_numpy(packed)}, cfg, tp)
    l_t, c_t = model.prefill(params, {"tokens": torch.from_numpy(toks.astype(np.int32))}, cfg, tp)
    out["packed"] = (torch.equal(_full(l_p), _full(l_t)),
                     all(torch.equal(_full(c_p[0][n]), _full(c_t[0][n])) for n in ("k", "v")))

    # decode under fsdp: the wide batch and the flash-decode cache both on `model`
    eng = ServeEngine(params_from_reference(inp["qwen3"][1], device="cpu"), cfg, n_slots=SLOTS,
                      max_len=MAX_LEN, ctx=ShardingCtx(mesh=mesh, strategy="fsdp"), device="cpu")
    try:
        _served(eng, inp["prompts"])
        out["fsdp decode"] = None
    except sharding.DuplicateSpecError as e:
        out["fsdp decode"] = (type(e).__name__, str(e), eng.steps)
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


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh"))
    code = (REFERENCE.replace("D + ", repr(d) + " + ")
            .replace("SLOTS", str(SLOTS)).replace("MAX_LEN", str(MAX_LEN))
            .replace("NEW_TOKENS", str(NEW_TOKENS)).replace("PREFILL_CACHE", str(PREFILL_CACHE)))
    ref_error = []

    def reference():
        try:
            assert "REFERENCE_OK" in run_with_devices(code, n_devices=RANKS, timeout=600)
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
            while not procs.join():
                pass
        finally:
            t.join(timeout=660)
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


def test_every_rank_holds_its_own_coordinate(mesh_results):
    ranks, _, _ = mesh_results
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("spec", [(("data", "model"), None, None), ("model", "data", None),
                                  (None, None, "model"), (None, ("data", "model"), None)])
def test_placements_round_trip_and_shard_major_to_minor(mesh_results, spec):
    ranks, _, _ = mesh_results
    for rank, r in enumerate(ranks):
        whole, local, got = r["placement", spec]
        assert whole and local, (rank, spec)
        data, model = divmod(rank, 2)
        for dim, entry in enumerate(spec):
            size = (8, 8, 4)[dim]
            if entry is None:
                assert got[dim] == (0, size)
            elif isinstance(entry, tuple):  # (data, model): data major
                n = size // 4
                assert got[dim] == ((data * 2 + model) * n, n)
            else:
                n = size // 2
                assert got[dim] == ((data if entry == "data" else model) * n, n)


@pytest.mark.parametrize("arm,placement", [("head", "(Shard(dim=0), Shard(dim=2))"),
                                           ("seq", "(Shard(dim=0), Shard(dim=1))"),
                                           ("flash_decode", "(Shard(dim=0), Replicate())")])
def test_attention_arms_match_no_mesh(mesh_results, arm, placement):
    ranks, _, _ = mesh_results
    for r in ranks:
        got, want, place = r["attn", arm]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert place == placement


def _bf16_close(got, want):
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    frac = float(np.mean(d > 1e-2))
    assert frac < BF16_FRAC, (frac, float(d.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", ["tp", "fsdp_ep"])
def test_moe_ffn_mesh_arms_match_the_references_ep(mesh_results, strategy, dtype):
    """moe_shared=0: the port's arm against the reference's under the same
    mesh (`_routed_local` with the model axis under tp, `_routed_2d`
    resident under fsdp_ep)."""
    ranks, ref, _ = mesh_results
    got, aux = _same_on_every_rank(ranks, ("moe", strategy, dtype, 0))
    want, want_aux = ref["moe", strategy, dtype, 0]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        assert aux == pytest.approx(want_aux, rel=RTOL)
    else:
        _bf16_close(got, want)
        assert aux == pytest.approx(want_aux, rel=1e-2)


@pytest.mark.parametrize("strategy", ["tp", "fsdp_ep"])
def test_moe_ffn_with_shared_experts_matches_one_device(mesh_results, strategy):
    """With the shared experts: against the port's single-device moe_ffn by
    the reference test's rule (the reference's own EP tests, which use its
    make_mesh, fail there: ROADMAP C)."""
    ranks, _, _ = mesh_results
    got, aux = _same_on_every_rank(ranks, ("moe", strategy, "bfloat16", 2))
    want, want_aux = ranks[0]["moe single", "bfloat16", 2]
    _bf16_close(got, want)
    assert aux == pytest.approx(want_aux, rel=1e-2)


@pytest.mark.parametrize("strategy", ["tp", "fsdp_ep"])
def test_moe_ffn_with_shared_experts_matches_the_references_ep(mesh_results, strategy):
    """On Auto axes the reference's EP serves the shared experts too: the
    port's arm against it under the same mesh, by the same rule."""
    ranks, ref, _ = mesh_results
    got, aux = _same_on_every_rank(ranks, ("moe", strategy, "bfloat16", 2))
    want, want_aux = ref["moe", strategy, "bfloat16", 2]
    _bf16_close(got, want)
    assert aux == pytest.approx(want_aux, rel=1e-2)


@pytest.mark.parametrize("rows,ff", MOE_GLOBAL)
def test_moe_ffn_without_ep_matches_one_device(mesh_results, rows, ff):
    """5 experts on the 2x2 mesh (`moe._routed_global`): the dispatch over
    the global tokens on each rank's shard of the experts' ff; the output,
    the Switch loss and every gradient against one device, float32."""
    ranks, _, _ = mesh_results
    res = _same_on_every_rank(ranks, "moe global")
    for got, want in zip(res[rows, ff, "mesh"], res[rows, ff, "one"]):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_moe_2d_row_sharded_arm_matches_the_resident_one(mesh_results):
    """Expert F dims sharded over the data rows (tokens gathered along the
    rows, partial outputs reduce-scattered) against the resident arm."""
    ranks, _, _ = mesh_results
    got = _same_on_every_rank(ranks, "moe rows")
    want, _ = ranks[0]["moe", "fsdp_ep", "float32", 0]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for r in ranks:
        index, group_rank, data = r["row index"]
        assert index == group_rank == data


@pytest.mark.parametrize("name", ["qwen3", "qwen3_kv1"])
def test_serve_engine_under_the_mesh_gives_the_references_tokens(mesh_results, name):
    """qwen3 smoke (float32) under 2x2 tp: head-parallel (H 4, KV 2), and
    with n_kv 1 sequence-parallel prefill and flash-decode; the same tokens
    and ticks as the JAX engine under its 2x2 mesh, prefill logits within
    1e-5."""
    ranks, ref, _ = mesh_results
    assert _same_on_every_rank(ranks, (name, "served")) == ref[name, "served"]
    np.testing.assert_allclose(_same_on_every_rank(ranks, (name, "prefill")),
                               ref[name, "prefill"], atol=ATOL, rtol=RTOL)
    seq = "Shard(dim=2)" if name == "qwen3_kv1" else "Shard(dim=3)"
    assert _same_on_every_rank(ranks, (name, "cache placements")) == [
        f"(Shard(dim=1), {seq})"] * 2


def test_moe_engine_under_the_mesh_matches_the_unsharded_one(mesh_results):
    ranks, _, _ = mesh_results
    served = _same_on_every_rank(ranks, ("deepseek", "served"))
    assert served == ranks[0]["deepseek", "unsharded"]
    assert len(served[0]) == len(PROMPTS)


@pytest.mark.parametrize("strategy", ["fsdp", "fsdp_ep"])
def test_prefill_under_zero_strategies_matches_no_mesh(mesh_results, strategy):
    ranks, _, _ = mesh_results
    np.testing.assert_allclose(_same_on_every_rank(ranks, ("qwen3", "prefill", strategy)),
                               ranks[0]["qwen3", "prefill", "none"], atol=ATOL, rtol=RTOL)


def test_packed_prompts_under_the_mesh_equal_tokens(mesh_results):
    ranks, _, _ = mesh_results
    assert _same_on_every_rank(ranks, "packed") == (True, True)


def test_reference_make_mesh_builds_explicit_axes(mesh_results):
    """A reference trait (ROADMAP C): on jax 0.9 `repro.distributed.compat.
    make_mesh` builds Explicit axes, under which `with_sharding_constraint`
    asserts; the shared experts' MLP constraint (`repro/models/moe.py:302`)
    is the first that meets an array sharded otherwise, which is how the
    reference's two EP tests fail.  On a plain `jax.sharding.Mesh` (Auto) the
    same call serves (above)."""
    _, ref, _ = mesh_results
    assert ref["explicit axes"] == ["Explicit", "Explicit"]
    name, msg = ref["explicit moe"]
    assert name == "AssertionError" and "type `Explicit`" in msg


def test_decode_under_fsdp_raises_as_the_reference_does(mesh_results):
    """A reference trait (ROADMAP C): under fsdp the flash-decode constraint
    puts `model` on the widened batch and on seq_tp, a duplicate spec; the
    prefills admit, the first decode raises."""
    ranks, ref, _ = mesh_results
    assert ref["fsdp decode"] is not None and ref["fsdp decode"][0] == "DuplicateSpecError"
    for r in ranks:
        name, msg, steps = r["fsdp decode"]
        assert name == "DuplicateSpecError" and "'model'" in msg and steps == 0
