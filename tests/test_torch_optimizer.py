"""The port's optimizers (`repro_torch.train.optimizer`) against the JAX
package's: the schedule, AdamW with float32 and bf16 moments, Adafactor
factored and unfactored, clipping, the decay mask and `global_norm`, on the
same numpy parameters and gradients; then `tests/test_optimizer.py`'s own
six properties on the port.

Tolerance: the port runs the reference's float32 operations in its order,
but XLA and torch may round a pow, cos, sqrt or a long reduction an ulp
apart, so values agree within a few float32 ulps of each tensor's scale:
|got - want| <= RTOL (|want| + max|want|), RTOL = 4 * 2^-23 (~4.8e-7).  (A
parameter near 0 after p - lr * delta keeps the update's absolute rounding,
so a bound relative to the element alone would be too tight there.)  bf16
tensors within one bf16 ulp (2^-7) on the same terms, since a float32 ulp
can flip a bf16 rounding.  A flipped bf16 moment moves its parameter's
update by a bf16 step of |delta| (<= ~2 here), so with bf16 moments the
parameters after n steps agree within n * lr * 2 * 2^-7.  `global_norm` sums
~40,000 squares in another order: within 32 ulps (2 sides x log2 N).
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as opt

RTOL = 4 * 2.0 ** -23
NORM_RTOL = 32 * 2.0 ** -23
BF16_RTOL = 2.0 ** -7


def _trees(seed, shapes, scale=0.01):
    """(numpy params, numpy grads) shaped like a model's: a dict with a
    list of dicts."""
    rng = np.random.default_rng(seed)
    mk = lambda s, k: {n: (rng.standard_normal(shp) * k).astype(np.float32)  # noqa: E731
                       for n, shp in s.items()}
    params = {**mk(shapes["top"], 1.0), "segments": [mk(shapes["seg"], 1.0)]}
    grads = {**mk(shapes["top"], scale), "segments": [mk(shapes["seg"], scale)]}
    return params, grads


SHAPES = {"top": {"embed": (160, 24), "norm": (24,)},
          "seg": {"wq": (2, 24, 16), "ln1": (2, 24), "big": (2, 136, 144)}}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32):
    return opt.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rtol=RTOL, atol=None):
    gl, wl = opt.tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        w = _np(w)
        bound = rtol * np.abs(w).max() if atol is None else atol
        np.testing.assert_allclose(_np(g), w, rtol=rtol, atol=bound)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 1000), (3, 3)])
def test_schedule_against_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total, min_lr_ratio=0.1)
    for s in (0, 1, 2, 5, 10, 11, 50, 99, 100, 101, 5000):
        want = jopt.schedule(jnp.int32(s), jopt.OptConfig(**cfg))
        got = opt.schedule(torch.tensor(s, dtype=torch.int32), opt.OptConfig(**cfg))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=0)


def _run(name, steps, **kw):
    """Both packages' apply_updates over `steps` steps of the same grads;
    returns (port params, port state, port stats, ref ...)."""
    params, grads = _trees(0, SHAPES)
    jc, tc = jopt.OptConfig(name=name, **kw), opt.OptConfig(name=name, **kw)
    jp, jg = _jax(params), _jax(grads)
    tp, tg = _torch(params), _torch(grads)
    js, ts = jopt.init_opt_state(jp, jc), opt.init_opt_state(tp, tc)
    for _ in range(steps):
        jp, js, jstats = jopt.apply_updates(jp, jg, js, jc)
        tp, ts, tstats = opt.apply_updates(tp, tg, ts, tc)
    return tp, ts, tstats, jp, js, jstats


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 1.0, 1e-3])
def test_adamw_against_reference(moments, clip):
    tp, ts, tstats, jp, js, jstats = _run("adamw", 3, lr=1e-2, warmup_steps=1,
                                          total_steps=10, moments_dtype=moments,
                                          clip_norm=clip, weight_decay=0.1)
    assert int(ts["step"]) == int(js["step"]) == 3 and ts["step"].dtype == torch.int32
    _close(tp, jp, atol=None if moments == "float32" else 3 * 1e-2 * 2 * BF16_RTOL)
    rtol = RTOL if moments == "float32" else BF16_RTOL
    for k in ("m", "v"):
        assert opt.tree_leaves(ts[k])[0].dtype == getattr(torch, moments)
        _close(ts[k], js[k], rtol=rtol)
    np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]), rtol=RTOL)
    np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                               rtol=NORM_RTOL)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adafactor_against_reference(clip):
    """`big` (136 x 144 per layer) is factored, the rest are not."""
    tp, ts, tstats, jp, js, jstats = _run("adafactor", 3, lr=1e-2, warmup_steps=1,
                                          total_steps=10, clip_norm=clip,
                                          weight_decay=0.1)
    assert tuple(ts["vr"]["segments"][0]["big"].shape) == (2, 136)
    assert tuple(ts["vc"]["segments"][0]["big"].shape) == (2, 144)
    assert tuple(ts["vc"]["embed"].shape) == (1,)
    _close(tp, jp)
    for k in ("vr", "vc"):
        _close(ts[k], js[k])
    np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]),
                               rtol=NORM_RTOL)


def test_bf16_params_against_reference():
    """bf16 parameters and grads, updated in float32 and rounded back: equal
    to the reference's bf16 within one bf16 ulp."""
    params, grads = _trees(1, SHAPES)
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jp, jg = _jax(params, jnp.bfloat16), _jax(grads, jnp.bfloat16)
    tp, tg = _torch(params, torch.bfloat16), _torch(grads, torch.bfloat16)
    jp, js, _ = jopt.apply_updates(jp, jg, jopt.init_opt_state(jp, jopt.OptConfig(**cfg)),
                                   jopt.OptConfig(**cfg))
    tp, ts, _ = opt.apply_updates(tp, tg, opt.init_opt_state(tp, opt.OptConfig(**cfg)),
                                  opt.OptConfig(**cfg))
    assert all(p.dtype == torch.bfloat16 for p in opt.tree_leaves(tp))
    _close(tp, jp, rtol=BF16_RTOL)


def test_global_norm_and_decay_mask_against_reference():
    params, grads = _trees(2, SHAPES, scale=3.0)
    np.testing.assert_allclose(float(opt.global_norm(_torch(grads))),
                               float(jopt.global_norm(_jax(grads))), rtol=NORM_RTOL)
    bf = float(opt.global_norm(_torch(grads, torch.bfloat16)))
    np.testing.assert_allclose(bf, float(jopt.global_norm(_jax(grads, jnp.bfloat16))),
                               rtol=NORM_RTOL)
    assert opt.tree_leaves(opt._decay_mask(_torch(params))) == jax.tree.leaves(
        jopt._decay_mask(_jax(params)))
    # the reference's leaf order: dict keys sorted, lists in order
    assert [tuple(x.shape) for x in opt.tree_leaves(_torch(params))] == [
        x.shape for x in jax.tree.leaves(_jax(params))]


def test_update_is_in_place():
    params, grads = _trees(3, SHAPES)
    tp, tg = _torch(params), _torch(grads)
    before = {id(t): t.data_ptr() for t in opt.tree_leaves(tp)}
    state = opt.init_opt_state(tp, opt.OptConfig())
    m0 = opt.tree_leaves(state["m"])[0]
    new, state2, _ = opt.apply_updates(tp, tg, state, opt.OptConfig())
    assert new is tp and {id(t): t.data_ptr() for t in opt.tree_leaves(new)} == before
    assert opt.tree_leaves(state2["m"])[0] is m0 and float(m0.abs().max()) > 0


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        opt.init_opt_state({"w": torch.zeros(2)}, opt.OptConfig(name="sgd"))


# ---------------------------------------------------------------------------
# tests/test_optimizer.py's properties, on the port
# ---------------------------------------------------------------------------


def _tiny_params():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((8, 16), generator=g), "norm": torch.ones(16)}


def _const(params, v):
    return opt.tree_map(lambda p: torch.full_like(p, v), params)


def test_adamw_matches_hand_rolled():
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10**9, b1=0.9, b2=0.999,
                        eps=1e-8, weight_decay=0.0, clip_norm=0.0, min_lr_ratio=1.0)
    params = _tiny_params()
    w0 = params["w"].clone()
    p1, _, _ = opt.apply_updates(params, _const(params, 0.1), opt.init_opt_state(params, cfg),
                                 cfg)
    g = 0.1  # bias-corrected adam, step 1: mhat = g, vhat = g^2
    expected_delta = cfg.lr * g / (np.sqrt(g * g) + cfg.eps)
    assert abs(float((w0 - p1["w"])[0, 0]) - expected_delta) < 1e-6


def test_weight_decay_mask_skips_norms():
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5, clip_norm=0.0,
                        min_lr_ratio=1.0, total_steps=10**9)
    params = _tiny_params()
    before = opt.tree_map(torch.clone, params)
    p1, _, _ = opt.apply_updates(params, _const(params, 0.0), opt.init_opt_state(params, cfg),
                                 cfg)
    assert float((p1["norm"] - before["norm"]).abs().max()) == 0.0  # 1-D: no decay
    assert float((p1["w"] - before["w"]).abs().max()) > 0.0  # 2-D: decayed


def test_grad_clipping():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=0, clip_norm=1.0, weight_decay=0.0,
                        min_lr_ratio=1.0, total_steps=10**9)
    params = _tiny_params()
    _, _, stats = opt.apply_updates(params, _const(params, 100.0),
                                    opt.init_opt_state(params, cfg), cfg)
    assert float(stats["grad_norm"]) > 1.0  # reported pre-clip


def test_schedule_shape():
    cfg = opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(opt.schedule(torch.tensor(s, dtype=torch.int32), cfg))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0 and abs(lrs[2] - 1e-3) < 1e-9
    assert lrs[3] < lrs[2] and abs(lrs[4] - 1e-4) < 1e-8  # cosine to min ratio


def test_bf16_moments_close_to_f32():
    outs = {}
    for mdt in ("float32", "bfloat16"):
        params = _tiny_params()
        g = opt.tree_map(lambda p: torch.sin(torch.arange(p.numel(), dtype=torch.float32))
                         .reshape(p.shape) * 0.01, params)
        cfg = opt.OptConfig(lr=1e-3, warmup_steps=0, moments_dtype=mdt, clip_norm=0.0,
                            weight_decay=0.0, min_lr_ratio=1.0, total_steps=10**9)
        p, s = params, opt.init_opt_state(params, cfg)
        for _ in range(5):
            p, s, _ = opt.apply_updates(p, g, s, cfg)
        outs[mdt] = p
    rel = float((outs["bfloat16"]["w"] - outs["float32"]["w"]).abs().max()
                / outs["float32"]["w"].abs().max())
    assert rel < 1e-2  # bf16 moments: half the state, <1% trajectory error


def test_adafactor_factored_state_is_small():
    params = {"big": torch.zeros((512, 1024))}
    cfg = opt.OptConfig(name="adafactor")
    state = opt.init_opt_state(params, cfg)
    assert tuple(state["vr"]["big"].shape) == (512,)
    assert tuple(state["vc"]["big"].shape) == (1024,)
    p1, _, _ = opt.apply_updates(params, {"big": torch.full((512, 1024), 0.01)}, state, cfg)
    assert bool(torch.isfinite(p1["big"]).all())
    assert float(p1["big"].abs().max()) > 0
