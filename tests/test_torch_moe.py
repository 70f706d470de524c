"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
`repro.models.moe` on the same numpy inputs: `_capacity`, the routed
experts on given ids and gates at float32 (an expert over capacity, and
segments whose start the reference's `dynamic_slice_in_dim` clamps), the
router's top k with tied probabilities, and `moe_ffn`'s output, Switch aux
loss and gradients with shared experts (deepseek's smoke shapes) and top-1
(llama4's), at float32 and bfloat16.

Tolerances: float32 atol 2e-6, rtol 1e-5 (outputs ~0.1-1; sums in other
orders over at most 96 terms); gradients relative L2 1e-5 per leaf, but
1e-4 for the router of a top-1 config: its one gate is v / v = 1, whose
derivative 1/v - v/v^2 is 0 up to rounding, so that part of the router's
gradient is float32 noise that each side rounds its own way (measured 3.4e-5
relative); bfloat16 outputs within 2^-7 of the largest output (one bf16
step: the expert products round to bf16 on both sides).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed.sharding import local_ctx as jlocal_ctx
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import ShardingCtx, local_ctx
from repro_torch.models import moe

ATOL, RTOL = 2e-6, 1e-5
GRAD_REL = 1e-5
TOP1_ROUTER_GRAD_REL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("n,k,e,f", [(32, 2, 4, 1.25), (4, 6, 64, 1.25), (4096, 6, 64, 1.25),
                                     (4096, 1, 128, 1.25), (7, 3, 8, 1.0), (100, 1, 8, 2.0)])
def test_capacity(n, k, e, f):
    assert moe._capacity(n, k, e, f) == jmoe._capacity(n, k, e, f)


def _ids(rng, N, k, E, skew):
    """Distinct experts per token; with `skew` every token picks expert 0
    first (expert 0 overflows its capacity)."""
    ids = np.stack([rng.permutation(E)[:k] for _ in range(N)]).astype(np.int32)
    if skew:
        for row in ids:
            j = np.flatnonzero(row == 0)
            if len(j):
                row[[0, j[0]]] = row[[j[0], 0]]
            else:
                row[0] = 0
    return ids


def _first_c(x, ids, gates, wg, wu, wo, C):
    """The routing's function in numpy, float64: each expert keeps its first
    C entries in (expert, token, slot) order; each kept entry adds its gated
    GLU output to its token."""
    N, k = ids.shape
    out = np.zeros((N, x.shape[1]))
    for e in range(wg.shape[0]):
        rows = [(t, j) for t in range(N) for j in range(k) if ids[t, j] == e][:C]
        for t, j in rows:
            hg, hu = x[t] @ wg[e], x[t] @ wu[e]
            out[t] += gates[t, j] * ((hg / (1 + np.exp(-hg)) * hu) @ wo[e])
    return out


@pytest.mark.parametrize("B,S,k,E,skew", [
    (2, 16, 2, 4, False),   # C 24 of 64 entries; the last experts' starts clamp
    (2, 16, 2, 4, True),    # expert 0 takes every token: 32 > C, 8 dropped
    (1, 24, 3, 8, False),   # C 16 of 72: several segments clamp
    (1, 3, 2, 8, False),    # C 8 > 6 entries: C = N k, every start clamps to 0
])
def test_routed_local(B, S, k, E, skew):
    rng = np.random.default_rng(B * 100 + S + k + skew)
    D, F = 12, 10
    N = B * S
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ids = _ids(rng, N, k, E, skew).reshape(B, S, k)
    gates = rng.uniform(0.1, 1.0, (B, S, k)).astype(np.float32)
    wg, wu = (rng.standard_normal((E, D, F)).astype(np.float32) * 0.3 for _ in range(2))
    wo = rng.standard_normal((E, F, D)).astype(np.float32) * 0.3
    kw = dict(k=k, n_experts=E, capacity=1.25, act="swiglu")
    want = jmoe._routed_local(*map(jnp.asarray, (x, ids, gates, wg, wu, wo)), e_local=E,
                              tp_axis=None, **kw)
    got = moe._routed_local(*map(_t, (x, ids, gates, wg, wu, wo)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    C = min(moe._capacity(N, k, E, 1.25), N * k)
    counts = np.bincount(ids.reshape(-1), minlength=E)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    assert (starts > N * k - C).any()  # a segment the clamp moves
    assert (counts > C).any() == skew  # an expert over capacity
    oracle = _first_c(*(a.astype(np.float64) for a in (x.reshape(N, D), ids.reshape(N, k),
                                                        gates.reshape(N, k), wg, wu, wo)), C)
    np.testing.assert_allclose(got.numpy().reshape(N, D), oracle, atol=1e-5, rtol=1e-5)


def _layer(arch, dtype, seed):
    """The smoke config at `dtype` and an MoE layer's parameters drawn with
    numpy: a router scaled so that routing spreads over the experts."""
    cj = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    ct = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    rng = np.random.default_rng(seed)
    D, E, F = ct.d_model, ct.moe_experts, ct.moe_d_ff
    Fs = ct.moe_shared * F
    p = {"router": rng.standard_normal((D, E)) * 0.3,
         "e_wg": rng.standard_normal((E, D, F)) * 0.1,
         "e_wu": rng.standard_normal((E, D, F)) * 0.1,
         "e_wo": rng.standard_normal((E, F, D)) * 0.1}
    if ct.moe_shared:
        p.update(shared_wg=rng.standard_normal((D, Fs)) * 0.1,
                 shared_wu=rng.standard_normal((D, Fs)) * 0.1,
                 shared_wo=rng.standard_normal((Fs, D)) * 0.1)
    x = rng.standard_normal((2, 24, D))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pj = {k: jnp.asarray(v, jnp.float32).astype(jdt) for k, v in p.items()}
    pt = {k: _t(v.astype(np.float32)).to(tdt) for k, v in p.items()}
    return cj, ct, pj, pt, jnp.asarray(x, jnp.float32).astype(jdt), _t(x.astype(np.float32)).to(tdt)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn(arch, dtype):
    cj, ct, pj, pt, xj, xt = _layer(arch, dtype, 1)
    oj, aj = jmoe.moe_ffn(xj, pj, cj, jlocal_ctx())
    ot, at = moe.moe_ffn(xt, pt, ct, local_ctx())
    assert ot.dtype == xt.dtype and at.dtype == torch.float32
    _, _, ids = moe.route(xt, pt["router"], ct)
    assert len(torch.unique(ids)) == ct.moe_experts  # every expert routed to
    want = np.asarray(oj.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(ot.numpy(), want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(float(at), float(aj), atol=1e-7, rtol=1e-6)
    else:
        assert np.abs(ot.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(float(at), float(aj), atol=0, rtol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llama4-maverick-400b-a17b"])
def test_moe_ffn_grads(arch):
    """float32 gradients of every parameter and the input through the
    routed experts, the gates, the router and the aux loss."""
    cj, ct, pj, pt, xj, xt = _layer(arch, "float32", 2)
    r = np.random.default_rng(3).standard_normal(xt.shape).astype(np.float32)

    def jloss(p, x):
        o, a = jmoe.moe_ffn(x, p, cj, jlocal_ctx())
        return jnp.sum(o * r) + 100 * a

    gpj, gxj = jax.grad(jloss, argnums=(0, 1))(pj, xj)
    leaves = [pt[k].requires_grad_(True) for k in sorted(pt)] + [xt.requires_grad_(True)]
    o, a = moe.moe_ffn(xt, pt, ct, local_ctx())
    grads = torch.autograd.grad(torch.sum(o * _t(r)) + 100 * a, leaves)
    for name, got, want in zip(sorted(pt) + ["x"], grads, [gpj[k] for k in sorted(pt)] + [gxj]):
        bound = TOP1_ROUTER_GRAD_REL if name == "router" and ct.moe_top_k == 1 else GRAD_REL
        assert _rel(got.numpy(), want) <= bound, name


def test_top_k_ties_go_to_the_lower_expert():
    """A router of zeros: every probability ties at 1/E, and lax.top_k
    takes experts 0..k-1; so does the port's stable descending sort, and
    the outputs agree."""
    cj, ct, pj, pt, xj, xt = _layer("deepseek-moe-16b", "float32", 4)
    pj = {**pj, "router": jnp.zeros_like(pj["router"])}
    pt = {**pt, "router": torch.zeros_like(pt["router"])}
    _, _, ids = moe.route(xt, pt["router"], ct)
    assert (ids == torch.arange(ct.moe_top_k, dtype=torch.int32)).all()
    oj, aj = jmoe.moe_ffn(xj, pj, cj, jlocal_ctx())
    ot, at = moe.moe_ffn(xt, pt, ct, local_ctx())
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=RTOL)
    assert float(at) == pytest.approx(float(aj), rel=1e-6)


def test_moe_ffn_gradient_under_a_mesh_equals_one_devices():
    """Gradients through the mesh moe_ffn (its local bodies, DTensor
    parameters, the Switch loss as a replicated scalar) on a (1, 1) mesh of
    one gloo rank: x's and every parameter's gradient equal to one device's,
    bit for bit.  The 4-rank arms are held to the reference in
    tests/test_torch_train_mesh.py."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import as_dtensor

    _, ct, _, pt, _, xt = _layer("deepseek-moe-16b", "float32", 5)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        ctx = ShardingCtx(mesh=mesh, strategy="tp")
        grads = {}
        for label in ("mesh", "one"):
            x = xt.clone().requires_grad_(True)
            if label == "mesh":
                p = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()]).requires_grad_()
                     for k, v in pt.items()}
                y, aux = moe.moe_ffn(as_dtensor(x, mesh), p, ct, ctx)
                total = (y.float() ** 2).sum().full_tensor() + aux
            else:
                p = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
                y, aux = moe.moe_ffn(x, p, ct, local_ctx())
                total = (y.float() ** 2).sum() + aux
            grads[label] = [g.full_tensor() if hasattr(g, "full_tensor") else g
                            for g in torch.autograd.grad(total, [x, *p.values()])]
    finally:
        dist.destroy_process_group()
    for got, want in zip(grads["mesh"], grads["one"]):
        assert torch.equal(got, want)
    assert float(grads["one"][1].abs().sum()) > 0  # the router learns through the gates
