"""The port's LM serving slice (`repro_torch.models`, `.configs`,
`.distributed`) against the JAX package: layers, parameter shapes and
conversion, `prefill` and `decode_step` on converted parameters, and the
bit-packed prompt path, for the dense family and the decoder-only MoE, SSM
and hybrid ones (deepseek-moe, llama4-maverick, mamba2, hymba): also their
`forward_train` loss and gradients, decode ≡ prefill, and hymba's ring
caches past their wrap.

Inputs are made with numpy from a seed and handed to both packages;
parameters are the reference's own `init_params`, carried across leaf for
leaf by `params_from_reference`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.distributed.sharding import local_ctx as jlocal_ctx
from repro.lakeformat.encodings import bitpack_encode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.distributed.sharding import ShardingCtx, constrain, local_ctx
from repro_torch.kernels import ops
from repro_torch.models import layers, model, moe, transformer

DENSE = ["qwen3-1.7b", "granite-3-8b", "gemma-7b", "mistral-large-123b"]
FAMILIES = ["mamba2-370m", "hymba-1.5b", "deepseek-moe-16b", "llama4-maverick-400b-a17b"]

# float32 layers: XLA and torch sum in other orders and their f32 sin, cos,
# pow and rsqrt may differ by an ulp; on unit-scale inputs that stays within
# a few 1e-6 (measured up to 4.8e-6, rotary at angles of ~3,600 rad).
LAYER_ATOL, LAYER_RTOL = 2e-5, 1e-5
# float32 model: the same rounding carried through 3 layers and the head;
# logits and caches are of unit scale (measured ~1e-6).
F32_ATOL, F32_RTOL = 2e-5, 1e-5
# bfloat16 model: the bound of tests/test_models.py:81 for serve vs train.
BF16_ATOL = 5e-2
# bfloat16 bounds by architecture, tests/test_models.py's PREFILL_DECODE_TOL:
# the llama4 smoke config's two bf16 expert sums and router softmax measure
# 0.0636 there between its own decode and prefill; the port against the
# reference rounds them apart the same way (one k-cache element of the second
# pair measures 0.053).  Used for decode against prefill and for the bf16
# port against the reference.
PREFILL_DECODE_TOL = {"llama4-maverick-400b-a17b": 1e-1}
# gradients at float32: relative L2 per leaf (test_torch_train.py's bound)
GRAD_REL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _configs(arch, dtype=None):
    cj, ct = jget_smoke(arch), get_smoke_config(arch)
    if dtype:
        cj, ct = dataclasses.replace(cj, dtype=dtype), dataclasses.replace(ct, dtype=dtype)
    return cj, ct


def _params(cj, seed):
    pj = jmodel.init_params(cj, jax.random.PRNGKey(seed))
    return pj, model.params_from_reference(jax.tree.map(np.asarray, pj), device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm(plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, 4, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6, plus_one)
    got = layers.rmsnorm(_t(x), _t(w), 1e-6, plus_one)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, rtol=LAYER_RTOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rotary(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(37, dtype=np.int32) * 100, (2, 37)).copy()
    want = jlayers.rotary(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rotary(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, rtol=LAYER_RTOL)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,chunk,causal,win,kvl", [
    (2, 300, 300, 4, 2, 16, 128, True, None, None),   # Sq > chunk, 300 % 128: chunks of 100
    (1, 262, 262, 4, 2, 16, 128, True, None, None),   # divisor 2 <= 64: one chunk of 262
    (2, 256, 256, 4, 2, 16, 64, True, None, None),    # 4 whole chunks
    (2, 64, 64, 4, 4, 32, 1024, True, 16, None),      # sliding window
    (3, 1, 80, 4, 2, 16, 1024, False, None, 50),      # decode: kv_valid_len
])
def test_attention(B, Sq, Skv, H, KV, hd, chunk, causal, win, kvl):
    rng = np.random.default_rng(Sq + chunk)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=win, chunk=chunk, kv_valid_len=kvl)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jlocal_ctx(), **kw)
    got = layers.attention(_t(q), _t(k), _t(v), local_ctx(), **kw)
    assert got.shape == (B, Sq, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, rtol=LAYER_RTOL)


def test_attention_matches_the_kernel_oracle():
    """layers.attention (B,S,H,hd) is ref.mha (B,H,S,D) in another layout."""
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((2, 96, 4, 32)).astype(np.float32))
    k = _t(rng.standard_normal((2, 96, 2, 32)).astype(np.float32))
    v = _t(rng.standard_normal((2, 96, 2, 32)).astype(np.float32))
    got = layers.attention(q, k, v, local_ctx(), chunk=32).transpose(1, 2)
    want = ops.flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LAYER_ATOL, rtol=LAYER_RTOL)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_param_shapes_match_reference_at_full_size(arch):
    assert model.param_shapes(get_config(arch)) == jmodel.param_shapes(jget_config(arch))


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_params_from_reference_is_bit_exact(arch):
    """Every leaf bit for bit in its own dtype: the SSM's A_log and dt_bias
    stay float32 in a bfloat16 model."""
    cj, _ = _configs(arch)
    pj, pt = _params(cj, 3)
    dtypes = {str(leaf.dtype) for leaf in jax.tree_util.tree_leaves(pt)}
    assert dtypes == ({"torch.bfloat16", "torch.float32"} if cj.ssm_heads else {"torch.bfloat16"})
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(pt))
    for path, leaf in flat_j:
        got = pt
        for key in path:
            got = got[key.key if hasattr(key, "key") else key.idx]
        want = np.asarray(leaf)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype) == f"torch.{want.dtype.name}", path
        bits = np.uint16 if want.dtype.itemsize == 2 else np.uint32
        sint = torch.int16 if want.dtype.itemsize == 2 else torch.int32
        np.testing.assert_array_equal(got.view(sint).numpy().view(bits), want.view(bits),
                                      err_msg=str(path))


def test_init_params_distributions_and_seed():
    cfg = get_smoke_config("gemma-7b")  # (1 + w) norms: zeros
    shapes, _ = model.param_shapes(cfg)
    a = model.init_params(cfg, 0, device="cpu")
    b = model.init_params(cfg, 0, device="cpu")
    c = model.init_params(cfg, 1, device="cpu")
    assert tuple(a["embed"].shape) == shapes["embed"] and a["embed"].dtype == torch.bfloat16
    seg = a["segments"][0]
    assert {k: tuple(v.shape) for k, v in seg.items()} == shapes["segments"][0]
    assert torch.equal(seg["ln1"], torch.zeros_like(seg["ln1"]))
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
    assert abs(float(a["embed"].float().std()) - 0.02) < 2e-3
    wo_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(float(seg["wo"].float().std()) - wo_std) < 0.1 * wo_std
    q = model.init_params(get_smoke_config("qwen3-1.7b"), 0, device="cpu")
    assert torch.equal(q["segments"][0]["qn"], torch.ones_like(q["segments"][0]["qn"]))


def test_init_params_ssm_and_moe_leaves():
    """hymba's SSM leaves and llama4's experts: A_log = log U(1, 16) and
    dt_bias = log(expm1(U(1e-3, 0.1))) in float32 in a bfloat16 model,
    D_skip, conv_b, the mixing norms and betas 1, the output projections
    (out_proj, the shared expert's) at 0.02 / sqrt(2 L), the routed
    experts' at 0.02; the shapes are param_shapes'."""
    cfg = get_smoke_config("hymba-1.5b")
    p = model.init_params(cfg, 0, device="cpu")
    shapes, _ = model.param_shapes(cfg)
    for seg, shp in zip(p["segments"], shapes["segments"]):
        assert {k: tuple(v.shape) for k, v in seg.items()} == shp
    seg = p["segments"][1]
    a, dt = seg["s_A_log"], seg["s_dt_bias"]
    assert a.dtype == dt.dtype == torch.float32 and seg["wq"].dtype == torch.bfloat16
    assert float(a.exp().min()) >= 1.0 and float(a.exp().max()) < 16.0
    u = torch.log1p(dt.exp())  # softplus(dt_bias) recovers U(1e-3, 0.1)
    assert float(u.min()) >= 1e-3 - 1e-7 and float(u.max()) < 0.1 + 1e-7
    for k in ("s_D_skip", "s_conv_b", "s_norm_y", "na", "ns", "beta_a", "beta_s", "ln1", "ln2"):
        assert torch.equal(seg[k], torch.ones_like(seg[k])), k
    std = 0.02 / np.sqrt(2 * cfg.n_layers)
    assert abs(float(seg["s_out_proj"].float().std()) - std) < 0.15 * std
    l4 = get_smoke_config("llama4-maverick-400b-a17b")
    seg = model.init_params(l4, 0, device="cpu")["segments"][0]
    std = 0.02 / np.sqrt(2 * l4.n_layers)
    assert abs(float(seg["b_shared_wo"].float().std()) - std) < 0.15 * std
    assert abs(float(seg["b_e_wo"].float().std()) - 0.02) < 2e-3
    assert torch.equal(seg["a_ln1"], torch.ones_like(seg["a_ln1"]))


# ---------------------------------------------------------------------------
# prefill / decode against the reference
# ---------------------------------------------------------------------------


def _prefill_decode(cj, ct, pj, pt, B=2, S=48):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cj.vocab, (B, S + 1)).astype(np.int32)
    lj, cache_j = jmodel.prefill(pj, {"tokens": jnp.asarray(toks[:, :S])}, cj, cache_len=S + 8)
    lt, cache_t = model.prefill(pt, {"tokens": _t(toks[:, :S])}, ct, cache_len=S + 8)
    pre = (lj, lt, cache_j, [{k: c.clone() for k, c in seg.items()} for seg in cache_t])
    dj, cache_j = jmodel.decode_step(pj, jnp.asarray(toks[:, S:]), cache_j, jnp.int32(S), cj)
    dt, cache_t = model.decode_step(pt, _t(toks[:, S:]), cache_t, S, ct)
    return pre, (dj, dt, cache_j, cache_t)


def _assert_close(got_logits, want_logits, got_caches, want_caches, atol, rtol):
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), atol=atol, rtol=rtol)
    assert len(got_caches) == len(want_caches)
    for gs, ws in zip(got_caches, want_caches):
        assert sorted(gs) == sorted(ws)
        for k in ws:
            assert tuple(gs[k].shape) == ws[k].shape
            np.testing.assert_allclose(_np(gs[k]), _np(ws[k]), atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-8b", "gemma-7b"] + FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    cj, ct = _configs(arch, dtype)
    pj, pt = _params(cj, 1)
    (lj, lt, cj1, ct1), (dj, dt, cj2, ct2) = _prefill_decode(cj, ct, pj, pt)
    assert lt.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    atol, rtol = ((F32_ATOL, F32_RTOL) if dtype == "float32"
                  else (PREFILL_DECODE_TOL.get(arch, BF16_ATOL), 0))
    _assert_close(lt, lj, ct1, cj1, atol, rtol)
    _assert_close(dt, dj, ct2, cj2, atol, rtol)


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_port_prefill_decode_matches_prefill(arch):
    """serve path consistency (tests/test_models.py:66-81): decode logits at
    position S equal the prefill logits of the (S+1)-token prompt."""
    cfg = get_smoke_config(arch)
    params = model.init_params(cfg, 1, device="cpu")
    rng = np.random.default_rng(1)
    B, S = 2, 64
    toks = _t(rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))
    _, caches = model.prefill(params, {"tokens": toks[:, :S]}, cfg, cache_len=S + 8)
    l_full, _ = model.prefill(params, {"tokens": toks[:, :S + 1]}, cfg, cache_len=S + 8)
    l_dec, _ = model.decode_step(params, toks[:, S:S + 1], caches, S, cfg)
    err = float((l_dec.float() - l_full.float()).abs().max())
    assert err < PREFILL_DECODE_TOL.get(arch, BF16_ATOL), (arch, err)


def test_capacity_drops_part_decode_from_prefill_as_in_the_reference():
    """A trait of the reference's MoE, not of the port: a prefill keeps each
    expert's first C (token, expert) entries in token order, so an expert
    over capacity drops the last token first, and a one-token decode drops
    nothing.  llama4 smoke cut to 2 layers at float32, tokens of seed 3: the
    41-token prefill drops its last token (its expert gets 9 entries, C 8),
    and decode at 40 differs from that prefill's logits in both packages
    alike; at moe_capacity E / k (C = N: nothing dropped) decode ≡ prefill."""
    cj, ct = _configs("llama4-maverick-400b-a17b", "float32")
    cj, ct = (dataclasses.replace(c, n_layers=2) for c in (cj, ct))
    pj, pt = _params(cj, 0)
    S = 40
    seq = np.random.default_rng(3).integers(0, cj.vocab, (1, S + 1)).astype(np.int32)

    def gap(cfg_j, cfg_t):
        out = []
        for pre, dec, p, cfg, tok, pos in (
                (jmodel.prefill, jmodel.decode_step, pj, cfg_j, jnp.asarray, jnp.int32(S)),
                (model.prefill, model.decode_step, pt, cfg_t, _t, S)):
            full, _ = pre(p, {"tokens": tok(seq)}, cfg, cache_len=S + 8)
            _, caches = pre(p, {"tokens": tok(seq[:, :S])}, cfg, cache_len=S + 8)
            d, _ = dec(p, tok(seq[:, S:]), caches, pos, cfg)
            out.append((_np(full), _np(d)))
        (fj, dj), (ft, dt) = out
        np.testing.assert_allclose(ft, fj, atol=F32_ATOL, rtol=F32_RTOL)
        np.testing.assert_allclose(dt, dj, atol=F32_ATOL, rtol=F32_RTOL)
        return [float(np.linalg.norm(d - f) / np.linalg.norm(f)) for f, d in ((fj, dj), (ft, dt))]

    assert min(gap(cj, ct)) > 0.1
    wide = {"moe_capacity": cj.moe_experts / cj.moe_top_k}
    assert max(gap(dataclasses.replace(cj, **wide), dataclasses.replace(ct, **wide))) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sliding_window_ring_cache(dtype):
    """tests/test_models.py:99's case on the port: hymba smoke (window 32),
    a prefill of 48 tokens, then 32 decode steps, past two wraps of the
    ring: the last logits equal the full 80-token prefill's (bf16: the
    reference test's 5e-2), and each step's logits and caches the
    reference's decode steps' (float32 at F32_ATOL)."""
    cj, ct = _configs("hymba-1.5b", dtype)
    pj, pt = _params(cj, 3)
    rng = np.random.default_rng(3)
    n_total, n0 = 80, 48
    toks = rng.integers(0, cj.vocab, (1, n_total)).astype(np.int32)
    l_ref, _ = model.prefill(pt, {"tokens": _t(toks)}, ct, cache_len=n_total)
    _, caches = model.prefill(pt, {"tokens": _t(toks[:, :n0])}, ct, cache_len=n_total)
    _, jcaches = jmodel.prefill(pj, {"tokens": jnp.asarray(toks[:, :n0])}, cj, cache_len=n_total)
    windowed = [i for i, seg in enumerate(model.model_segments(ct)) if seg.window]
    assert windowed and all(caches[i]["k"].shape[2] == ct.window for i in windowed)
    step = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos, cj))
    for t in range(n0, n_total):
        logits, caches = model.decode_step(pt, _t(toks[:, t:t + 1]), caches, t, ct)
        jlogits, jcaches = step(pj, jnp.asarray(toks[:, t:t + 1]), jcaches, jnp.int32(t))
        if dtype == "float32":
            _assert_close(logits, jlogits, caches, jcaches, F32_ATOL, F32_RTOL)
    err = float((logits.float() - l_ref.float()).abs().max())
    assert err < (BF16_ATOL if dtype == "bfloat16" else F32_ATOL), err


def test_packed_prompt_equals_tokens_bit_for_bit():
    """The datapath path: a bit-packed 4096-token prompt, unpacked by
    ops.bitunpack inside prefill, gives the same logits and caches bit for
    bit as the decoded tokens."""
    cfg = get_smoke_config("qwen3-1.7b")
    params = model.init_params(cfg, 2, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 2, 4096
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    k = model.token_bits(cfg)
    packed = np.stack([bitpack_encode(toks[i], k) for i in range(B)])
    assert model.packed_token_shape(cfg, B, S) == packed.shape
    ops.reset_dispatch_count()
    l_packed, c_packed = model.prefill(params, {"packed": _t(packed.view(np.int32))}, cfg)
    assert ops.dispatch_count() == 1  # one bitunpack over both prompts
    l_tokens, c_tokens = model.prefill(params, {"tokens": _t(toks.astype(np.int32))}, cfg)
    assert torch.equal(l_packed, l_tokens)
    for k in ("k", "v"):
        assert torch.equal(c_packed[0][k], c_tokens[0][k])


@pytest.mark.parametrize("arch", FAMILIES)
def test_packed_prompt_at_each_familys_k(arch):
    """The smoke config with the full config's vocabulary, so that the
    prompt packs at the family's own k (mamba2 16, hymba 15, deepseek 17,
    llama4 18 bits): packed ≡ tokens bit for bit, one bitunpack."""
    cfg = dataclasses.replace(get_smoke_config(arch), vocab=get_config(arch).vocab)
    k = model.token_bits(cfg)
    assert k == {"mamba2-370m": 16, "hymba-1.5b": 15, "deepseek-moe-16b": 17,
                 "llama4-maverick-400b-a17b": 18}[arch]
    params = model.init_params(cfg, 2, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 4096)).astype(np.int64)
    packed = np.stack([bitpack_encode(toks[0], k)])
    ops.reset_dispatch_count()
    l_packed, c_packed = model.prefill(params, {"packed": _t(packed.view(np.int32))}, cfg)
    assert ops.dispatch_count() == 1
    l_tokens, c_tokens = model.prefill(params, {"tokens": _t(toks.astype(np.int32))}, cfg)
    assert torch.equal(l_packed, l_tokens)
    for a, b in zip(c_packed, c_tokens):
        assert all(torch.equal(a[key], b[key]) for key in b)


# ---------------------------------------------------------------------------
# forward_train on the families
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_and_grads_against_reference(arch, dtype):
    """The loss with the MoE layers' aux loss added, the aux loss itself
    (float32 within 1e-7; bfloat16 within 1e-4, the float32 router reading
    activations that round apart), and at float32 every leaf's gradient
    (relative L2 per leaf)."""
    cj, ct = _configs(arch, dtype)
    pj, pt = _params(cj, 0)
    toks = np.random.default_rng(1).integers(0, cj.vocab, (2, 64)).astype(np.int32)
    def jloss(p):
        return jmodel.forward_train(p, {"tokens": jnp.asarray(toks)}, cj)

    (lj, mj), gj = (jax.value_and_grad(jloss, has_aux=True)(pj) if dtype == "float32"
                    else (jloss(pj), None))
    leaves = jax.tree_util.tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(dtype == "float32")
    lt, mt = model.forward_train(pt, {"tokens": _t(toks)}, ct)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=atol, rtol=0)
    np.testing.assert_allclose(float(mt["aux_loss"].detach()), float(mj["aux_loss"]),
                               atol=1e-7 if dtype == "float32" else 1e-4, rtol=0)
    assert (float(mj["aux_loss"]) > 0) == bool(ct.moe_experts)
    if dtype == "float32":
        gt = torch.autograd.grad(lt, leaves)
        for got, want in zip(gt, jax.tree_util.tree_leaves(gj)):
            assert tuple(got.shape) == want.shape and got.dtype == torch.float32
            assert _rel(got.numpy(), want) <= GRAD_REL


# ---------------------------------------------------------------------------
# what the slice does not port yet
# ---------------------------------------------------------------------------


def test_later_pieces_raise_naming_the_roadmap_item():
    """What still raises: the enc-dec and VLM families (A.5b-ii), the
    non-gated gelu MLP, and anything under a mesh, the expert-parallel
    moe_ffn included (A.6)."""
    assert list_archs() == ["llama4_maverick_400b", "deepseek_moe_16b", "qwen3_1_7b",
                            "gemma_7b", "mistral_large_123b", "granite_3_8b", "mamba2_370m",
                            "hymba_1_5b"]
    for arch in ("deepseek-moe-16b", "mamba2-370m", "hymba-1.5b", "llama4-maverick-400b",
                 "llama4-maverick-400b-a17b"):
        assert get_config(arch).family in ("moe", "ssm", "hybrid")
    for arch in ("whisper-base", "llava-next-34b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.5b-ii"):
            get_smoke_config(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.5b-ii"):
            get_config(arch)
    qwen = get_smoke_config("qwen3-1.7b")
    for family in ("audio", "vlm"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.5b-ii"):
            model.param_shapes(dataclasses.replace(qwen, family=family))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5b-ii"):
        model.param_shapes(dataclasses.replace(qwen, encoder_layers=2))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5b-ii"):
        model.param_shapes(dataclasses.replace(qwen, act="gelu"))
    x = torch.zeros(2, 3)
    assert constrain(x, ("batch", None), local_ctx()) is x
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        constrain(x, ("batch", None), ShardingCtx(mesh=object()))
    ds = get_smoke_config("deepseek-moe-16b")
    layer = transformer._layer(model.init_params(ds, 0, device="cpu")["segments"][1], 0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        moe.moe_ffn(torch.zeros(1, 4, ds.d_model, dtype=torch.bfloat16), layer, ds,
                    ShardingCtx(mesh=object()))
