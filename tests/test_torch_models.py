"""The port's LM serving slice (`repro_torch.models`, `.configs`,
`.distributed`) against the JAX package: layers, parameter shapes and
conversion, `prefill` and `decode_step` on converted parameters, and the
bit-packed prompt path.

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
from repro_torch.models import layers, model

DENSE = ["qwen3-1.7b", "granite-3-8b", "gemma-7b", "mistral-large-123b"]

# float32 layers: XLA and torch sum in other orders and their f32 sin, cos,
# pow and rsqrt may differ by an ulp; on unit-scale inputs that stays within
# a few 1e-6 (measured up to 4.8e-6, rotary at angles of ~3,600 rad).
LAYER_ATOL, LAYER_RTOL = 2e-5, 1e-5
# float32 model: the same rounding carried through 3 layers and the head;
# logits and caches are of unit scale (measured ~1e-6).
F32_ATOL, F32_RTOL = 2e-5, 1e-5
# bfloat16 model: the bound of tests/test_models.py:81 for serve vs train.
BF16_ATOL = 5e-2


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


@pytest.mark.parametrize("arch", DENSE)
def test_param_shapes_match_reference_at_full_size(arch):
    assert model.param_shapes(get_config(arch)) == jmodel.param_shapes(jget_config(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_reference_is_bit_exact(arch):
    cj, _ = _configs(arch)
    pj, pt = _params(cj, 3)
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


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-3-8b", "gemma-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(arch, dtype):
    cj, ct = _configs(arch, dtype)
    pj, pt = _params(cj, 1)
    (lj, lt, cj1, ct1), (dj, dt, cj2, ct2) = _prefill_decode(cj, ct, pj, pt)
    assert lt.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    atol, rtol = (F32_ATOL, F32_RTOL) if dtype == "float32" else (BF16_ATOL, 0)
    _assert_close(lt, lj, ct1, cj1, atol, rtol)
    _assert_close(dt, dj, ct2, cj2, atol, rtol)


@pytest.mark.parametrize("arch", DENSE)
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
    assert err < BF16_ATOL, (arch, err)


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


# ---------------------------------------------------------------------------
# what the slice does not port yet
# ---------------------------------------------------------------------------


def test_later_pieces_raise_naming_the_roadmap_item():
    assert list_archs() == ["qwen3_1_7b", "gemma_7b", "mistral_large_123b", "granite_3_8b"]
    for arch in ("deepseek-moe-16b", "mamba2-370m", "hymba-1.5b", "whisper-base",
                 "llava-next-34b", "llama4-maverick-400b-a17b"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
            get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
        model.param_shapes(dataclasses.replace(get_smoke_config("qwen3-1.7b"), family="ssm"))
    x = torch.zeros(2, 3)
    assert constrain(x, ("batch", None), local_ctx()) is x
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        constrain(x, ("batch", None), ShardingCtx(mesh=object()))
