"""The port's LM serving slice (`repro_torch.models`, `.configs`,
`.distributed`) against the JAX package: layers, parameter shapes and
conversion, `prefill` and `decode_step` on converted parameters, and the
bit-packed prompt path, for the dense family and the other five (the MoE,
SSM and hybrid ones: deepseek-moe, llama4-maverick, mamba2, hymba; the
enc-dec whisper and the VLM llava): also their `forward_train` loss and
gradients, decode ≡ prefill, hymba's ring caches past their wrap, the
non-gated gelu MLP, the encoder's non-causal attention over 1,500 frames,
and a VLM prefill that reads no `embeds` in either package.

Inputs are made with numpy from a seed and handed to both packages (an
enc-dec model's frames and a VLM's vision embeddings as bfloat16, as
tests/test_models.py makes them); parameters are the reference's own
`init_params`, carried across leaf for leaf by `params_from_reference`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import list_archs as jlist_archs
from repro.distributed.sharding import local_ctx as jlocal_ctx
from repro.lakeformat.encodings import bitpack_encode
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.distributed.sharding import ShardingCtx, constrain, local_ctx
from repro_torch.kernels import ops
from repro_torch.models import layers, model, transformer

DENSE = ["qwen3-1.7b", "granite-3-8b", "gemma-7b", "mistral-large-123b"]
FAMILIES = ["mamba2-370m", "hymba-1.5b", "deepseek-moe-16b", "llama4-maverick-400b-a17b",
            "whisper-base", "llava-next-34b"]

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


def _extra(cfg, rng, B):
    """A VLM's vision embeddings and an enc-dec model's frames, made as
    tests/test_models.py's `_batch` makes them: standard normal, as float32
    numpy arrays that each side casts to bfloat16."""
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _jbatch(tokens, extra):
    return {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v, jnp.bfloat16)
                                              for k, v in extra.items()}}


def _tbatch(tokens, extra):
    return {"tokens": _t(tokens), **{k: _t(v).bfloat16() for k, v in extra.items()}}


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
    (1, 1500, 1500, 4, 4, 16, 1024, False, None, None),  # whisper's encoder: chunks of 750
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


def test_encoder_attention_takes_chunks_of_750():
    assert layers._chunk_for(1500, 1024) == 750


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_block(dtype):
    """whisper's non-gated MLP, gelu(x @ w1, tanh) @ w2 after the norm, with
    the residual, on random weights of the smoke config's widths: float32 at
    LAYER_ATOL; bfloat16 at BF16_ATOL, the two packages' bf16 products
    rounding apart."""
    cj, ct = _configs("whisper-base", dtype)
    rng = np.random.default_rng(5)
    D, F = cj.d_model, cj.d_ff
    w = {"ln2": 1 + 0.1 * rng.standard_normal(D), "w1": 0.1 * rng.standard_normal((D, F)),
         "w2": 0.1 * rng.standard_normal((F, D))}
    h = rng.standard_normal((2, 37, D))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jtransformer.mlp_block(jnp.asarray(h, jdt),
                                  {k: jnp.asarray(v, jdt) for k, v in w.items()}, cj, jlocal_ctx())
    got = transformer.mlp_block(_t(h).to(tdt), {k: _t(v).to(tdt) for k, v in w.items()}, ct,
                                local_ctx())
    assert got.dtype == tdt and got.shape == (2, 37, D)
    assert set(model._mlp_shapes(ct)) == {"ln2", "w1", "w2"}
    atol, rtol = (LAYER_ATOL, LAYER_RTOL) if dtype == "float32" else (BF16_ATOL, 0)
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


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
    extra = _extra(cj, rng, B)
    lj, cache_j = jmodel.prefill(pj, _jbatch(toks[:, :S], extra), cj, cache_len=S + 8)
    lt, cache_t = model.prefill(pt, _tbatch(toks[:, :S], extra), ct, cache_len=S + 8)
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
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    extra = _extra(cfg, rng, B)
    _, caches = model.prefill(params, _tbatch(toks[:, :S], extra), cfg, cache_len=S + 8)
    l_full, _ = model.prefill(params, _tbatch(toks[:, :S + 1], extra), cfg, cache_len=S + 8)
    toks = _t(toks)
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
    llama4 18, whisper 16, llava 16 bits): packed ≡ tokens bit for bit, the
    cross-attention's ck/cv included, one bitunpack."""
    cfg = dataclasses.replace(get_smoke_config(arch), vocab=get_config(arch).vocab)
    k = model.token_bits(cfg)
    assert k == {"mamba2-370m": 16, "hymba-1.5b": 15, "deepseek-moe-16b": 17,
                 "llama4-maverick-400b-a17b": 18, "whisper-base": 16,
                 "llava-next-34b": 16}[arch]
    params = model.init_params(cfg, 2, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (1, 4096)).astype(np.int64)
    extra = {k: _t(v).bfloat16() for k, v in _extra(cfg, rng, 1).items()}
    packed = np.stack([bitpack_encode(toks[0], k)])
    ops.reset_dispatch_count()
    l_packed, c_packed = model.prefill(params, {"packed": _t(packed.view(np.int32)), **extra},
                                       cfg)
    assert ops.dispatch_count() == 1
    l_tokens, c_tokens = model.prefill(params, {"tokens": _t(toks.astype(np.int32)), **extra},
                                       cfg)
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
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cj.vocab, (2, 64)).astype(np.int32)
    extra = _extra(cj, rng, 2)

    def jloss(p):
        return jmodel.forward_train(p, _jbatch(toks, extra), cj)

    (lj, mj), gj = (jax.jit(jax.value_and_grad(jloss, has_aux=True))(pj) if dtype == "float32"
                    else (jax.jit(jloss)(pj), None))
    leaves = jax.tree_util.tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(dtype == "float32")
    lt, mt = model.forward_train(pt, _tbatch(toks, extra), ct)
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
# the enc-dec and VLM families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,top,layer", [
    ("whisper-base", {"enc_final_ln"}, {"x_ln1", "x_wq", "x_wk", "x_wv", "x_wo", "w1", "w2"}),
    ("llava-next-34b", {"vis_proj"}, {"wg", "wu", "wo2"}),
])
def test_new_leaves_carry_across_bit_for_bit(arch, top, layer):
    """The leaves that the two families add: whisper's `enc_final_ln`, its
    decoder's cross-attention (`x_`) and gelu MLP leaves (`w1`, `w2`, in the
    encoder too), llava's `vis_proj`; bf16 bit for bit, and `init_params`
    draws the same shapes (`enc_final_ln` and `x_ln1` ones)."""
    cj, _ = _configs(arch)
    pj, pt = _params(cj, 3)
    assert top <= set(pt) and layer <= set(pt["segments"][-1])
    for name in top:
        np.testing.assert_array_equal(pt[name].view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(pj[name]).view(np.uint16))
    for seg_t, seg_j in zip(pt["segments"], pj["segments"]):
        for name in layer & set(seg_j):
            np.testing.assert_array_equal(seg_t[name].view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(seg_j[name]).view(np.uint16), err_msg=name)
    drawn = model.init_params(get_smoke_config(arch), 0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), jax.tree.map(np.asarray, pj)) == \
        jax.tree.map(lambda t: tuple(t.shape), drawn, is_leaf=torch.is_tensor)
    if arch == "whisper-base":
        assert [(g.kind, g.count) for g in model.model_segments(get_config(arch))] == \
            [("enc", 6), ("decx", 6)]
        for w in (drawn["enc_final_ln"], drawn["segments"][1]["x_ln1"]):
            assert torch.equal(w, torch.ones_like(w))


def test_vlm_prefill_ignores_embeds_as_the_reference_does():
    """A trait of the reference that the port follows: `prefill` never reads
    a VLM batch's `embeds`, so its logits and caches are the same bit for bit
    with and without them, in both packages (float32); the port's
    `forward_train` does prepend them, and its loss moves (its value against
    the reference's is test_forward_train_and_grads_against_reference's)."""
    cj, ct = _configs("llava-next-34b", "float32")
    pj, pt = _params(cj, 6)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cj.vocab, (2, 40)).astype(np.int32)
    extra = _extra(cj, rng, 2)
    with_j, cache_wj = jmodel.prefill(pj, _jbatch(toks, extra), cj)
    without_j, cache_j = jmodel.prefill(pj, _jbatch(toks, {}), cj)
    with_t, cache_wt = model.prefill(pt, _tbatch(toks, extra), ct)
    without_t, cache_t = model.prefill(pt, _tbatch(toks, {}), ct)
    np.testing.assert_array_equal(np.asarray(with_j), np.asarray(without_j))
    assert all(np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for a, b in zip(cache_wj, cache_j) for k in a)
    assert torch.equal(with_t, without_t)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(cache_wt, cache_t) for k in a)
    np.testing.assert_allclose(with_t.numpy(), np.asarray(with_j), atol=F32_ATOL, rtol=F32_RTOL)
    lt, _ = model.forward_train(pt, _tbatch(toks, extra), ct)
    lt0, _ = model.forward_train(pt, _tbatch(toks, {}), ct)
    assert float(lt) != float(lt0)


def test_encoder_frames_reach_the_decoder():
    """whisper smoke at float32: other frames give other logits and
    cross-attention caches, the self-attention caches of layer 0 stay (they
    see only tokens); decode over the prefill's ck/cv equals the reference's
    (F32_ATOL)."""
    cj, ct = _configs("whisper-base", "float32")
    pj, pt = _params(cj, 7)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cj.vocab, (1, 33)).astype(np.int32)
    a, b = _extra(cj, rng, 1), _extra(cj, rng, 1)
    la, ca = model.prefill(pt, _tbatch(toks[:, :32], a), ct, cache_len=40)
    lb, cb = model.prefill(pt, _tbatch(toks[:, :32], b), ct, cache_len=40)
    assert ca[0] == {} and cb[0] == {}
    assert not torch.equal(la, lb) and not torch.equal(ca[1]["ck"], cb[1]["ck"])
    assert torch.equal(ca[1]["k"][0], cb[1]["k"][0])
    assert tuple(ca[1]["ck"].shape) == (ct.n_layers, 1, ct.encoder_seq, ct.n_kv, ct.head_dim)
    _, cj1 = jmodel.prefill(pj, _jbatch(toks[:, :32], a), cj, cache_len=40)
    dj, cj2 = jmodel.decode_step(pj, jnp.asarray(toks[:, 32:]), cj1, jnp.int32(32), cj)
    dt, ct2 = model.decode_step(pt, _t(toks[:, 32:]), ca, 32, ct)
    assert ct2[0] == {}
    _assert_close(dt, dj, ct2, cj2, F32_ATOL, F32_RTOL)


# ---------------------------------------------------------------------------
# every family under a mesh
# ---------------------------------------------------------------------------


def test_later_pieces_raise_naming_the_roadmap_item():
    """Every architecture resolves, as in the reference, and `constrain` is
    the identity without a mesh.  Nothing raises `NotImplementedError` under
    a mesh any more: the SSM, hybrid, enc-dec and VLM families (ROADMAP
    A.6b-ii, the last ones) prefill, decode and train under a (1, 1) mesh
    over a gloo group of one rank, bit for bit as without it (4 ranks:
    tests/test_torch_families_mesh.py and ..._train_mesh.py)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.compat import make_mesh
    from repro_torch.distributed.sharding import shard_params

    assert list_archs() == jlist_archs() and len(list_archs()) == 10
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jget_smoke(arch))
    for arch in ("deepseek-moe-16b", "mamba2-370m", "hymba-1.5b", "llama4-maverick-400b",
                 "llama4-maverick-400b-a17b", "whisper-base", "llava-next-34b"):
        assert get_config(arch).family in ("moe", "ssm", "hybrid", "audio", "vlm")
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("whisper-large")
    x = torch.zeros(2, 3)
    assert constrain(x, ("batch", None), local_ctx()) is x
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = ShardingCtx(mesh=make_mesh((1, 1), ("data", "model"), device="cpu"))
        for arch in ("mamba2-370m", "hymba-1.5b", "whisper-base", "llava-next-34b"):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", n_layers=2)
            params = model.init_params(cfg, 0, device="cpu")
            rng = np.random.default_rng(0)
            batch = {"tokens": _t(rng.integers(0, cfg.vocab, (1, 40)).astype(np.int32)),
                     **{k: _t(v) for k, v in _extra(cfg, rng, 1).items()}}
            got = {}
            for label, ctx, p in (("mesh", mesh, shard_params(params, cfg, mesh)),
                                  ("none", None, params)):
                logits, caches = model.prefill(p, batch, cfg, ctx, cache_len=48)
                step, _ = model.decode_step(p, batch["tokens"][:, :1], caches, 40, cfg, ctx)
                loss, _ = model.forward_train(p, batch, cfg, ctx)
                got[label] = [t.full_tensor() if isinstance(t, DTensor) else t
                              for t in (logits, step, loss)]
                assert isinstance(logits, DTensor) == (label == "mesh")
            for a, b in zip(got["mesh"], got["none"]):
                assert torch.equal(a, b), arch
    finally:
        dist.destroy_process_group()
