"""The port's attention oracle (`repro_torch.kernels.ref.mha`) and its
`ops.flash_attention` on CPU tensors, against the JAX package's `ref.mha` and
its Pallas `flash_attention` kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages as
float32 (or rounded to bfloat16 the same way on both sides).
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as cu_flash
from repro_torch.kernels import ops, ref

# The reference test's own tolerance for the Pallas kernel against ref.mha
# (tests/test_kernels.py): float32 sums in another order.
ATOL, RTOL = 3e-5, 1e-4


def _qkv(seed, B, H, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32) * 0.3,
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32) * 0.3,
            rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32) * 0.3)


def _port(fn, q, k, v, **kw):
    return fn(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()


def _jax(fn, q, k, v, **kw):
    return np.asarray(fn(*(jnp.asarray(x) for x in (q, k, v)), **kw))


# the four shapes of tests/test_kernels.py::test_flash_attention_vs_ref
SHAPES = [(2, 4, 2, 256, 64, None), (1, 8, 8, 256, 128, None), (1, 4, 1, 512, 64, 128),
          (1, 2, 2, 256, 256, None)]


@pytest.mark.parametrize("B,H,Hkv,S,D,win", SHAPES)
def test_mha_matches_reference_and_pallas(B, H, Hkv, S, D, win):
    q, k, v = _qkv(B + H + S, B, H, Hkv, S, S, D)
    want_ref = _jax(jref.mha, q, k, v, causal=True, window=win)
    want_pallas = _jax(jops.flash_attention, q, k, v, causal=True, window=win,
                       backend="pallas", bq=128, bk=128)
    for got in (_port(ref.mha, q, k, v, causal=True, window=win),
                _port(ops.flash_attention, q, k, v, causal=True, window=win)):
        np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)


def test_mha_bfloat16():
    """bf16 in, bf16 out: both compute in float32 and round once, so they may
    differ by one bf16 rounding step, at most 2^-7 of the largest output."""
    q, k, v = _qkv(7, 2, 4, 2, 192, 192, 64)
    to_bf16 = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = jref.mha(to_bf16(q), to_bf16(k), to_bf16(v))
    assert want.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(np.asarray(to_bf16(x), np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    for got in (ref.mha(tq, tk, tv), ops.flash_attention(tq, tk, tv)):
        assert got.dtype == torch.bfloat16
        want32 = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want32).max()
        assert err <= 2.0 ** -7 * np.abs(want32).max(), err


@pytest.mark.parametrize("Sq,Sk,causal,win", [
    (200, 200, True, None),    # a length that is not a multiple of 64
    (256, 256, False, None),   # non-causal
    (96, 320, True, None),     # Sq < Sk: ends aligned, queries at 224..319
    (320, 96, True, None),     # Sq > Sk: the first 224 rows see no key, mean of V
    (130, 130, False, 32),     # non-causal sliding window
    (70, 70, True, 5),         # a short causal window on a ragged length
])
def test_mha_aligned_ends_and_masks(Sq, Sk, causal, win):
    q, k, v = _qkv(Sq * 7 + Sk, 2, 4, 2, Sq, Sk, 32)
    want = _jax(jref.mha, q, k, v, causal=causal, window=win)
    for got in (_port(ref.mha, q, k, v, causal=causal, window=win),
                _port(ops.flash_attention, q, k, v, causal=causal, window=win)):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_non_causal_against_pallas():
    q, k, v = _qkv(11, 1, 4, 2, 256, 256, 64)
    want = _jax(jops.flash_attention, q, k, v, causal=False, backend="pallas", bq=128, bk=128)
    np.testing.assert_allclose(_port(ops.flash_attention, q, k, v, causal=False), want,
                               atol=ATOL, rtol=RTOL)


def test_rows_without_keys_average_v():
    """With every logit at -1e30 softmax is uniform over all Sk keys."""
    q, k, v = _qkv(3, 1, 2, 2, 8, 4, 16)
    got = _port(ref.mha, q, k, v, causal=True)  # Sq > Sk: rows 0..3 see no key
    np.testing.assert_allclose(got[:, :, :4], np.broadcast_to(v.mean(axis=2, keepdims=True),
                                                              (1, 2, 4, 16)), atol=1e-6)


def test_flash_attention_is_the_twelfth_kernel_and_counts_no_dispatch():
    assert list(ops.KERNELS)[-1] == "flash_attention" and len(ops.KERNELS) == 12
    kern = ops.KERNELS["flash_attention"]
    assert kern.replaces == "src/repro/kernels/flash_attention.py:82"
    assert kern.source == cu_flash.SOURCES["wgmma"]
    assert cu_flash.SOURCES == {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                                "cuda_cores": "src/repro_torch/kernels/csrc/flash_attention.cu"}
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 2, 1, 64, 64, 16))
    ops.reset_dispatch_count()
    launches = kern.launches
    ops.flash_attention(q, k, v)
    # the CPU runs the plain version: no dispatch counted (as in the
    # reference) and no kernel launch
    assert ops.dispatch_count() == 0 and kern.launches == launches


def test_kernel_wrapper_raises_on_what_it_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 4, 2, 64, 64, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cu_flash.flash_attention(q, k, v)
    q48 = torch.zeros((1, 4, 64, 48))
    with pytest.raises(ValueError, match="head dim"):
        cu_flash.flash_attention(q48, q48, q48)
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q, k.to("meta"), v)


LOG2E = 1.4426950408889634


def _wgmma_model(q, k, v, causal=True, window=None, scale=None, bk=64):
    """The arithmetic of csrc/flash_attention_wgmma.cu, tile by tile over
    64-key tiles, in plain torch: bf16 q, k, v; float32 logits, scaled into
    the log2 domain, masked (-1e30, or -inf past Sk); float32 running max m;
    P = 2^(x - m), summed into l in float32 and rounded to bf16 before P V;
    the output O / l rounded once to bf16.  Every tile is visited: a tile the
    kernel skips adds exactly nothing here (P = 0 against a real running max,
    or weights that the first real max multiplies by 2^-1e30 = 0)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    vf = v.float().repeat_interleave(H // Hkv, dim=1)
    scale_log2 = torch.tensor((scale if scale is not None else D ** -0.5), dtype=torch.float32)
    scale_log2 = scale_log2 * torch.tensor(LOG2E, dtype=torch.float32)
    pos = torch.arange(Sq)[:, None] + (Sk - Sq)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Sk, bk):
        keys = torch.arange(k0, k0 + bk)[None, :]
        kt = torch.zeros((B, H, bk, D))
        vt = torch.zeros((B, H, bk, D))
        n = min(bk, Sk - k0)
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        x = (q.float() @ kt.transpose(2, 3)) * scale_log2
        seen = torch.ones((Sq, bk), dtype=torch.bool)
        if causal:
            seen &= keys <= pos
        if window is not None:
            seen &= pos - keys < window
        x = torch.where(seen, x, torch.tensor(-1e30))
        x = torch.where(keys < Sk, x, torch.tensor(-float("inf")))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        p = torch.exp2(x - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (o / l).to(torch.bfloat16)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,win,std", [
    (1, 16, 8, 1024, 1024, 128, True, None, 1.0),   # qwen3's widths
    (1, 16, 8, 1024, 1024, 128, True, None, 2.0),
    (1, 4, 2, 512, 512, 64, True, None, 0.3),
    (1, 4, 2, 512, 512, 256, True, None, 1.0),       # gemma-7b's head dim
    (1, 4, 2, 300, 300, 128, True, 5, 1.0),          # a window smaller than a tile
    (1, 4, 2, 200, 456, 128, True, None, 1.0),       # Sq < Sk
    (1, 4, 2, 456, 200, 128, True, None, 2.0),       # Sq > Sk: 256 rows see no key
])
def test_bf16_probabilities_stay_within_one_bf16_step(B, H, Hkv, Sq, Sk, D, causal, win, std):
    """Rounding P to bf16 before P V (the tensor-core kernel's one departure
    from ref.mha, which keeps P in float32) stays within the bf16 rule of the
    card tests against the JAX package's ref.mha: 2^-7 of the largest output
    of each row, so a row that averages a thousand keys is held to its own
    scale and not to that of a row that sees a few."""
    rng = np.random.default_rng(Sq * 13 + Sk + D)
    arrays = [rng.standard_normal(s).astype(np.float32) * std
              for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]
    bf = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    want = np.asarray(jref.mha(*bf, causal=causal, window=win), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) for x in bf)
    got = _wgmma_model(tq, tk, tv, causal=causal, window=win).float().numpy()
    assert np.isfinite(got).all()
    ratio = np.abs(got - want) / (2.0 ** -7 * np.abs(want).max(axis=-1, keepdims=True))
    assert ratio.max() <= 1.0, ratio.max()


@pytest.mark.parametrize("dtype,D,way", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 16, "cuda_cores"), (torch.bfloat16, 32, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.float32, 256, "cuda_cores")])
def test_route_is_a_rule_on_dtype_and_head_dim(dtype, D, way):
    assert cu_flash.route(dtype, D) == way
