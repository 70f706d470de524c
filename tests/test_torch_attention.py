"""The port's attention oracle (`repro_torch.kernels.ref.mha`) and its
`ops.flash_attention` on CPU tensors, against the JAX package's `ref.mha` and
its Pallas `flash_attention` kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both packages as
float32 (or rounded to bfloat16 the same way on both sides).
"""

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
    assert kern.source == "src/repro_torch/kernels/csrc/flash_attention.cu"
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
