"""The port's Mamba2 SSD block (`repro_torch.models.ssm`) against the JAX
package's `repro.models.ssm` on the same numpy inputs, at float32: the
chunked scan with and without a carried state, the causal conv with and
without history, the whole branch over a chunk multiple and over a ragged
tail, and the decode step; within the port, the branch over a sequence ≡ a
run of decode steps.

Tolerances: float32 sums in other orders over chunks of at most 256 steps:
atol 2e-5, rtol 1e-5 (measured |err| <= 4.6e-6 (1 + |want|)).  The port's
forward against its own decode steps, and the scan against a float64
recurrence, take the same bound (the chunked form against the recurrence).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed.sharding import local_ctx as jlocal_ctx
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import local_ctx
from repro_torch.models import ssm

ATOL, RTOL = 2e-5, 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scan_inputs(rng, B, S, H, P, N, a_max=1.0):
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.1, a_max, H).astype(np.float32)
    return xh, Bc, Cc, dt, A


@pytest.mark.parametrize("S,chunk,carried", [
    (64, 16, False),  # 4 chunks
    (64, 16, True),   # ... from a carried state
    (48, 64, False),  # one chunk shorter than the chunk size
    (96, 32, True),
])
def test_ssd_scan(S, chunk, carried):
    rng = np.random.default_rng(S + chunk)
    B, H, P, N = 2, 3, 8, 5
    xh, Bc, Cc, dt, A = _scan_inputs(rng, B, S, H, P, N)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if carried else None
    yj, sj = jssm.ssd_scan(*map(jnp.asarray, (xh, Bc, Cc, dt, A)), chunk,
                           None if s0 is None else jnp.asarray(s0))
    yt, st = ssm.ssd_scan(*map(_t, (xh, Bc, Cc, dt, A)), chunk, None if s0 is None else _t(s0))
    assert yt.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL, rtol=RTOL)


def _recurrence(xh, Bc, Cc, dt, A):
    """The SSD's stated function, step by step in float64: h_t = exp(A dt_t)
    h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t."""
    B, S, H, P = xh.shape
    h = np.zeros((B, H, P, Bc.shape[-1]))
    ys = []
    for t in range(S):
        a = np.exp(A[None, :] * dt[:, t])
        h = h * a[:, :, None, None] + np.einsum("bhp,bn->bhpn", xh[:, t] * dt[:, t, :, None],
                                                Bc[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cc[:, t]))
    return np.stack(ys, 1), h


def test_ssd_scan_decay_overflow_is_a_reference_divergence():
    """A 256-step chunk in which a head's summed |A dt| passes ~88: the
    reference takes exp of the whole (i, j) square, overflows to inf above
    the diagonal and multiplies it by 0 into NaN; the port takes the decay
    on the causal triangle only and gives the recurrence's values (ROADMAP.md
    C, not port faults)."""
    rng = np.random.default_rng(7)
    B, S, H, P, N = 1, 256, 2, 4, 8
    xh, Bc, Cc, dt, A = _scan_inputs(rng, B, S, H, P, N)
    dt[:] = 0.2
    A[:] = (-16.0, -1.0)  # head 0: 0.2 * 16 * 256 = 819 in one chunk
    yj, _ = jssm.ssd_scan(*map(jnp.asarray, (xh, Bc, Cc, dt, A)), S)
    assert np.isnan(np.asarray(yj)[:, :, 0]).any() and not np.isnan(np.asarray(yj)[:, :, 1]).any()
    yt, st = ssm.ssd_scan(*map(_t, (xh, Bc, Cc, dt, A)), S)
    y64, s64 = _recurrence(*(a.astype(np.float64) for a in (xh, Bc, Cc, dt, A)))
    np.testing.assert_allclose(yt.numpy(), y64, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), s64, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(yt.numpy()[:, :, 1], np.asarray(yj)[:, :, 1], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state else None
    yj, nj = jssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                               None if st is None else jnp.asarray(st))
    yt, nt = ssm._causal_conv(*map(_t, (x, w, b)), None if st is None else _t(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def _branch(arch="mamba2-370m", seed=0):
    """The smoke config at float32 and one layer's SSM parameters, drawn
    with numpy (A_log and dt_bias from the reference's distributions)."""
    cj = dataclasses.replace(jget_smoke(arch), dtype="float32")
    ct = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rng = np.random.default_rng(seed)
    D, di, N, H, W = ct.d_model, ct.d_inner, ct.ssm_state, ct.ssm_heads, ct.conv_width
    p = {
        "in_proj": rng.standard_normal((D, 2 * di + 2 * N + H)) * 0.1,
        "conv_w": rng.standard_normal((W, di + 2 * N)) * 0.5,
        "conv_b": rng.standard_normal(di + 2 * N) * 0.1,
        "A_log": np.log(rng.uniform(1, 16, H)),
        "D_skip": rng.standard_normal(H),
        "dt_bias": np.log(np.expm1(rng.uniform(1e-3, 0.1, H))),
        "norm_y": 1 + 0.1 * rng.standard_normal(di),
        "out_proj": rng.standard_normal((di, D)) * 0.1,
    }
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return cj, ct, p, rng


@pytest.mark.parametrize("S", [64, 50])  # a chunk multiple (chunk 32), a ragged tail
@pytest.mark.parametrize("carried", [False, True])
def test_ssm_forward(S, carried):
    cj, ct, p, rng = _branch(seed=S)
    B = 2
    h = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
    conv = (rng.standard_normal((B, ct.conv_width - 1, ct.d_inner + 2 * ct.ssm_state))
            .astype(np.float32) if carried else None)
    state = (rng.standard_normal((B, ct.ssm_heads, ct.ssm_head_dim, ct.ssm_state))
             .astype(np.float32) if carried else None)
    oj, (cj_, sj) = jssm.ssm_forward(jnp.asarray(h), {k: jnp.asarray(v) for k, v in p.items()},
                                     cj, jlocal_ctx(), None if conv is None else jnp.asarray(conv),
                                     None if state is None else jnp.asarray(state),
                                     return_state=True)
    ot, (ct_, st) = ssm.ssm_forward(_t(h), {k: _t(v) for k, v in p.items()}, ct, local_ctx(),
                                    None if conv is None else _t(conv),
                                    None if state is None else _t(state), return_state=True)
    assert st.dtype == torch.float32 and tuple(ot.shape) == (B, S, ct.d_model)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ct_.numpy(), np.asarray(cj_), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL, rtol=RTOL)
    ot2 = ssm.ssm_forward(_t(h), {k: _t(v) for k, v in p.items()}, ct, local_ctx(),
                          None if conv is None else _t(conv), None if state is None else _t(state))
    assert torch.equal(ot2, ot)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_decode_step_against_reference_and_forward(arch):
    """One decode step against the reference's; then 40 steps from empty
    states against the port's forward over the same 40 tokens (outputs and
    the final states)."""
    cj, ct, p, rng = _branch(arch, seed=5)
    B, S = 2, 40
    h = rng.standard_normal((B, S, ct.d_model)).astype(np.float32)
    C = ct.d_inner + 2 * ct.ssm_state
    conv = rng.standard_normal((B, ct.conv_width - 1, C)).astype(np.float32)
    state = rng.standard_normal((B, ct.ssm_heads, ct.ssm_head_dim, ct.ssm_state)).astype(np.float32)
    pj, pt = {k: jnp.asarray(v) for k, v in p.items()}, {k: _t(v) for k, v in p.items()}
    oj, (cj1, sj1) = jssm.ssm_decode_step(jnp.asarray(h[:, :1]), pj, cj, jlocal_ctx(),
                                          jnp.asarray(conv), jnp.asarray(state))
    ot, (ct1, st1) = ssm.ssm_decode_step(_t(h[:, :1]), pt, ct, local_ctx(), _t(conv), _t(state))
    for got, want in ((ot, oj), (ct1, cj1), (st1, sj1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)

    full, (conv_f, state_f) = ssm.ssm_forward(_t(h), pt, ct, local_ctx(), return_state=True)
    cs = torch.zeros((B, ct.conv_width - 1, C))
    ss = torch.zeros((B, ct.ssm_heads, ct.ssm_head_dim, ct.ssm_state))
    steps = []
    for t in range(S):
        o, (cs, ss) = ssm.ssm_decode_step(_t(h[:, t:t + 1]), pt, ct, local_ctx(), cs, ss)
        steps.append(o)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ss.numpy(), state_f.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cs.numpy(), conv_f.numpy(), atol=ATOL, rtol=RTOL)


def test_softplus_has_no_linear_branch():
    """jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus returns x
    itself above its threshold of 20.  The port's equals the reference's
    bit for bit on both sides of it."""
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 40.0, 100.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(ssm._softplus(_t(x)).numpy(), want)
