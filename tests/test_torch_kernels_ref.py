"""Plain PyTorch versions of the port's kernels against the JAX package:
bit-exact against `repro.kernels.ops` with backend="ref" over seeded
sweeps (run eagerly, under jax.disable_jit, so the sweeps compile
nothing), and against backend="pallas" (interpret mode) at a few shapes.
Also the CPU routing of `repro_torch.kernels.ops`: a CPU tensor runs the
plain version, and the CUDA wrappers refuse a CPU tensor."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import bitunpack as cu_bitunpack
from repro_torch.kernels import delta_decode as cu_delta
from repro_torch.kernels import dict_decode as cu_dict
from repro_torch.kernels import fused_scan as cu_fused
from repro_torch.kernels import ops, ref

NBS = (1, 3, 17)


def _words(rng, nb, k):
    """Random packed words: every bit pattern, as uint32 for JAX and the
    int32 view of the same bits for the port."""
    w = rng.integers(0, 2**32, size=(nb, k, 128), dtype=np.uint64).astype(np.uint32)
    return w, torch.from_numpy(w.view(np.int32).copy())


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb", NBS)
def test_bitunpack_every_k(nb):
    with jax.disable_jit():
        rng = np.random.default_rng(100 + nb)
        for k in range(1, 33):
            w, t = _words(rng, nb, k)
            _eq(ref.bitunpack(t, k), jops.bitunpack(jnp.asarray(w), k, backend="ref"))


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_dict_decode_out_of_range_codes(nb, dtype):
    """Dictionaries shorter than 2^k, so many codes clip to the last entry;
    k = 32 words >= 2^31 are negative codes that clip to entry 0."""
    with jax.disable_jit():
        rng = np.random.default_rng(200 + nb)
        for k in (1, 2, 3, 4, 5, 8, 13, 16, 31, 32):
            d_len = int(rng.integers(1, min(1 << k, 3000)))  # D < 2^k
            if dtype == "float32":
                d = rng.standard_normal(d_len).astype(np.float32)
            else:
                d = rng.integers(-2**31, 2**31, d_len).astype(np.int32)
            w, t = _words(rng, nb, k)
            want = jops.dict_decode(jnp.asarray(w), jnp.asarray(d), k, backend="ref")
            _eq(ref.dict_decode(t, torch.from_numpy(d), k), want)


def _rand_delta(rng, nb, k):
    """Random zigzag words with bases at the int32 edges: the prefix sums
    wrap around mod 2^32."""
    w, t = _words(rng, nb, k)
    bases = np.concatenate([[2**31 - 1, -2**31, 2**31 - 7],
                            rng.integers(-2**31, 2**31, 17)])[:nb].astype(np.int32)
    return w, t, bases


@pytest.mark.parametrize("nb", NBS)
def test_delta_decode_wraparound(nb):
    with jax.disable_jit():
        rng = np.random.default_rng(300 + nb)
        for k in range(1, 33):
            w, t, bases = _rand_delta(rng, nb, k)
            want = jops.delta_decode(jnp.asarray(w), jnp.asarray(bases), k, backend="ref")
            _eq(ref.delta_decode(t, torch.from_numpy(bases), k), want)


RANGES = [(0, 2**31 - 1), (1, 0), (-2**31, 2**31 - 1), (5, 5), (3, 900), (-2**31, -1),
          (-100, 100)]


@pytest.mark.parametrize("nb", NBS)
def test_fused_scan_ranges(nb):
    """Empty, full and partial ranges; k = 32 carries negative values."""
    with jax.disable_jit():
        rng = np.random.default_rng(400 + nb)
        for k in (1, 4, 12, 18, 31, 32):
            w, t = _words(rng, nb, k)
            for lo, hi in RANGES:
                jm, jc = jops.fused_scan(jnp.asarray(w), k, lo, hi, backend="ref")
                m, c = ref.fused_scan(t, k, lo, hi)
                _eq(m, jm)
                _eq(c, jc)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_fused_scan_dictionary_arm(dtype):
    with jax.disable_jit():
        rng = np.random.default_rng(7)
        k, d_len = 5, 19  # codes past 18 clip to the true length, not a padded one
        d = (rng.integers(-50, 50, d_len).astype(np.int32) if dtype == "int32"
             else rng.standard_normal(d_len).astype(np.float32) * 40)
        w, t = _words(rng, 3, k)
        for lo, hi in [(-10, 10), (1, 0), (-2**31, 2**31 - 1)]:
            jm, jc = jops.fused_scan(jnp.asarray(w), k, lo, hi, jnp.asarray(d), backend="ref")
            m, c = ref.fused_scan(t, k, lo, hi, torch.from_numpy(d))
            _eq(m, jm)
            _eq(c, jc)


@pytest.mark.parametrize("k", [3, 17, 32])
def test_against_pallas_interpret(k):
    """The Pallas kernels (interpret mode) agree with the port's plain
    versions too, at a few shapes."""
    rng = np.random.default_rng(500 + k)
    w, t = _words(rng, 3, k)
    jw = jnp.asarray(w)
    _eq(ref.bitunpack(t, k), jops.bitunpack(jw, k, backend="pallas"))
    d = rng.integers(-1000, 1000, 6).astype(np.int32)  # int: the gather/select arms
    _eq(ref.dict_decode(t, torch.from_numpy(d), k),
        jops.dict_decode(jw, jnp.asarray(d), k, backend="pallas"))
    _, _, bases = _rand_delta(rng, 3, k)
    _eq(ref.delta_decode(t, torch.from_numpy(bases), k),
        jops.delta_decode(jw, jnp.asarray(bases), k, backend="pallas"))
    jm, jc = jops.fused_scan(jw, k, -7, 1 << 20, backend="pallas")
    m, c = ref.fused_scan(t, k, -7, 1 << 20)
    _eq(m, jm)
    _eq(c, jc)


def test_ops_route_cpu_tensors_to_plain_versions():
    rng = np.random.default_rng(9)
    w, t = _words(rng, 2, 6)
    ops.reset_dispatch_count()
    ops.reset_kernel_launches()
    d = torch.arange(40, dtype=torch.int32)
    b = torch.tensor([5, -5], dtype=torch.int32)
    assert torch.equal(ops.bitunpack(t, 6), ref.bitunpack(t, 6))
    assert torch.equal(ops.bitunpack(t, 6, n=5000), ref.bitunpack(t, 6).reshape(-1)[:5000])
    assert torch.equal(ops.dict_decode(t, d, 6), ref.dict_decode(t, d, 6))
    assert torch.equal(ops.delta_decode(t, b, 6), ref.delta_decode(t, b, 6))
    m, c = ops.fused_scan(t, 6, 3, 40)
    rm, rc = ref.fused_scan(t, 6, 3, 40)
    assert torch.equal(m, rm) and torch.equal(c, rc)
    put = ops.device_put(np.arange(10, dtype=np.float32), "cpu")
    assert put.dtype == torch.float32
    assert ops.dispatch_count() == 6
    assert all(n == 0 for n in ops.kernel_launches().values())  # no kernel ran


def test_to_tensor_copies_read_only_buffers():
    buf = np.frombuffer(np.arange(8, dtype=np.uint32).tobytes(), dtype=np.uint32)
    assert not buf.flags.writeable
    t = ops.to_tensor(buf, "cpu")
    assert t.dtype == torch.int32 and t.tolist() == list(range(8))


def test_mixed_or_unsupported_devices_raise():
    t = torch.zeros((1, 2, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.bitunpack(t.to("meta"), 2)
    with pytest.raises(ValueError):
        ops.dict_decode(t, torch.zeros(4, dtype=torch.int32, device="meta"), 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never runs on the CPU: it raises before building."""
    t = torch.zeros((1, 2, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        cu_bitunpack.bitunpack(t, 2)
    with pytest.raises(ValueError):
        cu_dict.dict_decode(t, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        cu_delta.delta_decode(t, torch.zeros(1, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        cu_fused.fused_scan(t, 2, 0, 1)


def test_shared_dictionary_threshold():
    assert cu_dict.uses_shared(1)
    assert cu_dict.uses_shared(16_384)  # l_orderkey's dictionary: > 48 KiB
    assert cu_dict.uses_shared(58_112)  # 227 KiB, the H100's opt-in limit
    assert not cu_dict.uses_shared(58_113)
    assert not cu_dict.uses_shared(65_536)  # dict_encode's largest
