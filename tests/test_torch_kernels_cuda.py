"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (`cuda` marker) and skips without one; on
the card each kernel must be bit-exact with `repro_torch.kernels.ref`.  The
file imports no JAX, so it runs where only torch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import DatapathEngine, agreement, tpch
from repro_torch.core import queries as tq
from repro_torch.kernels import bitunpack as cu_bitunpack
from repro_torch.kernels import delta_decode as cu_delta
from repro_torch.kernels import dict_decode as cu_dict
from repro_torch.kernels import fused_scan as cu_fused
from repro_torch.kernels import ops, ref
from repro_torch.lakeformat.reader import LakeReader

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(rng, nb, k):
    """Random packed words (every bit pattern) as the int32 view."""
    w = rng.integers(0, 2**32, size=(nb, k, 128), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-exact equality (floats compared by their bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("nb", [1, 3, 17])
def test_bitunpack_every_k(dev, nb):
    rng = np.random.default_rng(nb)
    for k in range(1, 33):
        p = _words(rng, nb, k).to(dev)
        got = cu_bitunpack.bitunpack(p, k)
        torch.cuda.synchronize()
        assert _same(got, ref.bitunpack(p, k)), k


@pytest.mark.parametrize("d_len,k,dtype", [
    (5, 3, torch.int32),            # codes past the end clip to the last entry
    (11, 4, torch.float32),
    (16_384, 14, torch.int32),      # > 48 KiB of shared memory (l_orderkey's size)
    (58_112, 16, torch.float32),    # the largest shared-memory dictionary
    (65_536, 16, torch.int32),      # does not fit: read from global memory
    (40, 32, torch.int32),          # k = 32: negative codes clip to entry 0
])
def test_dict_decode_both_branches(dev, d_len, k, dtype):
    rng = np.random.default_rng(d_len)
    p = _words(rng, 17, k).to(dev)
    if dtype == torch.float32:
        d = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32))
    else:
        d = torch.from_numpy(rng.integers(-2**31, 2**31, d_len).astype(np.int32))
    d = d.to(dev)
    assert cu_dict.uses_shared(d_len) == (d_len <= 58_112)
    got = cu_dict.dict_decode(p, d, k)
    torch.cuda.synchronize()
    assert _same(got, ref.dict_decode(p, d, k))


@pytest.mark.parametrize("k", [1, 2, 7, 20, 30, 31, 32])
def test_delta_decode_wraparound(dev, k):
    rng = np.random.default_rng(k)
    nb = 17
    p = _words(rng, nb, k).to(dev)
    bases = np.concatenate([
        [2**31 - 1, -2**31, 2**31 - 5, -2**31 + 3],
        rng.integers(-2**31, 2**31, nb - 4),
    ]).astype(np.int32)
    b = torch.from_numpy(bases).to(dev)
    got = cu_delta.delta_decode(p, b, k)
    torch.cuda.synchronize()
    assert _same(got, ref.delta_decode(p, b, k))


@pytest.mark.parametrize("k,lo,hi", [
    (1, 0, 1), (1, 1, 0),                      # full and empty
    (12, 300, 1500), (18, -5, 2**31 - 1),
    (31, 2**30, 2**31 - 1),
    (32, -2**31, -1), (32, -1000, 1000),       # k = 32: negative values
])
def test_fused_scan_ranges(dev, k, lo, hi):
    rng = np.random.default_rng(k + 7)
    p = _words(rng, 17, k).to(dev)
    mask, cnt = cu_fused.fused_scan(p, k, lo, hi)
    torch.cuda.synchronize()
    want_mask, want_cnt = ref.fused_scan(p, k, lo, hi)
    assert _same(mask, want_mask) and _same(cnt, want_cnt)


def test_fused_scan_dictionary_arm_not_on_card(dev):
    p = torch.zeros((1, 2, 128), dtype=torch.int32, device=dev)
    d = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        ops.fused_scan(p, 2, 0, 1, d)


def test_wrappers_reject_bad_operands(dev):
    with pytest.raises(ValueError):
        cu_bitunpack.bitunpack(torch.zeros((1, 3, 128), dtype=torch.int32), 3)  # CPU
    with pytest.raises(TypeError):
        cu_bitunpack.bitunpack(torch.zeros((1, 3, 128), dtype=torch.int64, device=dev), 3)
    with pytest.raises(ValueError):
        cu_bitunpack.bitunpack(torch.zeros((1, 4, 128), dtype=torch.int32, device=dev), 3)


@pytest.fixture(scope="module")
def tables(dev, tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_cuda")
    paths = tpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192)
    return {k: LakeReader(p) for k, p in paths.items()}


def test_queries_on_card_match_cpu(dev, tables):
    gpu, cpu = DatapathEngine(device="cuda"), DatapathEngine(device="cpu")
    ops.reset_kernel_launches()
    got = {name: q(gpu, tables) for name, q in tq.QUERIES.items()}
    launches = ops.kernel_launches()
    want = {name: q(cpu, tables) for name, q in tq.QUERIES.items()}
    assert all(n > 0 for n in launches.values()), launches
    per_supp = agreement.per_supplier_revenue(tables["lineitem"])
    for name in tq.QUERIES:
        agreement.compare(name, got[name], want[name], per_supp)
