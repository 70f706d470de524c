"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the engine and the LM serving path on the card against the CPU path.

Every test here needs a CUDA card (`cuda` marker) and skips without one; on
the card each datapath kernel must be bit-exact with `repro_torch.kernels.ref`,
and `flash_attention` within a stated tolerance of `ref.mha`.  The
file imports no JAX, so it runs where only torch is installed.
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import DatapathEngine, agreement, tpch
from repro_torch.core import queries as tq
from repro_torch.core.plan import AggSpec, Cmp, ScanPlan
from repro_torch.kernels import agg_push as cu_agg
from repro_torch.kernels import bitunpack as cu_bitunpack
from repro_torch.kernels import bloom_probe as cu_bloom
from repro_torch.kernels import delta_decode as cu_delta
from repro_torch.kernels import dict_decode as cu_dict
from repro_torch.kernels import filter_compact as cu_compact
from repro_torch.kernels import flash_attention as cu_flash
from repro_torch.kernels import fused_scan as cu_fused
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rle_decode as cu_rle
from repro_torch.lakeformat.encodings import bitpack_encode
from repro_torch.lakeformat.reader import LakeReader
from repro_torch.models import model as tmodel
from repro_torch.serve.engine import Request, ServeEngine

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


@pytest.mark.parametrize("d_len,k,dtype,nb,view", [
    (5, 3, torch.int32, 17, False),            # codes past the end clip to the last entry
    (11, 4, torch.float32, 17, False),
    (16_384, 14, torch.int32, 17, False),      # > 48 KiB (l_orderkey's size)
    (58_112, 16, torch.float32, 17, False),    # the H100's 227 KiB of shared memory a CTA
    (65_536, 16, torch.int32, 17, False),      # dict_encode's largest
    (40, 32, torch.int32, 17, False),          # k = 32: negative codes clip to entry 0
    # one block, and grids that do not divide among the CTAs that fit
    (16_143, 14, torch.int32, 1, False),
    (16_143, 14, torch.int32, 1473, False),
    (58_108, 16, torch.float32, 1473, False),
    # dictionaries under one 16-byte unit
    (1, 3, torch.float32, 17, False),
    (3, 5, torch.int32, 17, False),
    # a view off a 16-byte boundary
    (16_143, 14, torch.int32, 17, True),
    (65_536, 16, torch.float32, 1473, True),
])
def test_dict_decode_both_branches(dev, d_len, k, dtype, nb, view):
    rng = np.random.default_rng(d_len + nb)
    p = _words(rng, nb, k).to(dev)
    n = d_len + view
    if dtype == torch.float32:
        d = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    else:
        d = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    d = d.to(dev)[1:] if view else d.to(dev)
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


@pytest.mark.parametrize("d_len,k,dtype,lo,hi", [
    (19, 5, torch.int32, -10, 10),         # codes past 18 clip to the last entry
    (4, 2, torch.int32, 1, 0),             # empty range
    (300, 9, torch.float32, -1, 1),        # bounds compare as float32
    (2, 1, torch.float32, 2**24 + 1, 2**31 - 1),  # the bound rounds to 2^24 in float32
    (40, 32, torch.int32, -2**31, 2**31 - 1),  # k = 32: negative codes clip to 0
])
def test_fused_scan_dictionary_arm(dev, d_len, k, dtype, lo, hi):
    rng = np.random.default_rng(d_len + k)
    p = _words(rng, 17, k).to(dev)
    if lo == 2**24 + 1:
        d = torch.tensor([2.0**24 + 2, 2.0**24])
    elif dtype == torch.float32:
        d = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32))
    else:
        d = torch.from_numpy(rng.integers(-50, 50, d_len).astype(np.int32))
    d = d.to(dtype).to(dev)
    mask, cnt = ops.fused_scan(p, k, lo, hi, d)
    torch.cuda.synchronize()
    want_mask, want_cnt = ref.fused_scan(p, k, lo, hi, d)
    assert _same(mask, want_mask) and _same(cnt, want_cnt)


def _rle_pages(rng, nblk, dtype):
    """Nondecreasing ends: random, exactly 128 runs, one run, padded."""
    ends = np.sort(rng.integers(0, 1025, (nblk, 128)), axis=1).astype(np.int32)
    ends[0] = np.arange(1, 129) * 8  # 128 runs, the last ending on 1024
    ends[1] = 1024
    ends[2, 30:] = 1024
    ends[3] = np.arange(1, 129) * 3  # 128 runs ending at 384: the clip re-reads run 127
    if dtype == torch.float32:
        v = torch.from_numpy(rng.standard_normal((nblk, 128)).astype(np.float32))
    else:
        v = torch.from_numpy(rng.integers(-2**31, 2**31, (nblk, 128)).astype(np.int32))
    return v, torch.from_numpy(ends)


@pytest.mark.parametrize("nblk", [4, 65, 5888])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_rle_decode(dev, nblk, dtype):
    rng = np.random.default_rng(nblk)
    v, e = (t.to(dev) for t in _rle_pages(rng, nblk, dtype))
    got = cu_rle.rle_decode(v, e)
    torch.cuda.synchronize()
    assert _same(got, ref.rle_decode(v, e))


# 1,473 and 5,000 blocks: more than one wave of the grid-stride walk, and a
# count that is not a multiple of the grid; offset 1: a values view 4 bytes
# past a 16-byte boundary, which the wrapper copies to an aligned tensor
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nblk", [1, 3, 196, 1473, 5000, 5888])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_filter_compact(dev, nblk, dtype, offset):
    rng = np.random.default_rng(nblk + 1)
    if dtype == torch.float32:
        v = rng.standard_normal((nblk, 1024)).astype(np.float32)
        v[0, :5] = [-0.0, np.inf, -np.inf, np.nan, 0.0]
        v.view(np.int32)[0, 5] = 0x7FC00001  # a NaN with a payload
        v.view(np.int32)[0, 6] = -0x400000   # a negative NaN (0xFFC00000)
    else:
        v = rng.integers(-2**31, 2**31, (nblk, 1024)).astype(np.int32)
    m = rng.random((nblk, 1024)) < 0.4
    m[0] = True  # all kept
    if nblk > 2:
        m[1] = False  # none kept
        m[2] = False
        m[2, -1] = True  # only the last row
    base = torch.from_numpy(np.concatenate([np.zeros(offset, v.dtype), v.reshape(-1)])).to(dev)
    v = base[offset:].view(nblk, 1024)
    assert (v.data_ptr() % 16 != 0) == bool(offset)
    m = torch.from_numpy(m).to(dev)
    got = cu_compact.filter_compact(v, m)
    torch.cuda.synchronize()
    want = ref.filter_compact(v, m)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("n_bits,n_hashes,nblk", [
    (1 << 15, 4, 64), (1 << 15, 4, 5888), (1 << 17, 7, 9), (1 << 10, 1, 9), (16, 2, 3),
])
def test_bloom_probe(dev, n_bits, n_hashes, nblk):
    rng = np.random.default_rng(n_bits + nblk)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, (nblk, 1024)).astype(np.int32))
    keys[0, :4] = torch.tensor([-2**31, 2**31 - 1, 0, -1], dtype=torch.int32)
    keys = keys.to(dev)
    build_keys = keys[0, :512]
    bits = ref.bloom_build(build_keys, n_bits, n_hashes)
    got = cu_bloom.bloom_probe(keys, bits, n_hashes)
    torch.cuda.synchronize()
    assert _same(got, ref.bloom_probe(keys, bits, n_hashes))
    assert bool(got[0, :512].all())  # no false negative


def test_new_wrappers_reject_bad_operands(dev):
    with pytest.raises(TypeError):
        cu_rle.rle_decode(torch.zeros((1, 128), dtype=torch.int64, device=dev),
                          torch.zeros((1, 128), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        cu_compact.filter_compact(torch.zeros((2, 1024), dtype=torch.int32, device=dev),
                                  torch.zeros((1, 1024), dtype=torch.bool, device=dev))
    with pytest.raises(ValueError):  # n_bits not a power of two, then too large
        cu_bloom.bloom_probe(torch.zeros((1, 1024), dtype=torch.int32, device=dev),
                             torch.zeros(1000, dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError):
        cu_bloom.bloom_probe(torch.zeros((1, 1024), dtype=torch.int32, device=dev),
                             torch.zeros(1 << 18, dtype=torch.uint8, device=dev))


def test_wrappers_reject_bad_operands(dev):
    with pytest.raises(ValueError):
        cu_bitunpack.bitunpack(torch.zeros((1, 3, 128), dtype=torch.int32), 3)  # CPU
    with pytest.raises(TypeError):
        cu_bitunpack.bitunpack(torch.zeros((1, 3, 128), dtype=torch.int64, device=dev), 3)
    with pytest.raises(ValueError):
        cu_bitunpack.bitunpack(torch.zeros((1, 4, 128), dtype=torch.int32, device=dev), 3)


@pytest.fixture(scope="module")
def tables(dev, tmp_path_factory):
    """Seed-4 files (Q19 selects rows there), unsorted and sorted."""
    out = {}
    for sorted_data in (False, True):
        d = tmp_path_factory.mktemp("tpch_cuda")
        paths = tpch.write_tables(str(d), sf=0.05, seed=4, row_group_size=8192,
                                  sorted_data=sorted_data)
        out[sorted_data] = {k: LakeReader(p) for k, p in paths.items()}
    return out


QUERY_KERNELS = ("bitunpack", "dict_decode", "delta_decode", "fused_scan", "rle_decode",
                 "filter_compact", "bloom_probe")


def test_queries_on_card_match_cpu(dev, tables):
    """All six queries on unsorted and sorted files; every kernel of the
    sequential path launches (rle_decode on the sorted files only)."""
    gpu, cpu = DatapathEngine(device="cuda"), DatapathEngine(device="cpu")
    ops.reset_kernel_launches()
    for readers in tables.values():
        got = {name: q(gpu, readers) for name, q in tq.QUERIES.items()}
        want = {name: q(cpu, readers) for name, q in tq.QUERIES.items()}
        assert want["q19"]["rows"] > 0
        per_supp = agreement.per_supplier_revenue(readers["lineitem"])
        for name in tq.QUERIES:
            agreement.compare(name, got[name], want[name], per_supp)
    launches = ops.kernel_launches()
    assert all(launches[k] > 0 for k in QUERY_KERNELS), launches


def _dict_pages(rng, k, sizes, nbs, dtype):
    dmax = max(max(sizes), 1)
    if dtype == torch.float32:
        d = torch.from_numpy(rng.standard_normal((len(sizes), dmax)).astype(np.float32))
    else:
        d = torch.from_numpy(rng.integers(-2**31, 2**31, (len(sizes), dmax)).astype(np.int32))
    page = np.concatenate([np.full(nb, i, np.int32) for i, nb in enumerate(nbs)])
    return (_words(rng, sum(nbs), k), d, torch.tensor(sizes, dtype=torch.int32),
            torch.from_numpy(page))


@pytest.mark.parametrize("k,sizes,nbs,dtype", [
    (3, [5, 0, 8, 1], [2, 1, 3, 4], torch.int32),        # sizes differ, a size of 0
    (14, [16_143, 16_384, 9_000], [16, 16, 5], torch.int32),  # l_orderkey's shape
    (16, [65_536, 70_000, 3], [4, 2, 3], torch.float32),  # too large for shared memory
    (32, [40, 7], [3, 3], torch.int32),                  # negative codes clip to 0
])
def test_dict_decode_batch(dev, k, sizes, nbs, dtype):
    rng = np.random.default_rng(k + len(sizes))
    p, d, sz, pg = (t.to(dev) for t in _dict_pages(rng, k, sizes, nbs, dtype))
    got = cu_dict.dict_decode_batch(p, d, sz, pg, k)
    torch.cuda.synchronize()
    assert _same(got, ref.dict_decode_batch(p, d, sz, pg, k))


@pytest.mark.parametrize("k", [1, 8, 12, 32])
def test_fused_scan_batch(dev, k):
    rng = np.random.default_rng(k + 100)
    p = _words(rng, 6, k).to(dev)
    lo = torch.tensor([0, 1, -2**31, 5, 3, -100], dtype=torch.int32, device=dev)
    hi = torch.tensor([2**31 - 1, 0, -1, 5, 900, 100], dtype=torch.int32, device=dev)
    got = cu_fused.fused_scan_batch(p, k, lo, hi)
    torch.cuda.synchronize()
    assert _same(got, ref.fused_scan_batch(p, k, lo, hi)) and not bool(got[1].any())


# The grid-stride walk of csrc/fused_scan.cu: one block, one row group, a
# block count that is not a multiple of the CTAs that fit (1,473) and more
# than one wave (5,000).
WALK_BLOCKS = [1, 16, 1473, 5000]
WALK_KS = [1, 7, 12, 31, 32]


def _walk_words(rng, nb, k):
    """Packed words whose value x = min(2^k - 1, 5) fills block 0 (every row
    passes lo = hi = x), x - 1 fills block 1 (none passes) and block 2 but its
    last row (only that row passes); the other blocks are random."""
    top = (1 << k) - 1
    vals = rng.integers(0, top + 1, size=(nb, 4096), dtype=np.uint64)
    x = min(top, 5)
    vals[0] = x
    if nb > 1:
        vals[1] = x - 1
    if nb > 2:
        vals[2] = x - 1
        vals[2, -1] = x
    packed = bitpack_encode(vals.reshape(-1), k).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(packed)), x


@pytest.mark.parametrize("k", WALK_KS)
@pytest.mark.parametrize("nb", WALK_BLOCKS)
def test_fused_scan_walk(dev, nb, k):
    rng = np.random.default_rng(nb * 33 + k)
    p, x = _walk_words(rng, nb, k)
    p = p.to(dev)
    ranges = [(x, x), (1, 0), (-2**31, 2**31 - 1), (0, (1 << (k - 1)) - 1), (-2**31, -1)]
    for lo, hi in ranges:
        mask, cnt = cu_fused.fused_scan(p, k, lo, hi)
        torch.cuda.synchronize()
        want_mask, want_cnt = ref.fused_scan(p, k, lo, hi)
        assert _same(mask, want_mask) and _same(cnt, want_cnt), (lo, hi)
    mask, cnt = cu_fused.fused_scan(p, k, x, x)
    assert int(cnt[0]) == 4096
    if nb > 2:
        assert cnt[1:3].tolist() == [0, 1] and bool(mask[2, -1]) and not bool(mask[2, :-1].any())


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("k", [7, 12, 32])
@pytest.mark.parametrize("nb", WALK_BLOCKS)
def test_fused_scan_walk_dictionary_arm(dev, nb, k, dtype):
    """Dictionaries shorter than 2^k, so codes run past D and clip to its
    last entry; with k = 32 negative codes clip to entry 0."""
    rng = np.random.default_rng(nb * 7 + k + len(str(dtype)))
    p = _words(rng, nb, k).to(dev)
    d_len = 100 if k == 7 else 3000
    if dtype == torch.float32:
        d = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32))
        ranges = [(-1, 1), (0, 0), (1, 0)]
    else:
        d = torch.from_numpy(rng.integers(-50, 50, d_len).astype(np.int32))
        ranges = [(-10, 10), (-2**31, 2**31 - 1), (1, 0)]
    d = d.to(dev)
    for lo, hi in ranges:
        mask, cnt = cu_fused.fused_scan(p, k, lo, hi, d)
        torch.cuda.synchronize()
        want_mask, want_cnt = ref.fused_scan(p, k, lo, hi, d)
        assert _same(mask, want_mask) and _same(cnt, want_cnt), (lo, hi)


@pytest.mark.parametrize("k", WALK_KS)
@pytest.mark.parametrize("nb", WALK_BLOCKS)
def test_fused_scan_batch_walk(dev, nb, k):
    """Ragged per-block ranges, every third block the empty (1, 0)."""
    rng = np.random.default_rng(nb * 11 + k)
    p, x = _walk_words(rng, nb, k)
    p = p.to(dev)
    ends = np.sort(rng.integers(-2**31, 2**31, (nb, 2)), axis=1) if k == 32 else \
        np.sort(rng.integers(0, 1 << k, (nb, 2)), axis=1)
    lo, hi = ends[:, 0].astype(np.int32), ends[:, 1].astype(np.int32)
    lo[0], hi[0] = x, x
    lo[1::3], hi[1::3] = 1, 0
    lo_t, hi_t = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    got = cu_fused.fused_scan_batch(p, k, lo_t, hi_t)
    torch.cuda.synchronize()
    assert _same(got, ref.fused_scan_batch(p, k, lo_t, hi_t))
    assert bool(got[0].all()) and not bool(got[1::3].any())


@pytest.mark.parametrize("nb", [1, 16, 1473])
def test_dict_decode_every_k_with_shared_words(dev, nb):
    """dict_decode unpacks through rt::Words in common.cuh, which
    fused_scan.cu shares: every bit width against the plain version."""
    rng = np.random.default_rng(nb + 5)
    d = torch.from_numpy(rng.integers(-2**31, 2**31, 2557).astype(np.int32)).to(dev)
    for k in range(1, 33):
        p = _words(rng, nb, k).to(dev)
        got = cu_dict.dict_decode(p, d, k)
        torch.cuda.synchronize()
        assert _same(got, ref.dict_decode(p, d, k)), k


def _ragged_pages(rng, nb, dmax):
    """(sizes, page) of pages 1-40 blocks long covering nb blocks: the first
    pages' sizes are 0, 1, Dmax and above Dmax, and from 3 blocks on some
    blocks name a page below 0 or past the last."""
    runs = []
    while sum(runs) < nb:
        runs.append(int(rng.integers(1, 41)))
    runs[-1] -= sum(runs) - nb
    n_pages = len(runs)
    sizes = rng.integers(0, dmax + 10, n_pages)
    sizes[:4] = [0, 1, dmax, dmax + 7][:min(4, n_pages)]
    page = np.repeat(np.arange(n_pages), runs)
    if nb > 2:
        page[::97] = -3
        page[1::89] = n_pages + 2
    return sizes.astype(np.int32), page.astype(np.int32)


# dict_decode_batch's walk (csrc/dict_decode.cu): both dictionary arms, warp
# shuffles for Dmax <= 32 and __ldg lookups above it
@pytest.mark.parametrize("dmax", [3, 32, 33, 16_384])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("k", [1, 4, 14, 32])
@pytest.mark.parametrize("nb", WALK_BLOCKS)
def test_dict_decode_batch_walk(dev, nb, k, dtype, dmax):
    rng = np.random.default_rng(nb * 13 + k * 3 + dmax)
    sizes, page = _ragged_pages(rng, nb, dmax)
    n_pages = int(sizes.shape[0])
    if dtype == torch.float32:
        d = rng.standard_normal((n_pages, dmax)).astype(np.float32)
    else:
        d = rng.integers(-2**31, 2**31, (n_pages, dmax)).astype(np.int32)
    p = _words(rng, nb, k).to(dev)
    d, sz, pg = (torch.from_numpy(x).to(dev) for x in (d, sizes, page))
    got = cu_dict.dict_decode_batch(p, d, sz, pg, k)
    torch.cuda.synchronize()
    assert _same(got, ref.dict_decode_batch(p, d, sz, pg, k))


def _agg_inputs(rng, nb, G, dtype, mask_dtype):
    """Values over the dtype's range (int32 at +-2^31; float32 with +-inf,
    -0.0 and a NaN), ids past both ends of [0, G), a random mask; a group
    whose counted rows are all -0.0 (group G - 1 of block 0, or all of block
    2 at G = 1) and, from 3 blocks on, an all-masked last block."""
    g = rng.integers(-1, G + 1, (nb, 4096)).astype(np.int32)
    if dtype == torch.float32:
        v = (rng.standard_normal((nb, 4096)) * 1e4).astype(np.float32)
        if G > 1:
            v[0, g[0] == G - 1] = -0.0
        elif nb > 2:
            v[2] = -0.0
        v[0, :3] = [np.inf, -np.inf, -0.0]
        v[min(1, nb - 1), 7] = np.nan
    else:
        v = rng.integers(-2**31, 2**31, (nb, 4096)).astype(np.int32)
        v[0, :4] = [-2**31, 2**31 - 1, -1, 0]
    g[0, :4] = 0
    g[min(1, nb - 1), 7] = 0
    m = rng.random((nb, 4096)) < 0.7
    m[0, :4] = True
    m[min(1, nb - 1), 7] = True
    if nb > 2:
        m[-1] = False
    return (torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(m).to(mask_dtype))


@pytest.mark.parametrize("nb", [1, 17, 300])
@pytest.mark.parametrize("G", [1, 2, 3, 64, 127, 128])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_grouped_agg(dev, G, dtype, mask_dtype, nb):
    """Every plane bit for bit, the float sum included (the same fixed
    order), NaN cells as 0x7FC00000, a cell of -0.0 rows as +0.0, gids out
    of range and an all-masked block; block counts that leave the last CTA
    partly empty."""
    rng = np.random.default_rng(G * 1000 + nb)
    v, g, m = (t.to(dev) for t in _agg_inputs(rng, nb, G, dtype, mask_dtype))
    got = cu_agg.grouped_agg(v, g, m, G)
    torch.cuda.synchronize()
    want = ref.grouped_agg(v, g, m, G)
    assert all(_same(a, b) for a, b in zip(got, want))
    if dtype == torch.float32:
        assert got[3].view(torch.int32)[min(1, nb - 1), 0].item() == 0x7FC00000
        zb, zg = (0, G - 1) if G > 1 else (2, 0)
        if zb < nb:
            assert got[0][zb, zg].item() > 0 and got[1].view(torch.int32)[zb, zg].item() == 0


@pytest.mark.parametrize("G", [1, 3, 128])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_grouped_agg_no_counted_row(dev, G, dtype):
    """A window that no row falls in (ids shifted below and above it, as in
    most of the engine's windows over a wide domain): the identity fills, a
    +0.0 float sum, and the plain version's planes."""
    rng = np.random.default_rng(G + 5)
    v, g, m = (t.to(dev) for t in _agg_inputs(rng, 17, G, dtype, torch.bool))
    g = torch.where(g % 2 == 0, g - 2 * G - 1, g + 2 * G)
    got = cu_agg.grouped_agg(v, g, m, G)
    torch.cuda.synchronize()
    want = ref.grouped_agg(v, g, m, G)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert not got[0].any() and not got[1].view(torch.int32).any()
    lo, hi = ((float("inf"), float("-inf")) if dtype == torch.float32
              else (2**31 - 1, -2**31))
    assert (got[3] == lo).all() and (got[4] == hi).all()


def test_grouped_agg_unaligned_views(dev):
    """Operands whose data start off a 16-byte boundary (views at an odd
    offset) give the same planes as aligned copies."""
    rng = np.random.default_rng(9)
    v, g, m = (t.to(dev) for t in _agg_inputs(rng, 5, 3, torch.float32, torch.int32))
    shifted = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].reshape(t.shape)
               for t in (v, g, m)]
    assert all(t.data_ptr() % 16 for t in shifted)
    got = cu_agg.grouped_agg(*shifted, 3)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, ref.grouped_agg(v, g, m, 3)))


# 17 blocks at k = 1, 6, 32, then fused_agg's grid-stride walk at
# WALK_BLOCKS x WALK_KS
@pytest.mark.parametrize("nb,k", [(17, 1), (17, 6), (17, 32)]
                         + [(nb, k) for nb in WALK_BLOCKS for k in WALK_KS])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
def test_fused_agg(dev, nb, k, mask_dtype):
    """Block 0 counts every row, block 1 none, the last block none; at k = 32
    block 0 holds -2^31 and 2^31 - 1."""
    rng = np.random.default_rng(nb * 33 + k + 7)
    p = _words(rng, nb, k)
    if k == 32:
        p[0, :, :2] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
    p = p.to(dev)
    m = torch.from_numpy(rng.random((nb, 4096)) < 0.5)
    m[0] = True
    if nb > 1:
        m[1] = False
        m[-1] = False
    m = m.to(mask_dtype).to(dev)
    got = cu_agg.fused_agg(p, k, m)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, ref.fused_agg_scan(p, k, m)))


def test_fused_agg_unaligned_views(dev):
    """Words and a mask whose data start off a 16-byte boundary give the
    same planes as aligned copies."""
    rng = np.random.default_rng(10)
    p = _words(rng, 5, 6).to(dev)
    m = torch.from_numpy(rng.random((5, 4096)) < 0.5).to(torch.int32).to(dev)
    shifted = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].reshape(t.shape) for t in (p, m)]
    assert all(t.data_ptr() % 16 for t in shifted)
    got = cu_agg.fused_agg(shifted[0], 6, shifted[1])
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, ref.fused_agg_scan(p, 6, m)))


def test_batched_and_pushdown_on_card_match_cpu(dev, tables):
    """Batched row scans and pushed-down aggregates on the card equal the
    CPU path bit for bit (float sums included: both add in the kernels'
    fixed order), a group domain of 20 MAX_GROUPS-wide windows included,
    and launch the four batch and aggregate kernels."""
    gpu, cpu = DatapathEngine(device="cuda"), DatapathEngine(device="cpu")
    pred = Cmp("l_shipdate", "between", (365, 729))
    plans = [
        ScanPlan("lineitem", [], pred, aggregates=(AggSpec("sum", "l_extendedprice"),
                                                   AggSpec("count")), group_by="l_returnflag"),
        ScanPlan("lineitem", [], pred, aggregates=(AggSpec("sum", "l_quantity"),
                                                   AggSpec("min", "l_quantity"),
                                                   AggSpec("max", "l_quantity"))),
        ScanPlan("lineitem", [], pred, aggregates=(AggSpec("sum", "l_extendedprice"),
                                                   AggSpec("count")), group_by="l_shipdate"),
    ]
    ops.reset_kernel_launches()
    for readers in tables.values():
        li = readers["lineitem"]
        for batched in (False, True):
            for plan in plans:
                a = gpu.scan(li, plan, batched=batched).aggregates
                b = cpu.scan(li, plan, batched=batched).aggregates
                assert all(np.array_equal(a[k], b[k]) for k in b), plan
        for name, mk in tq.LINEITEM_PLANS.items():
            if name == "q19":
                continue
            a, b = gpu.scan(li, mk(), batched=True), cpu.scan(li, mk(), batched=True)
            assert torch.equal(a.mask.cpu(), b.mask) and int(a.count) == int(b.count)
            assert all(_same(a.columns[c], b.columns[c]) for c in b.columns)
    launches = ops.kernel_launches()
    assert all(launches[k] > 0 for k in ("grouped_agg", "fused_agg", "fused_scan_batch",
                                         "dict_decode_batch")), launches


def _within_one_bf16_step_per_row(got: torch.Tensor, want: torch.Tensor) -> bool:
    """|got - want| <= 2^-7 max|want[row]| on every output row: one bf16 step
    of the row's largest output.  A causal row that averages thousands of
    keys has outputs near 0.03 while the first rows reach 3, so a bound from
    the tensor's largest output would let a stale or skipped key tile pass."""
    err = (got.float() - want.float()).abs()
    return bool((err <= 2.0 ** -7 * want.float().abs().amax(dim=-1, keepdim=True)).all())


# the CPU test's shapes (tests/test_torch_attention.py), D = 256, ragged
# lengths, Sq != Sk both ways, non-causal and windowed
FLASH_CASES = [(2, 4, 2, 256, 256, 64, True, None), (1, 8, 8, 256, 256, 128, True, None),
               (1, 4, 1, 512, 512, 64, True, 128), (1, 2, 2, 256, 256, 256, True, None),
               (1, 4, 2, 200, 200, 256, True, None), (1, 4, 2, 96, 320, 32, True, None),
               (1, 4, 2, 320, 96, 32, True, None), (2, 4, 2, 130, 77, 16, False, None),
               (1, 4, 2, 257, 257, 128, False, 40), (1, 4, 4, 70, 70, 16, True, 5)]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,win", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention(dev, B, H, Hkv, Sq, Sk, D, causal, win, dtype):
    """float32: the reference test's atol 3e-5 / rtol 1e-4 (sums in another
    order); bfloat16: both round a float32 result once, so they may differ by
    one bf16 step, at most 2^-7 of the row's largest output."""
    rng = np.random.default_rng(Sq * 31 + Sk + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3).to(dev, dtype)
               for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    launches = cu_flash.KERNEL.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert cu_flash.KERNEL.launches == launches + 1 and got.dtype == dtype
    want = ref.mha(q, k, v, causal=causal, window=win).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
    else:
        assert _within_one_bf16_step_per_row(got, want)


# bf16 cases for the wgmma route (D in 64, 128, 256) at its edges: ragged Sk,
# Sq > Sk with rows that see no key, Sq < Sk, windows of 5 and 100, GQA 8:1
# and 16:8, B 2, qwen3's heads at S 4096, non-causal, and inputs of standard
# deviation 0.3, 1 and 2 (peakier softmax rows)
WGMMA_CASES = [(1, 4, 2, 200, 200, 128, True, None, 0.3), (2, 4, 2, 130, 77, 64, False, None, 1.0),
               (1, 4, 2, 320, 96, 128, True, None, 0.3), (1, 4, 2, 96, 320, 128, True, None, 1.0),
               (1, 4, 4, 300, 300, 128, True, 5, 1.0), (1, 4, 2, 517, 517, 64, True, 100, 2.0),
               (1, 8, 1, 256, 256, 128, True, None, 0.3), (1, 16, 8, 640, 640, 128, True, None, 2.0),
               (2, 4, 2, 256, 256, 128, True, None, 1.0), (1, 16, 8, 4096, 4096, 128, True, None, 1.0),
               (1, 4, 2, 384, 384, 64, True, None, 1.0), (1, 2, 2, 300, 300, 256, True, None, 1.0),
               (1, 2, 1, 257, 191, 256, False, 40, 2.0), (1, 4, 2, 256, 256, 128, False, None, 0.3)]


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal,win,std", WGMMA_CASES)
def test_flash_attention_wgmma_route(dev, B, H, Hkv, Sq, Sk, D, causal, win, std):
    """The tensor-core kernel rounds P to bf16 before P V; it stays within
    one bf16 step of the float32 oracle, 2^-7 of each row's largest output,
    the bound of test_flash_attention."""
    rng = np.random.default_rng(Sq * 37 + Sk + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * std)
               .to(dev, torch.bfloat16) for s in ((B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
    routes = dict(cu_flash.ROUTE_LAUNCHES)
    got = ops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert cu_flash.ROUTE_LAUNCHES == {**routes, "wgmma": routes["wgmma"] + 1}
    want = ref.mha(q, k, v, causal=causal, window=win).float()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert _within_one_bf16_step_per_row(got, want)


@pytest.mark.parametrize("D,dtype", [(16, torch.bfloat16), (32, torch.bfloat16),
                                     (64, torch.float32), (128, torch.float32),
                                     (256, torch.float32)])
def test_flash_attention_cuda_core_route(dev, D, dtype):
    """float32 operands and D in (16, 32) stay on the CUDA-core kernel."""
    q = torch.randn((1, 2, 96, D), device=dev).to(dtype)
    routes = dict(cu_flash.ROUTE_LAUNCHES)
    cu_flash.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert cu_flash.ROUTE_LAUNCHES == {**routes, "cuda_cores": routes["cuda_cores"] + 1}


def test_flash_attention_wgmma_route_needs_16_byte_alignment(dev):
    buf = torch.zeros(4 + 64 * 128, dtype=torch.bfloat16, device=dev)
    q = buf[4:].view(1, 1, 64, 128)  # 8 bytes past an aligned base
    with pytest.raises(ValueError, match="aligned to 16 bytes"):
        cu_flash.flash_attention(q, q, q)


def test_flash_attention_rejects_bad_operands(dev):
    q = torch.zeros((1, 4, 64, 64), device=dev)
    with pytest.raises(ValueError, match="group"):
        cu_flash.flash_attention(q, q[:, :3].contiguous(), q[:, :3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cu_flash.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(TypeError):
        cu_flash.flash_attention(q.half(), q.half(), q.half())


def test_serving_on_card_matches_cpu(dev):
    """The qwen3 smoke model at float32 (TF32 off): prefill logits on the
    card within 1e-4 of the CPU's (float32 sums in other orders), and the
    engine's greedy tokens equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), dtype="float32")
    cpu = tmodel.init_params(cfg, 0, device="cpu")
    card = {"embed": cpu["embed"].to(dev), "final_ln": cpu["final_ln"].to(dev),
            "segments": [{k: w.to(dev) for k, w in s.items()} for s in cpu["segments"]]}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 96))
                            .astype(np.int32))
    l_cpu, _ = tmodel.prefill(cpu, {"tokens": toks}, cfg)
    l_card, _ = tmodel.prefill(card, {"tokens": toks.to(dev)}, cfg)
    torch.testing.assert_close(l_card.cpu(), l_cpu, atol=1e-4, rtol=1e-4)
    outs = []
    for params, device in ((cpu, "cpu"), (card, dev)):
        eng = ServeEngine(params, cfg, n_slots=2, max_len=128, device=device)
        for i in range(3):
            eng.submit(Request(rid=i, tokens=toks[i % 2, :40 + i].numpy(), max_new_tokens=5))
        outs.append({r.rid: r.out for r in eng.run_until_drained()})
    assert outs[0] == outs[1]
