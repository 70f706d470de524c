"""Plain PyTorch versions of the port's kernels against the JAX package:
bit-exact against `repro.kernels.ops` with backend="ref" over seeded
sweeps (run eagerly, under jax.disable_jit, so the sweeps compile
nothing), and against backend="pallas" (interpret mode) at a few shapes.
The one exception is grouped_agg's float sum, which adds in the port's
fixed order (pinned by its own test) and agrees with the reference within
the float32 summation bound stated there.
Also the CPU routing of `repro_torch.kernels.ops`: a CPU tensor runs the
plain version, and the CUDA wrappers refuse a CPU tensor.

Compaction is compared on finite values without -0.0: the reference's f32
one-hot contraction turns -0.0 into +0.0 and a +-inf in a row that does not
survive into NaN, where the port's scatter moves every value exactly."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import agg_push as jagg_push
from repro_torch.kernels import agg_push as cu_agg
from repro_torch.kernels import bitunpack as cu_bitunpack
from repro_torch.kernels import bloom_probe as cu_bloom
from repro_torch.kernels import delta_decode as cu_delta
from repro_torch.kernels import dict_decode as cu_dict
from repro_torch.kernels import filter_compact as cu_compact
from repro_torch.kernels import fused_scan as cu_fused
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rle_decode as cu_rle
from repro_torch.lakeformat.encodings import rle_encode

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


def _rand_rle(rng, nblk, dtype):
    """Random RLE pages: nondecreasing ends in [0, 1024] with the writer's
    padding (end = 1024) on some blocks, a window of exactly 128 runs that
    end before 1024 on block 0, one run on block 1; int32 values over the
    whole range or float32 values."""
    ends = np.sort(rng.integers(0, 1025, (nblk, 128)), axis=1).astype(np.int32)
    ends[0] = np.arange(1, 129) * 7  # 128 runs, the last ending at 896
    if nblk > 1:
        ends[1] = 1024  # one run
    if nblk > 2:
        ends[2, 40:] = 1024  # 40 runs, then the writer's padding
    if dtype == "float32":
        vals = rng.standard_normal((nblk, 128)).astype(np.float32)
    else:
        vals = rng.integers(-2**31, 2**31, (nblk, 128)).astype(np.int32)
    return vals, ends


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_rle_decode_rank_lookup(nb, dtype):
    with jax.disable_jit():
        rng = np.random.default_rng(600 + nb)
        for _ in range(3):
            vals, ends = _rand_rle(rng, nb, dtype)
            want = jops.rle_decode(jnp.asarray(vals), jnp.asarray(ends), backend="ref")
            _eq(ref.rle_decode(torch.from_numpy(vals), torch.from_numpy(ends)), want)


def _edge_windows(kind, dtype):
    """Five blocks of one edge window: repeated ends (zero-length runs between
    runs, and at the start), every end 0, a single run (the writer's padding
    after it), or a single run that stops short of 1,024."""
    rng = np.random.default_rng(len(kind) * 7 + len(dtype))
    ends = np.zeros((5, 128), np.int32)
    for b in range(5):
        if kind == "zero-length runs":
            ends[b] = np.sort(rng.choice([0, 1, 17, 512, 1000, 1023, 1024], 128))
        elif kind == "ends of 0":
            ends[b, :rng.integers(1, 129)] = 0
            ends[b, ends[b] != 0] = 0 if b % 2 else 1024
        elif kind == "a single run":
            ends[b] = 1024
        else:  # a single run that stops short
            ends[b] = rng.integers(0, 1024)
    vals = (rng.standard_normal((5, 128)).astype(np.float32) if dtype == "float32"
            else rng.integers(-2**31, 2**31, (5, 128)).astype(np.int32))
    return vals, ends


@pytest.mark.parametrize("kind", ["zero-length runs", "ends of 0", "a single run",
                                  "a single short run"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_rle_decode_edge_windows(kind, dtype):
    """The plain version against the reference on the windows a kernel's
    rank count can get wrong: runs of no length (several runs on one end,
    every end 0: then each position re-reads run 127), one run a block."""
    vals, ends = _edge_windows(kind, dtype)
    with jax.disable_jit():
        want = jops.rle_decode(jnp.asarray(vals), jnp.asarray(ends), backend="ref")
    got = ref.rle_decode(torch.from_numpy(vals), torch.from_numpy(ends))
    _eq(got, want)
    if kind == "ends of 0":
        assert torch.equal(got[1], torch.from_numpy(vals[1, 127:]).expand(1024))


@pytest.mark.parametrize("days", [1, 3, 40])
def test_repeat_interleave_expands_the_writers_pages(days):
    """chip_smoke's yardstick for rle_decode: on the writer's pages of sorted
    dates (runs that end at 1,024, padded with empty runs),
    torch.repeat_interleave of the runs by the ends differenced within each
    block equals the plain version and the reference."""
    rng = np.random.default_rng(days)
    dates = np.sort(rng.integers(0, days, 9 * 1024 - 300)).astype(np.int32)
    bufs = rle_encode(dates)
    vals, ends = torch.from_numpy(bufs["rle_values"]), torch.from_numpy(bufs["rle_ends"])
    nb = vals.shape[0]
    lengths = torch.diff(ends.long(), dim=1, prepend=ends.new_zeros(nb, 1).long())
    got = torch.repeat_interleave(vals.reshape(-1), lengths.reshape(-1), output_size=nb * 1024)
    assert torch.equal(got.view(nb, 1024), ref.rle_decode(vals, ends))
    with jax.disable_jit():
        _eq(got.view(nb, 1024), jops.rle_decode(jnp.asarray(bufs["rle_values"]),
                                               jnp.asarray(bufs["rle_ends"]), backend="ref"))
    assert torch.equal(got[:dates.size], torch.from_numpy(dates))


@pytest.mark.parametrize("nblk,sms,want", [
    (64, 132, (8, 64)),      # the path: a CTA a block, a warp an eighth
    (196, 132, (8, 196)),
    (512, 132, (8, 512)),
    (527, 132, (8, 527)),    # the last count that searches on an H100
    (528, 132, (1, 66)),     # the first that walks: half a CTA's warps an SM
    (1473, 132, (1, 185)),   # a warp a block, the last CTA's warps ragged
    (5000, 132, (1, 264)),   # the walk: 2,112 warps over 5,000 blocks
    (5888, 132, (1, 264)),
    (1, 132, (8, 1)),
    (4, 1, (1, 1)),
])
def test_rle_launch_shape(nblk, sms, want):
    """The rank table's walk (a warp a block) once the blocks give every SM
    half a CTA's warps, on a grid of at most 2 CTAs an SM; the search (a CTA
    a block) below."""
    assert cu_rle.launch_shape(nblk, sms) == want


def test_rle_launch_shape_gives_eight_tiles_a_cta_a_block():
    """The kernel takes 8 tiles a block only on a grid of one CTA a block:
    the wrapper gives that grid whatever the block count and the card."""
    for sms in (1, 16, 132):
        for nblk in range(1, 4 * sms + 10):
            split, ctas = cu_rle.launch_shape(nblk, sms)
            assert ctas >= 1 and (split != 8 or ctas == nblk), (nblk, sms)


def _rand_compact(rng, nblk, dtype):
    """Values across int32 (far beyond +-2^24, negative) or finite float32
    without -0.0, and masks: random, all true, all false, last row only."""
    if dtype == "float32":
        v = (rng.standard_normal((nblk, 1024)) * 1e6).astype(np.float32)
        v[v == 0] = 1.0
    else:
        v = rng.integers(-2**31, 2**31, (nblk, 1024)).astype(np.int32)
        v[0, :4] = [-2**31, 2**31 - 1, 2**24 + 1, -(2**24) - 3]
    m = rng.random((nblk, 1024)) < 0.3
    m[0, :4] = True
    if nblk > 1:
        m[1] = True
    if nblk > 2:
        m[2] = False
        m[2, -1] = True
    return v, m


@pytest.mark.parametrize("nb", (1, 3, 5))
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_filter_compact_stable(nb, dtype):
    with jax.disable_jit():
        rng = np.random.default_rng(700 + nb)
        v, m = _rand_compact(rng, nb, dtype)
        jo, jc = jops.filter_compact(jnp.asarray(v), jnp.asarray(m), backend="ref")
        o, c = ref.filter_compact(torch.from_numpy(v), torch.from_numpy(m))
        _eq(o, jo)
        _eq(c, jc)
        if nb > 3:  # the all-false block: nothing but zeros
            assert not ref.filter_compact(torch.from_numpy(v), torch.zeros(
                (nb, 1024), dtype=torch.bool))[0].any()


@pytest.mark.parametrize("masks", ["all", "none", "last"])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_filter_compact_whole_block_masks_against_pallas_interpret(masks, dtype):
    """Every row, no row and only the last row of each block kept: the plain
    version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(1300 + len(masks) + len(dtype))
    v, _ = _rand_compact(rng, 3, dtype)
    m = np.zeros((3, 1024), bool)
    if masks == "all":
        m[:] = True
    elif masks == "last":
        m[:, -1] = True
    jo, jc = jops.filter_compact(jnp.asarray(v), jnp.asarray(m), backend="pallas")
    o, c = ref.filter_compact(torch.from_numpy(v), torch.from_numpy(m))
    _eq(o, jo)
    _eq(c, jc)
    assert c.tolist() == [int(m[0].sum())] * 3


def test_filter_compact_signed_zero_is_a_reference_divergence():
    """The reference's f32 contraction returns +0.0 for a surviving -0.0;
    the port's scatter keeps its sign bit (ROADMAP.md C)."""
    v = np.zeros((1, 1024), np.float32)
    v[0, 0] = -0.0
    m = np.zeros((1, 1024), bool)
    m[0, 0] = True
    o, _ = ref.filter_compact(torch.from_numpy(v), torch.from_numpy(m))
    jo, _ = jops.filter_compact(jnp.asarray(v), jnp.asarray(m), backend="ref")
    assert o.numpy().view(np.int32)[0, 0] == np.float32(-0.0).view(np.int32)
    assert float(jo[0, 0]) == 0.0 and o[0, 0] == 0.0


KEYS_EDGE = [-2**31, 2**31 - 1, 0, -1, 1, 2**24]


@pytest.mark.parametrize("n_bits,n_hashes", [(1 << 10, 1), (1 << 15, 4), (1 << 17, 7)])
def test_bloom_hashes_build_and_probe(n_bits, n_hashes):
    with jax.disable_jit():
        rng = np.random.default_rng(n_bits + n_hashes)
        build_keys = np.concatenate([KEYS_EDGE, rng.integers(-2**31, 2**31, 500)]).astype(np.int32)
        probe = rng.integers(-2**31, 2**31, (3, 1024)).astype(np.int32)
        probe[0, :len(build_keys) // 2] = build_keys[: len(build_keys) // 2]
        tk = torch.from_numpy(build_keys)
        for got, want in zip(ref.bloom_hashes(tk, n_hashes, n_bits),
                             jref.bloom_hashes(jnp.asarray(build_keys), n_hashes, n_bits)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
        bits = ops.bloom_build(tk, n_bits, n_hashes)
        jbits = jops.bloom_build(jnp.asarray(build_keys), n_bits, n_hashes)
        _eq(bits, jbits)
        hit = ops.bloom_probe(torch.from_numpy(probe), bits, n_hashes)
        _eq(hit, jops.bloom_probe(jnp.asarray(probe), jbits, n_hashes, backend="ref"))
        assert hit[0, : len(build_keys) // 2].all()  # no false negative
        assert ref.bloom_probe(tk, bits, n_hashes).all()


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


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_new_kernels_against_pallas_interpret(dtype):
    """rle_decode, filter_compact and bloom_probe as Pallas kernels in
    interpret mode agree with the port's plain versions."""
    rng = np.random.default_rng(800 + len(dtype))
    vals, ends = _rand_rle(rng, 5, dtype)
    _eq(ref.rle_decode(torch.from_numpy(vals), torch.from_numpy(ends)),
        jops.rle_decode(jnp.asarray(vals), jnp.asarray(ends), backend="pallas"))
    v, m = _rand_compact(rng, 3, dtype)
    jo, jc = jops.filter_compact(jnp.asarray(v), jnp.asarray(m), backend="pallas")
    o, c = ref.filter_compact(torch.from_numpy(v), torch.from_numpy(m))
    _eq(o, jo)
    _eq(c, jc)
    keys = rng.integers(-2**31, 2**31, (5, 1024)).astype(np.int32)
    bits = ref.bloom_build(torch.from_numpy(keys[0]), 1 << 12, 3)
    _eq(ref.bloom_probe(torch.from_numpy(keys), bits, 3),
        jops.bloom_probe(jnp.asarray(keys), jnp.asarray(bits.numpy()), 3, backend="pallas"))


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
    vals, ends = _rand_rle(rng, 3, "int32")
    tv, te = torch.from_numpy(vals), torch.from_numpy(ends)
    assert torch.equal(ops.rle_decode(tv, te), ref.rle_decode(tv, te))
    assert torch.equal(ops.rle_decode(tv, te, n=2000), ref.rle_decode(tv, te).reshape(-1)[:2000])
    v, m = _rand_compact(rng, 2, "int32")
    tv, tm = torch.from_numpy(v), torch.from_numpy(m)
    got, want = ops.filter_compact(tv, tm), ref.filter_compact(tv, tm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.dispatch_count() == 6 + 2 + 2  # an int column counts two, as in the reference
    ops.filter_compact(tv.view(torch.float32), tm)
    bits = ops.bloom_build(tv[0], 1 << 10)  # plain torch on every device: no dispatch
    assert ops.bloom_probe(tv, bits).dtype == torch.bool
    assert ops.dispatch_count() == 6 + 2 + 2 + 1 + 1
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
    with pytest.raises(ValueError):
        cu_rle.rle_decode(torch.zeros((1, 128), dtype=torch.int32),
                          torch.zeros((1, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        cu_compact.filter_compact(torch.zeros((1, 1024), dtype=torch.int32),
                                  torch.zeros((1, 1024), dtype=torch.bool))
    with pytest.raises(ValueError):
        cu_bloom.bloom_probe(torch.zeros((1, 1024), dtype=torch.int32),
                             torch.zeros(1024, dtype=torch.uint8))


@pytest.mark.parametrize("d_len,k,nb,view", [
    (1, 3, 17, False),             # a dictionary of one entry: every code reads it
    (3, 5, 17, False),             # under one 16-byte unit
    (5, 3, 1, False),              # one block
    (40, 32, 17, False),           # k = 32: negative codes clip to entry 0
    (16_143, 14, 1, False),        # l_orderkey's dictionary
    (16_143, 14, 17, True),        # a view off a 16-byte boundary
    (2_557, 12, 16, False),        # l_shipdate's dictionary, one row group
    (58_108, 16, 3, False),
    (58_112, 16, 3, True),
    (65_536, 16, 2, False),        # dict_encode's largest
    (65_536, 32, 2, True),
])
def test_dict_decode_edge_shapes(d_len, k, nb, view):
    """ops.dict_decode on CPU tensors (the plain version) against the JAX
    reference at the shapes the card test holds the kernel to."""
    rng = np.random.default_rng(d_len + nb)
    w, t = _words(rng, nb, k)
    d = rng.integers(-2**31, 2**31, d_len + view).astype(np.int32)
    td = torch.from_numpy(d)[1:] if view else torch.from_numpy(d)
    with jax.disable_jit():
        want = jops.dict_decode(jnp.asarray(w), jnp.asarray(d[1:] if view else d), k,
                                backend="ref")
    _eq(ops.dict_decode(t, td, k), want)


# ---------------------------------------------------------------------------
# batched decode and aggregate pushdown (B8-B11)
# ---------------------------------------------------------------------------


def _dict_stack(rng, k, sizes, nbs, dtype):
    """Pages of codes with their own dictionaries (sizes may be 0 or past
    2^k), padded into one (P, Dmax) array: (words, torch words, dicts,
    sizes, page)."""
    dmax = max(max(sizes), 1)
    if dtype == "float32":
        dicts = rng.standard_normal((len(sizes), dmax)).astype(np.float32)
    else:
        dicts = rng.integers(-2**31, 2**31, (len(sizes), dmax)).astype(np.int32)
    for i, n in enumerate(sizes):
        dicts[i, n:] = 0  # the padding a stack carries past a page's size
    w, t = _words(rng, sum(nbs), k)
    page = np.concatenate([np.full(nb, i, np.int32) for i, nb in enumerate(nbs)])
    return w, t, dicts, np.array(sizes, np.int32), page


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("k", [1, 5, 14, 32])
def test_dict_decode_batch_per_page_clip(k, dtype):
    """Pages of different dictionary sizes in one stack, a page of size 0
    (read as size 1, as the reference wrapper's np.maximum), codes past a
    page's size: each block clips to its own page."""
    with jax.disable_jit():
        rng = np.random.default_rng(900 + k)
        w, t, dicts, sizes, page = _dict_stack(rng, k, [7, 0, 300, 1], [2, 1, 3, 1], dtype)
        want = jops.dict_decode_batch(w, dicts, sizes, page, k, backend="ref")
        got = ref.dict_decode_batch(t, torch.from_numpy(dicts), torch.from_numpy(sizes),
                                    torch.from_numpy(page), k)
        _eq(got, want)
        s = 0
        for p, nb in enumerate([2, 1, 3, 1]):  # == the single-page decode
            d = torch.from_numpy(dicts[p, :max(sizes[p], 1)])
            assert torch.equal(got[s:s + nb], ref.dict_decode(t[s:s + nb], d, k))
            s += nb


@pytest.mark.parametrize("k", [1, 8, 12, 32])
def test_fused_scan_batch_per_block_bounds(k):
    with jax.disable_jit():
        rng = np.random.default_rng(950 + k)
        w, t = _words(rng, 6, k)
        lo = np.array([0, 1, -2**31, 5, 3, -100], np.int32)  # block 1: the empty (1, 0)
        hi = np.array([2**31 - 1, 0, -1, 5, 900, 100], np.int32)
        want = jops.fused_scan_batch(w, k, lo, hi, backend="ref")
        got = ref.fused_scan_batch(t, k, torch.from_numpy(lo), torch.from_numpy(hi))
        _eq(got, want)
        assert not got[1].any()


def _agg_inputs(rng, nb, G, dtype):
    """Values over the dtype's range (int32 at +-2^31; float32 with +-inf and
    NaN), group ids past both ends of [0, G), a random mask with one block
    all masked out."""
    if dtype == "float32":
        v = (rng.standard_normal((nb, 4096)) * 1e4).astype(np.float32)
        v[0, :3] = [np.inf, -np.inf, 0.5]
        v[min(1, nb - 1), 7] = np.nan
    else:
        v = rng.integers(-2**31, 2**31, (nb, 4096)).astype(np.int32)
        v[0, :4] = [-2**31, 2**31 - 1, -1, 0]
    g = rng.integers(-1, G + 1, (nb, 4096)).astype(np.int32)
    g[0, :4] = 0
    m = rng.random((nb, 4096)) < 0.7
    m[0, :4] = True
    m[-1] = False  # an all-masked block: identity fills
    return v, g, m


def _float_sum_tol(v, g, m, G):
    """Per (block, group) bound on the difference of two float32 sums of the
    same cell in different orders: each is within 4096 * 2^-24 * sum|v| of
    the exact sum, so they differ by at most twice that."""
    a = np.where(m[:, :, None] & (g[:, :, None] == np.arange(G)), np.abs(v)[:, :, None], 0)
    return 2 * 4096 * 2.0**-24 * a.sum(axis=1, dtype=np.float64)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("G", [1, 3, 128])
def test_grouped_agg_against_reference(G, dtype):
    """Every plane but the float s0 bit-exact (NaN cells equal as NaN); the
    float s0 within the float32 summation bound; against the jnp oracle
    and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(1000 + G)
    v, g, m = _agg_inputs(rng, 3, G, dtype)
    got = ref.grouped_agg(torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(m), G)
    with jax.disable_jit():
        want = jref.grouped_agg(jnp.asarray(v), jnp.asarray(g), jnp.asarray(m, jnp.int32), G)
    pallas = jagg_push.grouped_agg_pallas(jnp.asarray(v), jnp.asarray(g),
                                          jnp.asarray(m, jnp.int32), G)
    for w in (want, pallas):
        for i, (a, b) in enumerate(zip(got, w)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape == (3, G), i
            if i == 1 and dtype == "float32":
                fin = np.isfinite(b)
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
                assert (np.abs(a[fin] - b[fin]) <= _float_sum_tol(v, g, m, G)[fin]).all()
            else:
                np.testing.assert_array_equal(a, b)
    assert (got[0][-1] == 0).all()  # the all-masked block
    if dtype == "float32":
        assert np.isnan(got[3][1, 0].item()) == bool(
            m[1, 7] and 0 <= g[1, 7] < G and g[1, 7] == 0)


def test_grouped_agg_float_sum_order_is_the_kernels():
    """The plain float sum adds in the order csrc/agg_push.cu does: row r
    belongs to owner (r // 4) % 32 (lane l of the block's warp reads rows
    128 i + 4 l .. 128 i + 4 l + 3 in pass i) and is added, in row order,
    into slot (group, owner), zero-started; then slot[l] += slot[l + s] for
    s = 16, 8, 4, 2, 1.  Recomputed here with numpy float32 adds, bit for
    bit, at 3 and 128 groups."""
    assert (ref.AGG_OWNERS, ref.AGG_CHUNK) == (32, 4)  # the kernel's warp and vector
    T, C = ref.AGG_OWNERS, ref.AGG_CHUNK
    for G in (3, 128):
        rng = np.random.default_rng(77 + G)
        v, g, m = _agg_inputs(rng, 2, G, "float32")
        v[np.isnan(v) | np.isinf(v)] = 1.25
        slots = np.zeros((2, G, T), np.float32)
        for b in range(2):
            for r in range(4096):
                if m[b, r] and 0 <= g[b, r] < G:
                    own = (r // C) % T
                    slots[b, g[b, r], own] = np.float32(slots[b, g[b, r], own] + v[b, r])
        s = T // 2
        while s:
            slots[:, :, :s] = slots[:, :, :s] + slots[:, :, s:2 * s]
            s //= 2
        got = ref.grouped_agg(torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(m), G)
        np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                      slots[:, :, 0].view(np.int32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


def test_grouped_agg_float_sum_independent_of_window():
    """A cell's planes depend on its own rows' positions alone: the same
    rows at 3 groups and shifted into a 128-group window give the same bits;
    a 2,556-group domain equals its 20 MAX_GROUPS-wide windows side by side
    (as the engine launches them); a cell whose rows are all -0.0 sums to
    +0.0, like an empty one."""
    rng = np.random.default_rng(78)
    nb = 3
    v = (rng.standard_normal((nb, 4096)) * 1e4).astype(np.float32)
    g = rng.integers(0, 3, (nb, 4096)).astype(np.int32)
    m = rng.random((nb, 4096)) < 0.7
    v[0, g[0] == 2] = -0.0
    t = torch.from_numpy
    small = ref.grouped_agg(t(v), t(g), t(m), 3)
    assert small[0][0, 2] > 0 and _bits(small[1])[0, 2] == 0
    for shift in (0, 57, 125):
        wide = ref.grouped_agg(t(v), t(g + shift), t(m), ops.MAX_GROUPS)
        for a, b in zip(small, wide):
            np.testing.assert_array_equal(_bits(a), _bits(b[:, shift:shift + 3]))
        assert not np.delete(_bits(wide[1]), range(shift, shift + 3), axis=1).any()
    D = 2556
    gd = rng.integers(0, D, (nb, 4096)).astype(np.int32)
    gd[1, :64] = D - 1  # the last, narrower window
    whole = ref.grouped_agg(t(v), t(gd), t(m), D)
    windows = [ref.grouped_agg(t(v), t(gd - base), t(m), min(ops.MAX_GROUPS, D - base))
               for base in range(0, D, ops.MAX_GROUPS)]
    assert len(windows) == 20
    for p, w in enumerate(whole):
        np.testing.assert_array_equal(_bits(w), _bits(torch.cat([x[p] for x in windows], 1)))


def test_grouped_agg_float_min_max_order_free():
    """-0.0 sorts below +0.0 and NaN poisons its cell, whatever the rows' order."""
    v = np.zeros((1, 4096), np.float32)
    v[0, 0], v[0, 1] = 0.0, -0.0
    v[0, 2] = np.nan
    g = np.zeros((1, 4096), np.int32)
    g[0, 2] = 1
    m = np.zeros((1, 4096), bool)
    m[0, :3] = True
    for vv in (v, v[:, ::-1].copy()):
        gg = g if vv is v else g[:, ::-1].copy()
        mm = m if vv is v else m[:, ::-1].copy()
        cnt, _, _, mn, mx = ref.grouped_agg(torch.from_numpy(vv), torch.from_numpy(gg),
                                            torch.from_numpy(mm), 2)
        assert cnt.tolist() == [[2, 1]]
        assert mn.numpy().view(np.int32)[0, 0] == np.float32(-0.0).view(np.int32)
        assert mx.numpy().view(np.int32)[0, 0] == np.float32(0.0).view(np.int32)
        assert mn.numpy().view(np.int32)[0, 1] == 0x7FC00000 == mx.numpy().view(np.int32)[0, 1]


@pytest.mark.parametrize("k,mask_dtype", [
    pytest.param(k, torch.bool, id=str(k)) for k in (1, 6, 13, 31, 32)] + [
    pytest.param(k, torch.int32, id=f"{k}-int32-mask") for k in (6, 13, 31, 32)])
def test_fused_agg_against_reference(k, mask_dtype):
    """Block 0 counts every row, block 2 none; an int32 mask holds values
    other than 0 and 1."""
    rng = np.random.default_rng(1100 + k)
    w, t = _words(rng, 3, k)
    m = rng.random((3, 4096)) < 0.5
    m[0], m[2] = True, False
    mask = torch.from_numpy(m).to(mask_dtype)
    if mask_dtype == torch.int32:
        mask = mask * torch.from_numpy(rng.integers(-3, 4, (3, 4096), dtype=np.int32) | 1)
    jm = jnp.asarray(mask.numpy().astype(np.int32))
    got = ref.fused_agg_scan(t, k, mask)
    with jax.disable_jit():
        want = jref.fused_agg_scan(jnp.asarray(w), k, jm)
    pallas = jagg_push.fused_agg_pallas(jnp.asarray(w), k, jm)
    for a, b, c in zip(got, want, pallas):
        _eq(a, b)
        _eq(a, c)
    assert got[3][2].item() == 2**31 - 1 and got[4][2].item() == -2**31
    assert got[0][0].item() == 4096


def test_batch_kernels_against_pallas_interpret():
    """dict_decode_batch and fused_scan_batch as Pallas kernels in interpret
    mode (through the reference's ops) agree with the plain versions."""
    rng = np.random.default_rng(1200)
    w, t, dicts, sizes, page = _dict_stack(rng, 6, [5, 64, 2], [1, 2, 1], "int32")
    _eq(ref.dict_decode_batch(t, torch.from_numpy(dicts), torch.from_numpy(sizes),
                              torch.from_numpy(page), 6),
        jops.dict_decode_batch(w, dicts, sizes, page, 6, backend="pallas"))
    lo = np.array([0, 3, 1, -5], np.int32)
    hi = np.array([63, 40, 0, 5], np.int32)
    _eq(ref.fused_scan_batch(t, 6, torch.from_numpy(lo), torch.from_numpy(hi)),
        jops.fused_scan_batch(w, 6, lo, hi, backend="pallas"))


@pytest.mark.parametrize("nb", [1, 5])
@pytest.mark.parametrize("k", [1, 7, 12, 32])
def test_fused_scan_plain_versions_against_pallas_interpret(k, nb):
    """ref.fused_scan (both arms) and ref.fused_scan_batch, which the card's
    walk is held to bit for bit, against fused_scan_pallas and
    fused_scan_batch_pallas in interpret mode, as the reference's own tests
    run them: masks and counts exact.  The Pallas kernel takes its
    dictionary as int32 padded to a multiple of 128 and clips codes to the
    padded length, so the dictionaries here are 128-multiples (codes past D
    still clip to the same entry on both sides) and the float32 one holds
    whole numbers, which its int32 cast keeps."""
    rng = np.random.default_rng(1300 + 10 * k + nb)
    w, t = _words(rng, nb, k)
    jw = jnp.asarray(w)
    for lo, hi in RANGES:
        jm, jc = jops.fused_scan(jw, k, lo, hi, backend="pallas")
        m, c = ref.fused_scan(t, k, lo, hi)
        _eq(m, jm)
        _eq(c, jc)
    d_len = 128 if k < 12 else 384
    d_int = rng.integers(-1000, 1000, d_len).astype(np.int32)
    for d in (d_int, d_int.astype(np.float32)):
        for lo, hi in [(-100, 100), (1, 0), (-2**31, 2**31 - 1)]:
            jm, jc = jops.fused_scan(jw, k, lo, hi, jnp.asarray(d), backend="pallas")
            m, c = ref.fused_scan(t, k, lo, hi, torch.from_numpy(d))
            _eq(m, jm)
            _eq(c, jc)
    top = 2**31 - 1 if k == 32 else (1 << k) - 1
    ends = np.sort(rng.integers(-2**31 if k == 32 else 0, top, (nb, 2), endpoint=True), axis=1)
    lo, hi = ends[:, 0].astype(np.int32), ends[:, 1].astype(np.int32)
    if nb > 1:
        lo[1], hi[1] = 1, 0  # the empty range
    _eq(ref.fused_scan_batch(t, k, torch.from_numpy(lo), torch.from_numpy(hi)),
        jops.fused_scan_batch(w, k, lo, hi, backend="pallas"))


def test_batch_and_agg_ops_route_cpu_tensors_to_plain_versions():
    """The batch and aggregate entries of ops count ONE dispatch each and run
    the plain version on CPU tensors; no kernel launches."""
    rng = np.random.default_rng(13)
    _, t, dicts, sizes, page = _dict_stack(rng, 4, [3, 9], [1, 2], "float32")
    ops.reset_dispatch_count()
    ops.reset_kernel_launches()
    d, s, p = torch.from_numpy(dicts), torch.from_numpy(sizes), torch.from_numpy(page)
    assert torch.equal(ops.dict_decode_batch(t, d, s, p, 4),
                       ref.dict_decode_batch(t, d, s, p, 4))
    lo, hi = torch.zeros(3, dtype=torch.int32), torch.full((3,), 7, dtype=torch.int32)
    assert torch.equal(ops.fused_scan_batch(t, 4, lo, hi), ref.fused_scan_batch(t, 4, lo, hi))
    assert torch.equal(ops.bitunpack_batch(t, 4), ref.bitunpack(t, 4))
    v, g, m = (torch.from_numpy(a) for a in _agg_inputs(rng, 2, 3, "int32"))
    for a, b in zip(ops.grouped_agg_batch(v, g, m, 3), ref.grouped_agg(v, g, m, 3)):
        assert torch.equal(a, b)
    m3 = torch.ones((3, 4096), dtype=torch.bool)
    for a, b in zip(ops.fused_agg_batch(t, 4, m3), ref.fused_agg_scan(t, 4, m3)):
        assert torch.equal(a, b)
    assert ops.dispatch_count() == 5
    assert all(n == 0 for n in ops.kernel_launches().values())
    with pytest.raises(AssertionError):
        ops.grouped_agg_batch(v, g, m, ops.MAX_GROUPS + 1)


def test_new_cuda_wrappers_refuse_cpu_tensors():
    t = torch.zeros((1, 2, 128), dtype=torch.int32)
    i1 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        cu_dict.dict_decode_batch(t, torch.zeros((1, 4), dtype=torch.int32), i1, i1, 2)
    with pytest.raises(ValueError):
        cu_fused.fused_scan_batch(t, 2, i1, i1)
    with pytest.raises(ValueError):
        cu_agg.grouped_agg(torch.zeros((1, 4096), dtype=torch.int32),
                           torch.zeros((1, 4096), dtype=torch.int32),
                           torch.zeros((1, 4096), dtype=torch.bool), 3)
    with pytest.raises(ValueError):
        cu_agg.fused_agg(t, 2, torch.zeros((1, 4096), dtype=torch.bool))
    with pytest.raises(ValueError):  # n_groups past MAX_GROUPS, before any device check
        cu_agg.grouped_agg(torch.zeros((1, 4096), dtype=torch.int32),
                           torch.zeros((1, 4096), dtype=torch.int32),
                           torch.zeros((1, 4096), dtype=torch.bool), 129)
