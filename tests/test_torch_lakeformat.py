"""Port's lakeformat copy against the reference: byte-identical files from
the same seed, identical encodings, round trips, and pages carried across
packages with `from_numpy_column`."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import numpy as np
import pytest

from repro.core import tpch as jtpch
from repro.lakeformat import encodings as JE
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import tpch as ttpch
from repro_torch.lakeformat import encodings as TE
from repro_torch.lakeformat import from_numpy_column
from repro_torch.lakeformat.integrity import page_checksum
from repro_torch.lakeformat.reader import LakeReader as TReader


@pytest.fixture(scope="module")
def both_tables(tmp_path_factory):
    d_port = tmp_path_factory.mktemp("port")
    d_ref = tmp_path_factory.mktemp("ref")
    port = ttpch.write_tables(str(d_port), sf=0.05, seed=3, row_group_size=8192)
    ref = jtpch.write_tables(str(d_ref), sf=0.05, seed=3, row_group_size=8192)
    return port, ref


@pytest.mark.parametrize("table", ["lineitem", "orders", "part"])
def test_writer_files_byte_identical(both_tables, table):
    port, ref = both_tables
    with open(port[table], "rb") as a, open(ref[table], "rb") as b:
        assert a.read() == b.read()
    assert TReader(port[table]).n_row_groups >= 1


def test_sorted_files_byte_identical(tmp_path):
    port = ttpch.write_tables(str(tmp_path / "p"), sf=0.02, seed=1, sorted_data=True,
                              row_group_size=4096)
    ref = jtpch.write_tables(str(tmp_path / "r"), sf=0.02, seed=1, sorted_data=True,
                             row_group_size=4096)
    for t in port:
        with open(port[t], "rb") as a, open(ref[t], "rb") as b:
            assert a.read() == b.read(), t


def test_pages_carry_across_readers(both_tables):
    """A page read by the reference reader becomes a port page with the
    same bytes and checksum, and writable buffers."""
    port, ref = both_tables
    jr, tr = JReader(ref["lineitem"]), TReader(port["lineitem"])
    assert jr.footer == tr.footer
    for rg in range(jr.n_row_groups):
        jpages, tpages = jr.read_encoded(rg), tr.read_encoded(rg)
        for name, jcol in jpages.items():
            col = from_numpy_column(jcol)
            assert isinstance(col, TE.EncodedColumn)
            assert col.encoding == tpages[name].encoding
            assert page_checksum(col) == tr.page_checksum_meta(rg, name)
            assert all(b.flags.writeable and b.flags.c_contiguous for b in col.buffers.values())
            np.testing.assert_array_equal(TE.decode_column_host(col),
                                          JE.decode_column_host(jcol))


def _sweep_values(rng):
    """Columns that drive every encoding of encode_column's 'auto' choice."""
    n = 10_000
    return {
        "rle": np.repeat(rng.integers(0, 50, n // 100), 100).astype(np.int64),
        "dict": rng.integers(0, 37, n).astype(np.int64),
        "dict_f32": (rng.integers(0, 11, n) / 100).astype(np.float32),
        "delta": np.cumsum(rng.integers(-3, 40, n)).astype(np.int64),
        "bitpack": rng.integers(0, 1 << 20, n).astype(np.int64),
        "plain_f32": rng.standard_normal(n).astype(np.float32),
        "negative": rng.integers(-5000, 5000, n).astype(np.int64),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoders_match_and_round_trip(seed):
    for name, vals in _sweep_values(np.random.default_rng(seed)).items():
        for enc in ("auto", "plain", "dict"):
            tcol = TE.encode_column(vals, enc)
            jcol = JE.encode_column(vals, enc)
            assert tcol.encoding.value == jcol.encoding.value, (name, enc)
            assert (tcol.k, tcol.n, tcol.dtype) == (jcol.k, jcol.n, jcol.dtype)
            assert sorted(tcol.buffers) == sorted(jcol.buffers)
            for b in tcol.buffers:
                np.testing.assert_array_equal(tcol.buffers[b], jcol.buffers[b])
            got = TE.decode_column_host(tcol)
            want = vals.astype(np.float32 if vals.dtype.kind == "f" else np.int32)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 5, 13, 31, 32])
def test_bitpack_round_trip(k):
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 1 << k, 5000, dtype=np.uint64)
    packed = TE.bitpack_encode(vals, k)
    np.testing.assert_array_equal(packed, JE.bitpack_encode(vals, k))
    np.testing.assert_array_equal(TE.bitpack_decode_np(packed, k, 5000), vals.astype(np.uint32))
