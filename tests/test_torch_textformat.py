"""The port's text formats against the reference's: CSV and JSON-lines
files byte-identical from the same seeded TPC-H tables, and parses equal
column for column (string columns as their `strings_to_codes` codes)."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import numpy as np
import pytest

from repro.core import tpch as jtpch
from repro.lakeformat import textformat as J
from repro_torch.core import tpch as ttpch
from repro_torch.lakeformat import textformat as T

SCHEMAS = {"lineitem": ttpch.lineitem_schema, "orders": ttpch.orders_schema,
           "part": ttpch.part_schema}
FORMATS = {"csv": ("write_csv", "parse_csv"), "jsonl": ("write_jsonl", "parse_jsonl")}


@pytest.fixture(scope="module")
def tables():
    port = ttpch.gen_tables(sf=0.004, seed=5)
    ref = jtpch.gen_tables(sf=0.004, seed=5)
    return port, ref


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("table", sorted(SCHEMAS))
def test_files_byte_identical_and_parses_equal(tables, tmp_path, table, fmt):
    write, parse = FORMATS[fmt]
    port_data, ref_data = tables
    schema = SCHEMAS[table]()
    ref_schema = getattr(jtpch, f"{table}_schema")()
    port_path = getattr(T, write)(str(tmp_path / f"p.{fmt}"), schema, port_data[table])
    ref_path = getattr(J, write)(str(tmp_path / f"r.{fmt}"), ref_schema, ref_data[table])
    with open(port_path, "rb") as a, open(ref_path, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want and len(got) > 0

    port_cols = getattr(T, parse)(port_path, schema)
    ref_cols = getattr(J, parse)(ref_path, ref_schema)
    assert list(port_cols) == list(ref_cols) == schema.names()
    for name in schema.names():
        a, b = port_cols[name], ref_cols[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_parse_round_trips_the_columns(tables, tmp_path):
    """A parse gives back the written columns: ints and floats exact (the
    float32 values of these tables survive the CSV's six decimals), strings
    as their codes in order of first appearance."""
    data = tables[0]["lineitem"]
    schema = ttpch.lineitem_schema()
    csv = T.parse_csv(T.write_csv(str(tmp_path / "l.csv"), schema, data), schema)
    jsonl = T.parse_jsonl(T.write_jsonl(str(tmp_path / "l.jsonl"), schema, data), schema)
    for cs in schema.columns:
        want = data[cs.name]
        if cs.dtype == "str":
            first_seen = {}
            want = [first_seen.setdefault(v, len(first_seen)) for v in want]
        want = np.asarray(want, np.float32 if cs.dtype == "float32" else np.int32)
        np.testing.assert_array_equal(csv[cs.name], want, err_msg=cs.name)
        np.testing.assert_array_equal(jsonl[cs.name], want, err_msg=cs.name)
