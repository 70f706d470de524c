"""The port's DatapathEngine on the CPU against the JAX engine (backend
"ref") on the same files: masks, counts, columns and every ScanStats field
equal, for the fused (BITPACK and DICT-rewritten), InSet, conjunctive,
no-predicate, DELTA, all-pruned and corrupt-page cases.  Also what the port
refuses: a card that is not there, and the features of later slices."""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.lakeformat.integrity import CorruptPageError as JCorrupt
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.lakeformat.integrity import CorruptPageError as TCorrupt
from repro_torch.lakeformat.reader import LakeReader as TReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_engine")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192)


def _plans(P):
    """(table, plan) cases, built from one package's plan module `P`."""
    return {
        "fused_dict": ("lineitem", P.ScanPlan(
            "lineitem", ["l_extendedprice", "l_quantity"],
            P.Cmp("l_shipdate", "between", (365, 729)))),
        "fused_bitpack": ("lineitem", P.ScanPlan(
            "lineitem", ["l_discount", "l_orderkey"], P.Cmp("l_quantity", "lt", 12))),
        "fused_empty_dict_range": ("lineitem", P.ScanPlan(
            "lineitem", ["l_tax"], P.Cmp("l_shipdate", "between", (10, 9)))),
        "inset_strings": ("lineitem", P.ScanPlan(
            "lineitem", ["l_quantity", "l_shipmode"],
            P.InSet("l_shipmode", ("MAIL", "SHIP", "NOPE")))),
        "conjunction_floats": ("lineitem", P.ScanPlan(
            "lineitem", ["l_extendedprice", "l_discount"],
            P.and_(P.Cmp("l_shipdate", "between", (365, 729)),
                   P.Cmp("l_discount", "between", (0.05 - 1e-4, 0.07 + 1e-4)),
                   P.Cmp("l_quantity", "lt", 24)))),
        "disjunction_projected_pred": ("lineitem", P.ScanPlan(
            "lineitem", ["l_shipdate", "l_receiptdate"],
            P.or_(P.Cmp("l_shipdate", "ge", 2000), P.Cmp("l_receiptdate", "eq", 100)))),
        "no_predicate_delta": ("orders", P.ScanPlan(
            "orders", ["o_orderkey", "o_orderdate", "o_orderpriority"])),
        "delta_key_pred": ("part", P.ScanPlan(
            "part", ["p_partkey", "p_size", "p_type"], P.Cmp("p_partkey", "gt", 300))),
        "all_pruned": ("lineitem", P.ScanPlan(
            "lineitem", ["l_extendedprice", "l_quantity", "l_shipmode"],
            P.Cmp("l_shipdate", "between", (-20, -10)))),
    }


CASES = list(_plans(tplan))


def _assert_same_result(t, j):
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert t.mask.dtype == torch.bool
    assert int(t.count) == int(j.count) and t.count.dtype == torch.int32
    assert sorted(t.columns) == sorted(j.columns)
    for name, col in t.columns.items():
        want = np.asarray(j.columns[name])
        got = col.numpy()
        assert got.dtype == want.dtype, name
        if want.dtype == np.float32:
            got, want = got.view(np.int32), want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_scan_matches_jax_engine(paths, case):
    table, tp = _plans(tplan)[case]
    _, jp = _plans(jplan)[case]
    t = tengine.DatapathEngine(device="cpu").scan(TReader(paths[table]), tp)
    j = jengine.DatapathEngine(backend="ref").scan(JReader(paths[table]), jp)
    _assert_same_result(t, j)
    if case.startswith("fused"):
        assert t.stats.fused
    if case == "all_pruned":
        assert t.stats.row_groups_scanned == 0 and int(t.count) == 0


def test_sliced_scan_equals_one_shot(paths):
    _, tp = _plans(tplan)["conjunction_floats"]
    eng = tengine.DatapathEngine(device="cpu")
    r = TReader(paths["lineitem"])
    rs = tengine.ResumableScan(eng, r, tp)
    pending = rs.pending
    assert rs.advance(pending[:1]) is None
    with pytest.raises(ValueError):
        rs.advance(pending[2:3])  # out of order
    sliced = rs.advance(pending[1:])
    one = eng.scan(r, tp)
    assert torch.equal(sliced.mask, one.mask)
    assert dataclasses.asdict(sliced.stats) == dataclasses.asdict(one.stats)


def test_corrupt_page_raises_like_jax(paths, tmp_path):
    bad = str(tmp_path / "lineitem.lake")
    shutil.copy(paths["lineitem"], bad)
    meta = JReader(bad).row_group_meta(1)["columns"]["l_quantity"]["buffers"]["packed"]
    with open(bad, "r+b") as f:
        f.seek(meta["offset"] + 100)
        byte = f.read(1)
        f.seek(meta["offset"] + 100)
        f.write(bytes([byte[0] ^ 0xFF]))
    _, tp = _plans(tplan)["fused_bitpack"]
    _, jp = _plans(jplan)["fused_bitpack"]
    trs = tengine.ResumableScan(tengine.DatapathEngine(device="cpu"), TReader(bad), tp)
    jrs = jengine.ResumableScan(jengine.DatapathEngine(backend="ref"), JReader(bad), jp)
    with pytest.raises(TCorrupt) as te:
        trs.advance(trs.pending)
    with pytest.raises(JCorrupt) as je:
        jrs.advance(jrs.pending)
    assert (te.value.rg, te.value.column) == (je.value.rg, je.value.column) == (1, "l_quantity")
    assert dataclasses.asdict(trs.stats) == dataclasses.asdict(jrs.stats)
    assert trs.stats.corrupt_pages == 1


def test_cuda_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tengine.DatapathEngine()  # the default device is the card
    with pytest.raises(RuntimeError):
        tengine.DatapathEngine(device="cuda:0")


@pytest.mark.parametrize("kwargs", [
    {"offload": "preloaded"}, {"offload": "prefiltered"}, {"backend": "host"},
    {"cache": object()},
])
def test_later_slices_raise_not_implemented(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tengine.DatapathEngine(device="cpu", **kwargs)


def test_later_scan_features_raise_not_implemented(paths):
    eng = tengine.DatapathEngine(device="cpu")
    r = TReader(paths["lineitem"])
    base = tplan.ScanPlan("lineitem", ["l_quantity"])
    plans = [
        tplan.ScanPlan("lineitem", ["l_quantity"], compact=True),
        tplan.ScanPlan("lineitem", [], aggregates=(tplan.AggSpec("count"),)),
        tplan.ScanPlan("lineitem", ["l_quantity"], tplan.and_(
            tplan.BloomProbe("l_partkey"), tplan.Cmp("l_quantity", "lt", 5))),
    ]
    for p in plans:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            eng.scan(r, p)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.scan(r, base, batched=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        eng.scan(r, base, pool={})


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.queries, "
        "repro_torch.kernels.ops, repro_torch.kernels.build, repro_torch.lakeformat\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
