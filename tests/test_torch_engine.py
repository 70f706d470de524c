"""The port's DatapathEngine on the CPU against the JAX engine (backend
"ref") on the same files: masks, counts, columns and every ScanStats field
equal, for the fused (BITPACK and DICT-rewritten), InSet, conjunctive,
no-predicate, DELTA, all-pruned and corrupt-page cases; on sorted files
(RLE pages) for RLE predicate and projected columns, compact=True and a
bloom semijoin.  Also what the port refuses: a card that is not there, and
the datapath names of later slices.  Batched scans and aggregate pushdown have
their own files (test_torch_batch_decode.py, test_torch_pushdown.py)."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.kernels import ops as jops
from repro.lakeformat.integrity import CorruptPageError as JCorrupt
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core import tpch as ttpch
from repro_torch import datapath as tdatapath
from repro_torch.kernels import ops as tops
from repro_torch.lakeformat.integrity import CorruptPageError as TCorrupt
from repro_torch.lakeformat.reader import LakeReader as TReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_engine")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192)


SORTED = dict(sf=0.05, seed=4, row_group_size=8192, sorted_data=True)


@pytest.fixture(scope="module")
def sorted_paths(tmp_path_factory):
    """lineitem sorted on l_shipdate, whose pages are then RLE (the paper's
    Fig. 3b sorted files), and orders on o_orderdate."""
    d = tmp_path_factory.mktemp("tpch_engine_sorted")
    return jtpch.write_tables(str(d), **SORTED)


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


def _bloom_keys():
    """Part keys the semijoin tests build their bloom from: every 5th key."""
    return np.arange(0, 1000, 5, dtype=np.int32)


def _blooms(n_bits=1 << 15, n_hashes=4):
    """The same filter built by each package: (port's, reference's)."""
    keys = _bloom_keys()
    return ({"bloom": tops.bloom_build(torch.from_numpy(keys), n_bits, n_hashes)},
            {"bloom": jops.bloom_build(jnp.asarray(keys), n_bits, n_hashes)})


def _sorted_plans(P):
    """(table, plan) cases on sorted files, from one package's plan module."""
    return {
        "rle_predicate": ("lineitem", P.ScanPlan(
            "lineitem", ["l_extendedprice", "l_quantity"],
            P.Cmp("l_shipdate", "between", (365, 729)))),
        "rle_projected": ("lineitem", P.ScanPlan(
            "lineitem", ["l_shipdate", "l_discount"], P.Cmp("l_quantity", "lt", 12))),
        "sorted_orders_no_predicate": ("orders", P.ScanPlan(
            "orders", ["o_orderdate", "o_orderkey"])),
        "compact_rle_and_floats": ("lineitem", P.ScanPlan(
            "lineitem", ["l_shipdate", "l_extendedprice", "l_partkey"],
            P.and_(P.Cmp("l_shipdate", "between", (1000, 1400)),
                   P.Cmp("l_quantity", "lt", 20)), compact=True)),
        "compact_part_keys": ("part", P.ScanPlan(
            "part", ["p_partkey", "p_size"], P.Cmp("p_size", "le", 10), compact=True)),
        "bloom_semijoin": ("lineitem", P.ScanPlan(
            "lineitem", ["l_partkey", "l_shipdate", "l_quantity"],
            P.and_(P.BloomProbe("l_partkey", name="bloom"),
                   P.Cmp("l_shipdate", "ge", 1200)))),
    }


def test_sorted_fixture_holds_rle_pages(sorted_paths):
    """Every lineitem row group's l_shipdate is an RLE page.  (At this scale
    o_orderdate has too many runs per block for RLE; at SF1 it is RLE too.)"""
    r = TReader(sorted_paths["lineitem"])
    assert r.n_row_groups > 1
    encs = {r.read_encoded(rg, ["l_shipdate"])["l_shipdate"].encoding.value
            for rg in range(r.n_row_groups)}
    assert encs == {"rle"}


def test_sorted_files_written_by_both_packages_are_byte_identical(sorted_paths, tmp_path):
    port = ttpch.write_tables(str(tmp_path), **SORTED)
    for t, p in port.items():
        with open(p, "rb") as a, open(sorted_paths[t], "rb") as b:
            assert a.read() == b.read(), t


@pytest.mark.parametrize("case", list(_sorted_plans(tplan)))
def test_sorted_scan_matches_jax_engine(sorted_paths, case):
    table, tp = _sorted_plans(tplan)[case]
    _, jp = _sorted_plans(jplan)[case]
    tb, jb = _blooms()
    t = tengine.DatapathEngine(device="cpu").scan(TReader(sorted_paths[table]), tp, blooms=tb)
    j = jengine.DatapathEngine(backend="ref").scan(JReader(sorted_paths[table]), jp, blooms=jb)
    _assert_same_result(t, j)
    assert int(t.count) > 0
    if tp.compact:
        n = int(t.count)
        assert bool(t.mask[:n].all()) and not bool(t.mask[n:].any())
        for col in t.columns.values():
            assert not bool(col[n:].bool().any())  # zeros after the survivors
    if case == "bloom_semijoin":
        assert t.stats.row_groups_scanned < t.stats.row_groups_total  # l_shipdate pruned
        # the same scan without the semijoin: the same row groups survive
        # pruning, so its mask lines up with the semijoin's
        dated = tengine.DatapathEngine(device="cpu").scan(TReader(sorted_paths[table]),
                                                          tplan.ScanPlan(
            "lineitem", ["l_partkey"], tplan.Cmp("l_shipdate", "ge", 1200)))
        member = dated.mask.numpy() & np.isin(t.columns["l_partkey"].numpy(), _bloom_keys())
        assert member.any() and t.mask.numpy()[member].all()  # no false negative


def test_compact_scan_matches_jax_engine(paths):
    """compact=True on unsorted files: the survivors of every row group
    packed to the front, equal to the JAX engine's."""
    tp = tplan.ScanPlan("lineitem", ["l_quantity"], tplan.Cmp("l_shipmode", "eq", 2),
                        compact=True)
    jp = jplan.ScanPlan("lineitem", ["l_quantity"], jplan.Cmp("l_shipmode", "eq", 2),
                        compact=True)
    t = tengine.DatapathEngine(device="cpu").scan(TReader(paths["lineitem"]), tp)
    j = jengine.DatapathEngine(backend="ref").scan(JReader(paths["lineitem"]), jp)
    _assert_same_result(t, j)
    full = tengine.DatapathEngine(device="cpu").scan(TReader(paths["lineitem"]), tplan.ScanPlan(
        "lineitem", ["l_quantity"], tplan.Cmp("l_shipmode", "eq", 2)))
    n = int(t.count)
    assert 0 < n == int(full.count)
    assert torch.equal(t.columns["l_quantity"][:n], full.columns["l_quantity"][full.mask])


def test_bloom_scan_matches_jax_engine(paths):
    """A BloomProbe plan given its bloom: the mask keeps every row whose key
    was built into the filter, and matches the JAX engine's."""
    tb, jb = _blooms(n_bits=1 << 12, n_hashes=3)
    tp = tplan.ScanPlan("lineitem", ["l_partkey", "l_quantity"], tplan.and_(
        tplan.BloomProbe("l_partkey", n_bits=1 << 12, n_hashes=3, name="bloom"),
        tplan.Cmp("l_quantity", "lt", 5)))
    jp = jplan.ScanPlan("lineitem", ["l_partkey", "l_quantity"], jplan.and_(
        jplan.BloomProbe("l_partkey", n_bits=1 << 12, n_hashes=3, name="bloom"),
        jplan.Cmp("l_quantity", "lt", 5)))
    t = tengine.DatapathEngine(device="cpu").scan(TReader(paths["lineitem"]), tp, blooms=tb)
    j = jengine.DatapathEngine(backend="ref").scan(JReader(paths["lineitem"]), jp, blooms=jb)
    _assert_same_result(t, j)
    pk, q = t.columns["l_partkey"].numpy(), t.columns["l_quantity"].numpy()
    n = TReader(paths["lineitem"]).n_rows
    member = np.isin(pk[:n], _bloom_keys()) & (q[:n] < 5)
    assert member.any() and t.mask.numpy()[:n][member].all()  # no false negative


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


# the fabric's names (ROADMAP.md A.4c), each with the port module it comes
# from and its package
FABRIC_NAMES = {
    "ScanFabric": "datapath.fabric", "FabricTicket": "datapath.fabric",
    "Catalog": "datapath.catalog", "Snapshot": "datapath.catalog",
    "HashRing": "distributed.sharding", "rg_key": "distributed.sharding",
}
# the service's names (ROADMAP.md A.4b), each with the port module it comes from
SERVICE_NAMES = {
    **dict.fromkeys(("DatapathService", "Pod", "QueueFull", "QuotaExceeded", "ScanRequest",
                     "ServiceClient", "TenantQuota", "Ticket"), "service"),
    **dict.fromkeys(("form_batch", "run_tick"), "scheduler"),
    **dict.fromkeys(("AdaptiveOffloadPolicy", "StaticPolicy", "coalesce_compatible"), "policy"),
    **dict.fromkeys(("CircuitBreaker", "FaultInjector", "FaultPlan", "FetchFailed",
                     "FetchTimeout", "Overloaded", "Quarantined", "RetryPolicy", "StorageFault",
                     "TransientFetchError"), "faults"),
    **dict.fromkeys(("Telemetry", "jain_index", "quantile"), "telemetry"),
}


@pytest.mark.parametrize("name", sorted(FABRIC_NAMES))
def test_fabric_names_are_ported(name):
    """The fabric's names (A.4c) are exported by the port's package of the
    reference's name, raise nothing, and come from the port's own module of
    the reference's name."""
    import importlib

    package, module = FABRIC_NAMES[name].split(".")
    tpkg = importlib.import_module(f"repro_torch.{package}")
    jpkg = importlib.import_module(f"repro.{package}")
    obj = getattr(tpkg, name)
    assert obj.__module__ == f"repro_torch.{FABRIC_NAMES[name]}"
    assert getattr(jpkg, name).__module__ == f"repro.{FABRIC_NAMES[name]}"
    assert obj is not getattr(jpkg, name)


@pytest.mark.parametrize("name", sorted(SERVICE_NAMES))
def test_service_names_are_ported(name):
    """The service's names (A.4b) are exported, raise nothing and come from
    the port's own module of the reference's name."""
    import repro.datapath as jdatapath

    obj = getattr(tdatapath, name)
    assert obj.__module__ == f"repro_torch.datapath.{SERVICE_NAMES[name]}"
    assert getattr(jdatapath, name).__module__ == f"repro.datapath.{SERVICE_NAMES[name]}"


def test_later_names_cover_the_rest_of_the_reference_package():
    """No name is left for a later slice: the port's `repro_torch.datapath`
    exports every public name of `repro.datapath`, and an unknown name is an
    AttributeError."""
    import repro.datapath as jdatapath

    ref_names = {n for n in dir(jdatapath) if not n.startswith("_")
                 and not isinstance(getattr(jdatapath, n), type(sys))}
    ported = {n for n in dir(tdatapath) if not n.startswith("_")}
    assert ref_names <= ported, sorted(ref_names - ported)
    assert not hasattr(tdatapath, "LATER")
    with pytest.raises(AttributeError):
        getattr(tdatapath, "NoSuchName")


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.queries, "
        "repro_torch.core.agg, repro_torch.kernels.agg_push, "
        "repro_torch.kernels.ops, repro_torch.kernels.build, repro_torch.lakeformat, "
        "repro_torch.kernels.flash_attention, repro_torch.models, repro_torch.models.model, "
        "repro_torch.configs, repro_torch.configs.qwen3_1_7b, repro_torch.serve, "
        "repro_torch.distributed, repro_torch.core.cache, repro_torch.datapath, "
        "repro_torch.datapath.trace, repro_torch.datapath.netsim, "
        "repro_torch.datapath.costmodel, repro_torch.datapath.blockstore, "
        "repro_torch.datapath.telemetry, repro_torch.datapath.faults, "
        "repro_torch.datapath.policy, repro_torch.datapath.scheduler, "
        "repro_torch.datapath.service, repro_torch.datapath.fabric, "
        "repro_torch.datapath.catalog, repro_torch.distributed.sharding, "
        "repro_torch.distributed.fault_tolerance, repro_torch.train.optimizer, "
        "repro_torch.train.checkpoint, repro_torch.train.loop, repro_torch.data.corpus, "
        "repro_torch.data.pipeline, repro_torch.launch.train, repro_torch.models.moe, "
        "repro_torch.models.ssm, repro_torch.configs.mamba2_370m, "
        "repro_torch.configs.hymba_1_5b, repro_torch.configs.deepseek_moe_16b, "
        "repro_torch.configs.llama4_maverick_400b, repro_torch.distributed.compat, "
        "repro_torch.launch.mesh, repro_torch.launch.serve, repro_torch.distributed.collectives, "
        "repro_torch.launch.specs, repro_torch.launch.dryrun, repro_torch.lakeformat.textformat\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes'"
        " or m.startswith('ml_dtypes.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
