"""The port's aggregate pushdown on the CPU, mirroring tests/test_pushdown.py
where it needs no service or cache, and its fabric cases (the partial
aggregates of N pods merged in global row-group order).

Within the port, pushed-down aggregation must equal scan-then-aggregate
(`agg.aggregate_rows_host` over the same engine's row scan) bit for bit,
float sums included, whether the scan runs sequentially, batched or in
slices.  Against the JAX engine (backend "ref") on the same files: counts,
int sums, min and max exactly, float sums within rtol 1e-4 (the port's
float32 block sums add in another fixed order than XLA's), and every
ScanStats field equal but `batch_pad_blocks` (the port pads no stack; a
fleet's merged stats also differ in `kernel_launches`, which follow the
port's own dispatch)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.datapath as jdp
import repro_torch.datapath as tdp
from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.kernels import ops as jops
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import agg, agreement
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import padded_rows
from repro_torch.lakeformat.reader import LakeReader as TReader


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    out = {}
    for order in ("unsorted", "sorted"):
        d = tmp_path_factory.mktemp(f"tpch_push_{order}")
        out[order] = jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192,
                                        sorted_data=order == "sorted")
    return out


def _specs(P):
    return (P.AggSpec("sum", "l_extendedprice"), P.AggSpec("min", "l_quantity"),
            P.AggSpec("max", "l_quantity"), P.AggSpec("count"))


def _pred(P):
    return P.Cmp("l_shipdate", "between", (365, 729))


def _plans(P):
    """Name -> the same aggregate plan in one package's plan module."""
    return {
        "ungrouped": P.ScanPlan("lineitem", [], _pred(P), aggregates=_specs(P)),
        "grouped": P.ScanPlan("lineitem", [], _pred(P), aggregates=_specs(P),
                              group_by="l_returnflag"),
        # benchmarks/throughput.py's two pushdown plans
        "throughput_grouped_sum": P.ScanPlan(
            "lineitem", [], _pred(P),
            aggregates=(P.AggSpec("sum", "l_extendedprice"), P.AggSpec("count")),
            group_by="l_returnflag"),
        "throughput_fused_qty": P.ScanPlan(
            "lineitem", [], _pred(P),
            aggregates=(P.AggSpec("sum", "l_quantity"), P.AggSpec("min", "l_quantity"),
                        P.AggSpec("max", "l_quantity"))),
        # a DICT-coded float column and a bare count(*), grouped by a DICT column
        "grouped_dict_float_and_count": P.ScanPlan(
            "lineitem", [], P.Cmp("l_quantity", "lt", 30),
            aggregates=(P.AggSpec("sum", "l_discount"), P.AggSpec("max", "l_discount"),
                        P.AggSpec("count")), group_by="l_shipmode"),
    }


def _expected(reader, plan, blooms=None):
    """Scan-then-aggregate in the port, through its CPU engine."""
    return agreement.scan_then_aggregate(tengine.DatapathEngine(device="cpu"), reader, plan,
                                         blooms)


def _identical(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _agrees_with_jax(got, want):
    """Ints exactly, float sums within rtol 1e-4."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        if k.startswith("sum") and w.dtype == np.float64:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _stats(stats):
    return {k: v for k, v in dataclasses.asdict(stats).items() if k != "batch_pad_blocks"}


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("batched", [False, True], ids=["seq", "batched"])
@pytest.mark.parametrize("name", list(_plans(tplan)))
def test_pushdown_matches_scan_then_aggregate_and_jax(tables, order, batched, name):
    path = tables[order]["lineitem"]
    tp, jp = _plans(tplan)[name], _plans(jplan)[name]
    res = tengine.DatapathEngine(device="cpu").scan(TReader(path), tp, batched=batched)
    _identical(res.aggregates, _expected(TReader(path), tp))
    assert res.agg_partials is not None and res.columns == {}
    # the result DMA is the accumulator set, not the rows
    assert res.stats.result_bytes == sum(int(a.nbytes) for a in res.aggregates.values())
    j = jengine.DatapathEngine(backend="ref").scan(JReader(path), jp, batched=batched)
    _agrees_with_jax(res.aggregates, j.aggregates)
    assert int(res.count) == int(j.count) > 0
    assert _stats(res.stats) == _stats(j.stats)
    assert res.stats.batch_pad_blocks == 0


def test_float_sum_bit_identity_across_dispatch_shapes(tables):
    """The float64 canonical-order fold: sequential, batched and sliced
    batched scans give the same bits as scan-then-aggregate."""
    r = TReader(tables["unsorted"]["lineitem"])
    plan = tplan.ScanPlan("lineitem", [], _pred(tplan),
                          aggregates=(tplan.AggSpec("sum", "l_extendedprice"),),
                          group_by="l_returnflag")
    want = _expected(r, plan)["sum(l_extendedprice)"]
    assert want.dtype == np.float64
    eng = tengine.DatapathEngine(device="cpu")
    for batched in (False, True):
        got = eng.scan(r, plan, batched=batched).aggregates["sum(l_extendedprice)"]
        assert np.array_equal(got, want)
    rs = tengine.ResumableScan(eng, r, plan)
    pending = rs.pending
    assert len(pending) > 1
    assert rs.advance_batched(pending[:1])[0] is None
    sliced, _ = rs.advance_batched(pending[1:])
    assert np.array_equal(sliced.aggregates["sum(l_extendedprice)"], want)


def test_fused_agg_skip_decode(tables):
    """A BITPACK value column nothing else reads aggregates without a decode
    launch: decode_work books the page, and no 'agg' entry (no decoded
    source); one fused aggregate launch per row group (sequential) or per k
    (batched), as the JAX engine counts."""
    path = tables["unsorted"]["lineitem"]
    tp = tplan.ScanPlan("lineitem", [], _pred(tplan),
                        aggregates=(tplan.AggSpec("sum", "l_quantity"), tplan.AggSpec("count")))
    jp = jplan.ScanPlan("lineitem", [], _pred(jplan),
                        aggregates=(jplan.AggSpec("sum", "l_quantity"), jplan.AggSpec("count")))
    want = _expected(TReader(path), tp)
    for batched in (False, True):
        res = tengine.DatapathEngine(device="cpu").scan(TReader(path), tp, batched=batched)
        _identical(res.aggregates, want)
        assert "agg" not in res.stats.decode_work and res.stats.fused
        j = jengine.DatapathEngine(backend="ref").scan(JReader(path), jp, batched=batched)
        assert _stats(res.stats) == _stats(j.stats)
        _agrees_with_jax(res.aggregates, j.aggregates)


def test_all_pruned_agg_scan(tables):
    r = TReader(tables["unsorted"]["lineitem"])
    plan = tplan.ScanPlan("lineitem", [], tplan.Cmp("l_shipdate", "gt", 10**9),
                          aggregates=_specs(tplan), group_by="l_returnflag")
    n = tengine.group_domain(r, "l_returnflag")
    for batched in (False, True):
        res = tengine.DatapathEngine(device="cpu").scan(r, plan, batched=batched)
        assert int(res.count) == 0 and res.stats.row_groups_scanned == 0
        assert np.array_equal(res.aggregates["count(*)"], np.zeros(n, np.int64))
        assert np.array_equal(res.aggregates["sum(l_extendedprice)"], np.zeros(n, np.float64))
        assert np.array_equal(res.aggregates["min(l_quantity)"],
                              np.full(n, 2**31 - 1, np.int32))  # the identity fill
    ident = agg.identity_partial(3, np.float32)
    assert ident.mn.tolist() == [np.inf] * 3 and ident.mx.tolist() == [-np.inf] * 3


def test_over_max_groups_host_fallback(tables):
    """A group domain over MAX_GROUPS is reduced on the engine's device in
    MAX_GROUPS-wide windows, one grouped launch each, with the same
    per-row-group partials as scan-then-aggregate, sequential and batched.
    The JAX engine gathers the rows and reduces them on the host instead, so
    the port books the windows' launches and their 'agg' work on top of its
    stats; every other field is equal."""
    path = tables["unsorted"]["lineitem"]
    r = TReader(path)
    n_groups = tengine.group_domain(r, "l_partkey")
    assert n_groups > ops.MAX_GROUPS == 128
    windows = -(-n_groups // ops.MAX_GROUPS)
    mk = lambda P: P.ScanPlan("lineitem", [], _pred(P),  # noqa: E731
                              aggregates=(P.AggSpec("sum", "l_quantity"), P.AggSpec("count")),
                              group_by="l_partkey")
    want = _expected(r, mk(tplan))
    rgs = prune_row_groups(r, tplan.bind_expr(_pred(tplan), r))
    for batched in (False, True):
        res = tengine.DatapathEngine(device="cpu").scan(r, mk(tplan), batched=batched)
        _identical(res.aggregates, want)
        assert list(res.agg_partials) == rgs
        j = jengine.DatapathEngine(backend="ref").scan(JReader(path), mk(jplan), batched=batched)
        _agrees_with_jax(res.aggregates, j.aggregates)
        got, exp = _stats(res.stats), _stats(j.stats)
        # one fold per row group sequentially, one for the whole batched scan
        launches = windows * (1 if batched else len(rgs))
        assert got.pop("kernel_launches") == exp.pop("kernel_launches") + launches
        rows = sum(padded_rows(r.row_group_meta(rg)["n"]) for rg in rgs)
        work = got.pop("decode_work")
        assert work.pop("agg") == windows * rows * 4 and "agg" not in exp["decode_work"]
        assert work == exp.pop("decode_work")
        assert got == exp


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("batched", [False, True], ids=["seq", "batched"])
def test_over_max_groups_float_sum_bit_identical(tables, order, batched):
    """A float sum over a domain of 20 windows (l_shipdate's day numbers):
    the windows' planes side by side equal the plain reduction over the
    whole domain bit for bit, and agree with the JAX engine's host
    reduction."""
    path = tables[order]["lineitem"]
    r = TReader(path)
    assert -(-tengine.group_domain(r, "l_shipdate") // ops.MAX_GROUPS) == 20
    mk = lambda P: P.ScanPlan("lineitem", [], _pred(P),  # noqa: E731
                              aggregates=(P.AggSpec("sum", "l_extendedprice"),
                                          P.AggSpec("max", "l_extendedprice"),
                                          P.AggSpec("count")),
                              group_by="l_shipdate")
    res = tengine.DatapathEngine(device="cpu").scan(r, mk(tplan), batched=batched)
    _identical(res.aggregates, _expected(r, mk(tplan)))
    j = jengine.DatapathEngine(backend="ref").scan(JReader(path), mk(jplan), batched=batched)
    _agrees_with_jax(res.aggregates, j.aggregates)
    assert int(res.aggregates["count(*)"][365:730].sum()) == int(res.count) > 0


def test_agg_result_bytes_tiny_vs_row_scan(tables):
    r = TReader(tables["unsorted"]["lineitem"])
    aplan = _plans(tplan)["throughput_grouped_sum"]
    rplan = tplan.ScanPlan("lineitem", ["l_extendedprice", "l_returnflag"], _pred(tplan))
    eng = tengine.DatapathEngine(device="cpu")
    ares = eng.scan(r, aplan, batched=True)
    rres = eng.scan(r, rplan, batched=True)
    assert ares.stats.result_bytes * 5 <= rres.stats.result_bytes
    assert ares.stats.kernel_launches <= rres.stats.kernel_launches + len(
        agg.agg_sources(aplan.aggregates))


def _bloom_fixture(P, build, to):
    """A bloom of every 7th order key and its semijoin predicate, as one
    package builds them."""
    okeys = np.arange(0, 60_000, 7, dtype=np.int32)
    pred = P.and_(_pred(P), P.BloomProbe("l_orderkey", name="ok"))
    return {"ok": build(to(okeys), 1 << 15)}, pred


def test_bloom_semijoin_batched_and_into_pushdown(tables):
    """A bloom semijoin: the batched row scan ≡ the sequential one (one
    stacked probe launch against one per row group), and a grouped
    pushdown behind it ≡ its scan-then-aggregate and the JAX engine's."""
    path = tables["unsorted"]["lineitem"]
    tb, tpred = _bloom_fixture(tplan, ops.bloom_build, torch.from_numpy)
    jb, jpred = _bloom_fixture(jplan, jops.bloom_build, jnp.asarray)
    eng = tengine.DatapathEngine(device="cpu")
    rplan = tplan.ScanPlan("lineitem", ["l_quantity"], tpred)
    dispatches = {}
    for batched in (False, True):
        ops.reset_dispatch_count()
        res = eng.scan(TReader(path), rplan, blooms=tb, batched=batched)
        dispatches[batched] = ops.dispatch_count()
        if batched:
            assert torch.equal(res.mask, seq.mask) and int(res.count) > 0
            assert torch.equal(res.columns["l_quantity"], seq.columns["l_quantity"])
        seq = res
    assert dispatches[True] < dispatches[False]
    tp = tplan.ScanPlan("lineitem", [], tpred, aggregates=_specs(tplan), group_by="l_returnflag")
    jp = jplan.ScanPlan("lineitem", [], jpred, aggregates=_specs(jplan), group_by="l_returnflag")
    want = _expected(TReader(path), tp, blooms=tb)
    for batched in (False, True):
        res = eng.scan(TReader(path), tp, blooms=tb, batched=batched)
        _identical(res.aggregates, want)
        j = jengine.DatapathEngine(backend="ref").scan(JReader(path), jp, blooms=jb,
                                                       batched=batched)
        _agrees_with_jax(res.aggregates, j.aggregates)
        assert _stats(res.stats) == _stats(j.stats)


# ---------------------------------------------------------------------------
# the fabric: deterministic partial-aggregate merge across pods
# ---------------------------------------------------------------------------

def _fleet_scans(path, name, n_pods):
    """Plan `name` through a port fleet and a JAX fleet of n_pods."""
    tp, jp = _plans(tplan)[name], _plans(jplan)[name]
    got = tdp.ScanFabric(n_pods=n_pods, device="cpu").scan(TReader(path), tp)
    ref = jdp.ScanFabric(n_pods=n_pods, backend="ref").scan(JReader(path), jp)
    return tp, got, ref


def _fleet_stats(stats):
    return {k: v for k, v in _stats(stats).items() if k != "kernel_launches"}


@pytest.mark.parametrize("n_pods", [1, 2, 4])
def test_fabric_agg_merge_bit_identical(tables, n_pods):
    """N pods' partials re-fold to the single engine's aggregates bit for
    bit, and to scan-then-aggregate; the JAX fleet agrees."""
    path = tables["unsorted"]["lineitem"]
    tp, got, ref = _fleet_scans(path, "grouped", n_pods)
    want = _expected(TReader(path), tp)
    _identical(got.aggregates, want)
    direct = tengine.DatapathEngine(device="cpu").scan(TReader(path), tp)
    _identical(got.aggregates, direct.aggregates)
    assert int(got.count) == int(np.asarray(want["count(*)"]).sum()) == int(ref.count)
    assert got.count.dtype == torch.int32 and got.mask.shape == (0,)
    _agrees_with_jax(got.aggregates, ref.aggregates)
    assert _fleet_stats(got.stats) == _fleet_stats(ref.stats)


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_fabric_float_sum_order_pinned(tables, order):
    """The pod partition must not change a float sum's bits: the merge adds
    in global row-group order whichever pod owned which groups."""
    path = tables[order]["lineitem"]
    key = "sum(l_extendedprice)"
    base = _fleet_scans(path, "throughput_grouped_sum", 1)[1].aggregates[key]
    for n in (2, 4):
        _, got, ref = _fleet_scans(path, "throughput_grouped_sum", n)
        assert np.array_equal(got.aggregates[key].view(np.int64), base.view(np.int64)), n
        _agrees_with_jax(got.aggregates, ref.aggregates)


def test_fabric_all_pruned_agg(tables):
    path = tables["unsorted"]["lineitem"]
    got, ref = (
        F.ScanFabric(n_pods=2, **kw).scan(R(path), P.ScanPlan(
            "lineitem", [], P.Cmp("l_shipdate", "gt", 10 ** 9),
            aggregates=(P.AggSpec("sum", "l_quantity"), P.AggSpec("count"))))
        for F, P, R, kw in ((tdp, tplan, TReader, {"device": "cpu"}),
                            (jdp, jplan, JReader, {"backend": "ref"})))
    assert int(got.count) == 0 and got.count.dtype == torch.int32
    assert np.array_equal(got.aggregates["count(*)"], np.zeros(1, np.int64))
    _identical(got.aggregates, {k: np.asarray(v) for k, v in ref.aggregates.items()})
    assert _fleet_stats(got.stats) == _fleet_stats(ref.stats)
