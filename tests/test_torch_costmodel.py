"""The port's cost model (`repro_torch.datapath.costmodel`): the reference's
service-free cost-model tests driving the port (pricing, per-key
persistence, calibration and its CPU fallback, estimates equal to the
engine's actuals, netsim's single table), the port's own keying rule (a
table per timed device, `"cuda"` calibration never falls back), and the
footprints against the JAX engine's: equal on every plan but one whose
group-by domain is over MAX_GROUPS, where the port prices the windows it
launches on the card."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import json

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.datapath.costmodel import CostModel as JCostModel
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import BlockCache, Cmp, DatapathEngine, ScanPlan
from repro_torch.core import plan as tplan
from repro_torch.core.engine import group_domain
from repro_torch.core.plan import AggSpec, bind_expr
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.datapath import (
    NOMINAL_RATES_GBPS,
    CostModel,
    DecodeModel,
    LinkModel,
    PrefetchPipeline,
)
from repro_torch.datapath import costmodel as cmod
from repro_torch.kernels import ops
from repro_torch.lakeformat.encodings import padded_rows
from repro_torch.lakeformat.reader import LakeReader


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_cm")
    return jtpch.write_tables(str(d), sf=0.05, seed=0, sorted_data=True, row_group_size=8192)


@pytest.fixture(scope="module")
def lineitem(paths):
    return LakeReader(paths["lineitem"])


def _engine(**kw):
    return DatapathEngine(device="cpu", **kw)


# ---------------------------------------------------------------------------
# pricing + persistence
# ---------------------------------------------------------------------------

def test_nominal_pricing_and_unknown_encoding_fallback():
    cm = CostModel()
    assert cm.source == "nominal" and cm.backend == "cuda"
    assert NOMINAL_RATES_GBPS == JCostModel(backend="ref").rates  # the reference's table
    for enc, rate in NOMINAL_RATES_GBPS.items():
        assert cm.decode_seconds(1 << 30, enc) == pytest.approx((1 << 30) / (rate * 1e9))
    assert cm.decode_seconds(1000, "zstd_frame") == cm.decode_seconds(1000, "plain")
    assert cm.decode_seconds(2000, "rle") == pytest.approx(2 * cm.decode_seconds(1000, "rle"))


def test_save_load_round_trip(tmp_path):
    cm = CostModel(rates={"plain": 33.0, "rle": 44.0}, source="calibrated",
                   backend="cpu", link_bandwidth_gbps=5.0, link_latency_us=3.0)
    path = cm.save(str(tmp_path / "cal.json"))
    back = CostModel.load(path, backend="cpu")
    assert back.rates == cm.rates
    assert back.source == "calibrated" and back.backend == "cpu"
    assert back.link_model().bandwidth_gbps == 5.0
    assert back.link_model().latency_us == 3.0
    d = json.loads(open(path).read())
    entry = d["backends"]["cpu"]
    assert list(entry["rates_gbps"]) == sorted(entry["rates_gbps"])


def test_save_merges_per_device_and_load_never_borrows_another_table(tmp_path):
    """Tables timed on the card, on the CPU and for the host baseline live
    side by side in one file; saving one never clobbers another, and a key
    with no table raises instead of pricing with another key's."""
    path = str(tmp_path / "cal.json")
    for backend, rle, ovh in (("cpu", 1.0, 1e-5), ("cuda", 100.0, 1e-6), ("host", 0.5, 0.0)):
        CostModel(rates={"rle": rle}, source="calibrated", backend=backend,
                  launch_overhead_s=ovh).save(path)
    assert CostModel.load(path, backend="cpu").rates["rle"] == 1.0
    assert CostModel.load(path, backend="cuda").rates["rle"] == 100.0
    assert CostModel.load(path, backend="cuda").launch_overhead_s == 1e-6
    assert CostModel.load(path, backend="host").rates["rle"] == 0.5
    assert CostModel.load(path).rates["rle"] == 100.0  # the default key is the card's
    with pytest.raises(KeyError):
        CostModel.load(path, backend="tpu-v9")
    assert CostModel.load_or_nominal(path, backend="tpu-v9").source == "nominal"
    only_cpu = str(tmp_path / "cpu_only.json")
    CostModel(rates={"rle": 1.0}, source="calibrated", backend="cpu").save(only_cpu)
    with pytest.raises(KeyError):
        CostModel.load(only_cpu)  # a CPU table never prices the card


def test_active_backend_reads_the_device_it_is_given(monkeypatch):
    """The key follows the device named by the caller; nothing asks whether
    a card is present."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: (_ for _ in ()).throw(AssertionError("probed for a card")))
    assert cmod.active_backend("cuda") == "cuda"
    assert cmod.active_backend("cuda:0") == "cuda"
    assert cmod.active_backend("cpu") == "cpu"
    assert cmod.active_backend("cuda", backend="host") == "host"


def test_load_accepts_legacy_flat_format(tmp_path):
    legacy = {"rates_gbps": {"plain": 9.0}, "source": "calibrated",
              "backend": "cpu", "launch_overhead_s": 2e-5}
    path = tmp_path / "old.json"
    path.write_text(json.dumps(legacy))
    back = CostModel.load(str(path))
    assert back.rates["plain"] == 9.0 and back.launch_overhead_s == 2e-5
    CostModel(rates={"plain": 5.0}, backend="cuda", source="calibrated").save(str(path))
    assert CostModel.load(str(path), backend="cpu").rates["plain"] == 9.0
    assert CostModel.load(str(path), backend="cuda").rates["plain"] == 5.0


def test_load_or_nominal_degrades_gracefully(tmp_path):
    assert CostModel.load_or_nominal(None).source == "nominal"
    assert CostModel.load_or_nominal(str(tmp_path / "missing.json")).source == "nominal"
    bad = tmp_path / "corrupt.json"
    bad.write_text("{not json")
    assert CostModel.load_or_nominal(str(bad)).source == "nominal"


def test_nonpositive_rates_are_rejected():
    cm = CostModel(rates={"plain": 0.0, "rle": -3.0, "dict": 5.0})
    assert cm.rate_gbps("plain") == NOMINAL_RATES_GBPS["plain"]
    assert cm.rate_gbps("rle") == NOMINAL_RATES_GBPS["rle"]
    assert cm.rate_gbps("dict") == 5.0


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cpu", "host"])
def test_calibrate_smoke_measures_every_encoding(backend):
    cm = CostModel.calibrate(backend=backend, n=1 << 14, repeats=1)
    assert cm.source == "calibrated" and cm.backend == backend
    assert set(cm.rates) >= set(NOMINAL_RATES_GBPS)
    for enc in NOMINAL_RATES_GBPS:
        assert cm.rates[enc] > 0, enc
    assert cm.launch_overhead_s > 0


def test_calibrate_times_the_port_kernels_entry_points():
    """Calibration on a device goes through `kernels.ops`: each decode's
    entry point, and PLAIN's device put, is dispatched."""
    ops.reset_dispatch_count()
    cmod.measure_rates(backend="cpu", n=1 << 12, repeats=1)
    # plain, bitpack, dict, delta, rle: one untimed and one timed call each
    assert ops.dispatch_count() == 5 * 2


def test_calibrate_falls_back_to_nominal_on_failure():
    cm = CostModel.calibrate(backend="cpu", n=-5)  # invalid size -> error
    assert cm.source == "nominal-fallback"
    assert cm.rates == NOMINAL_RATES_GBPS


def test_calibrate_on_the_card_raises_instead_of_falling_back(monkeypatch):
    """On the card a kernel that fails is a fault: calibrate re-raises it."""
    def broken(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(cmod, "measure_launch_overhead", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        CostModel.calibrate(backend="cuda", n=1 << 12)
    assert CostModel.calibrate(backend="cpu", n=1 << 12).source == "nominal-fallback"
    with pytest.raises(ValueError):
        CostModel.calibrate(backend="pallas")


def test_median_seconds_synchronizes_the_card_and_warms_up(monkeypatch):
    """Timing on the card: one untimed call first (the kernel library's
    build), then a synchronize before and after every timed call."""
    import torch

    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: events.append("sync"))
    cmod._median_seconds(lambda: events.append("call"), 2, "cuda")
    assert events == ["call", "sync"] + ["sync", "call", "sync"] * 2
    events.clear()
    cmod._median_seconds(lambda: events.append("call"), 2, "cpu")
    assert events == ["call"] * 3


# ---------------------------------------------------------------------------
# estimates: equal to the engine's actuals
# ---------------------------------------------------------------------------

ESTIMATE_PLANS = [
    ScanPlan("lineitem", ["l_extendedprice", "l_quantity"]),  # full scan
    ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
             Cmp("l_shipdate", "between", (300, 900))),  # pruned, not fused
    ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_quantity", "le", 10)),  # fused
]


@pytest.mark.parametrize("idx", range(len(ESTIMATE_PLANS)))
def test_estimated_bytes_equal_engine_actuals(lineitem, idx):
    plan = ESTIMATE_PLANS[idx]
    eng = _engine(cache=BlockCache(1 << 30))
    pred = bind_expr(plan.predicate, lineitem)
    rgs = prune_row_groups(lineitem, pred)
    costs = CostModel().estimate_row_groups(eng, lineitem, plan, rgs, pred=pred)
    res = _engine().scan(lineitem, plan, row_groups=rgs)
    assert sum(c.nbytes for c in costs) == res.stats.decoded_bytes
    assert all(c.seconds > 0 for c in costs)


def test_estimated_seconds_match_actual_decode_work(lineitem):
    cm = CostModel()
    eng = _engine(cache=BlockCache(1 << 30))
    for plan in ESTIMATE_PLANS:
        pred = bind_expr(plan.predicate, lineitem)
        rgs = prune_row_groups(lineitem, pred)
        est_s = sum(c.seconds for c in cm.estimate_row_groups(eng, lineitem, plan, rgs,
                                                               pred=pred))
        res = _engine().scan(lineitem, plan, row_groups=rgs)
        actual_s = sum(cm.decode_seconds(b, e) for e, b in res.stats.decode_work.items())
        assert est_s == pytest.approx(actual_s)


def test_fused_predicate_column_priced_but_not_materialized(lineitem):
    cm = CostModel()
    eng = _engine()
    fused = ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_quantity", "le", 10))
    nofuse = ScanPlan("lineitem", ["l_extendedprice", "l_quantity"], Cmp("l_quantity", "le", 10))
    rgs = list(range(lineitem.n_row_groups))
    c_f = cm.estimate_row_groups(eng, lineitem, fused, rgs)
    c_n = cm.estimate_row_groups(eng, lineitem, nofuse, rgs)
    assert sum(c.nbytes for c in c_f) < sum(c.nbytes for c in c_n)
    assert sum(c.seconds for c in c_f) == pytest.approx(sum(c.seconds for c in c_n))


def test_fused_decode_work_uses_footer_dtype_width(lineitem):
    plan = ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_quantity", "le", 10))
    eng = _engine(cache=BlockCache(1 << 30))
    pred = bind_expr(plan.predicate, lineitem)
    rgs = prune_row_groups(lineitem, pred)
    res = eng.scan(lineitem, plan, row_groups=rgs)
    assert res.stats.fused
    assert np.dtype(lineitem.row_group_meta(rgs[0])["columns"]["l_quantity"]["dtype"]) == np.int32
    want = {}
    for fp in eng.decode_footprint(lineitem, plan, rgs, pred=pred):
        for col in fp["columns"].values():
            want[col["encoding"]] = want.get(col["encoding"], 0) + col["nbytes"]
    assert res.stats.decode_work == want
    cm = CostModel(launch_overhead_s=3e-6)
    est_s = sum(c.seconds for c in cm.estimate_row_groups(eng, lineitem, plan, rgs, pred=pred))
    actual_s = (sum(cm.decode_seconds(b, e) for e, b in res.stats.decode_work.items())
                + cm.launch_seconds(res.stats.kernel_launches))
    assert est_s == pytest.approx(actual_s)
    res_b = _engine(cache=BlockCache(1 << 30)).scan(lineitem, plan, row_groups=rgs,
                                                     batched=True)
    assert res_b.stats.decode_work == want


def test_estimates_use_padded_rows(lineitem):
    last = lineitem.n_row_groups - 1
    n = lineitem.row_group_meta(last)["n"]
    assert 0 < n < padded_rows(n)
    (cost,) = CostModel().estimate_row_groups(
        _engine(), lineitem, ScanPlan("lineitem", ["l_extendedprice"]), [last])
    assert cost.nbytes == padded_rows(n) * 4


# ---------------------------------------------------------------------------
# footprints against the JAX engine
# ---------------------------------------------------------------------------

def _footprint_plans(P):
    """(plan, wide): plans of every shape the footprint distinguishes, from
    one package's plan module; `wide` marks the group domain over MAX_GROUPS."""
    pred = P.Cmp("l_shipdate", "between", (365, 729))
    return {
        "full_scan": (P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"]), False),
        "fused": (P.ScanPlan("lineitem", ["l_extendedprice"], P.Cmp("l_quantity", "le", 10)),
                  False),
        "pruned_conjunction": (P.ScanPlan(
            "lineitem", ["l_extendedprice", "l_discount"],
            P.and_(pred, P.Cmp("l_discount", "lt", 0.05))), False),
        "grouped_agg": (P.ScanPlan(
            "lineitem", [], pred,
            aggregates=(P.AggSpec("sum", "l_extendedprice"), P.AggSpec("count")),
            group_by="l_returnflag"), False),
        "fused_agg": (P.ScanPlan(
            "lineitem", [], pred,
            aggregates=(P.AggSpec("sum", "l_quantity"), P.AggSpec("max", "l_quantity"))),
            False),
        "count_star": (P.ScanPlan("lineitem", [], pred, aggregates=(P.AggSpec("count"),)),
                       False),
        "wide_domain": (P.ScanPlan(
            "lineitem", [], pred,
            aggregates=(P.AggSpec("sum", "l_extendedprice"), P.AggSpec("count")),
            group_by="l_shipdate"), True),
    }


@pytest.mark.parametrize("name", list(_footprint_plans(jplan)))
def test_footprint_and_estimate_against_reference(paths, name):
    """decode_footprint and estimate_row_groups equal the JAX engine's on
    every plan whose group domain fits one launch.  Over MAX_GROUPS the
    reference reduces on the host and prices no aggregate work (it even
    calls the value column a predicate column); the port reduces on the
    card, one launch per MAX_GROUPS-wide window, and prices those: the
    difference is exactly the windows' agg entries and the value column's
    role."""
    tp, wide = _footprint_plans(tplan)[name]
    jp, _ = _footprint_plans(jplan)[name]
    tr, jr = LakeReader(paths["lineitem"]), JReader(paths["lineitem"])
    rgs = prune_row_groups(tr, bind_expr(tp.predicate, tr))
    eng, jeng = _engine(), jengine.DatapathEngine(backend="ref")
    got = eng.decode_footprint(tr, tp, rgs)
    want = jeng.decode_footprint(jr, jp, rgs)
    tcm, jcm = CostModel(launch_overhead_s=4e-6), JCostModel(backend="ref",
                                                             launch_overhead_s=4e-6)
    t_est = tcm.estimate_row_groups(eng, tr, tp, rgs)
    j_est = jcm.estimate_row_groups(jeng, jr, jp, rgs)
    if not wide:
        assert got == want
        assert [(c.nbytes, c.seconds) for c in t_est] == [(c.nbytes, c.seconds) for c in j_est]
        return
    n_windows = -(-group_domain(tr, "l_shipdate") // ops.MAX_GROUPS)
    assert n_windows > 1
    for g, w in zip(got, want):
        aggs = {k: v for k, v in g["columns"].items() if v["role"] == "agg"}
        assert len(aggs) == n_windows and not any(k in w["columns"] for k in aggs)
        assert all(v == {"nbytes": g["rows"] * 4, "encoded_bytes": 0, "encoding": "agg",
                         "materialized": False, "role": "agg"} for v in aggs.values())
        rest = {k: v for k, v in g["columns"].items() if k not in aggs}
        assert rest["l_extendedprice"]["role"] == "agg-source"
        assert w["columns"]["l_extendedprice"]["role"] == "pred"
        rest["l_extendedprice"] = dict(rest["l_extendedprice"], role="pred")
        assert rest == w["columns"]
    extra = [n_windows * (tcm.decode_seconds(fp["rows"] * 4, "agg") + 4e-6) for fp in got]
    assert [c.nbytes for c in t_est] == [c.nbytes for c in j_est]
    assert [t.seconds for t in t_est] == pytest.approx(
        [j.seconds + x for j, x in zip(j_est, extra)])


@pytest.mark.parametrize("batched", [False, True])
def test_wide_domain_estimate_equals_the_ports_actuals(lineitem, batched):
    """The wide-domain footprint follows the port's path: the estimate's
    bytes and seconds equal what the scan books, `decode_work["agg"]` and
    one launch per window included (sequential), and the batched scan
    books the same decode_work."""
    plan = ScanPlan("lineitem", [], Cmp("l_shipdate", "between", (365, 729)),
                    aggregates=(AggSpec("sum", "l_extendedprice"), AggSpec("count")),
                    group_by="l_shipdate")
    eng = _engine()
    rgs = prune_row_groups(lineitem, bind_expr(plan.predicate, lineitem))
    cm = CostModel(launch_overhead_s=5e-6)
    est = cm.estimate_row_groups(eng, lineitem, plan, rgs)
    res = eng.scan(lineitem, plan, batched=batched)
    st = res.stats
    assert st.decode_work["agg"] == sum(
        v["nbytes"] for fp in eng.decode_footprint(lineitem, plan, rgs)
        for v in fp["columns"].values() if v["role"] == "agg")
    if not batched:
        actual = (sum(cm.decode_seconds(b, e) for e, b in st.decode_work.items())
                  + cm.launch_seconds(st.kernel_launches))
        assert sum(c.seconds for c in est) == pytest.approx(actual, abs=1e-12)


# ---------------------------------------------------------------------------
# netsim unification
# ---------------------------------------------------------------------------

def test_decode_model_is_encoding_aware():
    dm = DecodeModel(decode_gbps=10.0, rates={"rle": 40.0})
    assert dm.decode_seconds(1 << 20, "rle") == pytest.approx(dm.decode_seconds(1 << 20) / 4)
    assert dm.decode_seconds(1 << 20, "bitpack") == dm.decode_seconds(1 << 20)


def test_default_decode_model_reads_the_registered_table():
    prev = cmod.set_default_cost_model(None)
    try:
        dm = DecodeModel()
        assert dm.rates == NOMINAL_RATES_GBPS
        assert dm.decode_gbps == NOMINAL_RATES_GBPS["plain"]
        cal = CostModel(rates={"plain": 3.0, "rle": 7.0}, source="calibrated",
                        launch_overhead_s=5e-6)
        cmod.set_default_cost_model(cal)
        dm2 = DecodeModel()
        assert dm2.rates == cal.rates and dm2.decode_gbps == 3.0
        assert dm2.launch_overhead_s == 5e-6
        assert PrefetchPipeline().decode.rates == cal.rates
        dm3 = DecodeModel(decode_gbps=10.0)
        assert dm3.rates is None and dm3.launch_overhead_s == 0.0
    finally:
        cmod.set_default_cost_model(prev)


def test_pipeline_decode_seconds_override():
    pipe = PrefetchPipeline(LinkModel(bandwidth_gbps=1.0, latency_us=0.0))
    enc = [1 << 20] * 4
    dec = [1 << 20] * 4
    slow = pipe.simulate(enc, dec, decode_seconds=[1.0] * 4)
    fast = pipe.simulate(enc, dec, decode_seconds=[1e-6] * 4)
    assert slow["serial_s"] > fast["serial_s"]
    assert abs(slow["serial_s"] - (slow["overlapped_s"] + slow["saved_s"])) < 1e-9


def test_cli_smoke(tmp_path, capsys):
    out = tmp_path / "cal.json"
    assert cmod.main(["--nominal", "--out", str(out)]) == 0
    assert CostModel.load(str(out)).rates == NOMINAL_RATES_GBPS
    assert "costmodel.plain" in capsys.readouterr().out
    assert cmod.main(["--backend", "cpu", "--n", "4096", "--repeats", "1",
                      "--out", str(out)]) == 0
    assert CostModel.load(str(out), backend="cpu").source == "calibrated"
    assert CostModel.load(str(out), backend="cuda").source == "nominal"
