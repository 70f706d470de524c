"""The port's six queries on the CPU against the JAX queries on the same
files, unsorted and sorted (lineitem on l_shipdate: RLE pages).  Integers
(counts, rows, keys) are exact.  Float totals are float32 sums taken in
another order than XLA's, so they agree within rtol=1e-4.  Q15's winner is
compared exactly only when the reference's top-two gap exceeds that
tolerance; otherwise either of the two is right.

Q19 selects about one lineitem row in 10,000, so its tests use seed 4,
whose sf=0.05 files give it a handful of rows (seed 0 gives none)."""

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import queries as jq
from repro.core import tpch as jtpch
from repro.lakeformat.reader import LakeReader as JReader
from repro_torch.core import agreement
from repro_torch.core import engine as tengine
from repro_torch.core import queries as tq
from repro_torch.lakeformat.reader import LakeReader as TReader

RTOL = agreement.RTOL


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_queries")
    paths = jtpch.write_tables(str(d), sf=0.05, seed=0, row_group_size=8192)
    return (
        tengine.DatapathEngine(device="cpu"),
        {k: TReader(p) for k, p in paths.items()},
        jengine.DatapathEngine(backend="ref"),
        {k: JReader(p) for k, p in paths.items()},
    )


def _env(d, **kw):
    paths = jtpch.write_tables(str(d), sf=0.05, row_group_size=8192, **kw)
    return (
        tengine.DatapathEngine(device="cpu"),
        {k: TReader(p) for k, p in paths.items()},
        jengine.DatapathEngine(backend="ref"),
        {k: JReader(p) for k, p in paths.items()},
    )


@pytest.fixture(scope="module", params=[False, True], ids=["unsorted", "sorted"])
def env_seed4(request, tmp_path_factory):
    return _env(tmp_path_factory.mktemp("tpch_queries_seed4"), seed=4,
                sorted_data=request.param)


def _run(env, name, **kw):
    te, tr, je, jr = env
    return tq.QUERIES[name](te, tr, **kw), jq.QUERIES[name](je, jr, **kw)


@pytest.mark.parametrize("delta_days", [90, 1200])
def test_q1(env, delta_days):
    got, want = _run(env, "q1", delta_days=delta_days)
    assert sorted(got) == sorted(want)
    for key, row in want.items():
        assert got[key]["count"] == row["count"]
        assert got[key]["sum_qty"] == row["sum_qty"]  # integer-valued, exact in f32
        for f in ("sum_base_price", "sum_disc_price", "sum_charge"):
            assert got[key][f] == pytest.approx(row[f], rel=RTOL), (key, f)


@pytest.mark.parametrize("year_start", [365, 1500])
def test_q6(env, year_start):
    got, want = _run(env, "q6", year_start=year_start)
    assert got["rows"] == want["rows"]
    assert got["revenue"] == pytest.approx(want["revenue"], rel=RTOL)


@pytest.mark.parametrize("year_start", [0, 730])
def test_q12(env, year_start):
    got, want = _run(env, "q12", year_start=year_start)
    assert got == want


@pytest.mark.parametrize("month_start", [100, 1000])
def test_q14(env, month_start):
    got, want = _run(env, "q14", month_start=month_start)
    assert got["total_revenue"] == pytest.approx(want["total_revenue"], rel=RTOL)
    assert got["promo_revenue_pct"] == pytest.approx(want["promo_revenue_pct"], rel=RTOL)


@pytest.mark.parametrize("quarter_start", [365, 2000])
def test_q15(env, quarter_start):
    got, want = _run(env, "q15", quarter_start=quarter_start)
    # the reference's per-supplier sums, recomputed in float64 for the tie rule
    _, tr, _, _ = env
    per = agreement.per_supplier_revenue(tr["lineitem"], quarter_start)
    assert agreement.q15_agrees(got, want, per)


def test_q19(env_seed4):
    got, want = _run(env_seed4, "q19")
    assert want["rows"] > 0
    assert got["rows"] == want["rows"]
    assert got["revenue"] == pytest.approx(want["revenue"], rel=RTOL)
    agreement.compare("q19", got, want)


def test_q19_without_matches(env):
    """Seed 0's files hold no Q19 row: both packages answer zero."""
    got, want = _run(env, "q19")
    assert got == want == {"revenue": 0.0, "rows": 0}


@pytest.mark.parametrize("name", ["q1", "q6", "q12", "q14", "q15"])
def test_sorted_files(env_seed4, name):
    """The five other queries on the seed-4 files; on sorted files their
    l_shipdate predicates read RLE pages and zone maps prune row groups."""
    got, want = _run(env_seed4, name)
    _, tr, _, _ = env_seed4
    agreement.compare(name, got, want, agreement.per_supplier_revenue(tr["lineitem"]))


def test_q15_tie_rule():
    per = np.array([1.0, 5.0, 5.00001, 2.0])
    assert agreement.q15_agrees({"suppkey": 1, "revenue": 5.0},
                                {"suppkey": 2, "revenue": 5.00001}, per)
    far = np.array([1.0, 4.0, 5.0])
    assert not agreement.q15_agrees({"suppkey": 1, "revenue": 5.0},
                                    {"suppkey": 2, "revenue": 5.0}, far)


def test_query_results_are_plain_python(env):
    te, tr, _, _ = env
    for name, q in tq.QUERIES.items():
        out = q(te, tr)
        assert not any(isinstance(v, torch.Tensor) for v in out.values()), name
