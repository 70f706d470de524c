"""The port's offload configurations on the CPU against the JAX engine
(backend "ref"), on the same seeded files.

- Every offload mode (`raw`, `preloaded`, `prefiltered`, `pre-aggregated`)
  and the `host` decode baseline, on unsorted and sorted files, sequential
  and batched: two scans on one engine (the second served by the store),
  each equal to the JAX engine's (ints, masks and decoded values exactly;
  pushed-down float sums within rtol 1e-4) with every ScanStats field but
  `batch_pad_blocks`, the store's ledger equal to the reference's, and the
  second scan equal to `raw` bit for bit.
- Pool and cache residency: pre-populated decode pools and decoded tiers,
  batched ≡ sequential in the port and ≡ the JAX engine.
- `scan_group_batched`: two requests' slices through one bucket pass over a
  shared DecodePool, equal to the reference's and to each request's own scan.
- The reference's engine-level offload tests (tests/test_engine.py,
  tests/test_pushdown.py, tests/test_batch_decode.py's offload, pool and
  cache cases) driving the port; the storage seam (duck-typed fault
  injector, checksum quarantine); the six queries twice per cached mode
  equal to `raw`.
"""

import dataclasses
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.core.cache import BlockCache as JBlockCache
from repro.datapath.blockstore import DecodePool as JDecodePool
from repro.lakeformat.reader import LakeReader as JReader
from repro.lakeformat.schema import ColumnSchema, TableSchema
from repro.lakeformat.writer import write_table
from repro_torch.core import BlockCache, DatapathEngine, agreement
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core import queries as tq
from repro_torch.core.plan import AggSpec, Cmp, ScanPlan, bind_expr
from repro_torch.core.zonemap import prune_row_groups
from repro_torch.datapath import CostModel, DecodePool
from repro_torch.datapath.netsim import LinkModel, SliceClock
from repro_torch.kernels import ops
from repro_torch.lakeformat.integrity import CorruptPageError
from repro_torch.lakeformat.reader import LakeReader

RG_ROWS = 6000  # the mixed table's row groups: not a PACK_BLOCK multiple


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Seed-4 TPC-H files (Q19 selects rows there), unsorted and sorted."""
    out = {}
    for order in ("unsorted", "sorted"):
        d = tmp_path_factory.mktemp(f"tpch_offload_{order}")
        out[order] = jtpch.write_tables(str(d), sf=0.05, seed=4, row_group_size=8192,
                                        sorted_data=order == "sorted")
    return out


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Every encoding in 4 ragged row groups (the reference's
    tests/test_batch_decode.py table)."""
    rng = np.random.default_rng(7)
    n = 3 * RG_ROWS + 1700
    base = np.arange(n, dtype=np.int64) // 3
    cols = {
        "ts": (base + rng.integers(0, 2, n)).astype(np.int32),
        "flag": np.repeat(rng.integers(0, 5, size=n // 64 + 1), 64)[:n].astype(np.int32),
        "level": np.repeat(rng.standard_normal(n // 128 + 1).astype(np.float32), 128)[:n],
        "price": rng.standard_normal(n).astype(np.float32),
        "cat": (rng.integers(0, 40, n) + 100 * (np.arange(n) // RG_ROWS)).astype(np.int32),
        "key": rng.integers(0, 1 << 13, n).astype(np.int32),
    }
    schema = TableSchema("mixed", [
        ColumnSchema("ts", "int32", "delta"),
        ColumnSchema("flag", "int32", "rle"),
        ColumnSchema("level", "float32", "rle"),
        ColumnSchema("price", "float32", "plain"),
        ColumnSchema("cat", "int32", "dict"),
        ColumnSchema("key", "int32", "bitpack"),
    ])
    path = str(tmp_path_factory.mktemp("offload_mixed") / "mixed.lake")
    write_table(path, schema, cols, row_group_size=RG_ROWS)
    return path


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bits(a):
    a = _np(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_rows(t, w):
    """Port result `t` against a result `w` of either engine: mask, count
    and columns bit for bit."""
    assert int(t.count) == int(w.count)
    np.testing.assert_array_equal(_np(t.mask), _np(w.mask))
    assert sorted(t.columns) == sorted(w.columns)
    for name in t.columns:
        assert _np(t.columns[name]).dtype == _np(w.columns[name]).dtype, name
        np.testing.assert_array_equal(_bits(t.columns[name]), _bits(w.columns[name]),
                                      err_msg=name)


def _same_aggs(got, want, exact: bool):
    """Aggregates: bit for bit within one package (`exact`); against the
    JAX engine ints exactly and float sums within rtol 1e-4."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        if not exact and k.startswith("sum") and w.dtype == np.float64:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def _stats(stats, skip=("batch_pad_blocks",)):
    return {k: v for k, v in dataclasses.asdict(stats).items() if k not in skip}


def _same_result(t, w, exact: bool):
    if t.aggregates is not None:
        _same_aggs(t.aggregates, w.aggregates, exact)
        assert int(t.count) == int(w.count)
    else:
        _same_rows(t, w)


def _blooms(readers):
    """Q19's bloom, built by the port: (the port's, the same bits for the
    JAX engine)."""
    bits = tq.q19_bloom(DatapathEngine(device="cpu"), readers)
    return {"q19": bits}, {"q19": jnp.asarray(bits.numpy())}


def _row_plans(P):
    return {
        "fused_dict": P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"],
                                 P.Cmp("l_shipdate", "between", (365, 729))),
        "conjunction_compact": P.ScanPlan(
            "lineitem", ["l_extendedprice", "l_discount", "l_shipmode"],
            P.and_(P.Cmp("l_shipdate", "between", (365, 1400)),
                   P.Cmp("l_quantity", "lt", 24)), compact=True),
        "q19_bloom": P.ScanPlan(
            "lineitem", ["l_partkey", "l_quantity", "l_extendedprice"],
            P.and_(P.BloomProbe("l_partkey", n_bits=1 << 15, n_hashes=4, name="q19"),
                   P.Cmp("l_quantity", "le", 30))),
    }


def _agg_plans(P):
    pred = P.Cmp("l_shipdate", "between", (365, 729))
    return {
        "grouped_sum": P.ScanPlan(
            "lineitem", [], pred,
            aggregates=(P.AggSpec("sum", "l_extendedprice"), P.AggSpec("count")),
            group_by="l_returnflag"),
        "fused_qty": P.ScanPlan(
            "lineitem", [], pred,
            aggregates=(P.AggSpec("sum", "l_quantity"), P.AggSpec("min", "l_quantity"),
                        P.AggSpec("max", "l_quantity"))),
    }


def _plans_for(mode):
    return _agg_plans if mode == "pre-aggregated" else _row_plans


MODES = ["raw", "preloaded", "prefiltered", "pre-aggregated", "host"]


def _engines(mode, cache_bytes=1 << 30):
    """(port engine, JAX engine) for a mode; "host" is the raw host baseline."""
    if mode == "host":
        return (DatapathEngine(device="cpu", backend="host", cache=BlockCache(cache_bytes)),
                jengine.DatapathEngine(backend="host", cache=JBlockCache(cache_bytes)))
    return (DatapathEngine(device="cpu", offload=mode, cache=BlockCache(cache_bytes)),
            jengine.DatapathEngine(backend="ref", offload=mode, cache=JBlockCache(cache_bytes)))


# ---------------------------------------------------------------------------
# every mode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("batched", [False, True], ids=["seq", "batched"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_engine_and_second_run_equals_raw(tables, mode, batched, order):
    plans_fn = _plans_for(mode)
    tr = {k: LakeReader(p) for k, p in tables[order].items()}
    jr = JReader(tables[order]["lineitem"])
    eng, jeng = _engines(mode)
    raw = DatapathEngine(device="cpu")
    for name in plans_fn(tplan):
        tp, jp = plans_fn(tplan)[name], plans_fn(jplan)[name]
        tb, jb = _blooms(tr) if name == "q19_bloom" else (None, None)
        want_raw = raw.scan(tr["lineitem"], tp, blooms=tb, batched=batched)
        for run in range(2):
            got = eng.scan(tr["lineitem"], tp, blooms=tb, batched=batched)
            ref = jeng.scan(jr, jp, blooms=jb, batched=batched)
            _same_result(got, ref, exact=False)
            assert _stats(got.stats) == _stats(ref.stats), (name, run)
            assert got.stats.batch_pad_blocks == 0
            # the store's answer is the raw scan's, bit for bit
            _same_result(got, want_raw, exact=True)
            if run == 1 and mode in ("prefiltered", "pre-aggregated"):
                assert got.stats.cache_hit
            if run == 1 and mode == "preloaded":
                assert got.stats.decoded_bytes_fresh == 0 and got.stats.encoded_bytes == 0
        if name == "q19_bloom":
            assert int(want_raw.count) > 0
    # one ledger, billed as the reference bills: the same entries, bytes,
    # hits, misses and prices
    assert eng.cache.stats() == jeng.cache.stats()
    assert eng.cache.store.stats() == jeng.cache.store.stats()
    if mode in ("raw", "host"):
        assert eng.cache.used == 0


@pytest.mark.parametrize("batched", [False, True], ids=["seq", "batched"])
def test_host_baseline_decodes_on_the_host(tables, batched):
    """The host backend decodes with numpy: no decode kernel or fused path
    runs, and every column is one host decode + copy."""
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = _row_plans(tplan)["fused_dict"]
    ops.reset_dispatch_count()
    res = DatapathEngine(device="cpu", backend="host").scan(r, plan, batched=batched)
    assert ops.dispatch_count() == 0  # no ops.* decode, fused scan or bloom call
    assert not res.stats.fused
    assert res.stats.kernel_launches == 3 * res.stats.row_groups_scanned
    _same_rows(res, DatapathEngine(device="cpu").scan(r, plan))


# ---------------------------------------------------------------------------
# pool and cache residency (tests/test_batch_decode.py's cases)
# ---------------------------------------------------------------------------

def _mixed_plans(P):
    return [
        P.ScanPlan("mixed", ["ts", "flag", "level", "price", "cat", "key"]),  # every encoding
        P.ScanPlan("mixed", ["price", "level"], P.Cmp("key", "le", 1000)),  # fused bitpack
        P.ScanPlan("mixed", ["price", "ts"], P.Cmp("cat", "between", (100, 140))),  # fused dict
        P.ScanPlan("mixed", ["flag", "cat"], P.Cmp("ts", "between", (1000, 3000))),  # pruning
    ]


def _run(path, plan, offload, batched, pool=None, cache=None, split_at=None, jax=False):
    """One scan of `plan` through a fresh engine, advanced in one or two
    slices, sequentially or batched."""
    if jax:
        eng = jengine.DatapathEngine(backend="ref", offload=offload,
                                     cache=cache if cache is not None else JBlockCache(1 << 30))
        reader = JReader(path)
    else:
        eng = DatapathEngine(device="cpu", offload=offload,
                             cache=cache if cache is not None else BlockCache(1 << 30))
        reader = LakeReader(path)
    rs = eng.resumable_scan(reader, plan)
    if rs.result is None:
        pending = list(rs.pending)
        cut = len(pending) if split_at is None else max(1, min(split_at, len(pending)))
        for part in (pending[:cut], pending[cut:]):
            if not part or rs.result is not None:
                continue
            if batched:
                rs.advance_batched(part, pool=pool)
            else:
                for rg in part:
                    rs.advance([rg], pool=pool)
    return rs


def _pair(path, tp, jp, offload="raw", pools=None, caches=None, split_at=None):
    """Port sequential ≡ port batched (all fields but kernel_launches) ≡ the
    JAX engine's batched scan (all but batch_pad_blocks)."""
    seq = _run(path, tp, offload, False, *(p[0] if p else None for p in (pools, caches)),
               split_at=split_at)
    bat = _run(path, tp, offload, True, *(p[1] if p else None for p in (pools, caches)),
               split_at=split_at)
    jb = _run(path, jp, offload, True, *(p[2] if p else None for p in (pools, caches)),
              split_at=split_at, jax=True)
    _same_rows(bat.result, seq.result)
    assert _stats(bat.stats, ("kernel_launches",)) == _stats(seq.stats, ("kernel_launches",))
    _same_rows(bat.result, jb.result)
    assert _stats(bat.stats) == _stats(jb.stats)
    return seq, bat


@pytest.mark.parametrize("offload", ["raw", "preloaded", "prefiltered"])
@pytest.mark.parametrize("idx", range(4))
def test_batched_identical_mixed(mixed, idx, offload):
    seq, bat = _pair(mixed, _mixed_plans(tplan)[idx], _mixed_plans(jplan)[idx], offload)
    if seq.stats.row_groups_scanned > 1 and seq.stats.decoded_bytes_fresh:
        assert bat.stats.kernel_launches < seq.stats.kernel_launches


def test_batched_identical_with_split_slices(mixed):
    for offload in ("raw", "preloaded"):
        for cut in (1, 2, 3):
            _pair(mixed, _mixed_plans(tplan)[0], _mixed_plans(jplan)[0], offload, split_at=cut)


def _donor_subset(path, tp, jp, density, seed):
    """The same (rg, column) subset of decoded columns, as each engine's pool
    entries: (port dict, JAX dict), keyed by each engine's rg_cache_key."""
    t_eng = DatapathEngine(device="cpu")
    j_eng = jengine.DatapathEngine(backend="ref")
    t_pool, j_pool = {}, {}
    t_eng.scan(LakeReader(path), tp, pool=t_pool)
    j_eng.scan(JReader(path), jp, pool=j_pool)
    rnd = random.Random(seed)
    tsub, jsub = {}, {}
    for key in sorted(t_pool, key=repr):
        if rnd.random() < density:
            _, p, rg, name, _ = key
            tsub[key] = t_pool[key]
            jsub[j_eng.rg_cache_key(JReader(path), rg, name)] = j_pool[
                j_eng.rg_cache_key(JReader(path), rg, name)]
    return tsub, jsub


@pytest.mark.parametrize("density", [0.0, 0.3, 0.7, 1.0])
def test_batched_identical_with_pool_residency(mixed, density):
    """Some (rg, column) decodes already in the shared pool: hits, puts and
    stats match exactly, the fully resident shortcut included."""
    tp, jp = _mixed_plans(tplan)[0], _mixed_plans(jplan)[0]
    tsub, jsub = _donor_subset(mixed, tp, jp, density, int(density * 10))
    seq, bat = _pair(mixed, tp, jp, pools=(dict(tsub), dict(tsub), dict(jsub)))
    if density == 1.0:
        assert seq.stats.decoded_bytes_fresh == 0
        assert bat.stats.pool_hits == seq.stats.pool_hits > 0


@pytest.mark.parametrize("density", [0.4, 1.0])
def test_batched_identical_with_cache_residency(mixed, density):
    """Preloaded-mode decoded-tier entries for a subset of (rg, column)."""
    tp = tplan.ScanPlan("mixed", ["ts", "flag", "price"])
    jp = jplan.ScanPlan("mixed", ["ts", "flag", "price"])
    donor = DatapathEngine(device="cpu", offload="preloaded", cache=BlockCache(1 << 30))
    jdonor = jengine.DatapathEngine(backend="ref", offload="preloaded", cache=JBlockCache(1 << 30))
    r, jr = LakeReader(mixed), JReader(mixed)
    donor.scan(r, tp)
    jdonor.scan(jr, jp)
    caches = []
    for make, d, rr in ((BlockCache, donor, r), (BlockCache, donor, r),
                        (JBlockCache, jdonor, jr)):
        cache = make(1 << 30)
        rnd = random.Random(int(density * 10))
        for rg in range(r.n_row_groups):
            for name in tp.columns:
                key = d.rg_cache_key(rr, rg, name)
                if rnd.random() < density:
                    e = d.cache.store.peek(key)
                    cache.put(key, e.value, encoding=e.encoding)
        caches.append(cache)
    seq, bat = _pair(mixed, tp, jp, "preloaded", caches=tuple(caches))
    if density == 1.0:
        assert bat.stats.encoded_bytes == seq.stats.encoded_bytes == 0


@pytest.mark.parametrize("seed", range(6))
def test_batched_equivalence_sweep_with_residency(mixed, seed):
    """Seeded random plans, offload modes, slice splits and pool densities
    (the reference's hypothesis sweep, tests/test_batch_decode.py)."""
    rng = random.Random(seed)
    names = ["ts", "flag", "level", "price", "cat", "key"]
    cols = sorted(rng.sample(names, rng.randint(1, 4)))
    preds = [None, ("key", "le", 1000), ("cat", "between", (100, 240)),
             ("ts", "between", (500, 9000)), ("flag", "eq", 2)]
    pred = rng.choice(preds)
    offload = rng.choice(["raw", "preloaded", "prefiltered"])
    split = rng.randint(0, 4) or None
    density = rng.choice([None, 0.3, 1.0])
    compact = rng.random() < 0.5
    tp, jp = (P.ScanPlan("mixed", cols, None if pred is None else P.Cmp(*pred), compact=compact)
              for P in (tplan, jplan))
    pools = None
    if density is not None:
        tsub, jsub = _donor_subset(mixed, tp, jp, density, seed)
        pools = (dict(tsub), dict(tsub), dict(jsub))
    _pair(mixed, tp, jp, offload, pools=pools, split_at=split)


def test_decode_pool_hits_promote_into_the_store(mixed):
    """Under a cached mode a pool hit still persists: it is promoted into
    the store with the pool's recorded encoding as its price, as in the
    reference."""
    plan = _mixed_plans(tplan)[0]
    pool = DecodePool()
    DatapathEngine(device="cpu").scan(LakeReader(mixed), plan, pool=pool)
    eng = DatapathEngine(device="cpu", offload="preloaded", cache=BlockCache(1 << 30))
    res = eng.scan(LakeReader(mixed), plan, pool=pool)
    assert res.stats.pool_hits == 6 * 4 and res.stats.decoded_bytes_fresh == 0
    for key in pool:
        e = eng.cache.store.peek(key)
        assert e is not None and e.tier == "decoded" and not e.ephemeral
        assert e.encoding == pool.encoding_of(key)


# ---------------------------------------------------------------------------
# cross-request stacking
# ---------------------------------------------------------------------------

def _group_items(reader, rs_list):
    return [{"reader": reader, "rgs": list(rs.pending), "plan": rs.plan, "pred": rs.pred,
             "blooms": rs.blooms, "stats": rs.stats, "offload": None, "owner": f"t{i}",
             "trace": None} for i, rs in enumerate(rs_list)]


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("mode", ["raw", "preloaded", "host"])
def test_scan_group_batched_matches_reference(tables, order, mode):
    """Two requests' slices (overlapping columns and row groups) through one
    stacked pass over a shared DecodePool: each request's result and stats
    equal the reference's, its columns equal its own scan's, and the pass
    launches fewer kernels than the two batched scans."""
    path = tables[order]["lineitem"]
    plans = {
        "a": lambda P: P.ScanPlan("lineitem", ["l_extendedprice", "l_discount"],
                                  P.Cmp("l_shipdate", "between", (300, 900))),
        "b": lambda P: P.ScanPlan("lineitem", ["l_extendedprice", "l_quantity"],
                                  P.and_(P.Cmp("l_shipdate", "between", (600, 1200)),
                                         P.Cmp("l_discount", "lt", 0.05))),
    }
    results = {}
    for side in ("port", "jax"):
        if side == "port":
            eng, _ = _engines(mode)
            reader, pool, P = LakeReader(path), DecodePool(), tplan
        else:
            _, eng = _engines(mode)
            reader, pool, P = JReader(path), JDecodePool(), jplan
        rs_list = [eng.resumable_scan(reader, plans[k](P)) for k in ("a", "b")]
        items = _group_items(reader, rs_list)
        out = eng.scan_group_batched(items, pool=pool)
        for rs, it, (per_rg, _fetched) in zip(rs_list, items, out):
            assert rs.ingest_batched(it["rgs"], per_rg) is not None
        results[side] = (rs_list, out)
    (t_rs, t_out), (j_rs, j_out) = results["port"], results["jax"]
    for trs, jrs, (_, t_fetched), (_, j_fetched) in zip(t_rs, j_rs, t_out, j_out):
        _same_rows(trs.result, jrs.result)
        assert _stats(trs.stats) == _stats(jrs.stats)
        assert t_fetched == j_fetched
    assert t_rs[1].stats.pool_hits > 0  # the second request reused the first's decodes
    own = [_engines(mode)[0].scan(LakeReader(path), plans[k](tplan), batched=True)
           for k in ("a", "b")]
    for rs, o in zip(t_rs, own):
        _same_rows(rs.result, o)
    if mode != "host":
        launched = sum(rs.stats.kernel_launches for rs in t_rs)
        assert launched < sum(o.stats.kernel_launches for o in own)


def test_scan_group_batched_attributes_owner_and_trace(tables):
    """`pool.owner` and the trace slice are rebound per item: each request's
    window hits are recorded under its owner, and each item's spans land in
    its own trace."""
    from repro_torch.datapath import Tracer
    from repro_torch.datapath import trace as trace_mod

    path = tables["unsorted"]["lineitem"]
    eng = DatapathEngine(device="cpu")
    reader = LakeReader(path)
    plan = tplan.ScanPlan("lineitem", ["l_extendedprice"], tplan.Cmp("l_quantity", "lt", 40))
    rs_list = [eng.resumable_scan(reader, plan) for _ in range(2)]
    tracer = Tracer()
    rts = [tracer.start(i, f"t{i}", "lineitem") for i in range(2)]
    items = _group_items(reader, rs_list)
    for it, rt in zip(items, rts):
        it["trace"] = (tracer, rt)
    pool = DecodePool()
    tengine.TRACE = trace_mod
    try:
        eng.scan_group_batched(items, pool=pool)
    finally:
        tengine.TRACE = None
    assert trace_mod._CUR is None
    entries = [pool.store.peek(k) for k in pool]
    assert entries and all(e.beneficiaries == {"t0", "t1"} for e in entries)
    names = [[c["name"] for c in rt.root["children"]] for rt in rts]
    # each request fetches its own pages; the one stacked pass's launches go
    # to the first traced request, and the second serves its column from
    # the first's decodes (window hits)
    assert "fetch" in names[0] and "decode_launch" in names[0]
    assert "fetch" in names[1] and "decode_launch" not in names[1]
    assert "store_hit" in names[1]


# ---------------------------------------------------------------------------
# the reference's engine-level offload tests, on the port
# ---------------------------------------------------------------------------

def test_offload_modes_agree_and_cache(tables):
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_shipdate", "le", 1000))
    results = {}
    for offload in ("raw", "preloaded", "prefiltered"):
        eng = DatapathEngine(device="cpu", offload=offload, cache=BlockCache(1 << 30))
        r1 = eng.scan(r, plan)
        r2 = eng.scan(r, plan)
        results[offload] = int(r1.count)
        assert int(r1.count) == int(r2.count)
        if offload == "prefiltered":
            assert r2.stats.cache_hit
        if offload == "preloaded":
            assert eng.cache.hits > 0
    assert len(set(results.values())) == 1


def test_cache_lru_eviction():
    c = BlockCache(capacity_bytes=1000)
    a = torch.zeros(100, dtype=torch.uint8)
    for i in range(20):
        c.put(("k", i), a)
    assert c.used <= 1000 and c.evictions > 0
    assert c.get(("k", 19)) is not None
    assert c.get(("k", 0)) is None


def test_per_call_offload_overrides_the_engine_mode(tables):
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_shipdate", "le", 1000))
    eng = DatapathEngine(device="cpu", cache=BlockCache(1 << 30))
    eng.scan(r, plan, offload="prefiltered")
    assert eng.scan(r, plan, offload="prefiltered").stats.cache_hit
    assert not eng.scan(r, plan).stats.cache_hit  # the engine's own mode is raw
    with pytest.raises(ValueError):
        eng.scan(r, plan, offload="cached")
    with pytest.raises(ValueError):
        DatapathEngine(device="cpu", offload="cached")
    with pytest.raises(ValueError):
        DatapathEngine(device="cpu", backend="pallas")


def test_row_groups_skip_pruning(tables):
    r = LakeReader(tables["sorted"]["lineitem"])
    plan = ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_shipdate", "between", (365, 729)))
    eng = DatapathEngine(device="cpu")
    rgs = prune_row_groups(r, bind_expr(plan.predicate, r))
    assert 0 < len(rgs) < r.n_row_groups
    _same_rows(eng.scan(r, plan, row_groups=rgs), eng.scan(r, plan))
    assert eng.scan(r, plan, row_groups=rgs[:1]).stats.row_groups_scanned == 1


def test_pre_aggregated_cache_hit(tables):
    """The second identical scan hits the prefiltered tier: the cached
    accumulators round-trip bit for bit, flagged as a hit (the reference's
    test drives it through the service's policy; here the engine's mode)."""
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = _agg_plans(tplan)["grouped_sum"]
    eng = DatapathEngine(device="cpu", offload="pre-aggregated", cache=BlockCache(1 << 30))
    first = eng.scan(r, plan)
    for _ in range(2):
        again = eng.scan(r, plan)
        assert again.stats.cache_hit and again.stats.kernel_launches == 0
        _same_aggs(again.aggregates, first.aggregates, exact=True)
        assert again.stats.result_bytes == first.stats.result_bytes
    # pre-aggregated never seeds the decoded tier: pushdown exists to avoid
    # materializing the value columns
    tiers = eng.cache.stats()["tiers"]
    assert tiers["decoded"]["entries"] == 0 and tiers["prefiltered"]["entries"] == 1


def test_agg_footprint_estimate_matches_actual(tables):
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = ScanPlan("lineitem", [], Cmp("l_shipdate", "between", (365, 729)),
                    aggregates=(AggSpec("sum", "l_extendedprice"), AggSpec("min", "l_quantity"),
                                AggSpec("max", "l_quantity"), AggSpec("count")),
                    group_by="l_returnflag")
    eng = DatapathEngine(device="cpu")
    cm = CostModel(backend="cpu", launch_overhead_s=5e-6)
    rgs = prune_row_groups(r, bind_expr(plan.predicate, r))
    est = sum(c.seconds for c in cm.estimate_row_groups(eng, r, plan, rgs))
    scan = eng.resumable_scan(r, plan, offload="raw")
    res = None
    while res is None:
        res = scan.advance(scan.pending[:1])
    st = res.stats
    actual = sum(cm.decode_seconds(b, e) for e, b in st.decode_work.items()
                 ) + cm.launch_seconds(st.kernel_launches)
    assert est == pytest.approx(actual, abs=1e-12)
    assert "agg" in st.decode_work


def test_footprint_roles(tables):
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = ScanPlan("lineitem", [], Cmp("l_shipdate", "between", (365, 729)),
                    aggregates=(AggSpec("sum", "l_extendedprice"), AggSpec("count")),
                    group_by="l_returnflag")
    fp = DatapathEngine(device="cpu").decode_footprint(r, plan, [0])[0]["columns"]
    assert fp["l_returnflag"]["role"] == "group-key"
    assert fp["l_extendedprice"]["role"] == "agg-source"
    assert fp["l_shipdate"]["role"] == "pred"
    assert not fp["l_shipdate"]["materialized"]  # fused predicate column
    aggs = [k for k, v in fp.items() if v["role"] == "agg"]
    assert aggs and all(not fp[k]["materialized"] for k in aggs)


def test_metadata_hooks_match_reference(tables):
    """estimate_selectivity, estimate_scan_bytes and fused_column_meta equal
    the JAX engine's; plan_cache_key scopes by plan, route, blooms and tag."""
    path = tables["unsorted"]["lineitem"]
    r, jr = LakeReader(path), JReader(path)
    eng, jeng = DatapathEngine(device="cpu"), jengine.DatapathEngine(backend="ref")
    for name in _row_plans(tplan):
        tp, jp = _row_plans(tplan)[name], _row_plans(jplan)[name]
        assert eng.estimate_selectivity(r, tp) == jeng.estimate_selectivity(jr, jp)
        assert eng.estimate_scan_bytes(r, tp) == jeng.estimate_scan_bytes(jr, jp)
        pred, jpred = bind_expr(tp.predicate, r), jplan.bind_expr(jp.predicate, jr)
        cols = r.row_group_meta(0)["columns"]
        assert (eng.fused_column_meta(pred, cols, tp.materialized_columns())
                == jeng.fused_column_meta(jpred, cols, jp.materialized_columns()))
    plan = _row_plans(tplan)["q19_bloom"]
    bits = torch.zeros(1 << 12, dtype=torch.uint8)
    k0 = eng.plan_cache_key(r, plan)
    k1 = eng.plan_cache_key(r, plan, {"q19": bits})
    bits2 = bits.clone()
    bits2[7] = 1
    assert k1 != k0 and k1 != eng.plan_cache_key(r, plan, {"q19": bits2})
    assert k1 == eng.plan_cache_key(r, plan, {"q19": bits.clone()})
    assert eng.plan_cache_key(r, plan, tag=(1, 2)) != k0
    assert k0 != DatapathEngine(device="cpu", backend="host").plan_cache_key(r, plan)
    assert eng.rg_cache_key(r, 0, "x")[-1] == "cpu/kernels"
    assert eng.page_cache_key(r, 0, "x") == jeng.page_cache_key(jr, 0, "x")


@pytest.mark.parametrize("share", [3, 16])
def test_page_tier_under_pressure_matches_reference(tables, share):
    """A store holding a third (then a sixteenth) of Q1's decoded lineitem
    columns: decoded columns are evicted, the second scan hits the page
    tier, used stays within capacity, and everything (the ledger included)
    equals the reference's.  At a third every evicted decode's page is
    still resident (pages price higher per byte than the decodes), so
    nothing demotes; at a sixteenth the pages no longer all fit, and
    decodes whose page went first demote to it."""
    path = tables["unsorted"]["lineitem"]
    plan = tq.LINEITEM_PLANS["q1"]()
    jp = _jax_row_plan(plan)
    full = DatapathEngine(device="cpu").scan(LakeReader(path), plan).stats.decoded_bytes
    cap = full // share
    eng = DatapathEngine(device="cpu", offload="preloaded", cache=BlockCache(cap))
    jeng = jengine.DatapathEngine(backend="ref", offload="preloaded", cache=JBlockCache(cap))
    want = DatapathEngine(device="cpu").scan(LakeReader(path), plan)
    for run in range(2):
        got = eng.scan(LakeReader(path), plan)
        ref = jeng.scan(JReader(path), jp)
        _same_rows(got, want)
        _same_rows(got, ref)
        assert _stats(got.stats) == _stats(ref.stats)
        assert eng.cache.used <= cap
    assert got.stats.page_hits > 0
    st = eng.cache.store.stats()
    assert st["tiers"]["decoded"]["evictions"] > 0
    assert (st["tiers"]["decoded"]["demotions"] > 0) == (share == 16)
    assert st == jeng.cache.store.stats()


def _jax_row_plan(plan):
    def expr(e):
        if e is None:
            return None
        if isinstance(e, tplan.Cmp):
            return jplan.Cmp(e.column, e.op, e.value)
        if isinstance(e, tplan.InSet):
            return jplan.InSet(e.column, e.values)
        if isinstance(e, tplan.BloomProbe):
            return jplan.BloomProbe(e.column, n_bits=e.n_bits, n_hashes=e.n_hashes, name=e.name)
        kids = [expr(c) for c in e.children]
        return jplan.and_(*kids) if isinstance(e, tplan.And) else jplan.or_(*kids)
    return jplan.ScanPlan(plan.table, list(plan.columns), expr(plan.predicate),
                          compact=plan.compact)


def test_slice_clock_streams_overlap():
    clk = SliceClock(LinkModel(bandwidth_gbps=1.0, latency_us=0.0))
    for _ in range(3):
        clk.feed(1_000_000_000, 0.5)  # 1 s fetch, 0.5 s decode
    assert clk.slices == 3
    assert clk.serial_s == pytest.approx(4.5)
    assert clk.overlapped_s == pytest.approx(3.5)
    assert clk.saved_s == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the storage seam
# ---------------------------------------------------------------------------

class _CountingInjector:
    """A duck-typed fault plane: reads through, counting its calls."""

    def __init__(self):
        self.calls = []

    def read(self, engine, reader, rg, columns, stats):
        self.calls.append((rg, tuple(columns)))
        stats.retry_fetches += 1
        return reader.read_encoded(rg, columns)


def test_fault_injector_seam_routes_every_fetch(tables):
    r = LakeReader(tables["unsorted"]["lineitem"])
    plan = ScanPlan("lineitem", ["l_extendedprice"], Cmp("l_quantity", "lt", 20))
    eng = DatapathEngine(device="cpu")
    eng.faults = _CountingInjector()
    res = eng.scan(r, plan, batched=True)
    assert len(eng.faults.calls) == res.stats.row_groups_scanned == res.stats.retry_fetches
    eng.faults = None
    _same_rows(res, eng.scan(r, plan))


def test_corrupt_page_is_quarantined_like_reference(tables, tmp_path):
    bad = str(tmp_path / "lineitem.lake")
    shutil.copy(tables["unsorted"]["lineitem"], bad)
    meta = JReader(bad).row_group_meta(1)["columns"]["l_quantity"]["buffers"]["packed"]
    with open(bad, "r+b") as f:
        f.seek(meta["offset"] + 100)
        byte = f.read(1)
        f.seek(meta["offset"] + 100)
        f.write(bytes([byte[0] ^ 0xFF]))
    plan = ScanPlan("lineitem", ["l_quantity"])
    eng = DatapathEngine(device="cpu", offload="preloaded", cache=BlockCache(1 << 30))
    jeng = jengine.DatapathEngine(backend="ref", offload="preloaded", cache=JBlockCache(1 << 30))
    with pytest.raises(CorruptPageError):
        eng.scan(LakeReader(bad), plan)
    with pytest.raises(Exception):
        jeng.scan(JReader(bad), jplan.ScanPlan("lineitem", ["l_quantity"]))
    key = eng.page_cache_key(LakeReader(bad), 1, "l_quantity")
    assert key in eng.cache.store._quarantined and eng.cache.store.quarantines == 1
    assert eng.cache.store.stats() == jeng.cache.store.stats()


# ---------------------------------------------------------------------------
# the six queries: cached modes, twice, equal to raw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["preloaded", "prefiltered"])
def test_queries_twice_in_a_cached_mode_equal_raw(tables, mode):
    """Nothing downstream writes into a cached tensor: the six queries run
    twice on a cached engine (the second run served by the store) give the
    raw engine's answers exactly."""
    readers = {k: LakeReader(p) for k, p in tables["unsorted"].items()}
    raw = {name: q(DatapathEngine(device="cpu"), readers) for name, q in tq.QUERIES.items()}
    eng = DatapathEngine(device="cpu", offload=mode, cache=BlockCache(1 << 30))
    per_supp = agreement.per_supplier_revenue(readers["lineitem"])
    for _ in range(2):
        for name, q in tq.QUERIES.items():
            got = q(eng, readers)
            assert got == raw[name], name
            agreement.compare(name, got, raw[name], per_supp)
    assert eng.cache.hits > 0
