"""The port's batched scan path on the CPU: `scan(batched=True)` ≡ the
sequential scan within the port (columns, masks, counts and every ScanStats
field but the launch count), and ≡ the JAX engine's batched scan (backend
"ref") with `kernel_launches` equal too.  Cases: a synthetic table whose
columns hit every encoding in ragged row groups, lineitem on unsorted and
sorted files, and the lineitem scan of each of the six queries (Q19's with
its bloom).  The port pads no stack, so it books `batch_pad_blocks` 0 where
the reference books its bucket padding.  Also the batch entry points of
`kernels.ops`."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plan as jplan
from repro.core import tpch as jtpch
from repro.kernels import ops as jops
from repro.lakeformat.reader import LakeReader as JReader
from repro.lakeformat.schema import ColumnSchema, TableSchema
from repro.lakeformat.writer import write_table
from repro_torch.core import engine as tengine
from repro_torch.core import plan as tplan
from repro_torch.core import queries as tq
from repro_torch.kernels import ops, ref
from repro_torch.lakeformat import encodings as E
from repro_torch.lakeformat.reader import LakeReader as TReader

RG_ROWS = 6000  # not a PACK_BLOCK multiple: every row group is ragged


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Every encoding in 4 ragged row groups: delta, RLE int and float,
    plain float, int DICT with a different dictionary per row group, bitpack."""
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
    path = str(tmp_path_factory.mktemp("batchdec") / "mixed.lake")
    write_table(path, schema, cols, row_group_size=RG_ROWS)
    return path


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Seed-4 TPC-H files (Q19 selects rows there), unsorted and sorted."""
    out = {}
    for order in ("unsorted", "sorted"):
        d = tmp_path_factory.mktemp(f"tpch_batch_{order}")
        out[order] = jtpch.write_tables(str(d), sf=0.05, seed=4, row_group_size=8192,
                                        sorted_data=order == "sorted")
    return out


def _fields(stats, skip):
    return {k: v for k, v in dataclasses.asdict(stats).items() if k not in skip}


def _same_rows(t, j) -> None:
    """Port result t against a result j of either engine: mask, count and
    columns bit for bit."""
    assert int(t.count) == int(j.count)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert sorted(t.columns) == sorted(j.columns)
    for name, col in t.columns.items():
        got = col.numpy()
        want = j.columns[name].numpy() if isinstance(j.columns[name], torch.Tensor) \
            else np.asarray(j.columns[name])
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.view(np.int32) if got.dtype == np.float32 else got,
                                      want.view(np.int32) if want.dtype == np.float32 else want,
                                      err_msg=name)


def _check(path, tp, jp, tblooms=None, jblooms=None, split_at=None):
    """Port sequential, port batched and JAX batched on one file: the port's
    two paths equal in all but kernel_launches; the port's batched equal to
    the JAX engine's in all but batch_pad_blocks.  Returns the port's pair."""
    eng = tengine.DatapathEngine(device="cpu")
    seq = eng.scan(TReader(path), tp, blooms=tblooms)
    if split_at is not None and split_at >= seq.stats.row_groups_scanned:
        split_at = None  # nothing left for a second slice
    if split_at is None:
        bat = eng.scan(TReader(path), tp, blooms=tblooms, batched=True)
    else:
        rs = tengine.ResumableScan(eng, TReader(path), tp, blooms=tblooms)
        pending = rs.pending
        assert rs.advance_batched(pending[:split_at]) == (None, list(pending[:split_at]))
        bat, _ = rs.advance_batched(pending[split_at:])
    _same_rows(bat, seq)
    assert _fields(bat.stats, ("kernel_launches",)) == _fields(seq.stats, ("kernel_launches",))
    jeng = jengine.DatapathEngine(backend="ref")
    if split_at is None:
        jb = jeng.scan(JReader(path), jp, blooms=jblooms, batched=True)
    else:
        jrs = jeng.resumable_scan(JReader(path), jp, blooms=jblooms)
        jrs.advance_batched(jrs.pending[:split_at])
        jb, _ = jrs.advance_batched(jrs.pending)
    _same_rows(bat, jb)
    assert _fields(bat.stats, ("batch_pad_blocks",)) == _fields(jb.stats, ("batch_pad_blocks",))
    assert bat.stats.batch_pad_blocks == 0  # the port launches unpadded stacks
    return seq, bat


def _mixed_plans(P):
    return [
        P.ScanPlan("mixed", ["ts", "flag", "level", "price", "cat", "key"]),  # every encoding
        P.ScanPlan("mixed", ["price", "level"], P.Cmp("key", "le", 1000)),  # fused bitpack
        P.ScanPlan("mixed", ["price", "ts"], P.Cmp("cat", "between", (100, 140))),  # fused dict:
        # per-row-group dictionaries give per-block bounds in one launch
        P.ScanPlan("mixed", ["flag", "cat"], P.Cmp("ts", "between", (1000, 3000))),  # pruning
    ]


@pytest.mark.parametrize("idx", range(4))
def test_batched_identical_mixed(mixed, idx):
    seq, bat = _check(mixed, _mixed_plans(tplan)[idx], _mixed_plans(jplan)[idx])
    if seq.stats.row_groups_scanned > 1:
        assert bat.stats.kernel_launches < seq.stats.kernel_launches


def test_batched_identical_with_split_slices(mixed):
    """A scan advanced in two batched slices folds in like the sequential one."""
    for cut in (1, 2, 3):
        _check(mixed, _mixed_plans(tplan)[0], _mixed_plans(jplan)[0], split_at=cut)


_SWEEP_PREDS = [
    None,
    ("key", "le", 1000),  # fused bitpack when key is not projected
    ("cat", "between", (100, 240)),  # fused dict when cat is not projected
    ("ts", "between", (500, 9000)),  # prunable
    ("flag", "eq", 2),
]


@pytest.mark.parametrize("seed", range(8))
def test_batched_equivalence_sweep(mixed, seed):
    """Seeded random plans over the mixed table (the reference's hypothesis
    sweep, tests/test_batch_decode.py, without its pools and caches):
    projections, predicates, compact=True and slice splits."""
    rng = np.random.default_rng(seed)
    names = ["ts", "flag", "level", "price", "cat", "key"]
    cols = sorted(rng.choice(names, size=int(rng.integers(1, 5)), replace=False).tolist())
    pred = _SWEEP_PREDS[int(rng.integers(0, len(_SWEEP_PREDS)))]
    compact = bool(rng.integers(0, 2))
    split = int(rng.integers(0, 4)) or None
    tp, jp = (P.ScanPlan("mixed", cols, None if pred is None else P.Cmp(*pred), compact=compact)
              for P in (tplan, jplan))
    _check(mixed, tp, jp, split_at=split)


def test_one_copy_and_one_launch_per_bucket(mixed):
    """The batched all-encodings scan: one host-to-device copy per bucket
    (PLAIN's stacked put included), so copies == launches; the sequential
    scan copies a dictionary, bases or run ends beside each page."""
    eng = tengine.DatapathEngine(device="cpu")
    plan = _mixed_plans(tplan)[0]
    counts = {}
    for batched in (False, True):
        ops.reset_transfer_count()
        ops.reset_dispatch_count()
        res = eng.scan(TReader(mixed), plan, batched=batched)
        counts[batched] = (ops.transfer_count(), ops.dispatch_count(), res.stats.kernel_launches)
    copies, dispatches, launches = counts[True]
    assert copies == dispatches == launches == 6  # delta, rle int, rle f32, plain, dict, bitpack
    assert counts[False][2] == 4 * 6 and counts[False][0] > counts[False][2]


def _lineitem_plans(P):
    return [
        P.ScanPlan("lineitem", ["l_extendedprice", "l_discount", "l_tax", "l_quantity"]),
        P.ScanPlan("lineitem", ["l_extendedprice"], P.Cmp("l_quantity", "le", 10)),
        # fused over an int-DICT string column: bounds rewritten onto per-group codes
        P.ScanPlan("lineitem", ["l_extendedprice"], P.Cmp("l_returnflag", "eq", "R")),
        P.ScanPlan("lineitem", ["l_orderkey", "l_shipmode"],
                   P.Cmp("l_shipdate", "between", (300, 900)), compact=True),
    ]


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("idx", range(4))
def test_batched_identical_lineitem(tables, order, idx):
    _check(tables[order]["lineitem"], _lineitem_plans(tplan)[idx], _lineitem_plans(jplan)[idx])


def _jax_plan(plan):
    """The JAX package's ScanPlan equal to a port ScanPlan."""
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


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("query", list(tq.LINEITEM_PLANS))
def test_query_lineitem_scans_batched(tables, order, query):
    """The lineitem scan of each query, Q19's with the bloom its build scan
    makes, batched ≡ sequential ≡ the JAX engine's batched scan."""
    tblooms = jblooms = None
    if query == "q19":
        readers = {k: TReader(p) for k, p in tables[order].items()}
        bits = tq.q19_bloom(tengine.DatapathEngine(device="cpu"), readers)
        tblooms, jblooms = {"q19": bits}, {"q19": jnp.asarray(bits.numpy())}
    tp = tq.LINEITEM_PLANS[query]()
    seq, bat = _check(tables[order]["lineitem"], tp, _jax_plan(tp), tblooms, jblooms)
    if query == "q19":
        assert int(bat.count) > 0
    if bat.stats.row_groups_scanned > 1:
        assert bat.stats.kernel_launches < seq.stats.kernel_launches


def test_batch_ops_match_sequential_and_reference():
    """Each *_batch entry equals per-page sequential calls bit for bit (ragged
    pages, per-page dictionaries of different sizes, per-block fused bounds),
    counts ONE dispatch, and equals the JAX package's *_batch (backend ref)."""
    rng = np.random.default_rng(3)
    # bitpack: ragged pages
    packs = [E.bitpack_encode(rng.integers(0, 1 << 9, size=n).astype(np.uint64), 9)
             for n in (4096, 9000, 100)]
    stack = np.concatenate(packs, axis=0)
    before = ops.dispatch_count()
    out = ops.bitunpack_batch(ops.to_tensor(stack, "cpu"), 9)
    assert ops.dispatch_count() == before + 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(jops.bitunpack_batch(stack, 9,
                                                                                backend="ref")))
    s = 0
    for p in packs:
        assert torch.equal(out[s:s + p.shape[0]], ops.bitunpack(ops.to_tensor(p, "cpu"), 9))
        s += p.shape[0]

    # dict: per-page dictionaries of different sizes, int and float
    for dtype, values in ((np.float32, np.array([1.5, 2.5, 9.0, -3.0], np.float32)),
                          (np.int32, np.array([3, 17, 99, 2048, 70000], np.int64))):
        vals = [rng.choice(values[: 3 + (i % 2)], size=n).astype(dtype)
                for i, n in enumerate((5000, 4096))]
        encs = [E.dict_encode(v) for v in vals]
        ks = [int(b.pop("_k")[0]) for b in encs]
        assert ks[0] == ks[1]
        dt = np.int32 if np.dtype(dtype).kind in "iu" else dtype
        dicts = np.zeros((2, max(b["dictionary"].shape[0] for b in encs)), dt)
        sizes = np.zeros(2, np.int32)
        for i, b in enumerate(encs):
            dicts[i, : len(b["dictionary"])] = b["dictionary"].astype(dt)
            sizes[i] = len(b["dictionary"])
        page = np.concatenate([np.full(b["packed"].shape[0], i, np.int32)
                               for i, b in enumerate(encs)])
        packed = np.concatenate([b["packed"] for b in encs], axis=0)
        out = ops.dict_decode_batch(ops.to_tensor(packed, "cpu"), torch.from_numpy(dicts),
                                    torch.from_numpy(sizes), torch.from_numpy(page), ks[0])
        want = np.asarray(jops.dict_decode_batch(packed, dicts, sizes, page, ks[0],
                                                 backend="ref"))
        np.testing.assert_array_equal(out.numpy().view(np.int32), want.view(np.int32))
        s = 0
        for b in encs:
            nb = b["packed"].shape[0]
            seq = ops.dict_decode(ops.to_tensor(b["packed"], "cpu"),
                                  torch.from_numpy(b["dictionary"].astype(dt)), ks[0])
            assert torch.equal(out[s:s + nb], seq)
            s += nb

    # fused: per-block bounds, including the empty range
    packs = [E.bitpack_encode(rng.integers(0, 1 << 8, size=n).astype(np.uint64), 8)
             for n in (8192, 5000, 4096)]
    blocks = [p.shape[0] for p in packs]
    bounds = [(10, 100), (50, 60), (1, 0)]
    lo = np.concatenate([np.full(b, lh[0], np.int32) for b, lh in zip(blocks, bounds)])
    hi = np.concatenate([np.full(b, lh[1], np.int32) for b, lh in zip(blocks, bounds)])
    stack = np.concatenate(packs, axis=0)
    m = ops.fused_scan_batch(ops.to_tensor(stack, "cpu"), 8, torch.from_numpy(lo),
                             torch.from_numpy(hi))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jops.fused_scan_batch(
        stack, 8, lo, hi, backend="ref")))
    s = 0
    for p, (lo_, hi_) in zip(packs, bounds):
        want, _ = ops.fused_scan(ops.to_tensor(p, "cpu"), 8, lo_, hi_)
        assert torch.equal(m[s:s + p.shape[0]], want)
        s += p.shape[0]
    assert not m[-1].any()

    # delta and rle stacks: the sequential kernels over the whole stack
    words = rng.integers(0, 2**32, size=(3, 5, 128), dtype=np.uint64).astype(np.uint32)
    bases = np.array([2**31 - 1, -5, 7], np.int32)
    assert torch.equal(ops.delta_decode_batch(ops.to_tensor(words, "cpu"),
                                              torch.from_numpy(bases), 5),
                       ref.delta_decode(ops.to_tensor(words, "cpu"), torch.from_numpy(bases), 5))
    ends = np.sort(rng.integers(0, 1025, (4, 128)), axis=1).astype(np.int32)
    rv = rng.integers(-9, 9, (4, 128)).astype(np.int32)
    np.testing.assert_array_equal(
        ops.rle_decode_batch(torch.from_numpy(rv), torch.from_numpy(ends)).numpy(),
        np.asarray(jops.rle_decode_batch(rv, ends, backend="ref")))
