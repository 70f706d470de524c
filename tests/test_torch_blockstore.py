"""The port's unified tiered BlockStore (`repro_torch.datapath.blockstore`):
the reference's service-free store tests driving the port — ledger, pinning
and eviction units, the hypothesis sweeps (ledger/capacity/pin invariants,
heap victim ≡ linear oracle, cost-ranked eviction waves), and the
engine-level encoded-page tier — with tensors as the values, billed at
`numel() * element_size()`.  Also the port's ownership rule: what the store
keeps never views a larger buffer, and an evicted tensor is released."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import gc
import weakref

import pytest
import torch

from repro.core import tpch
from repro_torch.core import BlockCache, DatapathEngine, ScanPlan
from repro_torch.datapath import BlockStore, CostModel
from repro_torch.lakeformat.reader import LakeReader

RG_ROWS = 8192


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_store")
    return tpch.write_tables(str(d), sf=0.05, seed=0, sorted_data=True,
                             row_group_size=RG_ROWS)


@pytest.fixture(scope="module")
def lineitem(tables):
    return LakeReader(tables["lineitem"])


def _assert_identical(got, want):
    assert int(got.count) == int(want.count)
    assert torch.equal(got.mask, want.mask)
    assert set(got.columns) == set(want.columns)
    for name in want.columns:
        assert torch.equal(got.columns[name], want.columns[name]), name


def _arr(nbytes: int) -> torch.Tensor:
    return torch.zeros(nbytes, dtype=torch.uint8)


# ---------------------------------------------------------------------------
# ledger + eviction units
# ---------------------------------------------------------------------------

def test_ledger_tracks_entries_and_rejects_oversized():
    st = BlockStore(capacity_bytes=1000)
    assert st.put("a", _arr(400))
    assert st.put("b", _arr(400))
    assert st.used == 800
    assert not st.put("huge", _arr(2000))  # bigger than the device
    assert st.used == 800
    assert st.put("a", _arr(100))  # resize bills only the delta
    assert st.used == 500


def test_eviction_prefers_cheapest_redecode_per_byte():
    """Victim selection is cost-aware, not LRU: the PLAIN column (cheapest
    re-decode seconds per byte) is evicted before DELTA/DICT even though it
    is the most recently used entry."""
    st = BlockStore(capacity_bytes=300)
    assert st.put("delta", _arr(100), encoding="delta")
    assert st.put("dict", _arr(100), encoding="dict")
    assert st.put("plain", _arr(100), encoding="plain")
    st.get("plain")  # freshen its LRU position
    assert st.put("delta2", _arr(100), encoding="delta")
    assert "plain" not in st and "delta" in st and "dict" in st
    assert st.put("delta3", _arr(100), encoding="delta")
    assert "dict" not in st  # next-cheapest ratio after plain
    assert st.used <= 300


def test_lru_breaks_ties_within_equal_cost():
    st = BlockStore(capacity_bytes=300)
    for k in ("a", "b", "c"):
        assert st.put(k, _arr(100), encoding="plain")
    st.get("a")  # a is now the most recent of three equal-cost entries
    assert st.put("d", _arr(100), encoding="plain")
    assert "b" not in st and "a" in st and "c" in st


def test_window_pins_survive_pressure_and_expiry_drops_ephemeral():
    st = BlockStore(capacity_bytes=300)
    view = st.window(expires_tick=2, max_bytes=None, owner="t0")
    view.put("p1", _arr(100), encoding="plain")
    view.put("p2", _arr(100), encoding="plain")
    assert st.put("cold", _arr(100), encoding="delta")
    # pinned blocks are never victims: the shortfall is pinned, so the put
    # is refused outright (the expensive DELTA entry is evictable but too
    # small to make room alone)
    assert not st.put("newcomer", _arr(250), encoding="delta")
    assert "p1" in st and "p2" in st
    assert st.used <= 300
    # promotion (a cache-path put) clears the ephemeral flag
    assert st.put("p2", st.peek("p2").value, tier="decoded", encoding="plain")
    st.advance_tick(3)  # window over: raw decodes drop, promoted stays
    assert "p1" not in st and "p2" in st
    assert not st.pinned("p2")  # evictable again, but resident


def test_refused_put_does_not_flush_the_unpinned_working_set():
    """Regression: a put whose shortfall is pinned must be refused WITHOUT
    evicting the unpinned entries first — a doomed insert used to destroy
    the working set while caching nothing."""
    st = BlockStore(capacity_bytes=300)
    view = st.window(expires_tick=5)
    view.put("pin1", _arr(100), encoding="plain")
    view.put("pin2", _arr(100), encoding="plain")
    assert st.put("dict", _arr(50), encoding="dict")
    assert not st.put("big", _arr(120), encoding="plain")  # 70 short, pinned
    assert "dict" in st  # the evictable entry survived the refusal
    assert st.used == 250


def test_promoted_pool_hit_keeps_its_encoding_price():
    """Regression: promoting a pool hit into a separate cache store used to
    drop the source encoding, re-pricing expensive decodes at the PLAIN
    floor and inverting the eviction ranking."""
    from repro_torch.datapath import DecodePool

    pool = DecodePool()
    pool.put("k", _arr(100), encoding="delta")
    cache = BlockCache(1 << 20)
    hit = pool.get("k")
    assert cache.promote("k", hit, encoding=pool.encoding_of("k"))
    assert cache.store.peek("k").encoding == "delta"
    assert cache.store.peek("k").redecode_s == pytest.approx(
        CostModel().decode_seconds(100, "delta"))


def test_tier_pricing_encoded_vs_prefiltered():
    cm = CostModel()
    st = BlockStore(capacity_bytes=1 << 20, cost_model=cm)
    st.put("page", _arr(1000), tier="encoded")
    assert st.peek("page").redecode_s == pytest.approx(
        cm.link_model().fetch_seconds(1000))
    work = {"delta": 4000, "rle": 2000}
    st.put("scan", _arr(1000), tier="prefiltered", decode_work=work)
    assert st.peek("scan").redecode_s == pytest.approx(
        sum(cm.decode_seconds(b, e) for e, b in work.items()))


def test_evicted_decode_demotes_to_its_encoded_page():
    """Regression: evicting a decoded column used to drop it to zero, so
    the next access paid re-fetch AND re-decode.  A decoded entry carrying
    a demote payload now falls back to the encoded tier (re-decode only),
    with the ledger billing the smaller encoded footprint."""
    st = BlockStore(capacity_bytes=1000)
    page = _arr(100)
    assert st.put("dec", _arr(400), encoding="dict", demote=("pg", page))
    assert st.put("filler", _arr(500), encoding="delta")
    assert "pg" not in st
    # pressure: DICT is the cheapest redecode/byte -> "dec" is the victim
    assert st.put("new", _arr(400), encoding="delta")
    assert "dec" not in st
    e = st.peek("pg")
    assert e is not None and e.tier == "encoded" and e.nbytes == 100
    assert e.value is page
    assert e.redecode_s == pytest.approx(
        st.cost_model.link_model().fetch_seconds(100))
    assert st.used == 1000  # 500 + 400 + the demoted 100, all billed
    assert st.stats()["tiers"]["decoded"]["demotions"] == 1
    # the source pages being resident already means nothing to preserve:
    # evicting a later decode with the same payload demotes nothing
    assert st.put("dec2", _arr(300), encoding="dict", demote=("pg", page))
    assert st.put("new2", _arr(200), encoding="delta")
    assert "dec2" not in st and st.peek("pg").nbytes == 100
    assert st.stats()["tiers"]["decoded"]["demotions"] == 1


def test_demotion_never_starves_the_triggering_put():
    """The demoted entry re-occupies bytes, but it is itself unpinned, so
    the eviction loop's coverage is preserved: the put that triggered the
    pressure still lands (the demoted fallback is sacrificed if needed)."""
    st = BlockStore(capacity_bytes=1000)
    assert st.put("dec", _arr(900), encoding="dict", demote=("pg", _arr(800)))
    assert st.put("new", _arr(900), encoding="delta")
    assert "new" in st and st.used <= 1000


def test_retention_charges_split_across_observed_beneficiaries():
    """Regression: the tenant that happened to decode first used to be
    billed the WHOLE window-retention price while free-riding coalescing
    partners paid nothing.  Charges now split equally across the observed
    beneficiaries, conserving the total."""
    st = BlockStore(capacity_bytes=1 << 20)
    view_a = st.window(expires_tick=4, owner="a")
    view_a.put("k", _arr(1000), encoding="delta")
    st.advance_tick(1)
    full = st.retention_charges()
    assert set(full) == {"a"}  # nobody else observed yet: 'a' pays all
    nb_full, price_full = full["a"]
    assert nb_full == 1000 and price_full > 0.0
    # partner 'b' reuses the decode through its own window view
    view_b = st.window(expires_tick=4, owner="b")
    assert view_b.get("k") is not None
    split = st.retention_charges()
    assert set(split) == {"a", "b"}
    assert split["a"][1] == pytest.approx(price_full / 2)
    assert split["b"][1] == pytest.approx(price_full / 2)
    assert split["a"][0] == split["b"][0] == 500
    assert split["a"][1] + split["b"][1] == pytest.approx(price_full)


# ---------------------------------------------------------------------------
# hypothesis property sweep
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st_

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    OPS = st_.lists(
        st_.tuples(
            st_.integers(0, 7),  # key
            st_.integers(0, 96),  # nbytes
            st_.sampled_from(["plain", "bitpack", "dict", "delta", "rle"]),
            st_.booleans(),  # window-pin this put?
            st_.booleans(),  # advance the tick after this op?
        ),
        min_size=1, max_size=60,
    )

    @settings(deadline=None, max_examples=150)
    @given(ops=OPS, capacity=st_.integers(1, 400), hold=st_.integers(0, 3))
    def test_ledger_capacity_and_pin_invariants(ops, capacity, hold):
        """After every operation: used == Σ nbytes of the kept entries,
        used never exceeds capacity, and an accepted window pin is never
        evicted before its window expires."""
        store = BlockStore(capacity_bytes=capacity)
        pins = {}  # key -> expiry tick of the latest accepted pin
        for key, nb, enc, pin, bump in ops:
            if pin:
                view = store.window(expires_tick=store.tick + hold)
                kept = view.put(key, _arr(nb), encoding=enc)
            else:
                kept = store.put(key, _arr(nb), encoding=enc)
            if kept and pin:
                pins[key] = max(pins.get(key, -1), store.tick + hold)
            assert store.used == sum(e.nbytes for e in store._entries.values())
            assert store.used <= capacity
            for k, exp in pins.items():
                if exp >= store.tick:
                    assert k in store, (k, exp, store.tick)
            if bump:
                store.advance_tick(store.tick + 1)
                assert store.used == sum(e.nbytes for e in store._entries.values())

    VICTIM_OPS = st_.lists(
        st_.tuples(
            st_.integers(0, 3),  # 0=put 1=get 2=pinned put 3=tick advance
            st_.integers(0, 9),  # key
            st_.integers(1, 64),  # nbytes (>= 1 so one eviction frees bytes)
            st_.sampled_from(["plain", "bitpack", "dict", "delta", "rle"]),
        ),
        min_size=1, max_size=80,
    )

    @settings(deadline=None, max_examples=150)
    @given(ops=VICTIM_OPS)
    def test_heap_victim_matches_linear_selection(ops):
        """The lazy-invalidation eviction heap must pick exactly the victim
        the old O(n) linear scan picked — lowest re-creation seconds per
        byte, LRU tie-break, pins skipped — across op sequences that churn
        the heap with stale records: re-puts (re-price + resize), gets
        (re-rank), window pins, and tick advances (pin expiry + ephemeral
        drops).  Drains the store victim by victim at the end, checking
        every single selection against the oracle."""
        store = BlockStore(capacity_bytes=1 << 20)
        for op, key, nb, enc in ops:
            if op == 0:
                store.put(key, _arr(nb), encoding=enc)
            elif op == 1:
                store.get(key)
            elif op == 2:
                store.window(expires_tick=store.tick + 2).put(
                    key, _arr(nb), encoding=enc)
            else:
                store.advance_tick(store.tick + 1)
        while True:
            oracle = store._victims_linear()
            if not oracle:
                # nothing evictable (empty, or every survivor is pinned):
                # the heap must agree — an evict attempt changes nothing
                before = dict(store._entries)
                store._evict(1)
                assert dict(store._entries) == before
                break
            want = oracle[0].key
            used0 = store.used
            store._evict(1)  # evicts exactly the top-ranked victim
            assert want not in store._entries
            assert store.used == used0 - oracle[0].nbytes
            for e in oracle[1:]:  # nothing beyond the chosen victim went
                assert e.key in store._entries

    @settings(deadline=None, max_examples=100)
    @given(
        entries=st_.lists(
            st_.tuples(st_.integers(1, 64),
                       st_.sampled_from(["plain", "bitpack", "dict", "delta", "rle"])),
            min_size=2, max_size=10,
        ),
        overflow=st_.integers(1, 128),
    )
    def test_eviction_follows_cost_ranking(entries, overflow):
        """Force an eviction wave and check the evicted set is exactly the
        cheapest-ranked prefix (re-decode seconds per byte, LRU tie-break)
        of the resident entries."""
        capacity = sum(nb for nb, _ in entries)
        store = BlockStore(capacity_bytes=capacity)
        for i, (nb, enc) in enumerate(entries):
            assert store.put(i, _arr(nb), encoding=enc)
        ranked = sorted(store._entries.values(), key=lambda e: e.rank())
        trigger = min(overflow, capacity)
        expected_evicted, freed = [], 0
        for e in ranked:
            if store.used + trigger - freed <= capacity:
                break
            expected_evicted.append(e.key)
            freed += e.nbytes
        assert store.put("trigger", _arr(trigger), encoding="plain")
        for key in expected_evicted:
            assert key not in store
        for i in range(len(entries)):
            if i not in expected_evicted:
                assert i in store
        assert store.used <= capacity


# ---------------------------------------------------------------------------
# encoded-page tier (engine level)
# ---------------------------------------------------------------------------

def test_page_tier_skips_refetch_when_decoded_tier_evicts(lineitem):
    """Under capacity pressure the cost ranking keeps encoded pages (link
    latency makes them expensive per byte to re-fetch) while PLAIN decoded
    columns churn — so a repeat scan re-decodes but never re-fetches."""
    plan = ScanPlan("lineitem", ["l_extendedprice"])
    enc_total = sum(
        lineitem.row_group_meta(rg)["columns"]["l_extendedprice"]["encoded_bytes"]
        for rg in range(lineitem.n_row_groups)
    )
    cap = enc_total + int(1.5 * RG_ROWS * 4)  # all pages + ~1.5 decoded groups
    eng = DatapathEngine(device="cpu", cache=BlockCache(cap))
    r1 = eng.scan(lineitem, plan, offload="preloaded")
    assert r1.stats.encoded_bytes > 0
    r2 = eng.scan(lineitem, plan, offload="preloaded")
    assert r2.stats.encoded_bytes == 0  # every page served from the store
    assert r2.stats.page_hits > 0
    assert r2.stats.decoded_bytes_fresh > 0  # decoded tier really churned
    assert eng.cache.stats()["tiers"]["decoded"]["evictions"] > 0
    _assert_identical(r2, DatapathEngine(device="cpu").scan(lineitem, plan))
    assert eng.cache.used <= cap




# ---------------------------------------------------------------------------
# the port's ownership rule: views copied, evictions release
# ---------------------------------------------------------------------------

def test_a_view_of_a_larger_buffer_is_kept_as_a_copy():
    """A slice of a bucket would keep the whole bucket alive and bill only
    its own bytes: the store keeps a copy of its own instead.  A tensor
    that owns its buffer is kept as it is."""
    st = BlockStore(capacity_bytes=1 << 20)
    bucket = torch.arange(1000, dtype=torch.int32)
    assert st.put("slice", bucket[100:200], encoding="bitpack")
    kept = st.peek("slice").value
    assert kept.untyped_storage().nbytes() == kept.nbytes == 400 == st.used
    assert torch.equal(kept, bucket[100:200])
    own = torch.ones(50, dtype=torch.float32)
    assert st.put("own", own)
    assert st.peek("own").value is own


def test_a_prefiltered_result_is_kept_without_views():
    """Whole results go through the same rule field by field: the compacted
    columns (views of an L + 1 buffer) are copied, the rest kept as is."""
    from repro_torch.core.engine import ScanResult, ScanStats

    buf = torch.arange(9, dtype=torch.int32)
    res = ScanResult({"c": buf[:8]}, torch.ones(8, dtype=torch.bool),
                     torch.tensor(8, dtype=torch.int32), ScanStats(rows_out=8))
    st = BlockStore(capacity_bytes=1 << 20)
    assert st.put("scan", res, tier="prefiltered")
    kept = st.peek("scan").value
    assert kept is not res and kept.mask is res.mask and kept.stats is res.stats
    assert kept.columns["c"].untyped_storage().nbytes() == 32
    assert torch.equal(kept.columns["c"], res.columns["c"])


def test_eviction_releases_the_tensor():
    """Nothing but the store holds what it keeps: once evicted (or cleared)
    the tensor is freed."""
    st = BlockStore(capacity_bytes=1000)
    t = _arr(600)
    ref = weakref.ref(t)
    assert st.put("a", t, encoding="plain")
    del t
    assert ref() is not None
    assert st.put("b", _arr(600), encoding="delta")  # evicts "a"
    assert "a" not in st
    gc.collect()
    assert ref() is None
    ref_b = weakref.ref(st.peek("b").value)
    st.clear()
    gc.collect()
    assert ref_b() is None and st.used == 0


def test_batched_preloaded_scan_keeps_no_bucket_alive(lineitem):
    """A batched scan's decodes are slices of their buckets; under
    `preloaded` every decoded entry the store keeps owns exactly its bytes,
    and the ledger equals the summed bytes of what it holds."""
    plan = ScanPlan("lineitem", ["l_extendedprice", "l_quantity", "l_shipdate"])
    eng = DatapathEngine(device="cpu", offload="preloaded", cache=BlockCache(1 << 30))
    eng.scan(lineitem, plan, batched=True)
    store = eng.cache.store
    decoded = [e for e in store._entries.values() if e.tier == "decoded"]
    assert len(decoded) == 3 * lineitem.n_row_groups
    for e in decoded:
        assert e.value.untyped_storage().nbytes() == e.value.nbytes == e.nbytes
    assert store.used == sum(e.nbytes for e in store._entries.values())
    _assert_identical(eng.scan(lineitem, plan, batched=True),
                      DatapathEngine(device="cpu").scan(lineitem, plan))
