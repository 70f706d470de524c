"""Property-based DecodePool budget-accounting invariants, on the port.

The reference's tests/test_decode_pool_props.py driving
`repro_torch.datapath.DecodePool` with tensors (billed at `numel() *
element_size()`, the bytes the reference bills for the same arrays).
DecodePool is a never-expiring window view over a private BlockStore
pinning every entry, so this suite doubles as a property test of the
store's pinned-put ledger through the old pool contract: the byte
bookkeeping must be exact — `used_bytes` is always the summed nbytes of
the kept entries, re-inserting an existing key bills only the size
delta, and a rejected (over-budget) put changes nothing.  Exercised over
random put sequences with a small key domain so re-insertions are
common.  (The store's own tier/pin/eviction properties live in
tests/test_torch_blockstore.py.)  A last case puts views of a larger
tensor: the pool keeps copies of their own, billed at their own bytes.

Module skips without `hypothesis` (same policy as tests/test_encodings.py).
"""

import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.datapath import DecodePool  # noqa: E402


def _pool_ops():
    """(key, size-in-int32-words) put sequences over a small key domain so
    re-insertions of existing keys are common."""
    return st.lists(
        st.tuples(st.integers(0, 4), st.integers(0, 64)), min_size=1, max_size=40
    )


@settings(deadline=None, max_examples=200)
@given(ops=_pool_ops(), budget=st.integers(1, 512))
def test_used_bytes_matches_kept_entries(ops, budget):
    """used_bytes always equals the summed nbytes of the entries actually
    kept, and never exceeds the budget."""
    pool = DecodePool(max_bytes=budget)
    for key, nwords in ops:
        pool[key] = torch.zeros(nwords, dtype=torch.int32)
        assert pool.used_bytes == sum(int(v.nbytes) for v in pool.values())
        assert pool.used_bytes <= budget
        assert pool.puts == len(pool)  # one billed put per kept key


@settings(deadline=None, max_examples=200)
@given(ops=_pool_ops(), budget=st.integers(1, 512))
def test_reinsert_never_double_bills(ops, budget):
    """Re-inserting an existing key bills only the size delta: same-size
    replacement leaves used_bytes unchanged, never counts a second put."""
    pool = DecodePool(max_bytes=budget)
    for key, nwords in ops:
        pool[key] = torch.zeros(nwords, dtype=torch.int32)
    for key in list(pool):
        before_used, before_puts = pool.used_bytes, pool.puts
        pool[key] = pool[key].clone()  # same-size re-insert
        assert pool.used_bytes == before_used
        assert pool.puts == before_puts
        assert pool.used_bytes == sum(int(v.nbytes) for v in pool.values())


@settings(deadline=None, max_examples=200)
@given(ops=_pool_ops(), budget=st.integers(1, 256))
def test_rejected_puts_never_decrease_used_bytes(ops, budget):
    """A rejected put is a no-op on the accounting: used_bytes unchanged,
    rejected_puts monotone, and the over-budget value is NOT kept."""
    pool = DecodePool(max_bytes=budget)
    for key, nwords in ops:
        before_used, before_rej = pool.used_bytes, pool.rejected_puts
        pool[key] = torch.zeros(nwords, dtype=torch.int32)
        assert pool.rejected_puts >= before_rej
        if pool.rejected_puts > before_rej:  # this put was refused
            assert pool.used_bytes == before_used
        assert pool.used_bytes == sum(int(v.nbytes) for v in pool.values())


@settings(deadline=None, max_examples=100)
@given(ops=_pool_ops(), budget=st.integers(1, 512))
def test_resized_reinsert_respects_budget(ops, budget):
    """A different-size re-insert either fits (delta billed) or is rejected
    with the OLD value still present — the pool never holds an unbilled or
    over-budget entry."""
    pool = DecodePool(max_bytes=budget)
    for key, nwords in ops:
        existing = key in pool
        old = int(pool[key].nbytes) if existing else None
        before_used = pool.used_bytes
        pool[key] = torch.zeros(nwords, dtype=torch.int32)
        if existing:
            assert key in pool  # rejection keeps the old entry
            new = int(pool[key].nbytes)
            assert pool.used_bytes == before_used - old + new or (
                new == old and pool.used_bytes == before_used
            )
        assert pool.used_bytes == sum(int(v.nbytes) for v in pool.values())
        assert pool.used_bytes <= budget


@settings(deadline=None, max_examples=100)
@given(ops=_pool_ops(), budget=st.integers(1, 512))
def test_views_of_a_larger_tensor_are_kept_as_copies(ops, budget):
    """A decoded column that views a larger buffer (a batched decode's
    slice of its bucket) is kept as a copy of its own: the pool's entries
    never hold a bigger buffer alive, and each is billed at its own bytes."""
    pool = DecodePool(max_bytes=budget)
    bucket = torch.arange(64 * 5, dtype=torch.int32)
    for key, nwords in ops:
        view = bucket[key * 64:key * 64 + nwords]
        rejected = pool.rejected_puts
        pool[key] = view
        if pool.rejected_puts == rejected:  # kept (a refused put keeps the old entry)
            kept = pool[key]
            assert kept.untyped_storage().nbytes() == kept.nbytes
            assert torch.equal(kept, view)
        assert pool.used_bytes == sum(int(v.nbytes) for v in pool.values())
        assert pool.used_bytes <= budget
