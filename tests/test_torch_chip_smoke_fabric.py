"""chip_smoke.py's fabric phase (phase F) rehearsed on the CPU, on seed-4
files of 2,048-row row groups in both orders, with every kernel wrapper
swapped for its plain version counted as a launch (so the merge's
filter_compact count is checked as on the card): it passes every check,
and it stops at the first fleet whose result differs from the direct
scan's.
"""

from __future__ import annotations

import dataclasses

import pytest

import chip_smoke
from repro_torch.core import tpch
from repro_torch.lakeformat.reader import LakeReader
from tests.test_torch_chip_smoke import on_cpu, plain_launches  # noqa: F401 (fixtures)

@pytest.fixture(scope="module")
def fleet_tables(tmp_path_factory):
    """Both file orders, in row groups small enough that 4 pods share them."""
    return {order: tpch.write_tables(str(tmp_path_factory.mktemp(f"chip_smoke_fleet_{order}")),
                                     sf=0.05, seed=4, row_group_size=2048,
                                     sorted_data=order == "sorted")
            for order in ("unsorted", "sorted")}


def _fleet_readers(fleet_tables):
    return [{k: LakeReader(p) for k, p in fleet_tables[o].items()} for o in ("unsorted", "sorted")]


@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_fabric_phase_rehearsal(fleet_tables, on_cpu, plain_launches, capsys, order):
    unsorted, sorted_ = _fleet_readers(fleet_tables)
    readers, other = (unsorted, sorted_) if order == "unsorted" else (sorted_, unsorted)
    launches = chip_smoke.fabric_phase(readers, order, other, device="cpu")
    out = capsys.readouterr().out
    for part in (f"(a) {order} 1 pods", f"(a) {order} 2 pods", f"(a) {order} 4 pods",
                 f"(b) {order} silent=False", f"(b) {order} silent=True: ",
                 f"(c) {order}: pod2 joined", f"(d) {order} relevel=True",
                 f"(d) {order} relevel=False", f"(e) {order}: fail_forever",
                 f"(f) {order}: lineitem re-registered"):
        assert part in out, part
    assert "drained by its heartbeat" in out and "makespan_s=" in out
    assert set(launches) == set(chip_smoke.ops.KERNELS)
    # the merge's compaction: once for the compact plan alone and once in the
    # drain, at each of the three fleet sizes
    assert launches["filter_compact"] >= 6
    assert launches["dict_decode_batch"] > 0 and launches["fused_agg"] + launches["grouped_agg"] > 0


def test_fabric_phase_stops_when_a_fleet_result_differs(fleet_tables, on_cpu, plain_launches,
                                                        monkeypatch, capsys):
    """A fleet whose merged row results come back one off: the phase raises
    at (a)'s first check and runs nothing after it."""
    class OffByOne(chip_smoke.ScanFabric):
        def _try_merge(self, t):
            done = super()._try_merge(t)
            if done and t.result is not None and t.result.aggregates is None:
                t.result = dataclasses.replace(
                    t.result, columns={k: v + 1 for k, v in t.result.columns.items()})
            return done

    monkeypatch.setattr(chip_smoke, "ScanFabric", OffByOne)
    readers, other = _fleet_readers(fleet_tables)
    with pytest.raises(AssertionError, match=r"\(a\) 1 pods q1"):
        chip_smoke.fabric_phase(readers, "unsorted", other, device="cpu")
    out = capsys.readouterr().out
    assert "(a)" not in out and "(b)" not in out and "(f)" not in out
