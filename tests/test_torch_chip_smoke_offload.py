"""chip_smoke.py's offload phase (phase O) rehearsed on the CPU: seed-4
TPC-H files at sf=0.05 with device="cpu" engines (synchronize, the profiler
and the card's memory counter faked).  It passes every check, and it stops
at the first mode whose answers differ from raw's.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import pytest

import chip_smoke
from repro_torch.lakeformat.reader import LakeReader
from tests.test_torch_chip_smoke import on_cpu, small_tables  # noqa: F401 (fixtures)

def test_offload_phase_rehearsal(small_tables, tmp_path, on_cpu, capsys):
    readers = {k: LakeReader(p) for k, p in small_tables.items()}
    chip_smoke.offload_configurations(readers, "unsorted", str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    for part in ("(a) unsorted average", "(a) q19 lineitem scan", "(b) unsorted",
                 "(c) sum_price_count_by_shipdate", "(d) preloaded", "(d) prefiltered",
                 "(d) scan_group_batched over 6 requests", "(e) preloaded q1, store of 1/3",
                 "(e) preloaded q1, store of 1/16", "(f) unsorted: CostModel.calibrate('cpu', n=16384)",
                 "(f) unsorted: estimate_row_groups"):
        assert part in out, part
    assert (tmp_path / "calibration.json").exists()


def test_offload_phase_stops_when_a_mode_differs_from_raw(small_tables, tmp_path, on_cpu,
                                                          monkeypatch, capsys):
    """A preloaded engine whose lineitem scans come back one off: the phase
    raises at (a)'s agreement check and runs nothing after it."""
    class OffByOne(chip_smoke.DatapathEngine):
        def scan(self, reader, plan, *a, **kw):
            res = super().scan(reader, plan, *a, **kw)
            if self.offload != "preloaded" or plan.table != "lineitem" or plan.aggregates:
                return res
            return dataclasses.replace(res, columns={k: v + 1 for k, v in res.columns.items()})

    monkeypatch.setattr(chip_smoke, "DatapathEngine", OffByOne)
    readers = {k: LakeReader(p) for k, p in small_tables.items()}
    with pytest.raises(AssertionError):
        chip_smoke.offload_configurations(readers, "unsorted", str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "(a) q1:" not in out and "(b)" not in out and "(f)" not in out
