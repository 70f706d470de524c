"""chip_smoke.py's service phase (phase S) rehearsed on the CPU, on the
seed-4 sf=0.05 files: it passes every check, and it stops at the first pod
whose results differ from the direct scans'.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import pytest

import chip_smoke
from repro_torch.lakeformat.reader import LakeReader
from tests.test_torch_chip_smoke import on_cpu, small_tables  # noqa: F401 (fixtures)

def _phase_s_inputs(small_tables):
    readers = {k: LakeReader(p) for k, p in small_tables.items()}
    eng = chip_smoke.DatapathEngine(device="cpu")
    direct = {name: q(eng, readers) for name, q in chip_smoke.Q.QUERIES.items()}
    per_supp = chip_smoke.agreement.per_supplier_revenue(readers["lineitem"])
    calibrated = chip_smoke.CostModel(source="calibrated", backend="cpu",
                                      launch_overhead_s=30e-6)
    return readers, direct, {name: 1.0 for name in direct}, per_supp, (80.0, 15.0, 5.0), calibrated


def test_service_phase_rehearsal(small_tables, on_cpu, capsys):
    readers, *rest = _phase_s_inputs(small_tables)
    launches = chip_smoke.service_phase(readers, "unsorted", *rest, device="cpu")
    out = capsys.readouterr().out
    for part in ("(a) unsorted: the six queries through DatapathService agree",
                 "(b) unsorted batch_decode=True: six tenants in one tick",
                 "(b) unsorted batch_decode=False", "(b) unsorted: phase 7(b)'s 3 pushdown plans",
                 "(c) unsorted fifo", "(c) unsorted wfq", "(d) unsorted recoverable faults",
                 "(d) unsorted fail_forever on part.lake", "(e) unsorted: traced bit-identical",
                 "(f) unsorted: priced with phase O's calibrated table"):
        assert part in out, part
    assert "'backend': 'cpu', 'source': 'calibrated'" in out
    # the CPU runs the plain versions: no kernel launch is counted
    assert set(launches) == set(chip_smoke.ops.KERNELS) and not any(launches.values())


def test_service_phase_stops_when_a_pod_result_differs(small_tables, on_cpu, monkeypatch,
                                                       capsys):
    """A pod whose six-tenant results come back one off: the phase raises at
    (b)'s first check and runs nothing after it."""
    class OffByOne(chip_smoke.DatapathService):
        """Row results of pods pinned to raw (phase S's (b)-(f)) come back
        one off; (a)'s adaptive service is left alone."""

        def tick(self):
            n = super().tick()
            if isinstance(self.policy, chip_smoke.StaticPolicy):
                for t in self._tickets:
                    if t.result is not None and t.result.aggregates is None:
                        t.result = dataclasses.replace(
                            t.result, columns={k: v + 1 for k, v in t.result.columns.items()})
            return n

        def submit(self, *a, **kw):
            t = super().submit(*a, **kw)
            self.__dict__.setdefault("_tickets", []).append(t)
            return t

    monkeypatch.setattr(chip_smoke, "DatapathService", OffByOne)
    readers, *rest = _phase_s_inputs(small_tables)
    with pytest.raises(AssertionError, match=r"\(b\)"):
        chip_smoke.service_phase(readers, "unsorted", *rest, device="cpu")
    out = capsys.readouterr().out
    assert "(a) unsorted" in out and "(b)" not in out and "(c)" not in out and "(f)" not in out
