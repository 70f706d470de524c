"""chip_smoke.py's profiler lines (phases 7 and 8) can name every port kernel,
and its offload phase (phase O) runs on the CPU at a small scale.

The script imports without a card: it runs nothing at import but reading the
kernel sources.  A kernel whose name the profiler lines cannot find is
skipped silently there, so these tests hold the name scan to a plain count.
Phase O is rehearsed on seed-4 TPC-H files at sf=0.05 with device="cpu"
engines (synchronize, the profiler and the card's memory counter faked): it
passes every check, and it stops at the first mode whose answers differ from
raw's.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import torch

import chip_smoke
from repro_torch.core import tpch
from repro_torch.lakeformat.reader import LakeReader

CSRC = Path(chip_smoke.ROOT) / "src" / "repro_torch" / "kernels" / "csrc"


def test_port_kernel_functions_finds_every_global_function():
    count = sum(p.read_text().count("__global__") for p in CSRC.glob("*.cu"))
    names = chip_smoke.port_kernel_functions()
    assert count > 0 and len(names) == count, names
    # both carry __launch_bounds__(kThreads, min_ctas(K, kArm)), whose inner
    # parentheses once hid fused_scan_kernel from the name scan;
    # fused_agg_kernel's hold two levels (fused_min_ctas(K, sizeof(MaskT)))
    assert {"dict_decode_batch_kernel", "fused_scan_kernel", "dict_decode_kernel",
            "fused_agg_kernel", "filter_compact_kernel"} <= set(names)


def test_port_kernel_functions_skips_nested_launch_bounds(tmp_path, monkeypatch):
    csrc = tmp_path / "src" / "repro_torch" / "kernels" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text(
        "__global__ void __launch_bounds__(f(g(1), h(2, (3))), 4) deep_kernel(int a) {}\n"
        "__global__ void plain_kernel(int a) {}\n"
        "__global__ void __launch_bounds__(128)\n    bounded_kernel (int a) {}\n")
    monkeypatch.setattr(chip_smoke, "ROOT", str(tmp_path))
    assert chip_smoke.port_kernel_functions() == ("bounded_kernel", "deep_kernel", "plain_kernel")


def test_bounds_count_the_same_work_as_before_the_redesigns():
    """The yardsticks of fused_agg and filter_compact count the same work
    whatever the kernels' design: the bounds at the stack (k = 6, bool mask;
    5,888 blocks) are 3.24 and 16.21 us."""
    assert chip_smoke.ops_per_value("fused_agg", 6) == 9
    assert chip_smoke.COMPACT_OPS_PER_VALUE == 8
    nb = chip_smoke.STACK_BLOCKS
    agg_bytes = nb * (6 * 128 * 4 + 4096 + 20) / chip_smoke.HBM_BYTES_PER_S
    agg_ops = nb * 4096 * 9 / chip_smoke.INT32_OPS_PER_S
    assert round(max(agg_bytes, agg_ops) * 1e6, 2) == 3.24 and agg_ops > agg_bytes
    nb = chip_smoke.RLE_STACK_BLOCKS
    compact_bytes = nb * (4096 + 1024 + 4096 + 4) / chip_smoke.HBM_BYTES_PER_S
    compact_ops = nb * 1024 * 8 / chip_smoke.INT32_OPS_PER_S
    assert round(compact_bytes * 1e6, 2) == 16.21 and compact_bytes > compact_ops


@pytest.mark.parametrize("key,want", [
    ("void (anonymous namespace)::dict_decode_batch_kernel<4, 2>((anonymous namespace)::Args)",
     ("dict_decode_batch_kernel", "<4, 2>")),
    ("void (anonymous namespace)::dict_decode_kernel<14>((anonymous namespace)::Args)",
     ("dict_decode_kernel", "<14>")),
    ("void (anonymous namespace)::fused_scan_kernel<12, 0>((anonymous namespace)::Args)",
     ("fused_scan_kernel", "<12, 0>")),
    ("void (anonymous namespace)::filter_compact_kernel(unsigned int const*, unsigned char "
     "const*, unsigned int*, int*)", ("filter_compact_kernel", "")),
    ("void (anonymous namespace)::filter_compact_kernel(unsigned int const*, unsigned char "
     "const*, unsigned int*, int*, int)", ("filter_compact_kernel", "")),
    ("void (anonymous namespace)::fused_agg_kernel<6, unsigned char>((anonymous "
     "namespace)::FusedArgs<unsigned char>)", ("fused_agg_kernel", "<6, unsigned char>")),
    ("void (anonymous namespace)::fused_agg_kernel<32, int>((anonymous "
     "namespace)::FusedArgs<int>)", ("fused_agg_kernel", "<32, int>")),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_port_kernel_of_names_the_kernel_and_its_instantiation(key, want):
    assert chip_smoke.port_kernel_of(key) == want


# ---------------------------------------------------------------------------
# phase O, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("chip_smoke_offload")
    return tpch.write_tables(str(d), sf=0.05, seed=4, row_group_size=8192)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "profiled", lambda fn: (fn(), (0.0, [], {}))[1])
    monkeypatch.setattr(chip_smoke, "CALIBRATION_N", (1 << 12, 1 << 14))


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
