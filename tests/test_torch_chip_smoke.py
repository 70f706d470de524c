"""chip_smoke.py's profiler lines (phases 7 and 8) can name every port kernel,
its bounds count the same work as before the redesigns, and its kernels line
(phase 10) sums every launch window; the fixtures that the phase rehearsals
share.

The script imports without a card: it runs nothing at import but reading the
kernel sources.  A kernel whose name the profiler lines cannot find is
skipped silently there, so these tests hold the name scan to a plain count.
Each later phase is rehearsed on the CPU in a file of its own
(`test_torch_chip_smoke_<phase>.py`), so that parallel test workers share
them out: `on_cpu` fakes the card's synchronize, memory counter and
profiler; `plain_launches` swaps every CUDA wrapper for its plain version
counted as a launch; `small_tables` writes seed-4 TPC-H files at sf=0.05.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
from pathlib import Path

import pytest
import torch

import chip_smoke
from repro_torch.core import tpch

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


def test_rle_bound_counts_the_redesigned_kernel():
    """rle_decode's bound stays the bytes' at the stack (9.00 us) and the
    walk sizes; its integer slots are 5.59 a value by the rank table at the
    stack (a tile a block on 132 SMs) and 23.5 by search at the 64-block
    path (8 tiles a block)."""
    nb = chip_smoke.RLE_STACK_BLOCKS
    assert chip_smoke.rle_ops(nb, 132) == nb * 1024 * 5.59375
    assert chip_smoke.rle_ops(64, 132) == 64 * 1024 * 23.5
    for nb in (chip_smoke.RLE_STACK_BLOCKS, *chip_smoke.WALK_BLOCKS):
        rle_bytes = nb * (512 + 512 + 4096) / chip_smoke.HBM_BYTES_PER_S
        assert rle_bytes > 4 * chip_smoke.rle_ops(nb, 132) / chip_smoke.INT32_OPS_PER_S
    assert round(chip_smoke.RLE_STACK_BLOCKS * 5120 / chip_smoke.HBM_BYTES_PER_S * 1e6, 2) == 9.0


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
# fixtures of the phase rehearsals
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


@pytest.fixture
def plain_launches(monkeypatch):
    """Every CUDA wrapper swapped for its plain version, which adds one to
    its kernel's launches as the wrapper does; ops routes every tensor to
    the wrappers."""
    from repro_torch.kernels import (agg_push, bitunpack, bloom_probe, delta_decode, dict_decode,
                                     filter_compact, fused_scan, ops, ref, rle_decode)

    for mod, name, plain, kernel in (
            (bitunpack, "bitunpack", ref.bitunpack, bitunpack.KERNEL),
            (dict_decode, "dict_decode", ref.dict_decode, dict_decode.KERNEL),
            (dict_decode, "dict_decode_batch", ref.dict_decode_batch, dict_decode.BATCH),
            (delta_decode, "delta_decode", ref.delta_decode, delta_decode.KERNEL),
            (rle_decode, "rle_decode", ref.rle_decode, rle_decode.KERNEL),
            (filter_compact, "filter_compact", ref.filter_compact, filter_compact.KERNEL),
            (bloom_probe, "bloom_probe", ref.bloom_probe, bloom_probe.KERNEL),
            (fused_scan, "fused_scan", ref.fused_scan, fused_scan.KERNEL),
            (fused_scan, "fused_scan_batch", ref.fused_scan_batch, fused_scan.BATCH),
            (agg_push, "grouped_agg", ref.grouped_agg, agg_push.GROUPED),
            (agg_push, "fused_agg", ref.fused_agg_scan, agg_push.FUSED)):
        def counted(*a, plain=plain, kernel=kernel, **kw):
            kernel.launches += 1
            return plain(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    monkeypatch.setattr(ops, "_on_card", lambda *tensors: True)


def test_kernels_line_counts_every_window():
    """Phase 10's record: launches summed over the by-order windows and
    phases 9 and T, each window kept under its own key."""
    names = list(chip_smoke.ops.KERNELS)
    case = {"blocks": 16, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes",
            "library_ms": None, "stage_ms": None}
    records = {n: {"max_abs_err": 0.0, "cases": [case, case]} for n in names}
    records["flash_attention"].update(launches_by_route={"wgmma": 1, "tf32x3": 1},
                                      cases=[dict(case, label="x", shape=[1], route="wgmma",
                                                  share=0.5, over_library=1.0)] * 2)
    zero = dict.fromkeys(names, 0)
    orders = {"unsorted": dict(zero, bitunpack=3), "sorted": dict(zero, bitunpack=2)}
    line = chip_smoke.kernels_line(records, {"launches_by_order": orders},
                                   {"launches_lm": dict(zero, bitunpack=1),
                                    "launches_train": dict(zero, bitunpack=7, rle_decode=4)})
    rec = {k["name"]: k for k in line}
    assert rec["bitunpack"]["launches"] == 13 and rec["bitunpack"]["launches_train"] == 7
    assert rec["bitunpack"]["launches_by_order"] == {"unsorted": 3, "sorted": 2}
    assert rec["rle_decode"]["launches"] == 4 and rec["rle_decode"]["launches_lm"] == 0
    assert all({"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(k) for k in line)
