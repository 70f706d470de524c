"""chip_smoke.py's profiler lines (phases 7 and 8) can name every port kernel.

The script imports without a card: it runs nothing at import but reading the
kernel sources.  A kernel whose name the profiler lines cannot find is
skipped silently there, so these tests hold the name scan to a plain count.
"""

from __future__ import annotations

from pathlib import Path

import pytest

import chip_smoke

CSRC = Path(chip_smoke.ROOT) / "src" / "repro_torch" / "kernels" / "csrc"


def test_port_kernel_functions_finds_every_global_function():
    count = sum(p.read_text().count("__global__") for p in CSRC.glob("*.cu"))
    names = chip_smoke.port_kernel_functions()
    assert count > 0 and len(names) == count, names
    # both carry __launch_bounds__(kThreads, min_ctas(K, kArm)), whose inner
    # parentheses once hid fused_scan_kernel from the name scan
    assert {"dict_decode_batch_kernel", "fused_scan_kernel", "dict_decode_kernel"} <= set(names)


@pytest.mark.parametrize("key,want", [
    ("void (anonymous namespace)::dict_decode_batch_kernel<4, 2>((anonymous namespace)::Args)",
     ("dict_decode_batch_kernel", "<4, 2>")),
    ("void (anonymous namespace)::dict_decode_kernel<14>((anonymous namespace)::Args)",
     ("dict_decode_kernel", "<14>")),
    ("void (anonymous namespace)::fused_scan_kernel<12, 0>((anonymous namespace)::Args)",
     ("fused_scan_kernel", "<12, 0>")),
    ("void (anonymous namespace)::filter_compact_kernel(unsigned int const*, unsigned char "
     "const*, unsigned int*, int*)", ("filter_compact_kernel", "")),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int>, "
     "std::array<char*, 1ul> >(int, at::native::FillFunctor<int>, std::array<char*, 1ul>)", None),
    ("Memcpy HtoD (Pageable -> Device)", None),
])
def test_port_kernel_of_names_the_kernel_and_its_instantiation(key, want):
    assert chip_smoke.port_kernel_of(key) == want
