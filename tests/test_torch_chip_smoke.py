"""chip_smoke.py's profiler lines (phases 7 and 8) can name every port kernel,
and its offload phase (phase O), service phase (phase S) and fabric phase
(phase F) run on the CPU at a small scale.

The script imports without a card: it runs nothing at import but reading the
kernel sources.  A kernel whose name the profiler lines cannot find is
skipped silently there, so these tests hold the name scan to a plain count.
Phase O is rehearsed on seed-4 TPC-H files at sf=0.05 with device="cpu"
engines (synchronize, the profiler and the card's memory counter faked): it
passes every check, and it stops at the first mode whose answers differ from
raw's.  Phase S is rehearsed on the same files: it passes every check, and it
stops at the first pod whose results differ from the direct scans'.  Phase F
is rehearsed on seed-4 files of 2,048-row row groups in both orders, with
every kernel wrapper swapped for its plain version counted as a launch (so
the merge's filter_compact count is checked as on the card): it passes every
check, and it stops at the first fleet whose result differs from the direct
scan's.
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


# ---------------------------------------------------------------------------
# phase S, rehearsed on the CPU
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# phase F, rehearsed on the CPU with plain kernels counted as launches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_tables(tmp_path_factory):
    """Both file orders, in row groups small enough that 4 pods share them."""
    return {order: tpch.write_tables(str(tmp_path_factory.mktemp(f"chip_smoke_fleet_{order}")),
                                     sf=0.05, seed=4, row_group_size=2048,
                                     sorted_data=order == "sorted")
            for order in ("unsorted", "sorted")}


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


# ---------------------------------------------------------------------------
# phase T, rehearsed on the CPU with plain kernels counted as launches
# ---------------------------------------------------------------------------

@pytest.fixture
def train_on_cpu(monkeypatch, on_cpu, plain_launches):
    """qwen3 smoke, cut to 2 layers and 2 heads, in place of the full width,
    and fewer, narrower steps (a step at S 4,096 takes ~1 s here); the
    card's memory counters faked."""
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config", lambda arch: dataclasses.replace(
        get_smoke_config(arch), n_layers=2, n_heads=2, n_kv=1))
    for name, n in (("TRAIN_BATCH", 1), ("TRAIN_STEPS", 2), ("TIMED_STEPS", 1),
                    ("MODE_STEPS", 1), ("RESUME_STEPS", 2), ("RESUME_TO", 3)):
        monkeypatch.setattr(chip_smoke, name, n)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_training_phase_rehearsal(train_on_cpu, tmp_path, capsys):
    launches = chip_smoke.training_phase(0, str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    for part in ("corpus: 1048576 tokens in 2 shards of 8 row groups", "(a) fused, B 1 x S 4096",
                 "(a) step_ms", "(b) host and engine (quality >= 30) equal token for token",
                 "(b) host: pipeline tokens/s", "(b) engine: pipeline tokens/s",
                 "(b) fused: pipeline tokens/s", "(c) fused unpacks to the host mode's tokens",
                 "(d) 2 layers at full width", "resumed at 2", "(e) 2 layers, float32"):
        assert part in out, part
    assert set(launches) == set(chip_smoke.ops.KERNELS)
    # (a) train() and the timed and profiled steps, (b) the fused steps,
    # (c) 3 unpacks, (d) the three runs' steps; engine mode's scans
    t = chip_smoke
    assert launches["bitunpack"] >= (t.TRAIN_STEPS + t.TIMED_STEPS + 1 + t.MODE_STEPS + 3
                                     + t.RESUME_STEPS + t.RESUME_TO + 2)
    assert launches["rle_decode"] > 0 and launches["filter_compact"] > 0


def test_training_phase_stops_when_engine_batches_differ(train_on_cpu, tmp_path, monkeypatch,
                                                         capsys):
    """An engine-mode pipeline whose tokens come back one off: the phase
    raises at (b)'s comparison and runs nothing after it."""
    class OffByOne(chip_smoke.TokenPipeline):
        def next_batch(self):
            batch = super().next_batch()
            return {"tokens": batch["tokens"] + 1} if self.mode == "engine" else batch

    monkeypatch.setattr(chip_smoke, "TokenPipeline", OffByOne)
    with pytest.raises(AssertionError, match=r"\(b\) host and engine batch 0 differ"):
        chip_smoke.training_phase(0, str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "(a) step_ms" in out and "(b)" not in out and "(c)" not in out


def test_kernels_line_counts_every_window():
    """Phase 10's record: launches summed over the by-order windows and
    phases 9 and T, each window kept under its own key."""
    names = list(chip_smoke.ops.KERNELS)
    case = {"blocks": 16, "ms": 1.0, "plain_ms": 2.0, "bound_ms": 0.5, "bound_by": "bytes",
            "library_ms": None, "stage_ms": None}
    records = {n: {"max_abs_err": 0.0, "cases": [case, case]} for n in names}
    records["flash_attention"].update(launches_by_route={"wgmma": 1, "cuda_cores": 1},
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


# ---------------------------------------------------------------------------
# phase M, rehearsed on the CPU with plain kernels counted as launches
# ---------------------------------------------------------------------------

@pytest.fixture
def families_on_cpu(monkeypatch, on_cpu, plain_launches):
    """The families' smoke configs at float32 in place of the full widths in
    bfloat16 (llama4's 4 layers cut to 2 as the full one is), prompts of 40-64
    tokens on 96-slot caches (hymba's windows of 32 wrap); the card's memory
    counters faked.  float32, since (b)'s bf16 bound is the full widths': at
    d_model 64 the logits are ~0.1 and bf16 decode and prefill differ by
    relative L2 0.03-0.15 (deepseek and llama4 smoke)."""
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config",
                        lambda arch: dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    monkeypatch.setattr(chip_smoke, "FAMILY_PROMPTS", (40, 48, 56, 64))
    monkeypatch.setattr(chip_smoke, "FAMILY_MAX_LEN", 96)
    monkeypatch.setattr(chip_smoke, "CHECK_LEN", 32)
    for name in ("reset_peak_memory_stats", "max_memory_allocated", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)


def test_families_phase_rehearsal(families_on_cpu, capsys):
    launches = chip_smoke.families_phase(0, device="cpu")
    out = capsys.readouterr().out
    for arch in chip_smoke.FAMILY_ARCHS:
        assert f"      {arch} [" in out, arch
    for part in ("[hybrid], uncut", "llama4-maverick-400b [moe], cut from 4 to 2 layers",
                 "(a) 4096-token prompt packed at k=9", "second engine gives the same tokens",
                 "decode_ms per tick", "idle_share=", "(c) 2 layers, float32",
                 "in float32 drawn from seed 0",
                 "(c) 2 layers, 8 experts, float32", "routing ids equal in 9 MoE calls",
                 "at the model's capacity 1.25: relative L2",
                 "with every entry within capacity (moe_capacity E): relative L2",
                 "on the card, decode at 32 against the 33-token prefill"):
        assert part in out, part
    # one bitunpack a family (its packed prefill), nothing else
    assert launches == dict(dict.fromkeys(chip_smoke.ops.KERNELS, 0), bitunpack=4)


def test_families_phase_holds_decode_in_float32_where_bf16_tips_the_router(
        families_on_cpu, monkeypatch, capsys):
    """Where (b)'s decode routes the last token to other experts than the
    prefill, the phase holds decode ≡ prefill in float32 at full width."""
    monkeypatch.setattr(chip_smoke, "FAMILY_ARCHS", ("deepseek-moe-16b",))
    seen = []

    def tipped(params, cfg, seq):
        got = against(params, cfg, seq)
        seen.append((cfg.dtype, cfg.moe_capacity))
        return dict(got, flipped=1) if len(seen) == 1 else got

    against = chip_smoke.decode_against_prefill
    monkeypatch.setattr(chip_smoke, "decode_against_prefill", tipped)
    chip_smoke.families_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "where the decode routes as the prefill" in out
    assert "(b) float32 at full width, every entry within capacity: decode at 40" in out
    assert seen[:3] == [("float32", 8.0), ("float32", 1.25), ("float32", 8.0)]


def test_family_config_cuts_hymba_to_a_global_and_a_windowed_layer():
    real = chip_smoke.get_config
    assert chip_smoke.family_config("mamba2-370m") == real("mamba2-370m")
    assert chip_smoke.family_config("llama4-maverick-400b").n_layers == 2
    cut = chip_smoke.family_config("hymba-1.5b", 2)
    segs = chip_smoke.model.model_segments(cut)
    assert [(s.count, s.window) for s in segs] == [(1, None), (1, cut.window)]


def test_families_phase_stops_when_packed_prompts_differ(families_on_cpu, monkeypatch, capsys):
    """A packed prompt that unpacks one off: the phase raises at the first
    family's (a) and prints nothing after its header."""
    unpack = chip_smoke.model.unpack_tokens
    monkeypatch.setattr(chip_smoke.model, "unpack_tokens", lambda *a: unpack(*a) + 1)
    with pytest.raises(AssertionError, match="mamba2-370m: the packed-prompt prefill differs"):
        chip_smoke.families_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "mamba2-370m [ssm]" in out and "(a)" not in out and "hymba" not in out


# ---------------------------------------------------------------------------
# phase E, rehearsed on the CPU with plain kernels counted as launches
# ---------------------------------------------------------------------------

@pytest.fixture
def encdec_vlm_on_cpu(monkeypatch, on_cpu, plain_launches):
    """whisper's and llava's smoke configs at float32 in place of the full
    widths in bfloat16 (llava's 3 layers cut to 2 as the full one is cut),
    prompts of 24-48 tokens on 64-slot caches, 32-token checks, (d) at B 1 x
    24 and (e) at 2 x 32; the card's memory counters faked.  float32 for
    (b)'s bound, as in the families' rehearsal."""
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config",
                        lambda arch: dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    monkeypatch.setattr(chip_smoke, "EV_LAYERS", {"llava-next-34b": 2})
    monkeypatch.setattr(chip_smoke, "EV_DECODE_F32", {"llava-next-34b": 1})
    prompts = (24, 32, 40, 48)
    monkeypatch.setattr(chip_smoke, "EV_PROMPTS", dict.fromkeys(chip_smoke.EV_ARCHS, prompts))
    monkeypatch.setattr(chip_smoke, "EV_NEW_TOKENS", dict.fromkeys(chip_smoke.EV_ARCHS, 6))
    monkeypatch.setattr(chip_smoke, "EV_MAX_LEN", dict.fromkeys(chip_smoke.EV_ARCHS, 64))
    monkeypatch.setattr(chip_smoke, "EV_CHECK_AT", dict.fromkeys(chip_smoke.EV_ARCHS, 48))
    monkeypatch.setattr(chip_smoke, "EV_STEP_BATCH", dict.fromkeys(chip_smoke.EV_ARCHS, (1, 24)))
    monkeypatch.setattr(chip_smoke, "CHECK_LEN", 32)
    for name, n in (("EV_TRAIN_B", 2), ("EV_TRAIN_S", 32)):
        monkeypatch.setattr(chip_smoke, name, n)
    for name in ("reset_peak_memory_stats", "max_memory_allocated", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)


def test_encdec_vlm_phase_rehearsal(encdec_vlm_on_cpu, capsys):
    launches = chip_smoke.encdec_vlm_phase(0, device="cpu")
    out = capsys.readouterr().out
    for part in ("whisper-base [audio], uncut: segments [('enc', 2), ('decx', 2)]",
                 "llava-next-34b [vlm], cut from 3 to 2 layers",
                 "(a) 4096-token prompt packed at k=9", "with 48 random frames",
                 "'ck', 'cv', 'k', 'v'", "with random (1, 16, 64) vision embeddings the same "
                 "logits bit for bit", "second engine gives the same tokens",
                 "decode at 48 against the 49-token prefill (random frames)",
                 "the encoder alone over 48 frames", "decode_ms per tick", "idle_share=",
                 "beside 0.03125; by depth {1: ", "held in float32 at 1 layers below",
                 "(b) float32 at full width, 1 layers: decode at 48 against the 49-token",
                 "(c) 2 layers, float32, a 32-token prefill over 48 random frames",
                 "(d) 2 layers, float32, one step on 1 x 24 tokens with 48 random frames",
                 "(d) 2 layers, float32, one step on 1 x 24 tokens after 16 random vision",
                 "'enc_final_ln'", "'vis_proj'",
                 "(e) 4 AdamW steps in float32 on one batch of 2 x 32 tokens"):
        assert part in out, part
    # one bitunpack a model (its packed prefill), nothing else
    assert launches == dict(dict.fromkeys(chip_smoke.ops.KERNELS, 0), bitunpack=2)


def test_encdec_vlm_phase_stops_when_packed_prompts_differ(encdec_vlm_on_cpu, monkeypatch,
                                                           capsys):
    """A packed prompt that unpacks one off: the phase raises at whisper's
    (a) and prints nothing after its header."""
    unpack = chip_smoke.model.unpack_tokens
    monkeypatch.setattr(chip_smoke.model, "unpack_tokens", lambda *a: unpack(*a) + 1)
    with pytest.raises(AssertionError, match="whisper-base: the packed-prompt prefill differs"):
        chip_smoke.encdec_vlm_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "whisper-base [audio]" in out and "(a)" not in out and "llava" not in out


def test_encdec_vlm_phase_stops_when_prefill_reads_the_image(encdec_vlm_on_cpu, monkeypatch,
                                                             capsys):
    """A prefill that lets the vision embeddings move its logits: the phase
    raises at llava's (a), the reference's trait broken."""
    monkeypatch.setattr(chip_smoke, "EV_ARCHS", ("llava-next-34b",))
    prefill = chip_smoke.model.prefill

    def reads_image(params, batch, cfg, *a, **kw):
        logits, caches = prefill(params, batch, cfg, *a, **kw)
        return (logits + batch["embeds"].float().mean() if "embeds" in batch else logits), caches

    monkeypatch.setattr(chip_smoke.model, "prefill", reads_image)
    with pytest.raises(AssertionError, match="llava-next-34b: prefill read the vision"):
        chip_smoke.encdec_vlm_phase(0, device="cpu")
    assert "llava-next-34b [vlm]" in capsys.readouterr().out
