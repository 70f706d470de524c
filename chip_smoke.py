#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with a CUDA card (an H100 for the
numbers in PERF.md).  It imports nothing of JAX or of the JAX package.
Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build the hand-written kernels from `src/repro_torch/kernels/csrc` (nvcc);
3. each kernel against its plain PyTorch version on the card, bit for bit, at
   the main path's shape (one 65,536-row row group: 16 blocks) and over a
   stack of 92 row groups (1,472 blocks), plus the edge cases (k = 1, 31, 32,
   a dictionary too large for shared memory, DELTA wraparound); each timed
   with CUDA events (cold L2, median of single launches) beside its bound
   and the plain version's time;
4. generate TPC-H SF1 (the generator's sf=10: 6,000,000 lineitem rows) into a
   temporary directory;
5. run Q1, Q6, Q12, Q14 and Q15 through DatapathEngine(device="cuda") with
   every kernel launch count set to 0 just before and read just after;
6. run the same queries on device="cpu" and compare: integers exactly,
   floats within rtol 1e-4 (Q15's supplier only outside a near tie);
7. print per-query wall time, peak device memory and, from torch.profiler,
   the device's busy time and idle share;
8. print one JSON line with every kernel's record (its launches on the query
   path must be > 0);
9. print the device line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core import DatapathEngine, agreement, tpch  # noqa: E402
from repro_torch.core import queries as Q  # noqa: E402
from repro_torch.kernels import bitunpack, build, delta_decode, dict_decode, fused_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.lakeformat.reader import LakeReader  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# The data sheet's 67e12 float32 FLOP/s is 128 FMA lanes per SM at 2
# operations each per clock.  Hopper has 64 lanes per SM for 32-bit integer
# add, shift, logic, compare and min/max, one operation each per clock, and
# issues warp shuffles at half that (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): a quarter of the rate.
INT32_OPS_PER_S = 67e12 / 4
SF = 10.0  # the generator's scale for TPC-H SF1: 6,000,000 lineitem rows
PATH_BLOCKS = 16  # one 65,536-row row group
STACK_BLOCKS = 1472  # 92 row groups: all of SF1 lineitem's
# 32-bit integer issue slots per decoded value, counted from each kernel's
# source, on top of the k-bit unpack's 2 (a funnel shift and a mask; none for
# k = 32).  A shuffle takes 2 slots, as it issues at half the integer rate.
#   dict_decode   clip (max, min) and the entry's address
#   delta_decode  un-zigzag 3; per scan step (5) a shuffle and an add; the
#                 row offset's add
#   fused_scan    two compares, the mask byte, the survivor count
EXTRA_OPS_PER_VALUE = {"bitunpack": 0, "dict_decode": 3, "delta_decode": 3 + 5 * 3 + 1,
                       "fused_scan": 4}


def ops_per_value(name: str, k: int) -> int:
    return EXTRA_OPS_PER_VALUE[name] + (2 if k < 32 else 0)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_words(rng, nb: int, k: int):
    w = rng.integers(0, 2**32, size=(nb, k, 128), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).cuda()


def median_ms(fn, iters: int, flush) -> float:
    """Median device time of one call of `fn`, each after an L2 flush,
    after a few untimed calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def max_abs_err(got, want) -> float:
    """Largest |got - want| (0 when bit-identical); raises unless identical."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    same = (torch.equal(got.view(torch.int32), want.view(torch.int32))
            if got.dtype == torch.float32 else torch.equal(got, want))
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if not same:
        raise AssertionError(f"kernel differs from its plain version (max |err| {err})")
    return err


def kernel_cases(rng):
    """(kernel, label, blocks, k, kernel fn, plain fn, bytes moved) per case.
    The first case of each kernel is its main-path shape, the second the
    92-row-group stack; the rest are edge cases."""
    cases = []

    def packed_bytes(nb, k):
        return nb * k * 128 * 4

    # bitunpack: l_partkey at SF1 is BITPACK k=18
    for label, nb, k in [("path k=18", PATH_BLOCKS, 18), ("stack k=18", STACK_BLOCKS, 18),
                         ("k=1", PATH_BLOCKS, 1), ("k=31", PATH_BLOCKS, 31),
                         ("k=32", PATH_BLOCKS, 32)]:
        p = make_words(rng, nb, k)
        cases.append(("bitunpack", label, nb, k,
                      lambda p=p, k=k: bitunpack.bitunpack(p, k),
                      lambda p=p, k=k: ref.bitunpack(p, k),
                      packed_bytes(nb, k) + nb * 4096 * 4))

    # dict_decode: l_orderkey at SF1 is DICT k=14 with ~16.1K int entries
    # (> 48 KiB of shared memory); l_discount is DICT k=4 over 11 floats
    def dict_case(label, nb, k, d_len, dtype):
        p = make_words(rng, nb, k)
        if dtype == "float32":
            d = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32)).cuda()
        else:
            d = torch.from_numpy(rng.integers(-2**31, 2**31, d_len).astype(np.int32)).cuda()
        cases.append(("dict_decode", label, nb, k,
                      lambda: dict_decode.dict_decode(p, d, k),
                      lambda: ref.dict_decode(p, d, k),
                      packed_bytes(nb, k) + d_len * 4 + nb * 4096 * 4))

    dict_case("path k=14 D=16143 shared", PATH_BLOCKS, 14, 16_143, "int32")
    dict_case("stack k=14 D=16143 shared", STACK_BLOCKS, 14, 16_143, "int32")
    dict_case("k=4 D=11 float32", PATH_BLOCKS, 4, 11, "float32")
    dict_case("k=16 D=65536 global (too large for shared)", PATH_BLOCKS, 16, 65_536, "int32")
    dict_case("k=16 D=65536 global, stack", STACK_BLOCKS, 16, 65_536, "float32")
    dict_case("k=32 D=40 (negative codes)", PATH_BLOCKS, 32, 40, "int32")

    # delta_decode: o_orderkey / p_partkey at SF1 are DELTA k=2
    def delta_case(label, nb, k, wrap):
        p = make_words(rng, nb, k)
        if wrap:
            b = np.concatenate([[2**31 - 1, -2**31, 2**31 - 9, -2**31 + 5],
                                rng.integers(-2**31, 2**31, nb)])[:nb]
        else:
            b = np.arange(nb) * 4096
        b = torch.from_numpy(b.astype(np.int32)).cuda()
        cases.append(("delta_decode", label, nb, k,
                      lambda: delta_decode.delta_decode(p, b, k),
                      lambda: ref.delta_decode(p, b, k),
                      packed_bytes(nb, k) + nb * 4 + nb * 4096 * 4))

    delta_case("path k=2", PATH_BLOCKS, 2, False)
    delta_case("stack k=2", STACK_BLOCKS, 2, False)
    delta_case("k=30 wraparound", PATH_BLOCKS, 30, True)
    delta_case("k=31 wraparound", PATH_BLOCKS, 31, True)
    delta_case("k=32 wraparound", PATH_BLOCKS, 32, True)

    # fused_scan: l_shipdate codes at SF1 are DICT k=12; Q1 keeps codes <= 2466
    for label, nb, k, lo, hi in [("path k=12", PATH_BLOCKS, 12, 0, 2466),
                                 ("stack k=12", STACK_BLOCKS, 12, 1000, 1029),
                                 ("k=1 full", PATH_BLOCKS, 1, 0, 1),
                                 ("k=12 empty", PATH_BLOCKS, 12, 1, 0),
                                 ("k=32 negative", PATH_BLOCKS, 32, -2**31, -1)]:
        p = make_words(rng, nb, k)
        cases.append(("fused_scan", label, nb, k,
                      lambda p=p, k=k, lo=lo, hi=hi: fused_scan.fused_scan(p, k, lo, hi),
                      lambda p=p, k=k, lo=lo, hi=hi: ref.fused_scan(p, k, lo, hi),
                      packed_bytes(nb, k) + nb * 4096 + nb * 4))
    return cases


def check_kernels(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    # about a second of work first, so the clocks are up before any timing
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        a @ a
        torch.cuda.synchronize()
    del a
    records: dict = {}
    for name, label, nb, k, run, plain, nbytes in kernel_cases(rng):
        err = max_abs_err(run(), plain())
        torch.cuda.synchronize()
        iters = 30 if nb == PATH_BLOCKS else 10
        ms = median_ms(run, iters, flush)
        plain_ms = median_ms(plain, max(3, iters // 3), flush)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nb * 4096 * ops_per_value(name, k) / INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        log(f"  {name:12s} {label:44s} blocks={nb:5d} exact (max|err|={err}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({nbytes} B, by {'bytes' if bytes_ms >= ops_ms else 'operations'})")
        rec = records.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append({"label": label, "blocks": nb, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms,
                             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    del flush
    return records


# ---------------------------------------------------------------------------
# phases 5-6: the queries on the card and on the CPU
# ---------------------------------------------------------------------------


def run_queries(engine, readers, queries, on_card: bool):
    out, times, peaks, launches = {}, {}, {}, {}
    for name, q in queries.items():
        before = ops.kernel_launches()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[name] = q(engine, readers)
        if on_card:
            torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        if on_card:
            peaks[name] = torch.cuda.max_memory_allocated()
        after = ops.kernel_launches()
        launches[name] = {k: after[k] - before[k] for k in after}
    return out, times, peaks, launches


def device_busy(engine, readers, queries) -> dict:
    """Per query, under torch.profiler: the device's busy time (the sum of
    the self time of every CUDA kernel and copy) and its four largest items.
    The profiler slows the host side, so the wall time it sees is not used."""
    out = {}
    for name, q in queries.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            q(engine, readers)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
        out[name] = (busy_ms, [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
                               for e in top])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available; nothing was run", file=sys.stderr)
        return 1

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # phase 2
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    log(f"[2] built {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f} s")

    # phase 3
    log("[3] kernels against their plain versions on the card (bit-exact):")
    records = check_kernels(args.seed)

    # phase 4
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tpch_") as d:
        t0 = time.perf_counter()
        paths = tpch.write_tables(d, sf=SF, seed=args.seed)
        readers = {k: LakeReader(p) for k, p in paths.items()}
        log(f"[4] wrote TPC-H sf={SF} seed={args.seed} in "
            f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
                f"{k} {r.n_rows} rows / {r.n_row_groups} row groups"
                for k, r in readers.items()))

        # phase 5: the main path on the card
        gpu = DatapathEngine(device="cuda")
        ops.reset_kernel_launches()
        ops.reset_dispatch_count()
        got, first_ms, peaks, per_query = run_queries(gpu, readers, Q.QUERIES, True)
        launches = ops.kernel_launches()
        dispatches = ops.dispatch_count()
        log(f"[5] queries on the card: launches {launches}, dispatches {dispatches}")
        for name, per in per_query.items():
            log(f"      {name}: {per}")
        _, warm_ms, _, _ = run_queries(gpu, readers, Q.QUERIES, True)
        busy = device_busy(gpu, readers, Q.QUERIES)

        # phase 6: the same queries on the CPU
        cpu = DatapathEngine(device="cpu")
        t0 = time.perf_counter()
        want, cpu_ms, _, _ = run_queries(cpu, readers, Q.QUERIES, False)
        log(f"[6] queries on the CPU in {time.perf_counter() - t0:.1f} s")
        per_supp = agreement.per_supplier_revenue(readers["lineitem"])
        if len(want["q1"]) != 6:
            raise AssertionError(f"q1 has {len(want['q1'])} groups at SF1, not 6")
        for name in Q.QUERIES:
            agreement.compare(name, got[name], want[name], per_supp)
            log(f"      {name} agrees: {got[name]}")

    # phase 7
    log("[7] per query on the card (wall ms after synchronize; first run, warm run;"
        " peak device memory):")
    for name in Q.QUERIES:
        log(f"      {name}: first_ms={first_ms[name]:.2f} warm_ms={warm_ms[name]:.2f} "
            f"cpu_ms={cpu_ms[name]:.2f} peak_bytes={peaks[name]}")
    log("[7] device busy per query (torch.profiler, one more warm run; idle share"
        " against warm_ms):")
    for name, (busy_ms, top) in busy.items():
        idle = 1 - busy_ms / warm_ms[name] if busy_ms else float("nan")
        log(f"      {name}: busy_ms={busy_ms:.3f} idle_share={idle:.3f} top={top}")

    # phase 8
    kernels = []
    for name, mod in ops.KERNELS.items():
        path, stack = records[name]["cases"][0], records[name]["cases"][1]
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
            "launches": launches[name], "max_abs_err": records[name]["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "library_ms": None,
            "blocks": path["blocks"], "stack_blocks": stack["blocks"],
            "stack_ms": stack["ms"], "stack_plain_ms": stack["plain_ms"],
            "stack_bound_ms": stack["bound_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the query path: {idle}")

    # phase 9
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
