#!/usr/bin/env python3
"""rle_decode on one card: this tree's kernel against another tree's, and
this tree's tilings against each other.

    python3 scripts/rle_decode_ab.py [--other DIR] [--seed 0]

DIR holds an unpacked checkout of another commit (`git archive`).  Each tree
runs in a process of its own, in turns other, this, this, other, and is
reached only through its public entry points (`kernels.ops.rle_decode_batch`,
`kernels.ref.rle_decode`, `core.DatapathEngine`, `core.queries`).  A turn
holds the kernel bit for bit against its plain version and times it:

- cold (median device time of single calls, each after a 256 MiB L2 flush and
  a device spin): the writer's pages of sorted dates at the path (64 blocks,
  one row group) and the stack (5,888, 92 row groups), random windows at
  5,000 and 1,473 blocks;
- in situ: Q1 over sorted TPC-H SF1 (written once, by this tree) through
  DatapathEngine(device="cuda") under torch.profiler: rle_decode_kernel's
  self us a launch, and Q1's result, which every turn must give alike.

Then, in this process, each tiling of `kernels.rle_decode.SPLITS` at block
counts on both sides of `launch_shape`'s choice, on the writer's pages and on
random windows, through the C entry point with that tiling's `grid`.

Run it from the repository root on a machine with a CUDA card; it prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 10.0  # the generator's scale for TPC-H SF1 (as chip_smoke.SF)
SHAPES = (("path: sorted dates", 64, "dates"), ("stack: sorted dates", 5888, "dates"),
          ("walk: 5,000 random", 5000, "random"), ("walk: 1,473 random", 1473, "random"))
SWEEP_BLOCKS = (64, 264, 528, 896, 1055, 1056, 1473, 2048, 5888)
SPIN_CYCLES = 200_000  # ~0.1 ms: the host enqueues the call while the card spins


def median_ms(fn, flush, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]


def same(got: torch.Tensor, want: torch.Tensor) -> None:
    if got.dtype != want.dtype or not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("rle_decode differs from its plain version")


def pages(rng, nb: int, kind: str, rle_encode):
    """The writer's pages of sorted dates (2,346 rows a day, as SF1's
    l_shipdate) or random windows of nondecreasing ends, on the card."""
    if kind == "dates":
        days = nb * 1024 // 2346 + 1
        bufs = rle_encode(np.sort(rng.integers(0, days, nb * 1024)).astype(np.int32))
        vals, ends = bufs["rle_values"], bufs["rle_ends"]
    else:
        ends = np.sort(rng.integers(0, 1025, (nb, 128)), axis=1).astype(np.int32)
        vals = rng.integers(-2**31, 2**31, (nb, 128)).astype(np.int32)
    return torch.from_numpy(vals).cuda(), torch.from_numpy(ends).cuda()


def turn(tree: str, tables: dict, seed: int) -> dict:
    """One tree's kernel, cold at SHAPES and in situ in Q1."""
    sys.path.insert(0, os.path.join(tree, "src"))
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from repro_torch.core import DatapathEngine
    from repro_torch.core import queries as Q
    from repro_torch.kernels import ops, ref
    from repro_torch.lakeformat.encodings import rle_encode
    from repro_torch.lakeformat.reader import LakeReader

    rng = np.random.default_rng(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for label, nb, kind in SHAPES:
        v, e = pages(rng, nb, kind, rle_encode)
        same(ops.rle_decode_batch(v, e), ref.rle_decode(v, e))
        res[label] = median_ms(lambda: ops.rle_decode_batch(v, e), flush)
    del flush
    readers = {k: LakeReader(p) for k, p in tables.items()}
    engine = DatapathEngine(device="cuda")
    res["q1"] = repr(Q.QUERIES["q1"](engine, readers))  # a warm run first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        Q.QUERIES["q1"](engine, readers)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "rle_decode_kernel" in e.key]
    n = sum(e.count for e in ev)
    res["in situ"] = (sum(e.self_device_time_total for e in ev) / n, n)
    return res


def sweep(seed: int) -> None:
    """This tree's tilings at SWEEP_BLOCKS, each bit for bit, timed twice in
    turns (the splits ascending, then descending)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ref, rle_decode
    from repro_torch.lakeformat.encodings import rle_encode

    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for kind in ("dates", "random"):
        for nb in SWEEP_BLOCKS:
            v, e = pages(rng, nb, kind, rle_encode)
            want = ref.rle_decode(v, e)
            out = torch.empty_like(want)
            times = {s: [] for s in rle_decode.SPLITS}
            for order in (rle_decode.SPLITS, rle_decode.SPLITS[::-1]):
                for s in order:
                    def fn(s=s, g=rle_decode.grid(nb, s, sms)):
                        build.launch("rt_rle_decode", v.device, v, e, out, nb, s, g)

                    out.zero_()
                    fn()
                    same(out, want)
                    times[s].append(median_ms(fn, flush))
            chosen = rle_decode.launch_shape(nb, sms)[0]
            print(f"  sweep {kind:6s} blocks={nb:5d} chosen={chosen} " + "; ".join(
                f"split {s} (ctas {rle_decode.grid(nb, s, sms)}) us "
                f"{', '.join(f'{t * 1e3:.2f}' for t in ts)}" for s, ts in times.items()),
                flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an unpacked checkout of another commit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # a tree, run in a process of its own
    ap.add_argument("--tables", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(turn(args.turn, json.loads(args.tables), args.seed)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.other:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch.core import tpch

        trees = {"other": os.path.abspath(args.other), "this": ROOT}
        with tempfile.TemporaryDirectory(prefix="rle_ab_tpch_") as d:
            tables = tpch.write_tables(d, sf=SF, seed=args.seed, sorted_data=True)
            q1 = None
            for name in ("other", "this", "this", "other"):
                r = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn",
                                    trees[name], "--tables", json.dumps(tables),
                                    "--seed", str(args.seed)], capture_output=True, text=True)
                if r.returncode:
                    sys.stderr.write(r.stderr)
                    return r.returncode
                res = json.loads(r.stdout.strip().splitlines()[-1])
                q1 = q1 or res["q1"]
                if res.pop("q1") != q1:
                    raise AssertionError(f"Q1 with the {name} tree's kernel gave another result")
                us, n = res.pop("in situ")
                print(f"  {name:5s} exact; cold us " + "; ".join(
                    f"{k} {ms * 1e3:.2f}" for k, ms in res.items())
                    + f"; in situ, sorted q1, {n} launches, {us:.3f} us a launch", flush=True)
    sweep(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
