#!/usr/bin/env python3
"""flash_attention on one card: this tree's kernels against another tree's.

    python3 scripts/flash_attention_ab.py --other DIR [--seed 0] [--iters 20]

DIR holds an unpacked checkout of another commit (`git archive`).  Each tree
runs in a process of its own, in turns other, this, this, other, and is
reached only through its public entry points (`kernels.flash_attention`,
`kernels.ref.mha`).  A turn builds the tree's kernels, then at each shape of
CASES (causal, scale D^-0.5, q, k, v drawn from --seed with standard
deviation 1) holds the kernel against ref.mha by phase 9(d)'s rule (float32
atol 3e-5 / rtol 1e-4; bf16 2^-7 of each row's largest output) and times it
cold: the median device time of --iters single calls, each after a 256 MiB
L2 flush and a device spin.

Each case prints both trees' times, the route each tree takes, and the bound:
the larger of the bytes the call must move at 3.35 TB/s and its
4 * B * H * D * S(S+1)/2 operations at 989 TFLOP/s (bf16) or 495 / 3 TFLOP/s
(float32 at float32 accuracy: three TF32 passes on the tensor cores).

Run it from the repository root on a machine with a CUDA card; it prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# label, B, H, Hkv, S, D, dtype: phase 9(d)'s shapes (qwen3-1.7b's heads at
# S 4096; its float32 case; D 32 and D 256 at 16 heads, S 2048) and D 64
CASES = (("path: layer 0, float32", 1, 16, 8, 4096, 128, "float32"),
         ("D 32: 16 heads, S 2048, bf16", 1, 16, 16, 2048, 32, "bfloat16"),
         ("D 64: 16 heads, S 4096, float32", 1, 16, 16, 4096, 64, "float32"),
         ("D 256: 16 heads, S 2048, float32", 1, 16, 16, 2048, 256, "float32"),
         ("path: layer 0, bf16", 1, 16, 8, 4096, 128, "bfloat16"),
         ("stack: 4 prompts, bf16", 4, 16, 8, 4096, 128, "bfloat16"))
TURNS = ("other", "this", "this", "other")
SPIN_CYCLES = 200_000  # ~0.1 ms: the host enqueues the call while the card spins
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}


def median_ms(fn, flush, iters: int) -> float:
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


def max_err(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    """max |got - want|, raising past phase 9(d)'s tolerance."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        ok = bool((err <= 3e-5 + 1e-4 * w.abs()).all())
    else:
        ok = bool((err <= 2.0 ** -7 * w.abs().amax(dim=-1, keepdim=True)).all())
    if not ok or got.dtype != want.dtype:
        raise AssertionError(f"{label}: flash_attention differs from ref.mha "
                             f"(max |err| {float(err.max())})")
    return float(err.max())


def bound_ms(B: int, H: int, Hkv: int, S: int, D: int, dtype: str) -> float:
    size = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * B * H + 2 * B * Hkv) * S * D * size
    nops = 4 * B * H * D * S * (S + 1) // 2
    return max(nbytes / HBM_BYTES_PER_S, nops / FLOPS_PER_S[dtype]) * 1e3


def turn(tree: str, seed: int, iters: int) -> dict:
    """One tree's kernels at CASES: {label: (route, ms, max |err|)}."""
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import build, flash_attention, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    rng = np.random.default_rng(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for label, B, H, Hkv, S, D, dtype in CASES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, D)).astype(np.float32))
                   .to("cuda", dt) for h in (H, Hkv, Hkv))
        kw = dict(causal=True, scale=D ** -0.5)
        err = max_err(flash_attention.flash_attention(q, k, v, **kw), ref.mha(q, k, v, **kw),
                      label)
        ms = median_ms(lambda: flash_attention.flash_attention(q, k, v, **kw), flush, iters)
        res[label] = (flash_attention.route(dt, D), ms, err)
        del q, k, v
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an unpacked checkout of another commit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # a tree, run in a process of its own
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(turn(args.turn, args.seed, args.iters)))
        return 0
    if not args.other:
        ap.error("--other is required")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {"other": os.path.abspath(args.other), "this": ROOT}
    runs = []
    for name in TURNS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", trees[name],
                            "--seed", str(args.seed), "--iters", str(args.iters)],
                           capture_output=True, text=True)
        if r.returncode:
            sys.stderr.write(r.stderr)
            return r.returncode
        runs.append((name, json.loads(r.stdout.strip().splitlines()[-1])))
        print(f"  turn {len(runs)}: {name} done", flush=True)
    for label, B, H, Hkv, S, D, dtype in CASES:
        times = {name: [res[label][1] for n, res in runs if n == name] for name in trees}
        routes = {n: res[label][0] for n, res in runs}
        errs = {n: max(res[label][2] for m, res in runs if m == n) for n in trees}
        other, this = (sum(times[n]) / len(times[n]) for n in ("other", "this"))
        bound = bound_ms(B, H, Hkv, S, D, dtype)
        print(f"  {label:33s} q {(B, H, S, D)} kv {(B, Hkv, S, D)}: other ({routes['other']}) "
              f"ms {', '.join(f'{t:.4f}' for t in times['other'])}; this ({routes['this']}) "
              f"ms {', '.join(f'{t:.4f}' for t in times['this'])}; other/this "
              f"{other / this:.3f}; bound_ms {bound:.5f} (share other {bound / other:.4f}, "
              f"this {bound / this:.4f}); max|err| other {errs['other']:.3e}, this "
              f"{errs['this']:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
