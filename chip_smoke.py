#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with a CUDA card (an H100 for the
numbers in PERF.md).  It imports nothing of JAX or of the JAX package.
Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi) and the torch/CUDA versions;
2. build the hand-written kernels from `src/repro_torch/kernels/csrc` (one
   nvcc per source, all started together, then one link);
3. each datapath kernel against its plain PyTorch version on the card, bit
   for bit (floats as bits), at the main path's shape (one 65,536-row row group: 16
   packed blocks or 64 RLE/probe blocks; the part table's 196 blocks for
   compaction) and over a stack of 92 row groups (1,472 or 5,888 blocks),
   plus the edge cases (k = 1, 31, 32, a dictionary too large for shared
   memory, DELTA wraparound, the fused_scan dictionary arm, 128-run RLE
   windows, all/none/last-row compaction masks, 2^10- and 2^17-byte filters;
   for the batch and aggregate kernels: pages of different dictionary sizes
   and a size of 0, per-block empty ranges, 1, 3 and 128 groups, group ids
   out of range, a 128-group window that no row falls in, all-masked blocks,
   int32 at +-2^31, float +-inf and NaN, int32 masks, k = 1, 6, 32; for
   the grid-stride walks of fused_scan, fused_scan_batch, fused_agg and
   filter_compact, 5,000 blocks, more than one wave of CTAs, and 1,473, not
   a multiple of the grid, with ragged per-block ranges and empty ones
   (1, 0) for fused_scan_batch); each
   timed with CUDA events (median of single launches, each after a 256 MiB
   L2 flush and a ~0.1 ms device spin that hides the host's launch
   overhead) beside its bound, the plain version's time and, where one
   exists, one PyTorch call's time (for dict_decode, torch.take of the
   unpacked, clipped codes: the lookup half alone, a yardstick; its cases
   include l_shipdate's k=12 dictionary of 2,557 entries; for
   dict_decode_batch, torch.take of the flattened page dictionaries at
   page * Dmax + the clipped code, and a case in the bucket shape phase 7
   launches most: k = 4, float32, 184 pages of 11 and 9 entries);
4. generate TPC-H SF1 (the generator's sf=10: 6,000,000 lineitem rows) twice
   into temporary directories: unsorted, and sorted (lineitem on l_shipdate,
   whose pages are then RLE in every row group);
5. on each file order, run Q1, Q6, Q12, Q14, Q15 and Q19 through
   DatapathEngine(device="cuda") with every kernel launch count set to 0 just
   before and read just after;
6. run the same queries on device="cpu" and compare: integers exactly,
   floats within rtol 1e-4 (Q15's supplier only outside a near tie);
7. batched scans and aggregate pushdown on each file order, with every
   launch count set to 0 just before the warm scans and read just after
   them (the first runs, Q19's bloom build, the comparators, (b)'s extra
   runs and the profiler's reruns lie outside that window): (a) the
   lineitem scan of each query (Q19's with its bloom) through
   scan(batched=False) and scan(batched=True), equal in columns, mask,
   count and every ScanStats field but the launch count, with each path's
   warm wall ms, dispatches,
   host-to-device copies and, from torch.profiler, device busy time and
   idle share; (b) the two pushdown plans of benchmarks/throughput.py and a
   sum grouped by l_shipdate (a domain of 20 MAX_GROUPS-wide windows),
   sequential and batched (warm ms: the median of three runs; device busy
   time and idle share as in (a)), bit-identical to each other, to
   scan-then-aggregate (agreement.scan_then_aggregate) and to device="cpu"
   (float sums included: both add in the kernel's order); per plan and
   path, every port kernel's self device time, launches and us a launch in
   situ from that profile (as phase 8 prints them), and per file order one
   line of each kernel's totals over phase 7's profiled scans, by path;
O. the paper's offload configurations on each file order, after phase 7,
   every launch count set to 0 at its start and read at its end (its
   comparators run on the CPU): (a) Fig. 2: the six queries on
   DatapathEngine(device="cuda", offload=m, cache=BlockCache(4 << 30)) for m
   raw, preloaded and prefiltered (the cached two warmed by one pass, as
   benchmarks/breakdown.py does), warm wall ms (median of three) and
   decode% / filter% / rest% computed as breakdown.py does, each mode's
   answers agreeing with raw's (agreement.compare), each query's lineitem
   scan (Q19's with its bloom) bit-identical in the three modes and its
   ScanStats equal to a device="cpu" engine's with the same history, field
   for field; (b) the six queries on backend="host" (numpy decode), agreeing
   with raw, wall ms beside raw's; (c) phase 7(b)'s three pushdown plans
   under pre-aggregated: the second run a cache hit, both bit-identical to
   raw; (d) scan(batched=True) ≡ sequential under preloaded and prefiltered
   (twice: cold, then from the store), and the six lineitem plans in one
   scan_group_batched pass over a shared DecodePool, each bit-identical to its
   own batched scan, in fewer launches than the six scans; (e) Q1's lineitem
   scan twice on preloaded stores holding a third and a sixteenth of its
   decoded bytes: bit-identical to raw, evictions, page hits on the second
   run, demotions to the encoded tier at a sixteenth, used <= capacity, and
   torch.cuda.memory_allocated() before and after clear() (the drop at least
   the store's decoded and prefiltered bytes); (f) CostModel.calibrate on
   the card at 2^18 and 2^24 values: source "calibrated" under the key
   "cuda", a failing calibration raising (no nominal fallback there), each
   encoding's rate and the launch overhead, a save/load round trip, and for
   each lineitem scan
   estimate_row_groups' bytes equal to its decoded_bytes_fresh, its
   estimated seconds printed beside the scan's device busy time;
S. the multi-tenant datapath service on each file order, after phase O,
   every launch count set to 0 at its start and read at its end: (a) the
   six queries through DatapathService(engine=DatapathEngine(device="cuda",
   cache=BlockCache(4 << 30))) with run_via_service, agreeing with phase 5's
   answers (agreement.compare), each query's lineitem scan through
   ServiceClient.scan bit-identical to the direct scan, wall ms beside phase
   5's; (b) six tenants submit the six lineitem plans (Q19's with its bloom)
   in one tick, drained with batch_decode=True and False: every ticket
   bit-identical to the direct scan, none failed; batched, the pod stacks
   (xreq_groups >= 1, no fall-back) in fewer launches than the six batched
   scans alone; drain wall ms, launches, fresh decoded bytes against the six
   scans', device busy ms and idle share (torch.profiler over one more
   drain); and phase 7(b)'s pushdown plans through one pod, bit-identical;
   (c) benchmarks/service_bench.py's skewed workload (one elephant, three
   mice, 1.5 elephant row groups of decoded bytes a tick) under FIFO and
   WFQ: bit-identical, the mice's p99 ticks and ms, the Jain index; (d)
   (b)'s submissions under tests/test_chaos_props.py's recoverable fault mix
   and retry policy, bit-identical to the clean run with no retries
   exhausted and every corruption caught, then a fail_forever plan on the
   part table with two part scans added: those end with a typed
   StorageFault, the lineitem ones bit-identical; the honesty invariant
   (sched + recon == actual, a failed slice's unreconciled charge counted)
   in both; (e) (c)'s WFQ run traced (sample rate 1) and untraced:
   bit-identical, the wall overhead ratio, the Chrome-trace event count and
   the trace's decode / filter / rest % beside phase O's; (f) a pod priced
   with phase O's calibrated table: costmodel_info backend "cuda", source
   "calibrated", honesty held;
8. print per (query, file order) wall time, peak device memory and, from
   torch.profiler, the device's busy time and idle share, and for every
   port kernel that ran (every __global__ function in kernels/csrc; always
   dict_decode_kernel) its self device time, launches and us a launch in
   situ, summed over its instantiations and per instantiation;
9. the LM serving path at the full width of qwen3-1.7b (28 layers, d_model
   2048, 16 heads, 8 kv heads of 128, d_ff 6144, vocab 151,936 padded to
   153,600; ~1.72 B bf16 parameters drawn by `init_params` from --seed),
   with every launch count set to 0 just before (a), (b)'s first engine and
   (d)'s entry-point calls and read just after them: (a) a 4096-token prompt
   through `prefill` bit-packed (k = 18, through the bitunpack kernel) and as
   tokens, bit-identical; (b) a ServeEngine of 4 slots drains requests of
   1024, 2048, 3072 and 4096 tokens with 32 new tokens each, a second engine
   gives the same tokens, decode at S agrees with the (S+1)-token prefill
   in bf16 and, with float32 weights from the same seed, in float32;
   it prints prefill ms per request, decode ms per tick, tokens/s, peak
   device memory and, from torch.profiler, one decode tick's idle share;
   (c) the config cut to 2 layers at float32 (TF32 off), the card against
   the CPU; (d) `ops.flash_attention` on layer 0's q, k, v of (a)'s prompt in
   bf16 (the wgmma route) and float32 (the CUDA-core route; the route tally
   must show one launch each) against `ref.mha` and the model's own
   `layers.attention`, then the kernel timed as phase 3 times one at that
   shape, at a stack of 4 prompts, in float32 and at gemma-7b's head dim
   (B 1, 16 heads, S 2048, D 256, bf16, random from --seed), each with its
   route, beside its bound (and the share of it), `ref.mha` and, as a
   yardstick the port never calls, torch's scaled_dot_product_attention (and
   the kernel's time over it);
10. print one JSON line with every kernel's record (its launches, summed over
   the counted windows of phases 5, 7, O and S on both file orders and of
   phase 9, must be > 0);
11. print the device line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BlockCache, DatapathEngine, agreement, tpch  # noqa: E402
from repro_torch.core import queries as Q  # noqa: E402
from repro_torch.core.plan import AggSpec, Cmp, ScanPlan, bind_expr  # noqa: E402
from repro_torch.core.zonemap import prune_row_groups  # noqa: E402
from repro_torch.datapath import (  # noqa: E402
    PAPER_FIG2_PCT,
    CostModel,
    DatapathService,
    DecodePool,
    FaultPlan,
    RetryPolicy,
    StaticPolicy,
    StorageFault,
)
from repro_torch.distributed.sharding import local_ctx  # noqa: E402
from repro_torch.kernels import agg_push, bitunpack, bloom_probe, build, delta_decode  # noqa: E402
from repro_torch.kernels import dict_decode, filter_compact, fused_scan  # noqa: E402
from repro_torch.kernels import ops, ref, rle_decode  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.lakeformat.encodings import bitpack_encode, rle_encode  # noqa: E402
from repro_torch.lakeformat.reader import LakeReader  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.models.transformer import _proj_qkv  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# The data sheet's 67e12 float32 FLOP/s is 128 FMA lanes per SM at 2
# operations each per clock.  Hopper has 64 lanes per SM for 32-bit integer
# add, shift, logic, compare and min/max, one operation each per clock, and
# issues warp shuffles at half that (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0): a quarter of the rate.
INT32_OPS_PER_S = 67e12 / 4
SF = 10.0  # the generator's scale for TPC-H SF1: 6,000,000 lineitem rows
PATH_BLOCKS = 16  # one row group in 4,096-value packed blocks
STACK_BLOCKS = 1472  # 92 row groups: all of SF1 lineitem's
RLE_PATH_BLOCKS = 64  # one row group in 1,024-value RLE / probe blocks
RLE_STACK_BLOCKS = 5888  # 92 row groups
PART_BLOCKS = 196  # the part table's 200,704 padded rows, Q19's compacted scan
WALK_BLOCKS = (5000, 1473)  # more than one wave of CTAs; not a multiple of the grid
# 32-bit integer issue slots per decoded value, counted from each kernel's
# source, on top of the k-bit unpack's 2 (a funnel shift and a mask; none for
# k = 32).  A shuffle takes 2 slots, as it issues at half the integer rate.
#   dict_decode     clip (max, min) and the entry's address
#   delta_decode    un-zigzag 3; per scan step (5) a shuffle and an add; the
#                   row offset's add
#   fused_scan      two compares, the mask byte, the survivor count; with a
#                   dictionary also its clip and the entry's address
#   rle_decode      per search step (7) the index add, the compare and the
#                   conditional add; the value's address
#   filter_compact  the mask test, the ballot, the lane mask's and, the
#                   popcount, the slot's add and the store's address, the
#                   zero-fill compare and the survivor's branch
#   bloom_probe     per key 21 + 5 per hash (csrc/bloom_probe.cu's note)
#   dict_decode_batch  as dict_decode (the page's size and row are per block)
#   fused_scan_batch   two compares and the mask byte
#   grouped_agg     every value: the mask test, the id's range test and
#                   their and, 3; every counted value on top: the float key
#                   2, the NaN test, min, max and the count, 6, or the hi/lo
#                   split 2, its two sums, min, max and the count, 7 (the
#                   warp reductions and cell updates are per pass or per
#                   group, not per value; the float add is not an integer
#                   operation)
#   fused_agg       the mask test, count, the hi/lo split and its 2 adds,
#                   min and max: 7
EXTRA_OPS_PER_VALUE = {"bitunpack": 0, "dict_decode": 3, "delta_decode": 3 + 5 * 3 + 1,
                       "fused_scan": 4, "fused_scan_dict": 4 + 3, "dict_decode_batch": 3,
                       "fused_scan_batch": 3, "fused_agg": 7}
GROUPED_AGG_OPS_PER_VALUE = 3
GROUPED_AGG_OPS_PER_COUNTED = {"float32": 6, "int32": 7}
RLE_OPS_PER_VALUE = 7 * 3 + 1
COMPACT_OPS_PER_VALUE = 8


def ops_per_value(name: str, k: int) -> int:
    return EXTRA_OPS_PER_VALUE[name] + (2 if k < 32 else 0)


def bloom_ops_per_key(n_hashes: int) -> int:
    return 21 + 5 * n_hashes


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header ("[n] ...") carries the seconds since start."""
    if msg.startswith("["):
        msg = f"{msg}  (t={time.perf_counter() - T0:.1f} s)"
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_words(rng, nb: int, k: int):
    w = rng.integers(0, 2**32, size=(nb, k, 128), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).cuda()


# Device cycles to spin before each timed call (~0.1 ms at the H100's
# 1.98 GHz boost clock): the card is still busy with the flush and the spin
# while the host enqueues the call, so the host's launch overhead (argument
# checks, output allocation) stays outside the event interval.
SPIN_CYCLES = 200_000


def median_ms(fn, iters: int, flush) -> float:
    """Median device time of one call of `fn`, each after an L2 flush and a
    device spin, after a few untimed calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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
    """0.0 when got and want are bit-identical (floats compared as bits, so
    NaN cells must match too); raises otherwise."""
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    same = (torch.equal(got.view(torch.int32), want.view(torch.int32))
            if got.dtype == torch.float32 else torch.equal(got, want))
    if not same:
        diff = (got.double() - want.double()).abs()
        raise AssertionError("kernel differs from its plain version (max |err| "
                             f"{float(diff.nan_to_num(float('inf')).max())})")
    return 0.0


def case(cases, name, label, blocks, run, plain, nbytes, nops, library=None, stage=None,
         done=None):
    """One timed comparison: `run` (the kernel) against `plain` (its plain
    version), with the bytes and integer operations its bound counts, and
    optionally one PyTorch call (`library`) and the engine stage around the
    kernel (`stage`) on the same inputs; `done`, if given, is called once the
    case is timed (to free what only its timing needed)."""
    cases.append({"name": name, "label": label, "blocks": blocks, "run": run,
                  "plain": plain, "bytes": nbytes, "ops": nops, "library": library,
                  "stage": stage, "done": done})


def kernel_cases(rng):
    """Every kernel's cases.  The first case of each kernel is its main-path
    shape, the second the 92-row-group stack; the rest are edge cases."""
    cases = []

    def packed_bytes(nb, k):
        return nb * k * 128 * 4

    # bitunpack: l_partkey at SF1 is BITPACK k=18
    for label, nb, k in [("path k=18", PATH_BLOCKS, 18), ("stack k=18", STACK_BLOCKS, 18),
                         ("k=1", PATH_BLOCKS, 1), ("k=31", PATH_BLOCKS, 31),
                         ("k=32", PATH_BLOCKS, 32)]:
        p = make_words(rng, nb, k)
        case(cases, "bitunpack", label, nb,
             lambda p=p, k=k: bitunpack.bitunpack(p, k),
             lambda p=p, k=k: ref.bitunpack(p, k),
             packed_bytes(nb, k) + nb * 4096 * 4, nb * 4096 * ops_per_value("bitunpack", k))

    # dict_decode: l_orderkey at SF1 is DICT k=14 with ~16.1K int entries
    # (63 KiB); l_shipdate is DICT k=12 over ~2.5K day numbers (q6 launches
    # it 92 times a query); l_discount is DICT k=4 over 11 floats.  One
    # PyTorch call, torch.take on codes already unpacked and clipped,
    # computes the lookup half alone: the yardstick.
    def dict_case(label, nb, k, d_len, dtype):
        p = make_words(rng, nb, k)
        if dtype == "float32":
            d = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32)).cuda()
        else:
            d = torch.from_numpy(rng.integers(-2**31, 2**31, d_len).astype(np.int32)).cuda()
        # the yardstick's int64 codes, made at its first call and freed once
        # the case is timed: held from here on, they shift where later cases'
        # tensors land (on an H100, a stack case's 48 MB moved
        # dict_decode_batch's stack time past run-to-run noise)
        codes = []

        def take():
            if not codes:
                codes.append(ref.bitunpack(p, k).clamp(0, d_len - 1).long())
            return torch.take(d, codes[0])

        case(cases, "dict_decode", label, nb,
             lambda: dict_decode.dict_decode(p, d, k),
             lambda: ref.dict_decode(p, d, k),
             packed_bytes(nb, k) + d_len * 4 + nb * 4096 * 4,
             nb * 4096 * ops_per_value("dict_decode", k), library=take, done=codes.clear)

    dict_case("path k=14 D=16143 (l_orderkey)", PATH_BLOCKS, 14, 16_143, "int32")
    dict_case("stack k=14 D=16143", STACK_BLOCKS, 14, 16_143, "int32")
    dict_case("k=4 D=11 float32", PATH_BLOCKS, 4, 11, "float32")
    dict_case("k=16 D=65536 (dict_encode's largest)", PATH_BLOCKS, 16, 65_536, "int32")
    dict_case("k=16 D=65536, stack", STACK_BLOCKS, 16, 65_536, "float32")
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
        case(cases, "delta_decode", label, nb,
             lambda: delta_decode.delta_decode(p, b, k),
             lambda: ref.delta_decode(p, b, k),
             packed_bytes(nb, k) + nb * 4 + nb * 4096 * 4,
             nb * 4096 * ops_per_value("delta_decode", k))

    delta_case("path k=2", PATH_BLOCKS, 2, False)
    delta_case("stack k=2", STACK_BLOCKS, 2, False)
    delta_case("k=30 wraparound", PATH_BLOCKS, 30, True)
    delta_case("k=31 wraparound", PATH_BLOCKS, 31, True)
    delta_case("k=32 wraparound", PATH_BLOCKS, 32, True)

    # fused_scan: l_shipdate codes at SF1 are DICT k=12; Q1 keeps codes <= 2466.
    # The dictionary arm (not on the engine's path) with int32 and float32
    # dictionaries whose codes run past their end.
    def fused_scan_case(label, nb, k, lo, hi, d_len, dtype):
        p = make_words(rng, nb, k)
        d = None
        if dtype == "int32":
            d = torch.from_numpy(np.sort(rng.integers(0, 2557, d_len)).astype(np.int32)).cuda()
        elif dtype == "float32":
            d = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32)).cuda()
        case(cases, "fused_scan", label, nb,
             lambda: fused_scan.fused_scan(p, k, lo, hi, d),
             lambda: ref.fused_scan(p, k, lo, hi, d),
             packed_bytes(nb, k) + nb * 4096 + nb * 4 + d_len * 4,
             nb * 4096 * ops_per_value("fused_scan" if d is None else "fused_scan_dict", k))

    for args in [
            ("path k=12", PATH_BLOCKS, 12, 0, 2466, 0, None),
            ("stack k=12", STACK_BLOCKS, 12, 1000, 1029, 0, None),
            ("k=1 full", PATH_BLOCKS, 1, 0, 1, 0, None),
            ("k=12 empty", PATH_BLOCKS, 12, 1, 0, 0, None),
            ("k=32 negative", PATH_BLOCKS, 32, -2**31, -1, 0, None),
            ("dictionary arm k=12 D=2557 int32", PATH_BLOCKS, 12, 365, 729, 2557, "int32"),
            ("dictionary arm k=4 D=11 float32", PATH_BLOCKS, 4, 0, 0, 11, "float32"),
            ("dictionary arm k=12 D=3000 float32, stack", STACK_BLOCKS, 12, -1, 1, 3000,
             "float32")]:
        fused_scan_case(*args)

    # rle_decode: sorted l_shipdate at SF1, 2,346 rows a day, is one or two
    # runs per block; the writer's own encoder makes those pages.  Then
    # random windows of up to 128 runs (positions on a run's end included),
    # exactly 128 runs, one run per block, float32 runs.
    def rle_pages(values):
        bufs = rle_encode(values)
        return (torch.from_numpy(bufs["rle_values"]).cuda(),
                torch.from_numpy(bufs["rle_ends"]).cuda())

    def rle_case(label, nb, vals, ends):
        case(cases, "rle_decode", label, nb,
             lambda: rle_decode.rle_decode(vals, ends),
             lambda: ref.rle_decode(vals, ends),
             nb * (512 + 512 + 4096), nb * 1024 * RLE_OPS_PER_VALUE)

    for label, nb in [("path: sorted dates, 1-2 runs a block", RLE_PATH_BLOCKS),
                      ("stack: sorted dates", RLE_STACK_BLOCKS)]:
        days = nb * 1024 // 2346 + 1
        dates = np.sort(rng.integers(0, days, nb * 1024)).astype(np.int32)
        rle_case(label, nb, *rle_pages(dates))

    def random_windows(nb, dtype, runs=None):
        if runs is None:
            ends = np.sort(rng.integers(0, 1025, (nb, 128)), axis=1)
        else:
            ends = np.broadcast_to(np.minimum(np.arange(1, 129) * (1024 // runs), 1024), (nb, 128))
        vals = (rng.standard_normal((nb, 128)).astype(np.float32) if dtype == "float32"
                else rng.integers(-2**31, 2**31, (nb, 128)).astype(np.int32))
        return (torch.from_numpy(vals).cuda(),
                torch.from_numpy(np.ascontiguousarray(ends, dtype=np.int32)).cuda())

    rle_case("random windows int32", RLE_PATH_BLOCKS, *random_windows(RLE_PATH_BLOCKS, "int32"))
    rle_case("random windows float32 (bits)", RLE_PATH_BLOCKS,
             *random_windows(RLE_PATH_BLOCKS, "float32"))
    rle_case("exactly 128 runs", RLE_PATH_BLOCKS,
             *random_windows(RLE_PATH_BLOCKS, "int32", runs=128))
    rle_case("one run per block", RLE_PATH_BLOCKS,
             *random_windows(RLE_PATH_BLOCKS, "float32", runs=1))

    # filter_compact: Q19's part scan keeps ~0.6% of 200,000 parts, int32
    # keys; then the stack, all/none/last-row masks, int32 beyond +-2^24
    # (negative too) and float32.  One PyTorch call, masked_select over the
    # flat column, computes what the kernel and the engine's stitch produce
    # together (less the zero fill): it is the yardstick of the `_compact`
    # stage, timed beside it, not of the kernel alone.
    engine = DatapathEngine(device="cuda")

    def compact_case(label, nb, values, mask):
        flat_v, flat_m = values.reshape(-1), mask.reshape(-1)
        case(cases, "filter_compact", label, nb,
             lambda: filter_compact.filter_compact(values, mask),
             lambda: ref.filter_compact(values, mask),
             nb * (4096 + 1024 + 4096 + 4), nb * 1024 * COMPACT_OPS_PER_VALUE,
             library=lambda: torch.masked_select(flat_v, flat_m),
             stage=lambda: engine._compact({"c": flat_v}, flat_m))

    def ints(nb):
        return torch.from_numpy(rng.integers(-2**31, 2**31, (nb, 1024)).astype(np.int32)).cuda()

    def bern(nb, p):
        return torch.from_numpy(rng.random((nb, 1024)) < p).cuda()

    compact_case("path: part keys, 0.6% kept", PART_BLOCKS, ints(PART_BLOCKS),
                 bern(PART_BLOCKS, 0.006))
    compact_case("stack, 30% kept", RLE_STACK_BLOCKS, ints(RLE_STACK_BLOCKS),
                 bern(RLE_STACK_BLOCKS, 0.3))
    full = torch.ones((PART_BLOCKS, 1024), dtype=torch.bool, device="cuda")
    compact_case("all kept", PART_BLOCKS, ints(PART_BLOCKS), full)
    compact_case("none kept", PART_BLOCKS, ints(PART_BLOCKS), ~full)
    last = ~full
    last[:, -1] = True
    compact_case("last row only", PART_BLOCKS, ints(PART_BLOCKS), last)
    compact_case("float32, 50% kept", PART_BLOCKS,
                 torch.from_numpy(rng.standard_normal((PART_BLOCKS, 1024)).astype(np.float32)
                                  ).cuda(), bern(PART_BLOCKS, 0.5))

    # bloom_probe: Q19 probes l_partkey (in [0, 200,000)) against a 2^15-byte
    # filter of the ~1,200 part keys its build scan keeps, with 4 hashes
    def bloom_case(label, nb, n_bits, n_hashes, keys, build_keys):
        bits = ref.bloom_build(build_keys, n_bits, n_hashes)
        member = ref.bloom_probe(build_keys, bits, n_hashes)
        if not bool(member.all()):
            raise AssertionError(f"bloom {label}: a build key is not in its own filter")
        case(cases, "bloom_probe", label, nb,
             lambda: bloom_probe.bloom_probe(keys, bits, n_hashes),
             lambda: ref.bloom_probe(keys, bits, n_hashes),
             nb * 1024 * 5 + n_bits, nb * 1024 * bloom_ops_per_key(n_hashes))

    def part_keys(nb):
        return torch.from_numpy(rng.integers(0, 200_000, (nb, 1024)).astype(np.int32)).cuda()

    build_keys = torch.from_numpy(rng.choice(200_000, 1_200, replace=False).astype(np.int32)).cuda()
    bloom_case("path n_bits=2^15 h=4", RLE_PATH_BLOCKS, 1 << 15, 4,
               part_keys(RLE_PATH_BLOCKS), build_keys)
    bloom_case("stack n_bits=2^15 h=4", RLE_STACK_BLOCKS, 1 << 15, 4,
               part_keys(RLE_STACK_BLOCKS), build_keys)
    edge = ints(RLE_PATH_BLOCKS)
    edge[0, :4] = torch.tensor([-2**31, 2**31 - 1, 0, -1], dtype=torch.int32)
    edge_build = edge[0, :512].contiguous()  # keys at +-2^31 among them
    bloom_case("n_bits=2^17 (shared-memory maximum) h=7", RLE_PATH_BLOCKS, 1 << 17, 7,
               edge, edge_build)
    bloom_case("n_bits=2^10 h=1", RLE_PATH_BLOCKS, 1 << 10, 1, edge, edge_build)

    # dict_decode_batch: l_orderkey at SF1 is DICT k=14, one dictionary of
    # ~16.1K entries per row group; the stack holds 92 pages of 16 blocks.
    # Then pages of different sizes with a size of 0, a dictionary too large
    # for shared memory, float32 dictionaries and negative k = 32 codes.  The
    # yardstick, as dict_decode's: torch.take of the flattened (P, Dmax)
    # dictionaries at page * Dmax + the clipped code, the lookup half alone
    # (its int64 indices made at its first call, freed once the case is timed).
    def dict_batch_case(label, k, sizes, nbs, dtype):
        dmax = max(max(sizes), 1)
        if dtype == "float32":
            d = torch.from_numpy(rng.standard_normal((len(sizes), dmax)).astype(np.float32))
        else:
            d = torch.from_numpy(rng.integers(-2**31, 2**31, (len(sizes), dmax)).astype(np.int32))
        d = d.cuda()
        sz = torch.tensor(sizes, dtype=torch.int32).cuda()
        pg = torch.from_numpy(np.concatenate([np.full(nb, i, np.int32)
                                              for i, nb in enumerate(nbs)])).cuda()
        nb = sum(nbs)
        p = make_words(rng, nb, k)
        flat = []

        def take():
            if not flat:
                page = pg.long().clamp(0, len(sizes) - 1)[:, None, None]
                last = sz.long().clamp(1, dmax)[page] - 1
                code = torch.minimum(ref.bitunpack(p, k).long().clamp(min=0), last)
                flat.append(page * dmax + code)
            return torch.take(d, flat[0])

        case(cases, "dict_decode_batch", label, nb,
             lambda: dict_decode.dict_decode_batch(p, d, sz, pg, k),
             lambda: ref.dict_decode_batch(p, d, sz, pg, k),
             packed_bytes(nb, k) + nb * 4096 * 4 + 4 * sum(sizes) + 4 * nb + 4 * len(sizes),
             nb * 4096 * ops_per_value("dict_decode_batch", k), library=take, done=flat.clear)

    dict_batch_case("path k=14 D=16143, 1 page", 14, [16_143], [PATH_BLOCKS], "int32")
    stack_sizes = [int(x) for x in rng.integers(16_000, 16_385, 92)]
    dict_batch_case("stack k=14 D~16.1K, 92 pages", 14, stack_sizes, [PATH_BLOCKS] * 92, "int32")
    dict_batch_case("k=3 sizes 5/0/8/1 (0 reads entry 0)", 3, [5, 0, 8, 1], [4, 4, 4, 4], "int32")
    dict_batch_case("k=16 D=65536 (too large for shared), float32", 16, [65_536, 40_000, 3],
                    [6, 5, 5], "float32")
    dict_batch_case("k=32 D=40/7 (negative codes)", 32, [40, 7], [8, 8], "int32")

    # fused_scan_batch: l_shipdate codes at SF1 are DICT k=12, rewritten per
    # row group onto that page's codes; the stack carries 92 ranges.  Then
    # per-block empty ranges (1, 0) and k = 1, 32.
    def scan_batch_case(label, k, lo, hi):
        nb = len(lo)
        p = make_words(rng, nb, k)
        lo_t = torch.from_numpy(np.asarray(lo, np.int32)).cuda()
        hi_t = torch.from_numpy(np.asarray(hi, np.int32)).cuda()
        case(cases, "fused_scan_batch", label, nb,
             lambda: fused_scan.fused_scan_batch(p, k, lo_t, hi_t),
             lambda: ref.fused_scan_batch(p, k, lo_t, hi_t),
             packed_bytes(nb, k) + nb * 4096 + nb * 8,
             nb * 4096 * ops_per_value("fused_scan_batch", k))

    scan_batch_case("path k=12", 12, [0] * PATH_BLOCKS, [2466] * PATH_BLOCKS)
    starts = np.repeat(rng.integers(0, 4000, 92), PATH_BLOCKS)
    scan_batch_case("stack k=12, 92 per-row-group ranges", 12, starts, starts + 364)
    scan_batch_case("k=12 every other block empty (1, 0)", 12,
                    [0, 1] * (PATH_BLOCKS // 2), [4095, 0] * (PATH_BLOCKS // 2))
    scan_batch_case("k=1 full/empty", 1, [0, 1] * (PATH_BLOCKS // 2), [1, 0] * (PATH_BLOCKS // 2))
    scan_batch_case("k=32 negative ranges", 32, [-2**31] * PATH_BLOCKS, [-1] * PATH_BLOCKS)

    # grouped_agg: sum(l_extendedprice), count(*) by l_returnflag at SF1 is
    # float32 values, 3 groups, int32 gids and the scan's bool mask (Q6's
    # date year keeps ~15%).  One PyTorch call, scatter_add of the float
    # values into (block, group) cells with the mask folded into the index
    # beforehand, computes the s0 plane alone (in another order): the
    # yardstick, not the same five planes.
    def agg_case(label, nb, G, dtype, keep=0.15, mask_dtype=torch.bool, edges=False, shift=0):
        if dtype == "float32":
            v = (rng.random((nb, 4096)) * 1e5).astype(np.float32)
            if edges:
                v[0, :3] = [np.inf, -np.inf, -0.0]
                v[min(1, nb - 1), 7] = np.nan
        else:
            v = rng.integers(-2**31, 2**31, (nb, 4096)).astype(np.int32)
            if edges:
                v[0, :4] = [-2**31, 2**31 - 1, -1, 0]
        g = rng.integers(-1 if edges else 0, G + 1 if edges else G, (nb, 4096)).astype(np.int32)
        g += shift
        m = rng.random((nb, 4096)) < keep
        if edges:
            m[0, :4] = True
            m[-1] = False
        vt, gt = torch.from_numpy(v).cuda(), torch.from_numpy(g).cuda()
        mt = torch.from_numpy(m).to(mask_dtype).cuda()
        library = None
        if dtype == "float32" and not edges:
            idx = torch.where(mt.bool() & (gt >= 0) & (gt < G), gt, G).long()
            zeros = torch.zeros((nb, G + 1), dtype=torch.float32, device="cuda")
            library = lambda: zeros.scatter_add(1, idx, vt)  # noqa: E731
        counted = int((m & (g >= 0) & (g < G)).sum())
        case(cases, "grouped_agg", label, nb,
             lambda: agg_push.grouped_agg(vt, gt, mt, G),
             lambda: ref.grouped_agg(vt, gt, mt, G),
             nb * 4096 * (4 + 4 + mt.element_size()) + 5 * 4 * nb * G,
             nb * 4096 * GROUPED_AGG_OPS_PER_VALUE
             + counted * GROUPED_AGG_OPS_PER_COUNTED[dtype], library=library)

    agg_case("path G=3 float32, bool mask", PATH_BLOCKS, 3, "float32")
    agg_case("stack G=3 float32, bool mask", STACK_BLOCKS, 3, "float32")
    agg_case("stack G=3 float32, int32 mask", STACK_BLOCKS, 3, "float32", mask_dtype=torch.int32)
    agg_case("G=1 int32 +-2^31, gids out of range, all-masked block", PATH_BLOCKS, 1, "int32",
             keep=0.7, edges=True)
    agg_case("G=3 int32, int32 mask, edges", PATH_BLOCKS, 3, "int32", keep=0.7,
             mask_dtype=torch.int32, edges=True)
    agg_case("G=128 float32 +-inf NaN -0.0, edges", PATH_BLOCKS, 128, "float32", keep=0.7,
             edges=True)
    agg_case("G=128 float32, stack", STACK_BLOCKS, 128, "float32", keep=0.7)
    # ids shifted below the window, as in 16 of phase 7's 20 windows
    agg_case("G=128 float32, stack, no counted row", STACK_BLOCKS, 128, "float32", keep=0.7,
             shift=-4 * 128)
    agg_case("G=1 int32, stack", STACK_BLOCKS, 1, "int32", keep=0.7)

    # fused_agg: sum/min/max(l_quantity) at SF1, BITPACK k=6, under the
    # scan's bool mask; then k = 1, 32 and an int32 mask.  No PyTorch call
    # unpacks k-bit words.
    def fused_agg_case(label, nb, k, mask_dtype=torch.bool):
        p = make_words(rng, nb, k)
        m = torch.from_numpy(rng.random((nb, 4096)) < 0.15).to(mask_dtype).cuda()
        m[-1] = 0
        case(cases, "fused_agg", label, nb,
             lambda: agg_push.fused_agg(p, k, m),
             lambda: ref.fused_agg_scan(p, k, m),
             packed_bytes(nb, k) + nb * 4096 * m.element_size() + nb * 20,
             nb * 4096 * ops_per_value("fused_agg", k))

    fused_agg_case("path k=6, bool mask", PATH_BLOCKS, 6)
    fused_agg_case("stack k=6, bool mask", STACK_BLOCKS, 6)
    fused_agg_case("stack k=6, int32 mask", STACK_BLOCKS, 6, torch.int32)
    fused_agg_case("k=1", PATH_BLOCKS, 1)
    fused_agg_case("k=32 (int32 range)", PATH_BLOCKS, 32)

    # dict_decode's l_shipdate case, last so that every case above draws the
    # same inputs from the seed as before it
    dict_case("path k=12 D=2557 (l_shipdate)", PATH_BLOCKS, 12, 2_557, "int32")

    # fused_scan's and fused_scan_batch's grid-stride walk, after every older
    # case for the same reason: more blocks than one wave of CTAs holds, and a
    # block count that is not a multiple of the grid; the batch with ragged
    # per-block ranges, every seventh block the empty (1, 0)
    for nb in WALK_BLOCKS:
        fused_scan_case(f"walk: {nb} blocks k=12", nb, 12, 1000, 1029, 0, None)
    for nb in WALK_BLOCKS:
        lo = rng.integers(0, 4000, nb)
        hi = lo + rng.integers(0, 400, nb)
        lo[::7], hi[::7] = 1, 0
        scan_batch_case(f"walk: {nb} blocks k=12, ragged ranges", 12, lo, hi)

    # dict_decode_batch at the bucket phase 7 launches most, after every older
    # case for the same reason: Q1's l_discount and l_tax together, DICT k=4
    # over 11 and 9 float32 entries, 92 row groups each (2,944 blocks)
    dict_batch_case("k=4 D=11/9 float32, 184 pages (Q1's bucket)", 4, [11, 9] * 92,
                    [PATH_BLOCKS] * 184, "float32")

    # fused_agg's and filter_compact's grid-stride walks, after every older
    # case for the same reason: more blocks than one wave of CTAs holds, and a
    # block count that is not a multiple of the grid
    for nb in WALK_BLOCKS:
        fused_agg_case(f"walk: {nb} blocks k=6, bool mask", nb, 6)
    for nb in WALK_BLOCKS:
        compact_case(f"walk: {nb} blocks, 30% kept", nb, ints(nb), bern(nb, 0.3))
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
    for c in kernel_cases(rng):
        name, nb = c["name"], c["blocks"]
        err = max_abs_err(c["run"](), c["plain"]())
        torch.cuda.synchronize()
        iters = 10 if nb >= STACK_BLOCKS else 30
        ms = median_ms(c["run"], iters, flush)
        plain_ms = median_ms(c["plain"], max(3, iters // 3), flush)
        library_ms = median_ms(c["library"], iters, flush) if c["library"] else None
        stage_ms = median_ms(c["stage"], iters, flush) if c["stage"] else None
        if c["done"]:
            c["done"]()
        bytes_ms = c["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = c["ops"] / INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        extra = "" if library_ms is None else f" library_ms={library_ms:.4f}"
        extra += "" if stage_ms is None else f" stage_ms={stage_ms:.4f}"
        log(f"  {name:14s} {c['label']:44s} blocks={nb:5d} exact (max|err|={err}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({c['bytes']} B, {c['ops']} ops, by {bound_by}){extra}")
        rec = records.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append({"label": c["label"], "blocks": nb, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": library_ms, "stage_ms": stage_ms})
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


def port_kernel_functions() -> tuple:
    """The names of the port's CUDA kernels (every __global__ function in
    kernels/csrc), as torch.profiler's kernel names carry them."""
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            for hit in re.finditer(r"__global__\s+void\s+", text):
                rest = text[hit.end():]
                if rest.startswith("__launch_bounds__"):
                    # skip its arguments, however deep their parentheses nest
                    depth = 0
                    for i, ch in enumerate(rest):
                        depth += (ch == "(") - (ch == ")")
                        if ch == ")" and depth == 0:
                            break
                    rest = rest[i + 1:]
                names.add(re.match(r"\s*(\w+)\s*\(", rest).group(1))
    return tuple(sorted(names))


PORT_KERNELS = port_kernel_functions()


def port_kernel_of(key: str):
    """(name, its template arguments "<K, ...>" or "") of the port kernel
    that a torch.profiler key names, or None for any other kernel."""
    for name in PORT_KERNELS:
        hit = re.search(rf"(?<!\w){name}(<[^>]*>)?\(", key)
        if hit:
            return name, hit.group(1) or ""
    return None


def profiled(fn):
    """One call of `fn` under torch.profiler: the device's busy time (the sum
    of the self time of every CUDA kernel and copy), its four largest items
    and, for each of the port's kernels that ran, (self ms, launches) summed
    over its instantiations and those of each instantiation ("<K, ...>").
    The profiler slows the host side, so the wall time it sees is not used."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
    kernels = {}
    for e in dev:
        hit = port_kernel_of(e.key)
        if hit:
            name, args = hit
            ms, n, each = kernels.get(name, (0.0, 0, []))
            each.append((args, round(e.self_device_time_total / 1e3, 3), e.count))
            kernels[name] = (ms + e.self_device_time_total / 1e3, n + e.count, each)
    return busy_ms, [(e.key[:60], round(e.self_device_time_total / 1e3, 3), e.count)
                     for e in top], kernels


def device_busy(engine, readers, queries) -> dict:
    """Per query: `profiled` of one more run."""
    return {name: profiled(lambda q=q: q(engine, readers)) for name, q in queries.items()}


def log_in_situ(prefix: str, kernels: dict, always=()) -> None:
    """One line per port kernel in `profiled`'s result (and per name in
    `always`, ran or not): self ms, launches and us a launch, summed over its
    instantiations and per instantiation."""
    for kern in sorted(set(kernels) | set(always)):
        k_ms, k_n, each = kernels.get(kern, (0.0, 0, []))
        per = f"{k_ms / k_n * 1e3:.2f}" if k_n else "-"
        log(f"      {prefix}: {kern} (every instantiation): self_ms={k_ms:.3f} "
            f"launches={k_n} us_per_launch={per}; by instantiation "
            f"(<K, ...>, self ms, launches): {each}")


# ---------------------------------------------------------------------------
# phase 7: batched scans and aggregate pushdown
# ---------------------------------------------------------------------------

# benchmarks/throughput.py's two pushdown plans, and a sum grouped over a
# domain wider than one launch's MAX_GROUPS (l_shipdate's ~2,527 day numbers:
# 20 windows)
PUSHDOWN_PLANS = {
    "sum_price_count_by_returnflag": ScanPlan(
        "lineitem", [], Cmp("l_shipdate", "between", (365, 729)),
        aggregates=(AggSpec("sum", "l_extendedprice"), AggSpec("count")),
        group_by="l_returnflag"),
    "sum_min_max_quantity": ScanPlan(
        "lineitem", [], Cmp("l_shipdate", "between", (365, 729)),
        aggregates=(AggSpec("sum", "l_quantity"), AggSpec("min", "l_quantity"),
                    AggSpec("max", "l_quantity"))),
    "sum_price_count_by_shipdate": ScanPlan(
        "lineitem", [], Cmp("l_shipdate", "between", (365, 729)),
        aggregates=(AggSpec("sum", "l_extendedprice"), AggSpec("count")),
        group_by="l_shipdate"),
}


def timed_scan(engine, reader, plan, blooms, batched: bool):
    """One scan on the card: (result, wall ms after synchronize, dispatches,
    host-to-device copies)."""
    ops.reset_dispatch_count()
    ops.reset_transfer_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.scan(reader, plan, blooms=blooms, batched=batched)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3, ops.dispatch_count(), ops.transfer_count()


def same_rows(a, b, label: str) -> None:
    """Two row scans equal in columns (floats as bits), mask and count;
    raises otherwise."""
    if not (torch.equal(a.mask, b.mask) and int(a.count) == int(b.count)):
        raise AssertionError(f"{label}: mask/count differ")
    if sorted(a.columns) != sorted(b.columns):
        raise AssertionError(f"{label}: columns differ: {sorted(a.columns)} {sorted(b.columns)}")
    for c in a.columns:
        x, y = a.columns[c], b.columns[c]
        if x.dtype != y.dtype or not torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                                                 else x,
                                                 y.view(torch.int32) if y.dtype == torch.float32
                                                 else y):
            raise AssertionError(f"{label}: column {c} differs")


def same_scan(a, b, label: str) -> None:
    """Two row scans equal in columns (floats as bits), mask, count and every
    ScanStats field but kernel_launches; raises otherwise."""
    same_rows(a, b, label)
    sa, sb = dataclasses.asdict(a.stats), dataclasses.asdict(b.stats)
    sa.pop("kernel_launches"), sb.pop("kernel_launches")
    if sa != sb:
        raise AssertionError(f"{label}: ScanStats differ: "
                             f"{ {k: (sa[k], sb[k]) for k in sa if sa[k] != sb[k]} }")


def path_numbers(runs) -> str:
    """Each path's warm ms (with the runs it is the median of, where there
    are several), dispatches, copies and launches."""
    return " ".join(f"{'batched' if b else 'sequential'}: warm_ms={ms:.2f} "
                    + (f"(median of {[round(x, 2) for x in rest[0]]}) " if rest else "")
                    + f"dispatches={dispatches} h2d_copies={copies} "
                    f"kernel_launches={res.stats.kernel_launches};"
                    for b, (res, ms, dispatches, copies, *rest) in runs.items())


def batched_and_pushdown(gpu, cpu, readers, order: str) -> dict:
    """Phase 7 on one file order: checks, and prints each plan's numbers.
    Returns the kernel launches of the warm sequential and batched scans
    alone: the counts are set to 0 just before those scans and read just
    after, so Q19's bloom build, the first runs, the comparators and the
    profiler's reruns launch outside that window."""
    li = readers["lineitem"]
    bloom = Q.q19_bloom(gpu, readers)
    scans = {("a", name): (make(), {"q19": bloom} if name == "q19" else None)
             for name, make in Q.LINEITEM_PLANS.items()}
    scans.update({("b", name): (plan, None) for name, plan in PUSHDOWN_PLANS.items()})
    for plan, blooms in scans.values():  # first runs
        for batched in (False, True):
            gpu.scan(li, plan, blooms=blooms, batched=batched)
    ops.reset_kernel_launches()
    warm = {key: {batched: timed_scan(gpu, li, plan, blooms, batched)
                  for batched in (False, True)}
            for key, (plan, blooms) in scans.items()}
    launches = ops.kernel_launches()
    # (b)'s plans twice more on each path, outside the counted window: one
    # host-bound run spreads by tens of percent, so their warm ms is the
    # median of three
    for (part, name), runs in warm.items():
        if part == "b":
            plan, blooms = scans[part, name]
            for b, (res, ms, dispatches, copies) in list(runs.items()):
                all_ms = [ms] + [timed_scan(gpu, li, plan, blooms, b)[1] for _ in range(2)]
                runs[b] = (res, sorted(all_ms)[1], dispatches, copies, all_ms)

    in_situ = {}  # kernel -> path -> [self ms, launches] over every profiled scan
    for (part, name), runs in warm.items():
        plan, blooms = scans[part, name]
        busy = {b: profiled(lambda b=b: gpu.scan(li, plan, blooms=blooms, batched=b))
                for b in runs}
        busy_numbers = " ".join(
            f"{'batched' if b else 'sequential'}: busy_ms={busy_ms:.3f} "
            f"idle_share={1 - busy_ms / runs[b][1]:.3f} top={top[:2]};"
            for b, (busy_ms, top, _) in busy.items())
        if part == "a":
            same_scan(runs[True][0], runs[False][0], f"{order} {name}")
            log(f"      (a) {name}: rows={int(runs[True][0].count)} " + path_numbers(runs)
                + " " + busy_numbers)
        else:
            want = agreement.scan_then_aggregate(gpu, li, plan)
            cpu_aggs = cpu.scan(li, plan, batched=True).aggregates
            for batched, r in runs.items():
                got = r[0].aggregates
                for k in want:
                    if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]):
                        raise AssertionError(f"{order} {name} batched={batched}: {k} differs "
                                             f"from scan-then-aggregate: {got[k]} vs {want[k]}")
                    # both add in the kernel's fixed float order, so the card's
                    # float sums are the CPU path's bit for bit
                    if not np.array_equal(got[k], cpu_aggs[k]):
                        raise AssertionError(f"{order} {name} batched={batched}: {k} differs "
                                             f"from the CPU: {got[k]} vs {cpu_aggs[k]}")
            shown = {k: (v.tolist() if v.size <= 8 else f"{v.size} groups, total {v.sum()}")
                     for k, v in want.items()}
            log(f"      (b) {name}: {shown} bit-identical to the CPU path: True; "
                + path_numbers(runs) + " " + busy_numbers)
        for b, (_, _, kernels) in busy.items():
            path = "batched" if b else "sequential"
            log_in_situ(f"({part}) {name} {path}", kernels)
            for kern, (k_ms, k_n, _) in kernels.items():
                tot = in_situ.setdefault(kern, {}).setdefault(path, [0.0, 0])
                tot[0] += k_ms
                tot[1] += k_n
    log(f"      {order}: in situ over phase 7's profiled scans (kernel: path, self ms, "
        "launches, us a launch): " + "; ".join(
            f"{kern}: " + ", ".join(f"{path} {ms:.3f} {n} {ms / n * 1e3:.2f}"
                                    for path, (ms, n) in sorted(paths.items()))
            for kern, paths in sorted(in_situ.items())))
    return launches


# ---------------------------------------------------------------------------
# phase O: the paper's offload configurations
# ---------------------------------------------------------------------------

OFFLOAD_MODES = ("raw", "preloaded", "prefiltered")
STORE_BYTES = 4 << 30  # benchmarks/breakdown.py's BlockCache(4 << 30)
# (e): stores holding a third and a sixteenth of Q1's decoded lineitem
# columns.  At a third the encoded pages all stay (they price higher per byte
# than the decodes), so nothing demotes; at a sixteenth pages go too, and a
# decode whose page went first demotes to it.
PRESSURE_SHARES = (3, 16)
# (f): calibration sizes, the cost model's default (2^18 values, whose decode
# takes about as long as one launch on the card) and 2^24
CALIBRATION_N = (1 << 18, 1 << 24)


def wall(fn):
    """(fn(), wall ms between two synchronizes)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def median3(fn):
    """(the last of three calls' results, their median wall ms)."""
    runs = [wall(fn) for _ in range(3)]
    return runs[-1][0], sorted(m for _, m in runs)[1]


def fig2(t_raw: float, t_pre: float, t_filt: float) -> tuple:
    """benchmarks/breakdown.py's decode%, filter% and rest% of one query."""
    decode = max(0.0, (t_raw - t_pre) / t_raw * 100)
    filt = max(0.0, (t_pre - t_filt) / t_raw * 100)
    return decode, filt, 100 - decode - filt


def offload_configurations(readers, order: str, tmpdir: str, device: str = "cuda"):
    """Phase O on one file order: (a) Fig. 2's three configurations, (b) the
    host baseline, (c) pre-aggregated, (d) batched forms and cross-request
    stacking, (e) the store under pressure, (f) the cost model.  Every
    launch count is set to 0 at its start and read at its end: every launch
    in it is on one of these paths (the comparators run on the CPU).
    Returns those counts, (a)'s average decode% / filter% / rest% and (f)'s
    calibrated table (the larger size's)."""
    li = readers["lineitem"]
    per_supp = agreement.per_supplier_revenue(li)
    ops.reset_kernel_launches()

    # (a) Fig. 2: raw, preloaded and prefiltered; the cached two warmed with
    # one pass of the six queries, as benchmarks/breakdown.py does, and each
    # CPU twin given the same history
    gpu = {m: DatapathEngine(device=device, offload=m, cache=BlockCache(STORE_BYTES))
           for m in OFFLOAD_MODES}
    cpu = {m: DatapathEngine(device="cpu", offload=m, cache=BlockCache(STORE_BYTES))
           for m in OFFLOAD_MODES}
    for m in OFFLOAD_MODES[1:]:
        for q in Q.QUERIES.values():
            q(gpu[m], readers)
            q(cpu[m], readers)
    got, ms = {}, {}
    for m in OFFLOAD_MODES:
        for name, q in Q.QUERIES.items():
            got[m, name], ms[m, name] = median3(lambda q=q, m=m: q(gpu[m], readers))
    log(f"      (a) {order}: Fig. 2 on the card (warm wall ms, median of three; decode% = "
        "(raw - preloaded) / raw, filter% = (preloaded - prefiltered) / raw; paper 46 / 17):")
    pcts = []
    for name in Q.QUERIES:
        for m in OFFLOAD_MODES[1:]:
            agreement.compare(name, got[m, name], got["raw", name], per_supp)
        pct = fig2(*(ms[m, name] for m in OFFLOAD_MODES))
        pcts.append(pct)
        log(f"      (a) {name}: raw_ms={ms['raw', name]:.2f} preloaded_ms="
            f"{ms['preloaded', name]:.2f} prefiltered_ms={ms['prefiltered', name]:.2f} "
            f"decode%={pct[0]:.1f} filter%={pct[1]:.1f} rest%={pct[2]:.1f}; preloaded and "
            "prefiltered agree with raw")
    avg = [sum(p[i] for p in pcts) / len(pcts) for i in range(3)]
    log(f"      (a) {order} average: decode%={avg[0]:.1f} filter%={avg[1]:.1f} "
        f"rest%={avg[2]:.1f} (paper: 46 / 17 / 37)")
    bloom = Q.q19_bloom(gpu["raw"], readers)
    cbloom = Q.q19_bloom(cpu["raw"], readers)
    scans = {name: (make(), {"q19": bloom} if name == "q19" else None,
                    {"q19": cbloom} if name == "q19" else None)
             for name, make in Q.LINEITEM_PLANS.items()}
    for name, (plan, blooms, cblooms) in scans.items():
        res = {}
        for m in OFFLOAD_MODES:
            res[m] = gpu[m].scan(li, plan, blooms=blooms)
            want = dataclasses.asdict(cpu[m].scan(li, plan, blooms=cblooms).stats)
            have = dataclasses.asdict(res[m].stats)
            if have != want:
                raise AssertionError(f"{order} {name} {m}: ScanStats differ from the CPU engine's: "
                                     f"{ {k: (have[k], want[k]) for k in have if have[k] != want[k]} }")
        for m in OFFLOAD_MODES[1:]:
            same_rows(res[m], res["raw"], f"{order} {name} lineitem scan {m} against raw")
        log(f"      (a) {name} lineitem scan: rows={int(res['raw'].count)} bit-identical in the "
            "three modes, ScanStats equal to the CPU engine's; " + " ".join(
                f"{m}: cache_hit={res[m].stats.cache_hit} decoded_bytes_fresh="
                f"{res[m].stats.decoded_bytes_fresh} kernel_launches={res[m].stats.kernel_launches};"
                for m in OFFLOAD_MODES))

    # (b) the host baseline: numpy decode on the host, the rest on the card
    host = DatapathEngine(device=device, backend="host")
    line = []
    for name, q in Q.QUERIES.items():
        agreement.compare(name, q(host, readers), got["raw", name], per_supp)
        _, host_ms = wall(lambda q=q: q(host, readers))
        line.append(f"{name} host_ms={host_ms:.2f} raw_ms={ms['raw', name]:.2f}")
    log(f"      (b) {order}: backend='host' agrees with raw; warm wall ms: " + "; ".join(line))

    # (c) pre-aggregated: the second run is a cache hit, bit-identical to raw
    pre_agg = DatapathEngine(device=device, offload="pre-aggregated", cache=BlockCache(STORE_BYTES))
    for pname, plan in PUSHDOWN_PLANS.items():
        want = gpu["raw"].scan(li, plan).aggregates
        (r1, ms1), (r2, ms2) = (wall(lambda plan=plan: pre_agg.scan(li, plan)) for _ in range(2))
        if r1.stats.cache_hit or not r2.stats.cache_hit:
            raise AssertionError(f"{order} {pname}: pre-aggregated hits {r1.stats.cache_hit}, "
                                 f"{r2.stats.cache_hit}; want False, True")
        for r in (r1, r2):
            for k in want:
                if r.aggregates[k].dtype != want[k].dtype or not np.array_equal(r.aggregates[k],
                                                                                want[k]):
                    raise AssertionError(f"{order} {pname}: pre-aggregated {k} differs from raw")
        log(f"      (c) {pname}: first_ms={ms1:.2f} (launches {r1.stats.kernel_launches}) "
            f"hit_ms={ms2:.2f} (cache_hit True), bit-identical to raw")

    # (d) batched under the cached modes (twice: cold, then served by the
    # store) against sequential; then the six lineitem plans stacked in one
    # scan_group_batched pass over a shared DecodePool
    for m in OFFLOAD_MODES[1:]:
        seq = DatapathEngine(device=device, offload=m, cache=BlockCache(STORE_BYTES))
        bat = DatapathEngine(device=device, offload=m, cache=BlockCache(STORE_BYTES))
        launches = {False: 0, True: 0}
        for run in range(2):
            for name, (plan, blooms, _) in scans.items():
                s_ = seq.scan(li, plan, blooms=blooms)
                b_ = bat.scan(li, plan, blooms=blooms, batched=True)
                same_scan(b_, s_, f"{order} {name} {m} run {run}")
                launches[False] += s_.stats.kernel_launches
                launches[True] += b_.stats.kernel_launches
        log(f"      (d) {m}: scan(batched=True) equals sequential on the six lineitem plans, "
            f"twice; kernel_launches sequential={launches[False]} batched={launches[True]}")
    raw = gpu["raw"]
    pending = [(name, raw.resumable_scan(li, plan, blooms=blooms))
               for name, (plan, blooms, _) in scans.items()]
    pending = [(name, rs) for name, rs in pending if rs.result is None]
    items = [{"reader": li, "rgs": list(rs.pending), "plan": rs.plan, "pred": rs.pred,
              "blooms": rs.blooms, "stats": rs.stats, "offload": None, "owner": name,
              "trace": None} for name, rs in pending]
    out, group_ms = wall(lambda: raw.scan_group_batched(items, pool=DecodePool()))
    for (name, rs), it, (per_rg, _) in zip(pending, items, out):
        rs.ingest_batched(it["rgs"], per_rg)
    own = {name: raw.scan(li, scans[name][0], blooms=scans[name][1], batched=True)
           for name, _ in pending}
    for name, rs in pending:
        same_rows(rs.result, own[name], f"{order} {name}: scan_group_batched against its own scan")
    stacked = sum(rs.stats.kernel_launches for _, rs in pending)
    alone = sum(r.stats.kernel_launches for r in own.values())
    if not stacked < alone:
        raise AssertionError(f"{order}: the stacked pass launched {stacked} kernels, the six "
                             f"batched scans {alone}")
    log(f"      (d) scan_group_batched over {len(items)} requests in {group_ms:.2f} ms: each "
        f"bit-identical to its own batched scan; kernel_launches stacked={stacked} against "
        f"{alone} for the six batched scans; pool hits "
        f"{sum(rs.stats.pool_hits for _, rs in pending)}")

    # (e) the store under pressure: Q1's lineitem scan, twice, on preloaded
    # stores that hold part of its decoded columns
    plan = scans["q1"][0]
    want = raw.scan(li, plan)
    for share in PRESSURE_SHARES:
        cap = want.stats.decoded_bytes // share
        eng = DatapathEngine(device=device, offload="preloaded", cache=BlockCache(cap))
        hits = []
        for run in range(2):
            r = eng.scan(li, plan)
            same_rows(r, want, f"{order} q1 preloaded under 1/{share} of its decoded bytes")
            if eng.cache.used > cap:
                raise AssertionError(f"{order}: the store holds {eng.cache.used} B over {cap}")
            hits.append(r.stats.page_hits)
        del r
        st = eng.cache.store.stats()
        dec = st["tiers"]["decoded"]
        if dec["evictions"] <= 0 or hits[1] <= 0 or (share > 3 and dec["demotions"] <= 0):
            raise AssertionError(f"{order} 1/{share}: evictions {dec['evictions']}, second-run "
                                 f"page hits {hits[1]}, demotions {dec['demotions']}")
        kept = dec["bytes"] + st["tiers"]["prefiltered"]["bytes"]
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng.cache.clear()
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        if device == "cuda" and before - after < kept:
            raise AssertionError(f"{order} 1/{share}: clear() freed {before - after} B of the "
                                 f"card, the store held {kept} B of tensors")
        log(f"      (e) preloaded q1, store of 1/{share} of its {want.stats.decoded_bytes} decoded "
            f"bytes ({cap} B): bit-identical to raw twice; used={st['used']} <= capacity; "
            f"decoded evictions={dec['evictions']} demotions={dec['demotions']} encoded "
            f"evictions={st['tiers']['encoded']['evictions']}; page_hits {hits}; "
            f"memory_allocated before clear()={before} after={after} (store decoded bytes "
            f"{dec['bytes']}, prefiltered {st['tiers']['prefiltered']['bytes']})")

    # (f) the cost model on the card: calibrated under the device's key, no
    # nominal fallback there, estimates equal to the scans' fresh bytes
    try:
        CostModel.calibrate(backend="cuda", n=-5)
    except Exception:  # noqa: BLE001 — the failure it must raise
        pass
    else:
        raise AssertionError("CostModel.calibrate('cuda') fell back instead of raising")
    key = torch.device(device).type
    for n in CALIBRATION_N:
        cm = CostModel.calibrate(backend=key, n=n)
        if cm.source != "calibrated" or cm.backend != key:
            raise AssertionError(f"calibrate gave source={cm.source} backend={cm.backend}")
        path = cm.save(os.path.join(tmpdir, "calibration.json"))
        back = CostModel.load(path, backend=key)
        if back.rates != cm.rates or back.launch_overhead_s != cm.launch_overhead_s:
            raise AssertionError("the calibration did not round-trip through save/load")
        log(f"      (f) {order}: CostModel.calibrate('{key}', n={n}): source={cm.source}; GB/s "
            + " ".join(f"{e}={cm.rates[e]:.3f}" for e in sorted(cm.rates))
            + f"; launch_overhead_us={cm.launch_overhead_s * 1e6:.2f}; save/load round trip "
            "equal")
    line = []
    for name, (plan, blooms, _) in scans.items():
        rgs = prune_row_groups(li, bind_expr(plan.predicate, li))
        est = cm.estimate_row_groups(raw, li, plan, rgs)
        res = raw.scan(li, plan, blooms=blooms)
        if sum(c.nbytes for c in est) != res.stats.decoded_bytes_fresh:
            raise AssertionError(f"{order} {name}: estimated {sum(c.nbytes for c in est)} B, the "
                                 f"scan decoded {res.stats.decoded_bytes_fresh} B")
        busy_ms = profiled(lambda plan=plan, blooms=blooms: raw.scan(li, plan, blooms=blooms))[0]
        line.append(f"{name} bytes={res.stats.decoded_bytes_fresh} est_ms="
                    f"{sum(c.seconds for c in est) * 1e3:.3f} busy_ms={busy_ms:.3f}")
    log(f"      (f) {order}: estimate_row_groups bytes equal each lineitem scan's "
        f"decoded_bytes_fresh; estimated ms (the n={CALIBRATION_N[-1]} table) against device "
        "busy ms: " + "; ".join(line))
    return ops.kernel_launches(), avg, cm


# ---------------------------------------------------------------------------
# phase S: the multi-tenant datapath service
# ---------------------------------------------------------------------------

# (c): benchmarks/service_bench.py's skewed workload, one elephant scanning
# every row group and three mice on 200-day windows of l_shipdate, with its
# per-tick budget rule (service_bench.py:173): 1.5 elephant row groups of
# decoded bytes, here of the file's own row-group size
ELEPHANT_COLS = ["l_extendedprice", "l_quantity"]
MICE_DAYS = (300, 900, 1500)
# (d): tests/test_chaos_props.py's recoverable mix and retry policy (:59-61)
RECOVERABLE = dict(seed=0, transient_rate=0.12, corrupt_rate=0.06, short_read_rate=0.04,
                   spike_rate=0.25, spike_s=1e-3)
CHAOS_RETRY = dict(max_attempts=10, timeout_s=0.5, hedge_after_s=5e-4)
FAILING_TABLE = "part.lake"
MAX_TICKS = 100_000  # hang guard for every drain


@dataclasses.dataclass(frozen=True)
class OneTableFaults(FaultPlan):
    """A fault plan whose transient errors hit one table (by basename) only."""

    table: str = ""

    def transient(self, table: str, rg: int, attempt: int) -> bool:
        return self._table(table) == self.table and super().transient(table, rg, attempt)


def drain(pod) -> None:
    """Tick until the queue is empty, with a hang guard."""
    for _ in range(MAX_TICKS):
        if not pod.queue:
            return
        pod.tick()
    raise AssertionError(f"the pod made no progress in {MAX_TICKS} ticks")


def new_pod(device: str, **kw):
    """A pod over a 4 GiB store (service_bench's) on `device`, offload pinned
    to raw (service_bench's isolation of coalescing from caching)."""
    kw.setdefault("policy", StaticPolicy("raw"))
    return DatapathService(engine=DatapathEngine(device=device, cache=BlockCache(STORE_BYTES)),
                           **kw)


def submit_all(pod, subs):
    """Submit (tenant, reader, plan, blooms) in order; returns (tickets, the
    admitted requests)."""
    tickets = [pod.submit(t, r, plan, blooms) for t, r, plan, blooms in subs]
    return tickets, list(pod.queue)


def check_honesty(pod, requests, label: str) -> None:
    """tests/test_chaos_props.py's invariant, sched + recon == actual per
    tenant.  A failed slice is never reconciled (the reference's semantics):
    its charge stays on its request and counts on the actual side."""
    for tenant, row in pod.telemetry.cost_report().items():
        unreconciled = sum(r.charged_s for r in requests if r.tenant == tenant)
        lhs, rhs = row["est_s"] + row["recon_s"], row["actual_s"] + unreconciled
        if abs(lhs - rhs) > 1e-9 + 1e-9 * abs(rhs):
            raise AssertionError(f"{label}: tenant {tenant} charged {lhs} s, actual {rhs} s")


def skewed(li, device: str, scheduler: str, rg_rows: int, **kw):
    """(c)'s workload on a fresh pod: (pod, tickets, wall ms of the drain)."""
    pod = new_pod(device, scheduler=scheduler, tick_bytes=int(rg_rows * 4 * 2 * 1.5), **kw)
    subs = [("elephant", li, ScanPlan("lineitem", ELEPHANT_COLS), None)]
    subs += [(f"mouse{i}", li, ScanPlan("lineitem", ["l_extendedprice"],
                                        Cmp("l_shipdate", "between", (d, d + 200))), None)
             for i, d in enumerate(MICE_DAYS)]
    (tickets, _), ms = wall(lambda: (submit_all(pod, subs), drain(pod))[0])
    return pod, tickets, ms


def service_phase(readers, order: str, direct: dict, direct_ms: dict, per_supp, fig2_avg,
                  calibrated, device: str = "cuda"):
    """Phase S on one file order: (a) the queries through the service, (b)
    coalescing and cross-request stacking, (c) fairness, (d) faults, (e) the
    flight recorder, (f) pricing with phase O's calibrated table.  Every
    launch count is set to 0 at its start and read at its end.  Returns
    those counts."""
    li = readers["lineitem"]
    ops.reset_kernel_launches()
    eng = DatapathEngine(device=device)

    # (a) the six queries through one service, against phase 5's answers;
    # each query's lineitem scan through ServiceClient.scan against the
    # direct scan, bit for bit
    svc = DatapathService(engine=DatapathEngine(device=device, cache=BlockCache(STORE_BYTES)))
    bloom = Q.q19_bloom(eng, readers)
    scans = {name: (make(), {"q19": bloom} if name == "q19" else None)
             for name, make in Q.LINEITEM_PLANS.items()}
    line = []
    for name in Q.QUERIES:
        got, ms = wall(lambda name=name: Q.run_via_service(svc, name, readers, tenant=name))
        agreement.compare(name, got, direct[name], per_supp)
        plan, blooms = scans[name]
        same_rows(svc.client(name).scan(li, plan, blooms), eng.scan(li, plan, blooms=blooms),
                  f"{order} {name}: ServiceClient.scan against the direct scan")
        line.append(f"{name} {ms:.2f} (direct {direct_ms[name]:.2f})")
    log(f"      (a) {order}: the six queries through DatapathService agree with phase 5's; "
        "each lineitem scan through ServiceClient.scan bit-identical to the direct scan; "
        "wall ms: " + "; ".join(line))

    # (b) six tenants, the six lineitem plans, one tick; stacked and
    # sequential dispatch
    subs = [(name, li, plan, blooms) for name, (plan, blooms) in scans.items()]
    want = {name: eng.scan(li, plan, blooms=blooms, batched=True)
            for name, (plan, blooms) in scans.items()}
    before = ops.kernel_launches()
    _, alone_ms = wall(lambda: [eng.scan(li, plan, blooms=blooms, batched=True)
                                for plan, blooms in scans.values()])
    after = ops.kernel_launches()
    alone = sum(after[k] - before[k] for k in after)  # counted on the card only
    alone_stats = sum(r.stats.kernel_launches for r in want.values())
    alone_fresh = sum(r.stats.decoded_bytes_fresh for r in want.values())
    for batch_decode in (True, False):
        pod = new_pod(device, batch_per_tick=len(subs), batch_decode=batch_decode)
        before = ops.kernel_launches()
        (tickets, requests), ms = wall(lambda: (submit_all(pod, subs), drain(pod))[0])
        after = ops.kernel_launches()
        launches = sum(after[k] - before[k] for k in after)
        c = pod.telemetry.counters
        for (name, *_), t in zip(subs, tickets):
            if t.status != "done":
                raise AssertionError(f"{order} (b) {name}: {t.status} {t.error!r}")
            same_rows(t.result, want[name], f"{order} (b) {name} batch_decode={batch_decode}")
        if c.get("failed", 0):
            raise AssertionError(f"{order} (b): {c['failed']} requests failed")
        if batch_decode and not (c.get("xreq_groups", 0) >= 1 and c.get("xreq_fallback", 0) == 0
                                 and c["decode_launches"] < alone_stats
                                 and (launches < alone or device == "cpu")):
            raise AssertionError(f"{order} (b): xreq_groups {c.get('xreq_groups', 0)}, "
                                 f"xreq_fallback {c.get('xreq_fallback', 0)}, launches "
                                 f"{launches} ({c['decode_launches']:.0f} in ScanStats) "
                                 f"against {alone} ({alone_stats}) for the six batched scans")
        check_honesty(pod, requests, f"{order} (b)")
        if batch_decode:
            clean = tickets  # (d)'s reference
        prof_pod = new_pod(device, batch_per_tick=len(subs), batch_decode=batch_decode)
        busy_ms = profiled(lambda: (submit_all(prof_pod, subs), drain(prof_pod)))[0]
        log(f"      (b) {order} batch_decode={batch_decode}: six tenants in one tick, "
            f"bit-identical to the direct scans; drain_ms={ms:.2f} (six batched scans alone, "
            f"one after another: {alone_ms:.2f}) launches={launches} (alone: {alone}) "
            f"decode_launches={c.get('decode_launches', 0):.0f} "
            f"(alone {alone_stats}) "
            f"xreq_groups={c.get('xreq_groups', 0):.0f} xreq_fallback="
            f"{c.get('xreq_fallback', 0):.0f} decoded_bytes_fresh="
            f"{c.get('decoded_bytes_fresh', 0):.0f} (alone {alone_fresh}) "
            f"decoded_bytes_saved={c.get('decoded_bytes_saved', 0):.0f} busy_ms={busy_ms:.3f} "
            f"idle_share={1 - busy_ms / ms:.3f}")
    # phase 7(b)'s pushdown plans through one pod, in one tick
    pod = new_pod(device, batch_per_tick=len(PUSHDOWN_PLANS))
    tickets, _ = submit_all(pod, [(name, li, plan, None) for name, plan in PUSHDOWN_PLANS.items()])
    drain(pod)
    for (name, plan), t in zip(PUSHDOWN_PLANS.items(), tickets):
        want_aggs = eng.scan(li, plan, batched=True).aggregates
        for k, w in want_aggs.items():
            if t.result is None or not np.array_equal(t.result.aggregates[k], w):
                raise AssertionError(f"{order} (b) {name}: {k} through the pod differs")
    log(f"      (b) {order}: phase 7(b)'s {len(tickets)} pushdown plans through one pod, "
        "bit-identical to the direct batched scans")

    # (c) fairness: FIFO and WFQ on the skewed workload
    rg_rows = li.row_group_meta(0)["n"]
    fair = {}
    for scheduler in ("fifo", "wfq"):
        pod, tickets, ms = skewed(li, device, scheduler, rg_rows)
        mice = [t for t in tickets if t.tenant != "elephant"]
        fair[scheduler] = (pod, tickets)
        log(f"      (c) {order} {scheduler}: drain_ms={ms:.2f} ticks={pod._tick} mice p99: "
            f"ticks={max(t.done_tick - t.submitted_tick for t in mice)} "
            f"ms={max(t.done_s - t.submitted_s for t in mice) * 1e3:.2f}; elephant ticks="
            f"{tickets[0].done_tick - tickets[0].submitted_tick}; jain_index="
            f"{pod.telemetry.fairness()['jain_index']:.4f}")
    for a, b in zip(fair["fifo"][1], fair["wfq"][1]):
        same_rows(a.result, b.result, f"{order} (c) {a.tenant}: FIFO against WFQ")

    # (d) faults: (b)'s submissions under the recoverable mix, then a
    # fail_forever plan on one table with two part scans among them
    pod = new_pod(device, batch_per_tick=len(subs), fault_plan=FaultPlan(**RECOVERABLE),
                  retry_policy=RetryPolicy(**CHAOS_RETRY))
    (tickets, requests), ms = wall(lambda: (submit_all(pod, subs), drain(pod))[0])
    for t, c_ in zip(tickets, clean):
        same_rows(t.result, c_.result, f"{order} (d) {t.tenant}: chaos against clean")
    f = pod.telemetry.fault_report()
    if f["retries_exhausted"] or f["corrupt_detected"] != f["corrupt_injected"] + f["short_reads"]:
        raise AssertionError(f"{order} (d): {f}")
    check_honesty(pod, requests, f"{order} (d) recoverable")
    log(f"      (d) {order} recoverable faults: bit-identical to the clean run; drain_ms={ms:.2f}; "
        + " ".join(f"{k}={v:.0f}" for k, v in f.items() if not isinstance(v, dict))
        + f"; fault_seconds={ {k: round(v, 6) for k, v in f['fault_seconds'].items()} }")
    part = readers["part"]
    part_plans = {"part_sizes": ScanPlan("part", ["p_partkey", "p_size"], Cmp("p_size", "le", 10)),
                  "part_attrs": ScanPlan("part", ["p_brand", "p_container", "p_size"])}
    fsubs = subs + [(name, part, plan, None) for name, plan in part_plans.items()]
    pod = new_pod(device, batch_per_tick=len(fsubs), retry_policy=RetryPolicy(max_attempts=3))
    pod.install_faults(OneTableFaults(transient_rate=1.0, fail_forever=True, table=FAILING_TABLE))
    tickets, requests = submit_all(pod, fsubs)
    drain(pod)
    for (name, r, *_), t in zip(fsubs, tickets):
        if r is part:
            if t.status != "error" or not isinstance(t.error, StorageFault):
                raise AssertionError(f"{order} (d) {name}: {t.status} {t.error!r}, want a "
                                     "StorageFault")
        else:
            same_rows(t.result, want[name], f"{order} (d) {name} beside a failing table")
    check_honesty(pod, requests, f"{order} (d) fail_forever")
    log(f"      (d) {order} fail_forever on {FAILING_TABLE}: its {len(part_plans)} requests ended "
        f"with {sorted({type(t.error).__name__ for t in tickets if t.error})}, the six lineitem "
        "requests bit-identical; honesty held (the failed slices' charges unreconciled); "
        f"breaker {pod.breaker.report()}")

    # (e) the flight recorder on (c)'s WFQ run: traced against untraced
    skewed(li, device, "wfq", rg_rows, trace_sample_rate=0.0)  # warm
    _, off, ms_off = skewed(li, device, "wfq", rg_rows, trace_sample_rate=0.0)
    pod, on, ms_on = skewed(li, device, "wfq", rg_rows, trace_sample_rate=1.0, trace_capacity=16)
    for a, b in zip(on, off):
        same_rows(a.result, b.result, f"{order} (e) {a.tenant}: traced against untraced")
    rep = pod.telemetry.trace_report()
    pct = rep["stage_pct"]
    log(f"      (e) {order}: traced bit-identical to untraced; wall_ms on={ms_on:.2f} "
        f"off={ms_off:.2f} ratio={ms_on / ms_off:.3f}; chrome_events="
        f"{len(pod.tracer.recorder.to_chrome_trace()['traceEvents'])}; recorded "
        f"{rep['recorded']}/{rep['completed']}; trace-derived decode%={pct['decode']:.1f} "
        f"filter%={pct['filter']:.1f} rest%={pct['rest']:.1f} (phase O's Fig. 2 split: "
        f"{fig2_avg[0]:.1f} / {fig2_avg[1]:.1f} / {fig2_avg[2]:.1f}; paper "
        f"{PAPER_FIG2_PCT['decode']:.0f} / {PAPER_FIG2_PCT['filter']:.0f})")

    # (f) pricing with phase O's calibrated table
    pod = new_pod(device, batch_per_tick=len(subs), cost_model=calibrated)
    info = pod.telemetry.costmodel_info
    if info["backend"] != torch.device(device).type or info["source"] != "calibrated":
        raise AssertionError(f"{order} (f): costmodel_info {info}")
    tickets, requests = submit_all(pod, subs)
    drain(pod)
    for t in tickets:
        same_rows(t.result, want[t.tenant], f"{order} (f) {t.tenant}")
    check_honesty(pod, requests, f"{order} (f)")
    cost = pod.telemetry.cost_report()
    log(f"      (f) {order}: priced with phase O's calibrated table ({info}); honesty held; "
        "est / actual ms per tenant: " + "; ".join(
            f"{t} {row['est_s'] * 1e3:.3f} / {row['actual_s'] * 1e3:.3f}"
            for t, row in cost.items()))
    return ops.kernel_launches()


# ---------------------------------------------------------------------------
# phase 9: the LM serving path at full width, and flash_attention
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-1.7b"  # 28 layers, d_model 2048, 16 heads, 8 kv heads, head_dim 128
LM_PROMPTS = (1024, 2048, 3072, 4096)  # multiples of the 1024 q-chunk
LM_NEW_TOKENS = 32
LM_SLOTS = 4
LM_MAX_LEN = 4160
PACKED_LEN = 4096  # one packed block of k = 18-bit token ids
CHECK_LAYERS, CHECK_LEN = 2, 256  # (c): the config cut to 2 layers, float32
STACK_BATCH = 4  # flash_attention's stack: 4 prompts of PACKED_LEN at layer 0
BF16_FLOPS_PER_S = 989e12  # H100 SXM tensor cores, dense
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# (b) decode logits at S against the (S+1)-token prefill, in bfloat16 at 28
# layers: the two paths round their bf16 activations at different places
# (a one-row step against 1,025-row products), so they agree to the bf16
# step, not bit for bit.  bf16 keeps 8 significant bits (a relative step of
# 2^-8 to 2^-7); allowed: four times that over the whole logits vector,
# ||d - p||_2 <= 2^-5 ||p||_2.  A wrong cache position or mask moves the
# logits by the order of the logits themselves.
DECODE_REL_TOL = 2.0 ** -5
# (b) the same check at float32, and (c) the card against the CPU at
# float32, TF32 off: sums in other orders over at most 6,144 terms agree to
# ~1e-5 on logits of std ~0.9; 1e-3 leaves room for sin/cos/pow that differ
# by an ulp between kernels or devices, and for 28 layers of it in (b).
F32_ATOL = 1e-3
# (d) flash_attention against ref.mha and the model's attention: float32 at
# the reference test's atol 3e-5 / rtol 1e-4 (tests/test_kernels.py; sums in
# another order); bfloat16 within one bf16 step of each row's largest
# output, 2^-7 max|want[row]|, since each side rounds its float32 result
# once.  Per row, since a causal row over thousands of keys has outputs
# ~100x smaller than the first rows': a bound from the tensor's largest
# output lets a stale or skipped key tile pass there.
FLASH_ATOL, FLASH_RTOL = 3e-5, 1e-4


def flash_err(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    """max |got - want| of an attention output, raising past its tolerance."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if got.dtype == torch.float32:
        ok = bool(((g - w).abs() <= FLASH_ATOL + FLASH_RTOL * w.abs()).all())
    else:
        ok = bool(((g - w).abs() <= 2.0 ** -7 * w.abs().amax(dim=-1, keepdim=True)).all())
    if not ok:
        raise AssertionError(f"{label}: flash_attention differs (max |err| {err})")
    return err


def causal_visible_keys(S: int) -> int:
    """Keys the rows of a causal S x S attention see, all rows together."""
    return S * (S + 1) // 2


def layer0_qkv(params, cfg, tokens: torch.Tensor):
    """Layer 0's q, k, v of a prefill of `tokens`, as (B, H, S, D)."""
    ctx = local_ctx()
    lp = {k: w[0] for k, w in params["segments"][0].items()}
    B, S = tokens.shape
    h = layers.embed_lookup(params["embed"], tokens, ctx, scale=cfg.embed_scale)
    x = layers.rmsnorm(h, lp["ln1"], cfg.norm_eps, cfg.norm_plus_one)
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    q, k, v = _proj_qkv(x, lp, cfg, positions, ctx)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def lm_serving(seed: int, device: str = "cuda"):
    """Phase 9.  Returns (the kernel launches of its counted window,
    flash_attention's records in phase 3's form)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=device)
    torch.cuda.synchronize()
    n_params = sum(w.numel() for seg in params["segments"] for w in seg.values()) + sum(
        w.numel() for k, w in params.items() if k != "segments")
    log(f"      {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"({cfg.n_kv} kv) of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_padded}); {n_params} parameters in {cfg.dtype}, drawn from seed "
        f"{seed} in {time.perf_counter() - t0:.1f} s")

    k_bits = model.token_bits(cfg)
    toks = rng.integers(0, cfg.vocab, (1, PACKED_LEN)).astype(np.int64)
    packed = np.stack([bitpack_encode(toks[0], k_bits)]).view(np.int32)
    tokens = torch.from_numpy(toks.astype(np.int32)).to(device)
    packed_t = torch.from_numpy(packed).to(device)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)),
                    max_new_tokens=LM_NEW_TOKENS) for i, n in enumerate(LM_PROMPTS)]
    qkv = layer0_qkv(params, cfg, tokens)

    # the counted window: (a), (b)'s first engine, and (d)'s entry-point calls
    ops.reset_kernel_launches()
    flash_attention.ROUTE_LAUNCHES.update(wgmma=0, cuda_cores=0)
    l_packed, c_packed = model.prefill(params, {"packed": packed_t}, cfg)
    l_tokens, c_tokens = model.prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=device)
    for r in reqs:
        eng.submit(r)
    ticks = []
    while eng.queue or any(s is not None for s in eng.slots):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = eng.step()
        torch.cuda.synchronize()
        ticks.append((n, (time.perf_counter() - t) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    outs = {"bfloat16": ops.flash_attention(*qkv, causal=True, scale=cfg.attn_scale),
            "float32": ops.flash_attention(*(t.float() for t in qkv), causal=True,
                                           scale=cfg.attn_scale)}
    torch.cuda.synchronize()
    launches = ops.kernel_launches()
    routes = dict(flash_attention.ROUTE_LAUNCHES)
    log(f"      launches on the LM path: {launches}; flash_attention by route: {routes}")
    if routes != {"wgmma": 1, "cuda_cores": 1}:
        raise AssertionError("the bf16 flash_attention call did not take the wgmma route, or "
                             f"the float32 one the CUDA-core route: {routes}")

    # (a) packed prompt == tokens, bit for bit, through bitunpack
    if not torch.equal(l_packed, l_tokens) or any(
            not torch.equal(c_packed[0][k], c_tokens[0][k]) for k in ("k", "v")):
        raise AssertionError("packed-prompt prefill differs from the tokens prefill")
    if launches["bitunpack"] < 1:
        raise AssertionError("the packed prompt did not go through the bitunpack kernel")
    log(f"      (a) {PACKED_LEN}-token prompt packed at k={k_bits} ({packed.nbytes} B against "
        f"{toks.size * 4} B of int32 tokens): logits and {cfg.n_layers}-layer caches "
        "bit-identical to the tokens prefill")

    # (b) serving: every request drained with its tokens, deterministically
    got = {r.rid: r.out for r in reqs}
    if sorted(got) != list(range(len(LM_PROMPTS))) or any(
            len(o) != LM_NEW_TOKENS for o in got.values()):
        raise AssertionError(f"not every request got {LM_NEW_TOKENS} tokens: "
                             f"{ {k: len(o) for k, o in got.items()} }")
    again = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_len=LM_MAX_LEN, device=device)
    reqs2 = [Request(rid=r.rid, tokens=r.tokens, max_new_tokens=LM_NEW_TOKENS) for r in reqs]
    for r in reqs2:
        again.submit(r)
    again.step()  # admits all four
    busy_ms, top, _ = profiled(again.step)
    again.run_until_drained()
    if {r.rid: r.out for r in reqs2} != got:
        raise AssertionError("a second engine gave other tokens")
    decode_ms = [ms for _, ms in ticks[1:]]
    tick_ms = sorted(decode_ms)[len(decode_ms) // 2]
    tokens_per_s = sum(n for n, _ in ticks[1:]) / (sum(decode_ms) / 1e3)
    S = LM_PROMPTS[0]
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1)).astype(np.int32)).to(device)
    _, caches = model.prefill(params, {"tokens": seq[:, :S]}, cfg, cache_len=S + 8)
    l_full, _ = model.prefill(params, {"tokens": seq}, cfg, cache_len=S + 8)
    l_dec, _ = model.decode_step(params, seq[:, S:], caches, S, cfg)
    diff = (l_dec.float() - l_full.float())
    rel = float(diff.norm() / l_full.float().norm())
    if not rel <= DECODE_REL_TOL:
        raise AssertionError(f"decode at {S} differs from the {S + 1}-token prefill: "
                             f"relative L2 {rel} > {DECODE_REL_TOL}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = model.init_params(cfg32, seed, device=device)
    _, caches = model.prefill(params32, {"tokens": seq[:, :S]}, cfg32, cache_len=S + 8)
    l_full32, _ = model.prefill(params32, {"tokens": seq}, cfg32, cache_len=S + 8)
    l_dec32, _ = model.decode_step(params32, seq[:, S:], caches, S, cfg32)
    err32 = float((l_dec32 - l_full32).abs().max())
    if not err32 <= F32_ATOL:
        raise AssertionError(f"float32 decode at {S} differs from the {S + 1}-token prefill: "
                             f"max |err| {err32} > {F32_ATOL}")
    del params32
    prefill_ms = {}
    for r in reqs:
        batch = {"tokens": torch.from_numpy(np.asarray(r.tokens, np.int32)[None]).to(device)}
        model.prefill(params, batch, cfg, cache_len=LM_MAX_LEN)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.prefill(params, batch, cfg, cache_len=LM_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms[len(r.tokens)] = (time.perf_counter() - t) * 1e3
    log(f"      (b) {len(reqs)} requests of {list(LM_PROMPTS)} tokens drained on {LM_SLOTS} "
        f"slots in {len(ticks)} ticks, {LM_NEW_TOKENS} tokens each, a second engine gives the "
        f"same tokens; decode at {S} against the {S + 1}-token prefill: bf16 relative L2 "
        f"{rel:.3e} (max |err| {float(diff.abs().max()):.4f}, tolerance {DECODE_REL_TOL}), "
        f"float32 max |err| {err32:.3e} (tolerance {F32_ATOL})")
    log(f"      prefill_ms per request (warm, cache_len {LM_MAX_LEN}): {prefill_ms}; first tick "
        f"(4 admissions + 1 decode) {ticks[0][1]:.1f} ms; decode_ms per tick (median) "
        f"{tick_ms:.2f}, tokens/s {tokens_per_s:.1f}; peak device bytes {peak}; one decode "
        f"tick: busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / tick_ms:.3f} top={top}")
    del eng, again, caches, c_packed, c_tokens

    # (c) the card against the CPU: 2 layers at float32
    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32")
    cpu_params = model.init_params(cfg2, seed, device="cpu")
    card_params = to_device(cpu_params, device)
    seq = rng.integers(0, cfg.vocab, (1, CHECK_LEN)).astype(np.int32)
    l_cpu, c_cpu = model.prefill(cpu_params, {"tokens": torch.from_numpy(seq)}, cfg2)
    l_card, c_card = model.prefill(card_params, {"tokens": torch.from_numpy(seq).to(device)},
                                   cfg2)
    errs = [float((l_card.cpu() - l_cpu).abs().max())] + [
        float((c_card[0][k].cpu() - c_cpu[0][k]).abs().max()) for k in ("k", "v")]
    if not max(errs) <= F32_ATOL:
        raise AssertionError(f"card differs from the CPU at float32: {errs}")
    log(f"      (c) {CHECK_LAYERS} layers, float32, {CHECK_LEN} tokens: card against CPU max "
        f"|err| logits {errs[0]:.3e}, k cache {errs[1]:.3e}, v cache {errs[2]:.3e} "
        f"(tolerance {F32_ATOL})")
    del cpu_params, card_params

    # (d) flash_attention on layer 0's q, k, v: the entry point's outputs
    # against ref.mha and the model's own attention, then timed
    for dt, out in outs.items():
        q, k, v = (t.to(getattr(torch, dt)) for t in qkv)
        e_ref = flash_err(out, ref.mha(q, k, v, causal=True, scale=cfg.attn_scale), f"{dt} mha")
        model_out = layers.attention(*(t.transpose(1, 2) for t in (q, k, v)), local_ctx(),
                                     causal=True, scale=cfg.attn_scale, chunk=cfg.attn_block)
        e_model = flash_err(out, model_out.transpose(1, 2), f"{dt} layers.attention")
        log(f"      (d) {dt} {tuple(q.shape)}: max |err| against ref.mha {e_ref:.3e}, against "
            f"layers.attention {e_model:.3e}")
    stack_toks = torch.from_numpy(rng.integers(0, cfg.vocab, (STACK_BATCH, PACKED_LEN))
                                  .astype(np.int32)).to(device)
    stack = layer0_qkv(params, cfg, stack_toks)
    D = 256  # gemma-7b's head dim: B 1, 16 heads, MHA, S 2048, random from the seed
    wide = tuple(torch.from_numpy(rng.standard_normal((1, 16, 2048, D)).astype(np.float32))
                 .to(device, torch.bfloat16) for _ in range(3))
    rec = flash_cases(qkv, stack, wide, cfg)
    rec["launches_by_route"] = routes
    return launches, rec


def flash_cases(path, stack, wide, cfg) -> dict:
    """flash_attention timed as phase 3 times a kernel: at the path's shape
    (one qwen3 layer at S = 4096, bf16), the stack (4 prompts), float32, and
    gemma-7b's head dim (D 256, bf16), each on the route its dtype and head
    dim give, with its share of the bound and its time over SDPA's."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=path[0].device)
    rec = {"max_abs_err": 0.0, "cases": []}
    for label, (q, k, v), scale in (("path: layer 0, bf16", path, cfg.attn_scale),
                                    (f"stack: {STACK_BATCH} prompts, bf16", stack,
                                     cfg.attn_scale),
                                    ("path: layer 0, float32", tuple(t.float() for t in path),
                                     cfg.attn_scale),
                                    ("D 256: 16 heads, S 2048, bf16", wide, None)):
        B, H, S, D = q.shape
        kw = dict(causal=True, scale=scale)
        way = flash_attention.route(q.dtype, D)
        before = flash_attention.ROUTE_LAUNCHES[way]
        err = flash_err(flash_attention.flash_attention(q, k, v, **kw), ref.mha(q, k, v, **kw),
                        label)
        torch.cuda.synchronize()
        if flash_attention.ROUTE_LAUNCHES[way] != before + 1:
            raise AssertionError(f"{label}: flash_attention did not take the {way} route")
        ms = median_ms(lambda: flash_attention.flash_attention(q, k, v, **kw), 10, flush)
        plain_ms = median_ms(lambda: ref.mha(q, k, v, **kw), 3, flush)
        library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), 10, flush)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        nops = 4 * B * H * D * causal_visible_keys(S)
        rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"  flash_attention {label:29s} {tuple(q.shape)} kv {tuple(k.shape)} route={way} "
            f"max|err|={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({nbytes} B, {nops} FLOP, by {bound_by}) share={bound_ms / ms:.4f} "
            f"library_ms={library_ms:.4f} over_library={ms / library_ms:.2f}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"].append({"label": label, "shape": [B, H, S, D], "route": way, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                             "share": bound_ms / ms, "library_ms": library_ms,
                             "over_library": ms / library_ms, "stage_ms": None})
    del flush
    return rec


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
        passes = {}
        for order, sorted_data in (("unsorted", False), ("sorted", True)):
            t0 = time.perf_counter()
            paths = tpch.write_tables(os.path.join(d, order), sf=SF, seed=args.seed,
                                      sorted_data=sorted_data)
            readers = {k: LakeReader(p) for k, p in paths.items()}
            log(f"[4] wrote {order} TPC-H sf={SF} seed={args.seed} in "
                f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
                    f"{k} {r.n_rows} rows / {r.n_row_groups} row groups"
                    for k, r in readers.items()))
            li = readers["lineitem"]
            encs = [li.row_group_meta(rg)["columns"]["l_shipdate"]["encoding"]
                    for rg in range(li.n_row_groups)]
            log(f"      l_shipdate pages: {sorted(set(encs))}")
            if sorted_data and set(encs) != {"rle"}:
                raise AssertionError(f"sorted l_shipdate is not RLE in every row group: {encs}")
            passes[order] = readers

        # phases 5-7 on each file order
        launches = {}
        report = {}
        batched_launches = {}
        offload_launches = {}
        service_launches = {}
        for order, readers in passes.items():
            # phase 5: the main path on the card
            gpu = DatapathEngine(device="cuda")
            ops.reset_kernel_launches()
            ops.reset_dispatch_count()
            got, first_ms, peaks, per_query = run_queries(gpu, readers, Q.QUERIES, True)
            launches[order] = ops.kernel_launches()
            dispatches = ops.dispatch_count()
            log(f"[5] {order}: queries on the card: launches {launches[order]}, "
                f"dispatches {dispatches}")
            for name, per in per_query.items():
                log(f"      {name}: {per}")
            _, warm_ms, _, _ = run_queries(gpu, readers, Q.QUERIES, True)
            busy = device_busy(gpu, readers, Q.QUERIES)

            # phase 6: the same queries on the CPU
            cpu = DatapathEngine(device="cpu")
            t0 = time.perf_counter()
            want, cpu_ms, _, _ = run_queries(cpu, readers, Q.QUERIES, False)
            log(f"[6] {order}: queries on the CPU in {time.perf_counter() - t0:.1f} s")
            per_supp = agreement.per_supplier_revenue(readers["lineitem"])
            if len(want["q1"]) != 6:
                raise AssertionError(f"q1 has {len(want['q1'])} groups at SF1, not 6")
            if want["q19"]["rows"] <= 0:
                raise AssertionError("q19 selects no row at SF1")
            for name in Q.QUERIES:
                agreement.compare(name, got[name], want[name], per_supp)
                log(f"      {name} agrees: {got[name]}")
            report[order] = (first_ms, warm_ms, cpu_ms, peaks, busy, per_query)

            # phase 7: batched scans and aggregate pushdown
            log(f"[7] {order}: batched scans and aggregate pushdown on the card:")
            batched_launches[order] = batched_and_pushdown(gpu, cpu, readers, order)
            log(f"      launches {batched_launches[order]}")

            # phase O: the offload configurations
            log(f"[O] {order}: the paper's offload configurations on the card:")
            offload_launches[order], fig2_avg, calibrated = offload_configurations(readers,
                                                                                   order, d)
            log(f"      launches {offload_launches[order]}")

            # phase S: the multi-tenant service
            log(f"[S] {order}: the multi-tenant datapath service on the card:")
            service_launches[order] = service_phase(readers, order, got, warm_ms, per_supp,
                                                    fig2_avg, calibrated)
            log(f"      launches {service_launches[order]}")

    # phase 8
    for order, (first_ms, warm_ms, cpu_ms, peaks, busy, per_query) in report.items():
        log(f"[8] {order}: per query on the card (wall ms after synchronize; first run,"
            " warm run; peak device memory):")
        for name in Q.QUERIES:
            log(f"      {name}: first_ms={first_ms[name]:.2f} warm_ms={warm_ms[name]:.2f} "
                f"cpu_ms={cpu_ms[name]:.2f} peak_bytes={peaks[name]}")
        log(f"[8] {order}: device busy per query (torch.profiler, one more warm run;"
            " idle share against warm_ms):")
        for name, (busy_ms, top, kernels) in busy.items():
            idle = 1 - busy_ms / warm_ms[name] if busy_ms else float("nan")
            log(f"      {name}: busy_ms={busy_ms:.3f} idle_share={idle:.3f} top={top}")
            # every port kernel that ran, in situ; dict_decode's line always.
            # A kernel the query launched but the profiler did not see is
            # named (the trace can drop records, so this does not fail).
            unseen = [k for k, n in per_query[name].items()
                      if n and f"{k}_kernel" in PORT_KERNELS and f"{k}_kernel" not in kernels]
            if unseen:
                log(f"      {name}: launched but not in the trace: {unseen}")
            log_in_situ(name, kernels, always=("dict_decode_kernel",))

    # phase 9
    log(f"[9] the LM serving path on the card: {LM_ARCH} at full width")
    lm_launches, records["flash_attention"] = lm_serving(args.seed)

    # phase 10
    kernels = []
    for name, kern in ops.KERNELS.items():
        path, stack = records[name]["cases"][0], records[name]["cases"][1]
        size = ({"shape": path["shape"], "stack_shape": stack["shape"]} if "shape" in path
                else {"blocks": path["blocks"], "stack_blocks": stack["blocks"]})
        kernels.append({
            "name": name, "route": "cuda", "source": kern.source, "replaces": kern.replaces,
            "launches": sum(launches[o][name] + batched_launches[o][name]
                            + offload_launches[o][name] + service_launches[o][name]
                            for o in launches) + lm_launches[name],
            "max_abs_err": records[name]["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "library_ms": path["library_ms"], **size,
            "stack_ms": stack["ms"], "stack_plain_ms": stack["plain_ms"],
            "stack_bound_ms": stack["bound_ms"], "stack_library_ms": stack["library_ms"],
            "launches_by_order": {o: launches[o][name] for o in launches},
            "launches_batched_pushdown_by_order": {o: batched_launches[o][name]
                                                   for o in batched_launches},
            "launches_offload_by_order": {o: offload_launches[o][name] for o in offload_launches},
            "launches_service_by_order": {o: service_launches[o][name] for o in service_launches},
            "launches_lm": lm_launches[name],
        })
        if name == "flash_attention":
            kernels[-1].update(
                library="torch.nn.functional.scaled_dot_product_attention "
                "(is_causal, enable_gqa; a yardstick, never called by the port)",
                sources=flash_attention.SOURCES,
                launches_by_route=records[name]["launches_by_route"],
                cases=[{k: c[k] for k in ("label", "shape", "route", "ms", "bound_ms", "share",
                                          "library_ms", "over_library")}
                       for c in records[name]["cases"]])
        elif path["stage_ms"] is not None:
            kernels[-1].update(library="torch.masked_select (yardstick of the _compact stage)",
                               stage_ms=path["stage_ms"], stack_stage_ms=stack["stage_ms"])
        elif name == "grouped_agg":
            kernels[-1].update(library="Tensor.scatter_add of the s0 plane alone")
        elif name == "dict_decode":
            kernels[-1].update(
                library="torch.take of the unpacked, clipped codes (the lookup half alone)",
                variant="__ldg lookups in place, no fill; 512 threads a block, 8 rows a thread")
        elif name == "dict_decode_batch":
            kernels[-1].update(
                library="torch.take of the flattened (P, Dmax) dictionaries at page * Dmax + "
                "the clipped code (the lookup half alone; a yardstick, never called by the port)",
                variant="dict_decode's walk, each CTA taking a run of consecutive blocks, "
                "each block's page and size loaded ahead, __ldg lookups; 128 threads a block "
                "(a thread a lane) where Dmax <= 32, 512 (8 rows a thread) above")
        elif name in ("fused_scan", "fused_scan_batch"):
            kernels[-1].update(
                variant="grid-stride walk: 512 threads a block, 8 rows a thread, the mask "
                "staged in shared memory and written 8 contiguous bytes a thread")
    print(json.dumps({"kernels": kernels}), flush=True)
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the query, batched, offload, service "
                             f"or LM paths: {idle}")

    # phase 11
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
