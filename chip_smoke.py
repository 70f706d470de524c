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
   windows and 128 runs that end at 384, all/none/last-row compaction
   masks, 2^10- and 2^17-byte filters;
   for the batch and aggregate kernels: pages of different dictionary sizes
   and a size of 0, per-block empty ranges, 1, 3 and 128 groups, group ids
   out of range, a 128-group window that no row falls in, all-masked blocks,
   int32 at +-2^31, float +-inf and NaN, int32 masks, k = 1, 6, 32; for
   the grid-stride walks of fused_scan, fused_scan_batch, fused_agg,
   filter_compact and rle_decode, 5,000 blocks, more than one wave of CTAs, and 1,473, not
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
   launches most: k = 4, float32, 184 pages of 11 and 9 entries; for
   rle_decode on the writer's pages, torch.repeat_interleave of the runs by
   their lengths, the expansion alone);
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
F. the scan fabric on each file order, after phase S, every launch count
   set to 0 at its start and read at its end; fleets are ScanFabric(n_pods=n,
   device="cuda"), all pods on the one card, offload pinned to raw unless
   said: (a) for n = 1, 2 and 4, (b)'s six lineitem plans (Q19's with its
   bloom), a compact=True plan and phase 7(b)'s pushdown plans, each alone
   through the fleet (columns, mask, count, aggregates bit-identical to the
   direct scan, ScanStats equal but kernel_launches and batch_pad_blocks),
   then all in one drain (bit-identical); filter_compact launched exactly
   once a column of each compact merge; per n the row groups each pod owns,
   the drain's wall ms, launches by kernel, each pod's median tick seconds
   and the modeled per-pod busy seconds (benchmarks/service_bench.py's
   _fabric_busy_s) and their max; (b) 3 pods, a tick budget of one row
   group: a pod holding a queued sub-scan fails after the first tick,
   explicitly and silently (drained by its heartbeat), the scan replays
   bit-identically (replays, reassigned and replayed printed), and failing
   a one-pod fleet's pod raises; (c) service_bench's _run_fabric_peer: two
   pods warm under preloaded, add_pod(), the same scan bit-identical, the
   new pod's peer hits billed to the tenant, the hop's seconds beside their
   storage equivalent, and clearing its store (whose peer hits alias its
   siblings' tensors) leaves every sibling's entry; (d) service_bench's
   _run_fabric_skew with the fleet's WFQ re-level on and off: bit-identical,
   the mice's p99 ticks and ms, the Jain index and fleet_vtime_seconds (> 0
   only with the re-level); (e) a fail_forever plan on one pod of three:
   drained by its breaker, the scan bit-identical; a one-pod fleet keeps its
   pod and ends FetchFailed; (f) a scan by table name with the catalog
   re-registered to the other file order mid-scan: the in-flight scan equals
   its pinned version's, the next one the new version's, no pin left;
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
   bf16 (the wgmma route) and float32 (the tf32x3 route: mma.sync in three
   TF32 passes; the route tally must show one launch each) against
   `ref.mha` and the model's own `layers.attention`, then the kernel timed
   as phase 3 times one at that shape, at a stack of 4 prompts, in float32,
   at gemma-7b's head dim (B 1, 16 heads, S 2048, D 256, bf16, random from
   --seed) and at D 32 (the same, bf16 on the tf32x3 route), each with its
   route, beside its bound (and the share of it), `ref.mha` and, as a
   yardstick the port never calls, torch's scaled_dot_product_attention (and
   the kernel's time over it);
T. training at the full width of qwen3-1.7b (bf16, remat, AdamW with
   tests/test_system.py's OptConfig), every launch count set to 0 at its
   start and read at its end, on a corpus that the port's write_corpus
   writes at vocab 151,936 (token k = 18; 2 shards of 8 row groups of
   65,536 rows): (a) `train` on a TokenPipeline(mode="fused") of 1 x 4,096:
   the losses finite and falling, bitunpack launched once a step (the step
   unpacks the packed blocks as its first op); then steps timed one by one:
   step ms (median), tokens/s, peak device memory, one step's device busy
   ms, idle share and top operations (torch.profiler), and the model-FLOP
   share of 989 TFLOP/s; (b) host and engine (quality >= 30) and fused
   batches each feeding the same step (step ms per mode), host and engine
   batches equal token for token, and each pipeline alone over 8 batches of
   4 x 4,096 (benchmarks/pipeline_bench.py's tokens/s, host bytes/token and
   DMA bytes/token) beside the step: engine mode launches bitunpack,
   rle_decode and filter_compact; (c) unfiltered fused batches unpack to
   the host mode's tokens bit for bit; (d) at 2 layers of full width, a
   4-step run checkpointed every 2 steps, then a run to 6 that resumes at 4
   with the pipeline's cursor, its losses within 1e-3 relative of an
   uninterrupted 6-step run's; (e) 2 layers at float32 (TF32 off), one
   step on the card against the CPU: loss, gradients and parameters;
M. the decoder-only MoE, SSM and hybrid families at full width, one model at
   a time, each freed before the next: mamba2-370m, hymba-1.5b and
   deepseek-moe-16b uncut, llama4-maverick-400b cut from 48 to 2 layers (one
   moe_pair with all 128 experts at d 5,120 and F 8,192), bf16 parameters
   from `init_params` with --seed; per family every launch count set to 0
   before its calls and read after (a) and (b)'s first engine: (a) a
   4,096-token prompt through `prefill` bit-packed at `token_bits(cfg)` (16,
   15, 17 and 18 bits) and as tokens, the logits and every cache leaf
   bit-identical, bitunpack launched once and nothing else; (b) a 4-slot
   ServeEngine drains prompts of 1,024, 2,048, 3,072 and 4,096 tokens with 8
   new tokens each (hymba's longer three wrap its 1,024-slot rings), a
   second engine gives the same tokens, decode at 1,024 agrees with the
   1,025-token prefill within 2^-5 relative L2 (the decode's history that
   prefill's own keys and values where the caches hold nothing else; MoE
   families with every entry within capacity, moe_capacity E, the model's
   own capacity and the last token's dropped entries printed beside it;
   where the two paths' bf16 roundings route the last token to other
   experts, the identity is held in float32 at full width within 1e-3
   instead, the bf16 numbers printed); prefill ms per request,
   decode ms per tick, tokens/s, peak device memory and, from
   torch.profiler, one decode tick's idle share; (c) the config cut to 2
   layers (hymba's first one global; llama4 with 16 of its 128 experts, since
   2 layers of 128 at float32 are 74 GB a side) at float32, TF32 off: a
   256-token prefill and 8 decode steps on the card against the CPU, the
   logits within 1e-3 and every MoE call's expert ids equal, and on the
   card decode at 256 against the 257-token prefill within 1e-3, routed
   alike;
E. the enc-dec and VLM families at full width, one model at a time, each
   freed before the next: whisper-base uncut (6 encoder and 6 decoder
   layers, d 512, 8 heads of 64, gelu d_ff 2,048, vocab 51,865 padded to
   53,248, 1,500 encoder frames) and llava-next-34b cut from 60 to 30 layers
   at full width (d 7,168, 56 heads with 8 kv heads of 128, d_ff 20,480,
   vocab 64,000 padded to 65,536, 576 vision tokens; 60 layers are 68.9 GB
   of bf16 weights, and init_params draws each stacked leaf whole in
   float32), bf16 parameters from `init_params` with --seed; per model every
   launch count set to 0 before its calls and read after them: (a) a
   4,096-token prompt through `prefill` bit-packed at `token_bits(cfg)` (16)
   and as tokens (whisper over 1,500 random frames), the logits and every
   cache leaf (ck/cv included) bit-identical, bitunpack launched once and
   nothing else in the whole window; llava's prefill with random (1, 576,
   7,168) vision embeddings gives the same logits bit for bit, as the
   reference's does; (b) a 4-slot ServeEngine drains prompts of 64, 192,
   320 and 448 tokens with 32 new tokens each on 512-slot caches (whisper)
   or phase M's prompts with 16 (llava), a second engine gives the same
   tokens, decode at S agrees with the (S+1)-token prefill within 2^-5
   relative L2 (whisper at 448 over (a)'s frames; llava at 1,024, in
   float32 at 16 layers of full width within 1e-3, since its bf16 gap
   compounds past 2^-5 from 16 layers on, printed beside it); prefill
   ms per request, whisper's encoder ms alone, decode ms per tick, tokens/s,
   peak device memory and one decode tick's idle share from torch.profiler;
   (c) at float32, TF32 off, whisper uncut and llava at 1 layer: a
   256-token prefill (whisper over 1,500 random frames) and 8 decode steps
   on the card against the CPU, the logits within 1e-3; (d) one training
   step on the card against the CPU at (c)'s configs (whisper B 2 x 448
   tokens with frames, llava B 1 x 128 tokens after 576 vision embeddings):
   phase T (e)'s bounds, the loss, the grad norm and every leaf's gradient
   (vis_proj and enc_final_ln included; read from the step's first moments,
   (1 - b1) times the clipped gradients) and parameters; (e) whisper-base
   trained in bf16 at full width: 4 AdamW steps (tests/test_system.py's
   OptConfig) on one batch of 8 x 448 tokens with random frames, the losses
   finite and falling, step ms, tokens/s and peak device memory;
D. serving under a device mesh: NCCL initialized at world size 1 on a
   HashStore and a (data=1, model=1) mesh from `distributed.compat.
   make_mesh` on the card, every launch count set to 0 at the phase's start
   and read at its end; qwen3-1.7b at full width from --seed's bf16
   parameters, placed as DTensors by `sharding.shard_params`: (a) a 4-slot
   ServeEngine drains phase 9's four prompts with 16 new tokens each under
   the mesh (strategy tp) and without it, the same tokens; a 1,024-token
   prefill's logits under the mesh against without it (largest difference
   printed; bit for bit is expected on one rank, within 1e-3 relative L2
   held); prefill ms, decode ms per tick, tokens/s and, from
   torch.profiler, one decode tick's idle share, each under the mesh and
   without it (what DTensor's dispatch costs the host); (b) a 4,096-token
   prompt bit-packed through `prefill` under the mesh: bitunpack launched
   once on the rank's own shard of the words, and nothing else in the
   phase, the logits equal to the tokens prefill's under the mesh; (c) the
   serve launcher, `launch.serve.main` on qwen3-1.7b at full width on the
   card, 16 requests: requests, tokens, tokens/s and ticks; (e)-(i)
   training under the mesh (qwen3-1.7b and deepseek-moe-16b at 2 layers
   of full width against no mesh, B 1 x 4,096 packed tokens a step, the
   collectives, a checkpoint re-meshed, the train launcher's mesh); (j)
   whisper-base uncut and mamba2-370m, hymba-1.5b and llava-next-34b cut
   to 2 layers at full width (on one rank depth changes nothing of what
   the mesh checks), each served by a 4-slot engine under the mesh and
   without it (phase M's prompts of 1,024-4,096 tokens, whose longer
   three wrap hymba's 1,024-slot rings; whisper's 64-448 over 1,500 zero
   frames; 16 new tokens each): the same tokens and ticks, a packed
   4,096-token prefill under the mesh (whisper: 448 tokens over random
   frames) against the tokens prefill without it within 1e-3 relative
   L2, its largest difference printed, prefill ms, decode ms per tick,
   busy ms, idle share and peak GB for both, whisper's encoder ms; (k)
   the same models at the same depths trained with remat, 3 AdamW steps
   under the mesh and without it, bit for bit in losses, grad norms and
   parameters, the second step's ms (and the first's) and the third's
   idle share for both: B 1 x 4,096 packed tokens (llava after its 576
   vision embeddings), whisper 8 x 448 tokens over 8 x 1,500 frames; (l)
   bitunpack counted over the window: one a packed prefill, one a packed
   step, nothing else; (d) the process group destroyed;
R. the multi-pod dry run: `python -m repro_torch.launch.dryrun`, a cell a
   subprocess (its `fake` process group is global to its process), all
   started together: qwen3-1.7b x decode_32k and x train_4k on the 16x16 mesh, and
   x long_500k, which a full-attention arch skips; mamba2-370m x decode_32k
   (its SSD mixer on each model rank's 2 of 32 heads), hymba-1.5b x
   decode_32k (its in_proj on each model rank's columns) and
   deepseek-moe-16b x decode_32k (its caches read in the layout they are
   placed in): each record's status, per-device FLOPs, collective bytes,
   argument bytes and trace seconds, with the card's name and power limit (a
   dry run computes nothing on the card, so the phase prints no card time);
   qwen3's train_4k, mamba2's decode and hymba's decode at most 1.02x the
   reference's per-device FLOPs (ROADMAP C.5, C.7), deepseek's decode at
   most 6.214e9 all-gather bytes a device (C.6); a nonzero exit, a failed
   cell, a cell of another status or over its bound stops the script;
10. print one JSON line with every kernel's record (its launches, summed over
   the counted windows of phases 5, 7, O, S and F on both file orders and of
   phases 9, T, M, E and D, must be > 0; phase D's as `launches_dist`);
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
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import BlockCache, DatapathEngine, agreement, tpch  # noqa: E402
from repro_torch.core import queries as Q  # noqa: E402
from repro_torch.core.plan import AggSpec, Cmp, ScanPlan, bind_expr  # noqa: E402
from repro_torch.core.zonemap import prune_row_groups  # noqa: E402
from repro_torch.data.corpus import write_corpus  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.datapath import (  # noqa: E402
    PAPER_FIG2_PCT,
    CostModel,
    DatapathService,
    DecodePool,
    FaultPlan,
    FetchFailed,
    RetryPolicy,
    ScanFabric,
    StaticPolicy,
    StorageFault,
    jain_index,
)
from repro_torch.distributed.collectives import (  # noqa: E402
    compressed_psum,
    hierarchical_psum,
)
from repro_torch.distributed.compat import BACKENDS, make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingCtx,
    local_ctx,
    shard_params,
    sharding_for,
)
from repro_torch.kernels import agg_push, bitunpack, bloom_probe, build, delta_decode  # noqa: E402
from repro_torch.kernels import dict_decode, filter_compact, fused_scan  # noqa: E402
from repro_torch.kernels import ops, ref, rle_decode  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.lakeformat.encodings import bitpack_encode, rle_encode  # noqa: E402
from repro_torch.lakeformat.reader import LakeReader  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import layers, model, moe  # noqa: E402
from repro_torch.models.transformer import _proj_qkv  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.loop import make_train_step, train  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    OptConfig,
    init_opt_state,
    opt_state_dims,
    plain,
    tree_leaves,
    tree_map,
)

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
#   rle_decode      by the rank table (a warp a block), per lane and block
#                   the walk, fetch and addresses 25, the scatter's 4 ends
#                   at 10 each and the lane total and 5-step scan 18, 4 a
#                   table word and 2 a value; by search (8 tiles a block, a
#                   CTA a block), per thread the block's and its own
#                   addresses 6 and 22 a value (csrc/rle_decode.cu's note):
#                   rle_ops
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
RLE_OPS_TABLE_LANE, RLE_OPS_PER_WORD = 25 + 58, 4 + 4 * 2
RLE_OPS_SEARCH_THREAD, RLE_OPS_SEARCH = 6, 22
COMPACT_OPS_PER_VALUE = 8


def ops_per_value(name: str, k: int) -> int:
    return EXTRA_OPS_PER_VALUE[name] + (2 if k < 32 else 0)


def bloom_ops_per_key(n_hashes: int) -> int:
    return 21 + 5 * n_hashes


def rle_ops(nb: int, sms: int) -> int:
    """rle_decode's integer issue slots for `nb` blocks as the wrapper
    launches them on a card of `sms` SMs: 32 lanes a block, each with 8
    table words of 4 values, or 256 threads a block, each with 4 values
    searched (8 tiles a block)."""
    split, _ = rle_decode.launch_shape(nb, sms)
    lane = (RLE_OPS_SEARCH_THREAD + 4 * RLE_OPS_SEARCH if split == 8 else
            RLE_OPS_TABLE_LANE + RLE_OPS_PER_WORD * 8)
    return nb * split * 32 * lane


T0 = time.perf_counter()


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


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
    # exactly 128 runs, one run per block, float32 runs.  On the writer's
    # pages, whose runs end at 1,024, one PyTorch call computes the same:
    # repeat_interleave of the runs by their lengths, the ends differenced
    # within each block before timing (the expansion alone; a yardstick the
    # port never calls).
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rle_pages(values):
        bufs = rle_encode(values)
        return (torch.from_numpy(bufs["rle_values"]).cuda(),
                torch.from_numpy(bufs["rle_ends"]).cuda())

    def rle_case(label, nb, vals, ends, library=None):
        case(cases, "rle_decode", label, nb,
             lambda: rle_decode.rle_decode(vals, ends),
             lambda: ref.rle_decode(vals, ends),
             nb * (512 + 512 + 4096), rle_ops(nb, sms), library=library)

    def expansion(nb, vals, ends):
        flat = vals.reshape(-1)
        lengths = torch.diff(ends.long(), dim=1, prepend=ends.new_zeros(nb, 1).long()).reshape(-1)
        return lambda: torch.repeat_interleave(flat, lengths, output_size=nb * 1024)

    for label, nb in [("path: sorted dates, 1-2 runs a block", RLE_PATH_BLOCKS),
                      ("stack: sorted dates", RLE_STACK_BLOCKS)]:
        days = nb * 1024 // 2346 + 1
        dates = np.sort(rng.integers(0, days, nb * 1024)).astype(np.int32)
        vals, ends = rle_pages(dates)
        rle_case(label, nb, vals, ends, library=expansion(nb, vals, ends))

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

    # rle_decode's grid-stride walk through the rank table, after every older
    # case for the same reason: a warp a block at both, more tiles than warps
    # at 5,000, a last CTA with idle warps at 1,473.  Of every 14 rows the
    # first 6 take the windows a rank table can get wrong, so that each meets
    # the walk at many places: 128 runs to 1,024; one run; 31 runs, then the
    # writer's padding; 128 runs ending at 384 (the clip re-reads run 127 for
    # the rest); every end 0 (every position takes run 127); runs of 64
    # between 7 empty ones
    edges = [np.arange(1, 129) * 8, np.full(128, 1024), np.minimum(np.arange(1, 129) * 34, 1024),
             np.arange(1, 129) * 3, np.zeros(128), np.repeat(np.arange(0, 1024, 64), 8)]

    def walk_windows(nb, dtype):
        vals, ends = random_windows(nb, dtype)
        ends = ends.cpu().numpy()
        for k, row in enumerate(edges):
            ends[k::14] = row
        return vals, torch.from_numpy(ends).cuda()

    for nb, dtype in zip(WALK_BLOCKS, ("int32", "float32")):
        rle_case(f"walk: {nb} blocks, random and edge windows {dtype}", nb,
                 *walk_windows(nb, dtype))
    # the same clip at the path's 64 blocks, where a CTA searches a block
    short = np.broadcast_to(np.arange(1, 129, dtype=np.int32) * 3, (RLE_PATH_BLOCKS, 128))
    rle_case("128 runs ending at 384 (the clip)", RLE_PATH_BLOCKS,
             random_windows(RLE_PATH_BLOCKS, "int32")[0],
             torch.from_numpy(np.ascontiguousarray(short)).cuda())
    # the writer's pages of 14 row groups (896 blocks), the batched stack of
    # sorted q6's and q14's dates: a walk of under a block a warp, near the
    # wrapper's choice between the walk and the search
    dates = np.sort(rng.integers(0, 896 * 1024 // 2346 + 1, 896 * 1024)).astype(np.int32)
    rle_case("14 row groups: sorted dates", 896, *rle_pages(dates))
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
    same_stats(a, b, label)


def same_stats(a, b, label: str) -> None:
    """Two scans' ScanStats equal in every field but kernel_launches (the port
    pads no stack, so batch_pad_blocks is 0 on every path); raises otherwise."""
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
# phase F: the scan fabric
# ---------------------------------------------------------------------------

FLEET_PODS = (1, 2, 4)
# (a): a compact plan beside phase S's six: the pods scan it uncompacted and
# the merge compacts the reassembled stream once, on a surviving pod's
# engine (one filter_compact launch a column)
COMPACT_PLAN = ScanPlan("lineitem", ["l_quantity"], Cmp("l_quantity", "le", 3), compact=True)
# (b), (c), (e), (f): tests/test_fabric.py's unprunable plan, which puts a
# sub-scan on every pod
FLEET_PLAN = ScanPlan("lineitem", ["l_extendedprice", "l_quantity"], Cmp("l_quantity", "le", 25))


def drain_fabric(fab, on_tick=None) -> int:
    """Tick until no fabric ticket is active, with a hang guard; calls
    on_tick(tick) after each tick.  Returns the ticks taken."""
    for tick in range(1, MAX_TICKS + 1):
        if not fab.active:
            return tick - 1
        fab.tick()
        if on_tick is not None:
            on_tick(tick)
    raise AssertionError(f"the fabric made no progress in {MAX_TICKS} ticks")


def new_fabric(device: str, n_pods: int, **kw):
    """A fleet of n_pods on `device`, offload pinned to raw (phase S's
    convention: no cache state between scans) unless `policy` is given."""
    kw.setdefault("policy", StaticPolicy("raw"))
    return ScanFabric(n_pods=n_pods, device=device, **kw)


def fleet_busy_s(fab) -> dict:
    """benchmarks/service_bench.py's _fabric_busy_s: each live pod's
    scheduled + reconciled + retained seconds, the modeled occupancy the
    WFQ clocks charge (pods would run concurrently on their own cards)."""
    return {pid: sum(sum(d.values()) for d in (
                fab.pods[pid].telemetry.tenant_sched_seconds,
                fab.pods[pid].telemetry.tenant_recon_seconds,
                fab.pods[pid].telemetry.tenant_retained_seconds))
            for pid in fab.live_pods}


def same_aggs(a, b, label: str) -> None:
    """Two aggregate scans equal in count and every aggregate, bit for bit."""
    if int(a.count) != int(b.count) or sorted(a.aggregates) != sorted(b.aggregates):
        raise AssertionError(f"{label}: count or aggregate names differ")
    for k, w in b.aggregates.items():
        g = a.aggregates[k]
        if g.dtype != w.dtype or g.tobytes() != w.tobytes():
            raise AssertionError(f"{label}: {k} differs")


def same_result(a, b, label: str) -> None:
    """A row or aggregate scan against another, bit for bit."""
    (same_aggs if b.aggregates is not None else same_rows)(a, b, label)


def fleet_skew(li, device: str, relevel: bool, rg_rows: int):
    """benchmarks/service_bench.py's _run_fabric_skew: one elephant (two
    whole-table scans) and three mice over two pods.  Returns (fleet,
    tickets, {mouse: (done tick, ms since submission)}, ticks, wall ms)."""
    fab = new_fabric(device, 2, tick_bytes=int(rg_rows * 4 * 2 * 1.5),
                     reconcile_fairness=relevel)
    plans = [("elephant", ScanPlan("lineitem", ELEPHANT_COLS)),
             ("elephant", ScanPlan("lineitem", ["l_discount", "l_tax"]))]
    plans += [(f"mouse{i}", ScanPlan("lineitem", ["l_extendedprice"],
                                     Cmp("l_shipdate", "between", (d, d + 200))))
              for i, d in enumerate(MICE_DAYS)]
    done = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [fab.submit(tenant, li, plan) for tenant, plan in plans]

    def note(tick):
        for t in tickets[2:]:
            if t.status == "done" and t.tenant not in done:
                done[t.tenant] = (tick, (time.perf_counter() - t0) * 1e3)

    ticks = drain_fabric(fab, note)
    torch.cuda.synchronize()
    return fab, tickets, done, ticks, (time.perf_counter() - t0) * 1e3


def fabric_phase(readers, order: str, other, device: str = "cuda"):
    """Phase F on one file order: (a) fleets of 1, 2 and 4 pods against the
    direct scans, (b) a pod drained explicitly and by its heartbeat, (c)
    scale-out peer fetch, (d) fleet fairness with the re-level on and off,
    (e) a breaker drain, (f) the catalog's snapshot isolation (`other` is the
    other file order's readers).  Every launch count is set to 0 at its start
    and read at its end.  Returns those counts."""
    li = readers["lineitem"]
    rg_rows = li.row_group_meta(0)["n"]
    ops.reset_kernel_launches()
    eng = DatapathEngine(device=device)

    # (a) bit identity: each plan alone through the fleet against the direct
    # scan (ScanStats included), then all of them in one drain
    bloom = Q.q19_bloom(eng, readers)
    scans = {name: (make(), {"q19": bloom} if name == "q19" else None)
             for name, make in Q.LINEITEM_PLANS.items()}
    scans["compact"] = (COMPACT_PLAN, None)
    scans.update((name, (plan, None)) for name, plan in PUSHDOWN_PLANS.items())
    direct = {name: eng.scan(li, plan, blooms=blooms) for name, (plan, blooms) in scans.items()}
    for n in FLEET_PODS:
        before = ops.kernel_launches()
        fab = new_fabric(device, n)
        alone, alone_ms = wall(lambda: {name: fab.scan(li, plan, blooms, tenant=name)
                                        for name, (plan, blooms) in scans.items()})
        for name, res in alone.items():
            same_result(res, direct[name], f"{order} (a) {n} pods {name}")
            same_stats(res, direct[name], f"{order} (a) {n} pods {name}")
        fab = new_fabric(device, n, batch_per_tick=len(scans))
        tickets, ms = wall(lambda: ([fab.submit(name, li, plan, blooms)
                                     for name, (plan, blooms) in scans.items()],
                                    drain_fabric(fab))[0])
        for t in tickets:
            if t.status != "done":
                raise AssertionError(f"{order} (a) {n} pods {t.tenant}: {t.status} {t.error!r}")
            same_result(t.result, direct[t.tenant], f"{order} (a) {n} pods, one drain, {t.tenant}")
        after = ops.kernel_launches()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        merges = 2 * len(COMPACT_PLAN.columns)  # (a)'s compact plan, alone and in the drain
        if launched.get("filter_compact", 0) != merges:
            raise AssertionError(f"{order} (a) {n} pods: filter_compact launched "
                                 f"{launched.get('filter_compact', 0)} times, not the "
                                 f"merges' {merges}")
        owned = {pid: 0 for pid in fab.live_pods}
        for rg in range(li.n_row_groups):
            owned[fab.owner_of(li.path, rg)] += 1
        strag = fab.report()["stragglers"]
        busy = fleet_busy_s(fab)
        log(f"      (a) {order} {n} pods: {len(scans)} plans bit-identical to the direct scans "
            f"(ScanStats but the launch counts too); one at a time {alone_ms:.2f} ms; one drain "
            f"drain_ms={ms:.2f} ticks={fab._tick}; row groups owned {owned}; launches "
            f"{launched}; median tick s "
            f"{ {p: round(strag[p]['median_s'], 6) for p in fab.live_pods} }; modeled busy s "
            f"{ {p: round(v, 6) for p, v in busy.items()} } makespan_s={max(busy.values()):.6f}")

    # (b) drain: a pod holding a queued sub-scan fails after the first tick,
    # explicitly and silently (the heartbeat drains it)
    want = eng.scan(li, FLEET_PLAN)
    for silent in (False, True):
        fab = new_fabric(device, 3, tick_bytes=rg_rows * 8)
        t = fab.submit("t0", li, FLEET_PLAN)
        fab.tick()
        victims = [s.pod_id for s in t.subs.values() if s.ticket.status == "queued"]
        if len(t.subs) < 2 or not victims:
            raise AssertionError(f"{order} (b): subs {list(t.subs)}, none queued after a tick")
        victim = victims[0]
        fab.fail_pod(victim, silent=silent)
        gone = {}

        def note(tick, fab=fab, victim=victim, gone=gone):
            if victim not in fab.live_pods:
                gone.setdefault("tick", tick)

        ticks, ms = wall(lambda: drain_fabric(fab, note))
        rep = fab.report()
        if (t.status != "done" or t.replays < 1 or victim in fab.live_pods
                or rep["drains"][-1]["dead"] != victim or rep["drains"][-1]["replayed"] < 1):
            raise AssertionError(f"{order} (b) silent={silent}: {t.status} {t.error!r} "
                                 f"replays {t.replays} drains {rep['drains']}")
        same_rows(t.result, want, f"{order} (b) silent={silent}: the replayed scan")
        log(f"      (b) {order} silent={silent}: {victim} failed after tick 1, drained "
            + (f"by its heartbeat {gone.get('tick', 0)} ticks later" if silent else "at once")
            + f"; bit-identical; replays={t.replays} reassigned="
            f"{rep['drains'][-1]['reassigned']} replayed={rep['drains'][-1]['replayed']} "
            f"survivors={rep['drains'][-1]['survivors']} ticks={ticks + 1} drain_ms={ms:.2f}")
    try:
        new_fabric(device, 1).fail_pod("pod0")
    except RuntimeError:
        pass
    else:
        raise AssertionError(f"{order} (b): failing a one-pod fleet's last pod did not raise")

    # (c) scale-out peer fetch: two warm pods, a third joins and steals arcs
    fab = new_fabric(device, 2, policy=StaticPolicy("preloaded"))
    same_rows(fab.scan(li, FLEET_PLAN), want, f"{order} (c) warm-up")
    new = fab.add_pod()
    got, ms = wall(lambda: fab.scan(li, FLEET_PLAN))
    same_rows(got, want, f"{order} (c) after add_pod")
    store, tel = fab.pods[new].store, fab.pods[new].telemetry
    serves = sum(fab.pods[p].store.peer_serves for p in fab.live_pods)
    if not (store.peer_hits > 0 and got.stats.peer_bytes == store.peer_hit_bytes > 0
            and tel.tenant_peer_bytes.get("default", 0) > 0
            and tel.tenant_peer_seconds.get("default", 0) > 0 and serves == store.peer_hits):
        raise AssertionError(f"{order} (c): peer_hits {store.peer_hits} bytes "
                             f"{store.peer_hit_bytes} billed {got.stats.peer_bytes} tenant "
                             f"{tel.tenant_peer_bytes} serves {serves}")
    lm = fab.cost_model.link_model()
    storage_s = (store.peer_hits * lm.latency_us * 1e-6
                 + store.peer_hit_bytes / (lm.bandwidth_gbps * 1e9))
    # a peer hit aliases the sibling's tensor: clearing the new store frees
    # none of the siblings' entries
    aliased = [(k, e.value, e.value.clone()) for k, e in store._entries.items()
               if isinstance(e.value, torch.Tensor) and any(
                   fab.pods[p].store.peek(k) is not None
                   and fab.pods[p].store.peek(k).value is e.value
                   for p in fab.live_pods if p != new)]
    mem = torch.cuda.memory_allocated()
    store.clear()
    freed = mem - torch.cuda.memory_allocated()
    for k, v, copy in aliased:
        held = [fab.pods[p].store.peek(k) for p in fab.live_pods if p != new]
        if not any(e is not None and e.value is v for e in held) or not torch.equal(v, copy):
            raise AssertionError(f"{order} (c): clearing {new}'s store changed a sibling's {k}")
    if not aliased:
        raise AssertionError(f"{order} (c): no peer hit aliases a sibling's tensor")
    log(f"      (c) {order}: {new} joined 2 warm pods; bit-identical in {ms:.2f} ms; "
        f"peer_hits={store.peer_hits} peer_bytes={store.peer_hit_bytes} (billed to the "
        f"tenant: {tel.tenant_peer_bytes['default']:.0f} B, "
        f"{tel.tenant_peer_seconds['default']:.6f} s) hop_s={store.peer_hit_seconds:.6f} "
        f"against storage_s={storage_s:.6f} ({storage_s / store.peer_hit_seconds:.2f}x); "
        f"{len(aliased)} of its tensors alias a sibling's; clearing its store freed {freed} B "
        "of the card and no sibling's entry")

    # (d) fleet fairness: the re-level on and off
    runs = {relevel: fleet_skew(li, device, relevel, rg_rows) for relevel in (True, False)}
    for t_on, t_off in zip(runs[True][1], runs[False][1]):
        same_rows(t_on.result, t_off.result, f"{order} (d) {t_on.tenant}: re-level on and off")
    for t in runs[True][1]:
        same_rows(t.result, eng.scan(li, t.plan), f"{order} (d) {t.tenant} against the direct scan")
    for relevel, (fab, tickets, done, ticks, ms) in runs.items():
        occ = {}
        for pid in fab.live_pods:
            tl = fab.pods[pid].telemetry
            for tenant in tl.known_tenants():
                occ[tenant] = (occ.get(tenant, 0.0) + tl.tenant_decoded_bytes.get(tenant, 0.0)
                               + tl.tenant_retained_bytes.get(tenant, 0.0))
        charged = sum(fab.pods[p].telemetry.counters.get("fleet_vtime_seconds", 0.0)
                      for p in fab.live_pods)
        if (charged > 0) != relevel or len(done) != len(MICE_DAYS):
            raise AssertionError(f"{order} (d) relevel={relevel}: fleet_vtime_seconds "
                                 f"{charged}, mice done {done}")
        log(f"      (d) {order} relevel={relevel}: drain_ms={ms:.2f} ticks={ticks} mice p99: "
            f"ticks={max(d[0] for d in done.values())} "
            f"ms={max(d[1] for d in done.values()):.2f}; jain_index="
            f"{jain_index(list(occ.values())):.4f} fleet_vtime_seconds={charged:.6f}")

    # (e) the breaker drains a pod whose storage fails forever; never the last
    fab = new_fabric(device, 3, tick_bytes=rg_rows * 8)
    t = fab.submit("t0", li, FLEET_PLAN)
    victim = next(iter(t.subs.values())).pod_id
    fab.inject_faults(victim, FaultPlan(transient_rate=1.0, fail_forever=True),
                      RetryPolicy(max_attempts=5))
    ticks, ms = wall(lambda: drain_fabric(fab))
    if (t.status != "done" or t.replays < 1 or victim in fab.live_pods
            or fab.report()["breaker_drains"] < 1):
        raise AssertionError(f"{order} (e): {t.status} {t.error!r} replays {t.replays} live "
                             f"{fab.live_pods} {fab.report()['breaker_drains']}")
    same_rows(t.result, want, f"{order} (e) after the breaker drain")
    one = new_fabric(device, 1, tick_bytes=rg_rows * 8)
    one.inject_faults("pod0", FaultPlan(transient_rate=1.0, fail_forever=True),
                      RetryPolicy(max_attempts=5))
    t1 = one.submit("t0", li, FLEET_PLAN)
    drain_fabric(one)
    if (t1.status != "error" or not isinstance(t1.error, FetchFailed)
            or one.live_pods != ["pod0"] or one.report()["breaker_drains"] != 0):
        raise AssertionError(f"{order} (e) one pod: {t1.status} {t1.error!r} {one.live_pods}")
    log(f"      (e) {order}: fail_forever on {victim}: breaker_drains="
        f"{fab.report()['breaker_drains']}, replays={t.replays}, survivors {fab.live_pods} "
        f"bit-identical in {ticks} ticks, {ms:.2f} ms; a one-pod fleet keeps its pod and ends "
        f"with {type(t1.error).__name__}")

    # (f) the catalog: a re-registration mid-scan is invisible to the scan
    other_li = other["lineitem"]
    want_other = eng.scan(other_li, FLEET_PLAN)
    fab = new_fabric(device, 2, tick_bytes=rg_rows * 8)
    v1 = fab.catalog.register("lineitem", li)
    t_old = fab.submit("t0", "lineitem", FLEET_PLAN)
    fab.tick()
    pinned = fab.catalog.pinned_versions()
    v2 = fab.catalog.register("lineitem", other_li)
    t_new = fab.submit("t0", "lineitem", FLEET_PLAN)
    drain_fabric(fab)
    same_rows(t_old.result, want, f"{order} (f) the scan pinned to v{v1}")
    same_rows(t_new.result, want_other, f"{order} (f) the scan submitted at v{v2}")
    if pinned != [v1] or fab.catalog.pinned_versions():
        raise AssertionError(f"{order} (f): pins {pinned} mid-scan, "
                             f"{fab.catalog.pinned_versions()} after the drain")
    log(f"      (f) {order}: lineitem re-registered to the other file order mid-scan: the "
        f"in-flight scan equals v{v1}'s direct scan, the next one v{v2}'s; pins {pinned} "
        "mid-scan, none after the drain")
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
# float32 work at float32 accuracy: three TF32 passes on the H100 SXM's
# tensor cores (495 TFLOP/s dense) split each operand into two TF32 parts and
# hold float32's tolerance, so 495 / 3, above the 67 TFLOP/s of float32 FMAs
# on the CUDA cores, is the least time the card could take
F32_FLOPS_PER_S = 495e12 / 3
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
    flash_attention.ROUTE_LAUNCHES.update(wgmma=0, tf32x3=0)
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
    if routes != {"wgmma": 1, "tf32x3": 1}:
        raise AssertionError("the bf16 flash_attention call did not take the wgmma route, or "
                             f"the float32 one the tf32x3 route: {routes}")

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
    card_params = tree_map(lambda p: p.to(device, copy=True), cpu_params)
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
    wide, narrow = (tuple(torch.from_numpy(rng.standard_normal((1, 16, 2048, d))
                                           .astype(np.float32)).to(device, torch.bfloat16)
                          for _ in range(3)) for d in (D, 32))
    rec = flash_cases(qkv, stack, wide, narrow, cfg)
    rec["launches_by_route"] = routes
    return launches, rec


def flash_cases(path, stack, wide, narrow, cfg) -> dict:
    """flash_attention timed as phase 3 times a kernel: at the path's shape
    (one qwen3 layer at S = 4096, bf16), the stack (4 prompts), float32,
    gemma-7b's head dim (D 256, bf16) and D 32 (bf16, the tf32x3 kernel's
    bf16 instantiation), each on the route its dtype and head dim give, with
    its share of the bound and its time over SDPA's."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=path[0].device)
    rec = {"max_abs_err": 0.0, "cases": []}
    for label, (q, k, v), scale in (("path: layer 0, bf16", path, cfg.attn_scale),
                                    (f"stack: {STACK_BATCH} prompts, bf16", stack,
                                     cfg.attn_scale),
                                    ("path: layer 0, float32", tuple(t.float() for t in path),
                                     cfg.attn_scale),
                                    ("D 256: 16 heads, S 2048, bf16", wide, None),
                                    ("D 32: 16 heads, S 2048, bf16", narrow, None)):
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


# ---------------------------------------------------------------------------
# phase T: training at full width, fed by the datapath's token pipeline
# ---------------------------------------------------------------------------

# tests/test_system.py's S, the launcher's --seq; B 2, since at B 1 the step
# peaked at 33.4 GB of the H100's 80
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
# (a): train()'s steps, then TIMED_STEPS more timed one by one.  At full width
# the loss rises over AdamW's first 3-5 steps before it falls (at lr 1e-3 and
# at 3e-4, B 1 and 2), so 8 of the schedule's 10 steps: B 2 gave 12.39,
# 12.64, 12.43, 14.03, 14.52, 10.35, 9.71, 9.29 on one H100
TRAIN_STEPS = 8
TIMED_STEPS = 3
MODE_STEPS = 2  # (b): steps fed by each ingestion mode
TRAIN_QUALITY = 30  # (b): host and engine filter quality >= 30, fused reads all
CORPUS_SHARDS, CORPUS_RG = 2, 65536
CORPUS_TOKENS = CORPUS_SHARDS * 8 * CORPUS_RG  # 2 shards of 8 row groups: 1,048,576
PIPE_B, PIPE_BATCHES = 4, 8  # benchmarks/pipeline_bench.py: 8 batches of 4 x 4,096
RESUME_LAYERS = CHECK_LAYERS  # (d): full width, 2 layers (a checkpoint of 28 is 17 GB)
RESUME_STEPS, RESUME_TO = 4, 6
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)  # test_system.py's
# (d) the resumed run's losses against an uninterrupted run's: the same
# parameters, moments and batches restored bit for bit, but the card's
# embedding backward may add in another order, which moves a bf16 parameter
# by an ulp (2^-8); one step on top moves the loss by far less than 1e-3.
RESUME_REL = 1e-3
# (e) the card against the CPU at float32, TF32 off: the loss within 1e-5
# relative; gradients and parameters after the step by relative L2 per
# leaf: sums in other orders over up to 6,144 terms differ by ~1e-6
# relative; 1e-4 leaves room for that carried through 2 layers and the
# backward.  After the AdamW step an element whose gradient lies within
# rounding of 0 may step by 2 lr the other way: 1e-3 for the parameters.
STEP_LOSS_REL, STEP_GRAD_REL, STEP_PARAM_REL = 1e-5, 1e-4, 1e-3


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).norm() / max(float(w.norm()), 1e-30))


def train_flops(cfg, n_params: int, tokens: int, B: int, S: int) -> float:
    """Model FLOPs of one training step: 6 n_params tokens (every
    parameter's product forward and backward, the tied head's through the
    embedding) plus the plain attention's full-square products, q k^T and
    p v at 2 B H S^2 hd each, which run forward, again in the recompute
    (remat), and twice in the backward: 4 x 4 B H S^2 hd a layer.  The
    recomputed projections are hardware work, not model FLOPs."""
    attn = 4 * 4 * B * cfg.n_heads * S * S * cfg.head_dim
    return 6 * n_params * tokens + cfg.n_layers * attn


def timed_steps(step, params, opt_state, pipe, n: int):
    """n steps on the pipeline's batches: (params, opt_state, per-step
    (ms, loss, bitunpack launches))."""
    out = []
    for _ in range(n):
        batch = pipe.next_batch()
        before = bitunpack.KERNEL.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - t) * 1e3, loss, bitunpack.KERNEL.launches - before))
    return params, opt_state, out


def pipeline_numbers(paths, mode: str, device: str) -> dict:
    """benchmarks/pipeline_bench.py's three numbers for one mode, the
    pipeline alone: PIPE_BATCHES batches of PIPE_B x TRAIN_SEQ."""
    pipe = TokenPipeline(paths, PIPE_B, TRAIN_SEQ, mode=mode,
                         quality_min=TRAIN_QUALITY if mode != "fused" else None, device=device)
    before = ops.kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PIPE_BATCHES):
        pipe.next_batch()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = PIPE_B * TRAIN_SEQ * PIPE_BATCHES
    after = ops.kernel_launches()
    return {"tokens_per_s": toks / dt,
            "host_bytes_per_token": pipe.stats["host_bytes_decoded"] / toks,
            "dma_bytes_per_token": pipe.stats["dma_bytes"] / toks,
            "ms_per_batch": dt / PIPE_BATCHES * 1e3,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def training_phase(seed: int, tmpdir: str, device: str = "cuda") -> dict:
    """Phase T.  Returns the kernel launches of its window (the whole phase)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(LM_ARCH), remat=True)
    optcfg = OptConfig(**OPT)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    paths = write_corpus(os.path.join(tmpdir, "corpus"), n_tokens=CORPUS_TOKENS,
                         vocab=cfg.vocab, n_shards=CORPUS_SHARDS, seed=seed,
                         row_group_size=CORPUS_RG)
    readers = [LakeReader(p) for p in paths]
    k = readers[0].footer["row_groups"][0]["columns"]["token"]["k"]
    log(f"      corpus: {CORPUS_TOKENS} tokens in {len(paths)} shards of "
        f"{readers[0].n_row_groups} row groups of {CORPUS_RG} (token k={k}, quality "
        f"{readers[0].row_group_meta(0)['columns']['quality']['encoding']}) written in "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) fused: train() on the packed blocks, then steps timed one by one
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused = TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="fused", device=device)
    before = bitunpack.KERNEL.launches
    t0 = time.perf_counter()
    out = train(cfg, optcfg, fused, steps=TRAIN_STEPS, seed=seed, log_every=1,
                log_fn=lambda s: log(f"      {s}"), device=device)
    train_s = time.perf_counter() - t0
    losses = out["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"(a) the loss did not fall or is not finite: {losses}")
    blocks = TRAIN_BATCH * -(-TRAIN_SEQ // 4096)
    if bitunpack.KERNEL.launches - before != TRAIN_STEPS:
        raise AssertionError(f"(a) bitunpack launched {bitunpack.KERNEL.launches - before} "
                             f"times in {TRAIN_STEPS} steps, not once a step")
    params, opt_state = out["params"], out["opt_state"]
    n_params = sum(p.numel() for p in tree_leaves(params))
    step = make_train_step(cfg, optcfg)
    params, opt_state, timed = timed_steps(step, params, opt_state, fused, TIMED_STEPS)
    if any(n != 1 for _, _, n in timed) or not all(np.isfinite([l for _, l, _ in timed])):
        raise AssertionError(f"(a) timed steps: {timed}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = sorted(ms for ms, _, _ in timed)[len(timed) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = fused.next_batch()
    busy_ms, top, _ = profiled(lambda: step(params, opt_state, batch))
    flops = train_flops(cfg, n_params, tokens, TRAIN_BATCH, TRAIN_SEQ)
    log(f"      (a) fused, B {TRAIN_BATCH} x S {TRAIN_SEQ}, {cfg.n_layers} layers, remat "
        f"{cfg.remat_policy}, {n_params} parameters: losses {[round(x, 4) for x in losses]} "
        f"(train() {train_s:.1f} s), then {[round(l, 4) for _, l, _ in timed]}; bitunpack "
        f"once a step ({blocks} block(s) of k={k})")
    log(f"      (a) step_ms (median of {TIMED_STEPS} after train()'s {TRAIN_STEPS}) "
        f"{step_ms:.2f} {[round(ms, 2) for ms, _, _ in timed]}; tokens/s "
        f"{tokens / step_ms * 1e3:.1f}; peak device bytes {peak}; one step: "
        f"busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / step_ms:.3f} top={top}; model "
        f"FLOPs {flops:.4e} a step, {flops / (step_ms / 1e3) / BF16_FLOPS_PER_S:.4f} of "
        f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s; (a) took {time.perf_counter() - t0:.1f} s")

    # (b) the three ingestion modes feeding the same step, and each pipeline alone
    t0 = time.perf_counter()
    filt = dict(quality_min=TRAIN_QUALITY, device=device)
    host = TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="host", **filt)
    eng = TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="engine", **filt)
    fed = {}
    for mode, pipe in (("host", host), ("engine", eng), ("fused", fused)):
        params, opt_state, fed[mode] = timed_steps(step, params, opt_state, pipe, MODE_STEPS)
    again = [TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode=m, **filt)
             for m in ("host", "engine")]
    for i in range(MODE_STEPS + 2):
        a, b = (p.next_batch()["tokens"] for p in again)
        if not torch.equal(a, b):
            raise AssertionError(f"(b) host and engine batch {i} differ")
    bench = {m: pipeline_numbers(paths, m, device) for m in ("host", "engine", "fused")}
    if not {"bitunpack", "rle_decode", "filter_compact"} <= set(bench["engine"]["launches"]):
        raise AssertionError(f"(b) engine mode launched {bench['engine']['launches']}")
    if any(n != 1 for _, _, n in fed["fused"]) or any(n for m in ("host", "engine")
                                                     for _, _, n in fed[m]):
        raise AssertionError(f"(b) bitunpack launches per step: {fed}")
    log(f"      (b) host and engine (quality >= {TRAIN_QUALITY}) equal token for token over "
        f"{MODE_STEPS + 2} batches; engine mode launched {bench['engine']['launches']}; "
        f"(b) took {time.perf_counter() - t0:.1f} s")
    for mode, nums in bench.items():
        ms = sorted(x for x, _, _ in fed[mode])[MODE_STEPS // 2]
        per_step = nums["ms_per_batch"] * tokens / (PIPE_B * TRAIN_SEQ)
        log(f"      (b) {mode}: pipeline tokens/s {nums['tokens_per_s']:.0f} host B/token "
            f"{nums['host_bytes_per_token']:.3f} dma B/token {nums['dma_bytes_per_token']:.3f} "
            f"ms/batch of {PIPE_B}x{TRAIN_SEQ} {nums['ms_per_batch']:.2f} (a step's "
            f"{tokens} tokens: {per_step:.2f} ms) beside step_ms "
            f"{[round(x, 2) for x, _, _ in fed[mode]]} (pipeline/step {per_step / ms:.4f}); "
            f"pipeline launches {nums['launches']}")
    del params, opt_state, out, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (c) fused == host without a filter: the step's unpacked tokens
    f2 = TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="fused", device=device)
    h2 = TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="host", device=device)
    for i in range(3):
        got = model.unpack_tokens(f2.next_batch()["packed"], TRAIN_SEQ, cfg)
        if not torch.equal(got, h2.next_batch()["tokens"]):
            raise AssertionError(f"(c) fused batch {i} unpacks to other tokens than host's")
    log("      (c) fused unpacks to the host mode's tokens bit for bit over 3 batches")

    # (d) resume: 4 steps with a checkpoint every 2, then on to 6, against 6 at once
    cfg_r = dataclasses.replace(cfg, n_layers=RESUME_LAYERS)
    ckpt = os.path.join(tmpdir, "ckpt")
    quiet = dict(seed=seed, log_every=10**9, log_fn=lambda s: None, device=device)
    t0 = time.perf_counter()
    first = train(cfg_r, optcfg, TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="fused",
                                               device=device),
                  steps=RESUME_STEPS, ckpt_dir=ckpt, ckpt_every=2, **quiet)["losses"]
    logs = []
    resumed_pipe = TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="fused", device=device)
    resumed = train(cfg_r, optcfg, resumed_pipe, steps=RESUME_TO, ckpt_dir=ckpt,
                    ckpt_every=10**9, **{**quiet, "log_fn": logs.append})["losses"]
    whole = train(cfg_r, optcfg, TokenPipeline(paths, TRAIN_BATCH, TRAIN_SEQ, mode="fused",
                                               device=device),
                  steps=RESUME_TO, **quiet)["losses"]
    if (f"[train] resumed from step {RESUME_STEPS}" not in logs
            or len(resumed) != RESUME_TO - RESUME_STEPS):
        raise AssertionError(f"(d) did not resume at step {RESUME_STEPS}: {logs}, {resumed}")
    if resumed_pipe.state.as_dict() == {"shard": 0, "row_group": 0, "epoch": 0, "pool_off": 0}:
        raise AssertionError("(d) the pipeline cursor was not restored")
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[RESUME_STEPS:]))
    gap_first = max(abs(a - b) / abs(b) for a, b in zip(first, whole))
    if not (gap <= RESUME_REL and gap_first <= RESUME_REL):
        raise AssertionError(f"(d) resumed {resumed} against {whole[RESUME_STEPS:]} (relative "
                             f"{gap}), the first run {first} against {whole} ({gap_first}); "
                             f"tolerance {RESUME_REL}")
    log(f"      (d) {RESUME_LAYERS} layers at full width: checkpoints at 2 and "
        f"{RESUME_STEPS}, resumed at {RESUME_STEPS} (cursor {resumed_pipe.checkpoint_state()}), "
        f"losses {resumed} against the uninterrupted {whole[RESUME_STEPS:]}: relative gap "
        f"{gap:.3e} (tolerance {RESUME_REL}); the first {RESUME_STEPS} steps {first}, "
        f"relative gap {gap_first:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (e) the card against the CPU: one step at 2 layers, float32
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32")
    cpu_params = model.init_params(cfg2, seed, device="cpu")
    card_params = tree_map(lambda p: p.to(device, copy=True), cpu_params)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (1, CHECK_LEN)).astype(np.int32)
    sides = {}
    for side, params in (("card", card_params), ("cpu", cpu_params)):
        batch = {"tokens": torch.from_numpy(toks).to(params["embed"].device)}
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = model.forward_train(params, batch, cfg2)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        state = init_opt_state(params, optcfg)
        _, _, m = make_train_step(cfg2, optcfg)(params, state, batch)
        sides[side] = (float(loss.detach()), grads, float(m["loss"]), tree_leaves(params))
    (lc, gc_, mc, pc), (lh, gh, mh, ph) = sides["card"], sides["cpu"]
    loss_rel = max(abs(lc - lh) / abs(lh), abs(mc - mh) / abs(mh))
    grad_rel = max(rel_l2(a, b) for a, b in zip(gc_, gh))
    param_rel = max(rel_l2(a, b) for a, b in zip(pc, ph))
    if not (loss_rel <= STEP_LOSS_REL and grad_rel <= STEP_GRAD_REL
            and param_rel <= STEP_PARAM_REL):
        raise AssertionError(f"(e) card against CPU: loss {loss_rel}, grads {grad_rel}, "
                             f"params {param_rel}")
    log(f"      (e) {CHECK_LAYERS} layers, float32, {CHECK_LEN} tokens, one step: card against "
        f"CPU loss relative {loss_rel:.3e} (tolerance {STEP_LOSS_REL}), grads relative L2 "
        f"{grad_rel:.3e} ({STEP_GRAD_REL}), parameters after the step {param_rel:.3e} "
        f"({STEP_PARAM_REL}); {time.perf_counter() - t0:.1f} s")
    del cpu_params, card_params, sides
    gc.collect()
    torch.cuda.empty_cache()
    return ops.kernel_launches()


# ---------------------------------------------------------------------------
# phase M: the decoder-only MoE, SSM and hybrid families served at full width
# ---------------------------------------------------------------------------

# uncut but llama4-maverick-400b: 48 layers of ~800 GB in bf16 cut to 2, one
# moe_pair (a dense layer, then an MoE layer of all 128 experts at d 5,120
# and F 8,192), ~18.5 B parameters
FAMILY_ARCHS = ("mamba2-370m", "hymba-1.5b", "deepseek-moe-16b", "llama4-maverick-400b")
FAMILY_LAYERS = {"llama4-maverick-400b": 2}
FAMILY_PROMPTS = (1024, 2048, 3072, 4096)  # hymba's three longer ones wrap its 1,024-slot rings
FAMILY_NEW_TOKENS = 8  # (b): a request's new tokens; its checks need no more
FAMILY_SLOTS = 4
FAMILY_MAX_LEN = 4160
CHECK_STEPS = 8  # (c): decode steps after the 256-token prefill, card against CPU
# (c) at float32 is 4 bytes a parameter on each side: llama4's 2 layers of 128
# experts would be 74 GB, so its (c) keeps 16 of them (top-1 routing over 16)
CHECK_EXPERTS = {"llama4-maverick-400b": 16}


def family_config(arch: str, n_layers: int = None):
    """The config of `arch` cut to `n_layers` (FAMILY_LAYERS' cut if None);
    a cut hymba keeps its first layer global, the rest windowed."""
    cfg = get_config(arch)
    n = n_layers or FAMILY_LAYERS.get(arch, cfg.n_layers)
    if n == cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=n, global_layers=(0,) if cfg.global_layers else ())


class Routing:
    """Records the expert ids of every `moe.route` call while installed
    (`with Routing() as ids:`)."""

    def __enter__(self):
        self.ids, self._route = [], moe.route

        def route(*a, **kw):
            probs, gates, ids = self._route(*a, **kw)
            self.ids.append(ids.cpu())
            return probs, gates, ids

        moe.route = route
        return self.ids

    def __exit__(self, *exc):
        moe.route = self._route


def no_drop(cfg):
    """`cfg` with every (token, expert) entry within capacity: moe_capacity E
    gives C = N k (`moe._capacity`)."""
    return dataclasses.replace(cfg, moe_capacity=float(cfg.moe_experts)) if cfg.moe_experts \
        else cfg


def decode_against_prefill(params, cfg, seq: torch.Tensor, extra=None) -> dict:
    """Decode at S = len - 1 against the last logits of a prefill of all of
    `seq` (with `extra` batch keys, an enc-dec model's frames, in both
    prefills): relative L2 `rel` and max |err| `err`.  The decode's history is
    that prefill's own caches where they hold only keys and values (dense
    and MoE layers: position S's slot, the one decode rewrites, is the only
    one that saw token S), so both sides share every earlier token's
    numbers; an S-token prefill's where they hold SSM states.  MoE layers
    make two discrete choices for the last token.  A prefill keeps each
    expert's first C (token, expert) entries in token order
    (`moe._capacity`), so its last token is the first an expert over
    capacity drops, where a one-token decode drops nothing: `dropped` of its
    `entries`.  And the two paths' roundings can tip a near-tie in the
    router's top k: `flipped` of the `layers` MoE layers route the token to
    another set of experts."""
    S = seq.shape[1] - 1
    extra = extra or {}
    with Routing() as full_ids:
        l_full, caches = model.prefill(params, {"tokens": seq, **extra}, cfg, cache_len=S + 8)
    if cfg.ssm_heads:
        _, caches = model.prefill(params, {"tokens": seq[:, :S], **extra}, cfg,
                                  cache_len=S + 8)
    with Routing() as dec_ids:
        l_dec, _ = model.decode_step(params, seq[:, S:], caches, S, cfg)
    d = l_dec.float() - l_full.float()
    out = dict(rel=float(d.norm() / l_full.float().norm()), err=float(d.abs().max()),
               dropped=0, entries=0, layers=len(full_ids))
    for layer in full_ids:
        flat = layer.reshape(-1)
        C = min(moe._capacity(S + 1, cfg.moe_top_k, cfg.moe_experts, cfg.moe_capacity),
                flat.numel())
        for e in layer[0, -1].tolist():
            out["dropped"] += int((flat == e).sum()) > C
            out["entries"] += 1
    out["flipped"] = sum(set(a[0, -1].tolist()) != set(b[0, -1].tolist())
                         for a, b in zip(full_ids, dec_ids))
    return out


def routing_note(got: dict, capacity: str) -> str:
    return (f"{capacity}: relative L2 {got['rel']:.3e} (the prefill dropped the last token "
            f"from {got['dropped']} of its {got['entries']} expert entries; the decode routed it "
            f"to other experts in {got['flipped']} of {got['layers']} layers)")


def family_serving(arch: str, seed: int, device: str = "cuda") -> dict:
    """Phase M for one family: (a) packed ≡ tokens, (b) a 4-slot engine,
    decode ≡ prefill and the numbers, (c) card ≡ CPU at float32.  Returns
    the kernel launches of its window ((a) and (b))."""
    t_start = time.perf_counter()
    cfg = family_config(arch)
    full = get_config(arch)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    cut = ("uncut" if cfg.n_layers == full.n_layers else
           f"cut from {full.n_layers} to {cfg.n_layers} layers (the uncut model: "
           f"{full.n_params() / 1e9:.1f} B parameters)")
    log(f"      {arch} [{cfg.family}], {cut}: segments "
        f"{[(g.kind, g.count, g.window) for g in model.model_segments(cfg)]}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}; {n_params} parameters in {cfg.dtype} drawn from "
        f"seed {seed} in {time.perf_counter() - t0:.1f} s")

    # (a) and (b)'s first engine: the counted window
    k_bits = model.token_bits(cfg)
    toks = rng.integers(0, cfg.vocab, (1, PACKED_LEN)).astype(np.int64)
    packed = torch.from_numpy(np.stack([bitpack_encode(toks[0], k_bits)]).view(np.int32))
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)),
                    max_new_tokens=FAMILY_NEW_TOKENS) for i, n in enumerate(FAMILY_PROMPTS)]
    ops.reset_kernel_launches()
    l_packed, c_packed = model.prefill(params, {"packed": packed.to(device)}, cfg)
    l_tokens, c_tokens = model.prefill(
        params, {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device)}, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, n_slots=FAMILY_SLOTS, max_len=FAMILY_MAX_LEN, device=device)
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
    launches = ops.kernel_launches()
    if launches["bitunpack"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"{arch}: launches {launches}, not one bitunpack for the one "
                             "packed prefill")
    if not torch.equal(l_packed, l_tokens) or any(
            not torch.equal(a[k], b[k]) for a, b in zip(c_packed, c_tokens) for k in b):
        raise AssertionError(f"{arch}: the packed-prompt prefill differs from the tokens prefill")
    log(f"      (a) {PACKED_LEN}-token prompt packed at k={k_bits} ({packed.numel() * 4} B "
        f"against {toks.size * 4} B of int32 tokens): logits and every cache leaf "
        f"({sorted(c_tokens[-1])}) bit-identical to the tokens prefill; launches {launches}")
    del c_packed, c_tokens

    # (b) every request drained, a second engine gives the same tokens
    got = {r.rid: r.out for r in reqs}
    if any(len(o) != FAMILY_NEW_TOKENS for o in got.values()) or len(got) != len(reqs):
        raise AssertionError(f"{arch}: not every request got {FAMILY_NEW_TOKENS} tokens: "
                             f"{ {k: len(o) for k, o in got.items()} }")
    del eng
    again = ServeEngine(params, cfg, n_slots=FAMILY_SLOTS, max_len=FAMILY_MAX_LEN,
                        device=device)
    reqs2 = [Request(rid=r.rid, tokens=r.tokens, max_new_tokens=FAMILY_NEW_TOKENS)
             for r in reqs]
    for r in reqs2:
        again.submit(r)
    again.step()  # admits all four
    busy_ms, top, _ = profiled(again.step)
    again.run_until_drained()
    if {r.rid: r.out for r in reqs2} != got:
        raise AssertionError(f"{arch}: a second engine gave other tokens")
    del again
    decode_ms = [ms for _, ms in ticks[1:]]
    tick_ms = sorted(decode_ms)[len(decode_ms) // 2]
    tokens_per_s = sum(n for n, _ in ticks[1:]) / (sum(decode_ms) / 1e3)
    S = FAMILY_PROMPTS[0]
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1)).astype(np.int32)).to(device)
    check = decode_against_prefill(params, no_drop(cfg), seq)
    compared = f"{cfg.dtype} relative L2 {check['rel']:.3e} (max |err| {check['err']:.4f})"
    if cfg.moe_experts:
        compared = (routing_note(decode_against_prefill(params, cfg, seq),
                                 f"at the model's capacity {cfg.moe_capacity}") + "; "
                    + routing_note(check, "with every entry within capacity (moe_capacity E)"))
    if not check["flipped"] and not check["rel"] <= DECODE_REL_TOL:
        raise AssertionError(f"{arch}: decode at {S} differs from the {S + 1}-token prefill: "
                             f"{compared} > {DECODE_REL_TOL}")
    prefill_ms = {}
    for r in reqs:  # each length ran in the engines already
        batch = {"tokens": torch.from_numpy(np.asarray(r.tokens, np.int32)[None]).to(device)}
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.prefill(params, batch, cfg, cache_len=FAMILY_MAX_LEN)
        torch.cuda.synchronize()
        prefill_ms[len(r.tokens)] = round((time.perf_counter() - t) * 1e3, 2)
    log(f"      (b) {len(reqs)} requests of {list(FAMILY_PROMPTS)} tokens drained on "
        f"{FAMILY_SLOTS} slots in {len(ticks)} ticks, {FAMILY_NEW_TOKENS} tokens each, a "
        f"second engine gives the same tokens; decode at {S} against the {S + 1}-token "
        f"prefill: {compared}, tolerance {DECODE_REL_TOL}"
        + (" where the decode routes as the prefill" if check["flipped"] else ""))
    log(f"      (b) prefill_ms per request (cache_len {FAMILY_MAX_LEN}): {prefill_ms}; first "
        f"tick ({FAMILY_SLOTS} admissions + 1 decode) {ticks[0][1]:.1f} ms; decode_ms per tick "
        f"(median) {tick_ms:.2f}, tokens/s {tokens_per_s:.1f}; peak device bytes {peak}; one "
        f"decode tick: busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / tick_ms:.3f} top={top}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if check["flipped"]:
        # the paths' bf16 roundings tipped the router for the last token, and
        # each tip moves that token's later layers: hold the identity in
        # float32 at full width, where roundings are 2^16 times finer
        t0 = time.perf_counter()
        cfg32 = dataclasses.replace(no_drop(cfg), dtype="float32")
        params = model.init_params(cfg32, seed, device=device)
        f32 = decode_against_prefill(params, cfg32, seq)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if f32["flipped"] or not f32["err"] <= F32_ATOL:
            raise AssertionError(f"{arch}: float32 decode at {S} differs from the "
                                 f"{S + 1}-token prefill: {routing_note(f32, 'float32')}")
        log(f"      (b) float32 at full width, every entry within capacity: decode at {S} "
            f"against the {S + 1}-token prefill: {routing_note(f32, 'float32')}, max |err| "
            f"{f32['err']:.3e} (tolerance {F32_ATOL}); {time.perf_counter() - t0:.1f} s")

    # (c) the card against the CPU: 2 layers at float32, prefill and decode steps
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(family_config(arch, CHECK_LAYERS), dtype="float32")
    if arch in CHECK_EXPERTS:
        cfg2 = dataclasses.replace(cfg2, moe_experts=min(cfg2.moe_experts, CHECK_EXPERTS[arch]))
    card = model.init_params(cfg2, seed, device=device)
    host = tree_map(lambda p: p.to("cpu", copy=True), card)
    seq = rng.integers(0, cfg.vocab, (1, CHECK_LEN + CHECK_STEPS)).astype(np.int32)
    sides = {}
    for side, params in (("card", card), ("cpu", host)):
        dev = params["embed"].device
        with Routing() as ids:
            logits, caches = model.prefill(
                params, {"tokens": torch.from_numpy(seq[:, :CHECK_LEN]).to(dev)}, cfg2,
                cache_len=CHECK_LEN + CHECK_STEPS)
            out = [logits.cpu()]
            for i in range(CHECK_STEPS):
                pos = CHECK_LEN + i
                logits, caches = model.decode_step(
                    params, torch.from_numpy(seq[:, pos:pos + 1]).to(dev), caches, pos, cfg2)
                out.append(logits.cpu())
        sides[side] = (out, ids)
    (lc, ic), (lh, ih) = sides["card"], sides["cpu"]
    errs = [float((a - b).abs().max()) for a, b in zip(lc, lh)]
    if not max(errs) <= F32_ATOL:
        raise AssertionError(f"{arch}: card differs from the CPU at float32: {errs}")
    if len(ic) != len(ih) or any(not torch.equal(a, b) for a, b in zip(ic, ih)):
        raise AssertionError(f"{arch}: the card routes tokens to other experts than the CPU")
    f32 = decode_against_prefill(card, no_drop(cfg2), torch.from_numpy(
        seq[:, :CHECK_LEN + 1]).to(device))
    if f32["flipped"] or not f32["err"] <= F32_ATOL:
        raise AssertionError(f"{arch}: float32 decode at {CHECK_LEN} differs from the "
                             f"{CHECK_LEN + 1}-token prefill: {routing_note(f32, 'float32')}")
    experts = f", {cfg2.moe_experts} experts" if arch in CHECK_EXPERTS else ""
    log(f"      (c) {CHECK_LAYERS} layers{experts}, float32, a {CHECK_LEN}-token prefill and "
        f"{CHECK_STEPS} decode steps: card against CPU max |err| of the logits {max(errs):.3e} "
        f"(tolerance {F32_ATOL}); routing ids equal in {len(ic)} MoE calls; on the card, "
        f"decode at {CHECK_LEN} against the {CHECK_LEN + 1}-token prefill (every entry within "
        f"capacity): max |err| {f32['err']:.3e} (tolerance {F32_ATOL}), routed alike in "
        f"{f32['layers'] - f32['flipped']} of {f32['layers']} MoE layers; "
        f"{time.perf_counter() - t0:.1f} s")
    del card, host, sides
    gc.collect()
    torch.cuda.empty_cache()
    log(f"      {arch}: {time.perf_counter() - t_start:.1f} s")
    return launches


def families_phase(seed: int, device: str = "cuda") -> dict:
    """Phase M: each family in turn, each model freed before the next.
    Returns the kernel launches of the families' windows, summed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = dict.fromkeys(ops.KERNELS, 0)
    for arch in FAMILY_ARCHS:
        for k, n in family_serving(arch, seed, device).items():
            total[k] += n
    return total


# ---------------------------------------------------------------------------
# phase E: the enc-dec and VLM families, served and trained at full width
# ---------------------------------------------------------------------------

# whisper-base uncut; llava-next-34b cut from 60 to 30 layers at full width:
# its 60 layers are 68.9 GB of bf16 weights, and init_params draws each
# stacked leaf whole in float32 (wg alone is 35.2 GB at 60 layers); at 30 the
# weights are ~35.5 GB and the draw peaks near 53 GB
EV_ARCHS = ("whisper-base", "llava-next-34b")
EV_LAYERS = {"llava-next-34b": 30}
# (b): whisper's text context is 448 tokens; llava takes phase M's prompts
EV_PROMPTS = {"whisper-base": (64, 192, 320, 448), "llava-next-34b": FAMILY_PROMPTS}
EV_NEW_TOKENS = {"whisper-base": 32, "llava-next-34b": FAMILY_NEW_TOKENS}
EV_MAX_LEN = {"whisper-base": 512, "llava-next-34b": FAMILY_MAX_LEN}
EV_CHECK_AT = {"whisper-base": 448, "llava-next-34b": FAMILY_PROMPTS[0]}  # (b) decode at S
# (b) decode ≡ prefill for llava is held in float32 at full width and 16
# layers (30 in float32 would be 71 GB of weights), its bf16 gap printed
# beside it and at the depths of EV_GAP_DEPTHS (the first n of its layers):
# on the card the bf16 gap grows with depth and passes 2^-5 relative L2
# from about 16 layers on, while float32 stays near 1e-5: bf16 roundings
# that compound over depth at d 7,168, not a wrong position or mask, which
# would move the logits by their own size in either dtype
EV_DECODE_F32 = {"llava-next-34b": 16}
EV_GAP_DEPTHS = (1, 2, 4, 8, 16, 24)
# (c) and (d): whisper uncut, llava at one layer of full width (at two, its
# float32 training step on the host took most of the phase); (d) B x S tokens
EV_CHECK_LAYERS = {"llava-next-34b": 1}
EV_STEP_BATCH = {"whisper-base": (2, 448), "llava-next-34b": (1, 128)}
# (e): whisper-base trained in bf16 on one fixed batch of B x S tokens
EV_TRAIN_B, EV_TRAIN_S, EV_TRAIN_STEPS = 8, 448, 4


def ev_config(arch: str, n_layers: int = None):
    """The config of `arch` cut to `n_layers` (EV_LAYERS' cut if None)."""
    cfg = get_config(arch)
    n = n_layers or EV_LAYERS.get(arch, cfg.n_layers)
    return cfg if n == cfg.n_layers else dataclasses.replace(cfg, n_layers=n)


def ev_inputs(cfg, rng, B: int, device) -> dict:
    """Random standard-normal bf16 inputs of the stub frontends, from `rng`:
    an enc-dec model's frames (B, encoder_seq, D), a VLM's vision embeddings
    (B, vision_tokens, D)."""
    n = cfg.encoder_seq if cfg.is_encdec else cfg.vision_tokens
    x = torch.from_numpy(rng.standard_normal((B, n, cfg.d_model)).astype(np.float32))
    return {"enc_embeds" if cfg.is_encdec else "embeds": x.to(torch.bfloat16).to(device)}


def ev_serving(arch: str, cfg, params, rng, device) -> dict:
    """(a) and (b) for one model: returns the kernel launches of (a)."""
    frames = ev_inputs(cfg, rng, 1, device) if cfg.is_encdec else {}

    # (a) packed ≡ tokens, through one bitunpack and nothing else
    k_bits = model.token_bits(cfg)
    toks = rng.integers(0, cfg.vocab, (1, PACKED_LEN)).astype(np.int64)
    packed = torch.from_numpy(np.stack([bitpack_encode(toks[0], k_bits)]).view(np.int32))
    tokens = torch.from_numpy(toks.astype(np.int32)).to(device)
    before = ops.kernel_launches()
    l_packed, c_packed = model.prefill(params, {"packed": packed.to(device), **frames}, cfg)
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    launches = {k: after[k] - before[k] for k in after}
    l_tokens, c_tokens = model.prefill(params, {"tokens": tokens, **frames}, cfg)
    if launches["bitunpack"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"{arch}: (a) launches {launches}, not one bitunpack for the "
                             "packed prefill")
    if not torch.equal(l_packed, l_tokens) or any(
            not torch.equal(a[k], b[k]) for a, b in zip(c_packed, c_tokens) for k in b):
        raise AssertionError(f"{arch}: the packed-prompt prefill differs from the tokens prefill")
    leaves = sorted({k for c in c_tokens for k in c})
    del c_packed, c_tokens
    note = f"with {cfg.encoder_seq} random frames" if frames else ""
    if cfg.family == "vlm":
        l_vis, _ = model.prefill(params, {"tokens": tokens, **ev_inputs(cfg, rng, 1, device)},
                                 cfg)
        if not torch.equal(l_vis, l_tokens):
            raise AssertionError(f"{arch}: prefill read the vision embeddings (the reference's "
                                 "never does)")
        note = (f"and with random (1, {cfg.vision_tokens}, {cfg.d_model}) vision embeddings "
                "the same logits bit for bit (prefill does not read them, as in the reference)")
    log(f"      (a) {PACKED_LEN}-token prompt packed at k={k_bits} ({packed.numel() * 4} B "
        f"against {toks.size * 4} B of int32 tokens) {note}: logits and every cache leaf "
        f"({leaves}) bit-identical to the tokens prefill; launches {launches}")
    del l_packed, l_tokens

    # (b) a 4-slot engine drains the requests; a second engine gives the same tokens
    prompts, new, max_len = EV_PROMPTS[arch], EV_NEW_TOKENS[arch], EV_MAX_LEN[arch]
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)), max_new_tokens=new)
            for i, n in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, n_slots=FAMILY_SLOTS, max_len=max_len, device=device)
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
    got = {r.rid: r.out for r in reqs}
    if len(got) != len(prompts) or any(len(o) != new for o in got.values()):
        raise AssertionError(f"{arch}: not every request got {new} tokens: "
                             f"{ {k: len(o) for k, o in got.items()} }")
    del eng
    again = ServeEngine(params, cfg, n_slots=FAMILY_SLOTS, max_len=max_len, device=device)
    reqs2 = [Request(rid=r.rid, tokens=r.tokens, max_new_tokens=new) for r in reqs]
    for r in reqs2:
        again.submit(r)
    again.step()  # admits all four
    busy_ms, top, _ = profiled(again.step)
    again.run_until_drained()
    if {r.rid: r.out for r in reqs2} != got:
        raise AssertionError(f"{arch}: a second engine gave other tokens")
    del again
    S = EV_CHECK_AT[arch]
    seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S + 1)).astype(np.int32)).to(device)
    check = decode_against_prefill(params, cfg, seq, frames)
    if arch not in EV_DECODE_F32 and not check["rel"] <= DECODE_REL_TOL:
        raise AssertionError(f"{arch}: decode at {S} differs from the {S + 1}-token prefill: "
                             f"relative L2 {check['rel']} > {DECODE_REL_TOL}")
    by_depth = ""
    if arch in EV_DECODE_F32:  # the bf16 gap of the first n layers (views of the stack)
        (seg,) = params["segments"]
        gaps = {n: decode_against_prefill(
            {**params, "segments": [{k: w[:n] for k, w in seg.items()}]},
            dataclasses.replace(cfg, n_layers=n), seq, frames)["rel"]
            for n in EV_GAP_DEPTHS if n < cfg.n_layers}
        by_depth = f"; by depth {({n: float(f'{g:.3e}') for n, g in gaps.items()})}"
    prefill_ms = {}
    stub = {k: torch.zeros_like(v) for k, v in frames.items()}  # the engine's frames
    for r in reqs:  # each length ran in the engines already
        batch = {"tokens": torch.from_numpy(np.asarray(r.tokens, np.int32)[None]).to(device),
                 **stub}
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.prefill(params, batch, cfg, cache_len=max_len)
        torch.cuda.synchronize()
        prefill_ms[len(r.tokens)] = round((time.perf_counter() - t) * 1e3, 2)
    encoder = ""
    if cfg.is_encdec:
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.encode(params, frames["enc_embeds"], cfg)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        encoder = (f"; the encoder alone over {cfg.encoder_seq} frames {sorted(runs)[1]:.2f} ms "
                   "(median of 3)")
    decode_ms = [ms for _, ms in ticks[1:]]
    tick_ms = sorted(decode_ms)[len(decode_ms) // 2]
    tokens_per_s = sum(n for n, _ in ticks[1:]) / (sum(decode_ms) / 1e3)
    log(f"      (b) {len(reqs)} requests of {list(prompts)} tokens drained on {FAMILY_SLOTS} "
        f"slots in {len(ticks)} ticks, {new} tokens each, a second engine gives the same "
        f"tokens; decode at {S} against the {S + 1}-token prefill"
        f"{' (random frames)' if frames else ''}: "
        f"{cfg.dtype} relative L2 {check['rel']:.3e} (max |err| {check['err']:.4f}), "
        + (f"tolerance {DECODE_REL_TOL}" if arch not in EV_DECODE_F32 else
           f"beside {DECODE_REL_TOL}{by_depth}; held in float32 at {EV_DECODE_F32[arch]} "
           "layers below"))
    log(f"      (b) prefill_ms per request (cache_len {max_len}): {prefill_ms}{encoder}; first "
        f"tick ({FAMILY_SLOTS} admissions + 1 decode) {ticks[0][1]:.1f} ms; decode_ms per tick "
        f"(median) {tick_ms:.2f}, tokens/s {tokens_per_s:.1f}; peak device bytes {peak}; one "
        f"decode tick: busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / tick_ms:.3f} top={top}")
    return launches, seq


def ev_decode_f32(arch: str, seed: int, seq: torch.Tensor, device) -> None:
    """(b) decode at S against the (S+1)-token prefill in float32 at full
    width and EV_DECODE_F32 layers, within F32_ATOL."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(ev_config(arch, EV_DECODE_F32[arch]), dtype="float32")
    params = model.init_params(cfg, seed, device=device)
    f32 = decode_against_prefill(params, cfg, seq)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    S = seq.shape[1] - 1
    if not f32["err"] <= F32_ATOL:
        raise AssertionError(f"{arch}: float32 decode at {S} differs from the {S + 1}-token "
                             f"prefill at {cfg.n_layers} layers: max |err| {f32['err']}")
    log(f"      (b) float32 at full width, {cfg.n_layers} layers: decode at {S} against the "
        f"{S + 1}-token prefill relative L2 {f32['rel']:.3e}, max |err| {f32['err']:.3e} "
        f"(tolerance {F32_ATOL}); {time.perf_counter() - t0:.1f} s")


def ev_against_cpu(arch: str, seed: int, rng, device):
    """(c) a 256-token prefill and 8 decode steps, then (d) one training
    step, on the card against the CPU at float32 (TF32 off): whisper uncut,
    llava at EV_CHECK_LAYERS."""
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(ev_config(arch, EV_CHECK_LAYERS.get(arch)), dtype="float32")
    card = model.init_params(cfg2, seed, device=device)
    host = tree_map(lambda p: p.to("cpu", copy=True), card)
    seq = rng.integers(0, cfg2.vocab, (1, CHECK_LEN + CHECK_STEPS)).astype(np.int32)
    frames = ev_inputs(cfg2, rng, 1, "cpu") if cfg2.is_encdec else {}
    outs = {}
    for side, params in (("card", card), ("cpu", host)):
        dev = params["embed"].device
        extra = {k: v.to(dev) for k, v in frames.items()}
        logits, caches = model.prefill(
            params, {"tokens": torch.from_numpy(seq[:, :CHECK_LEN]).to(dev), **extra}, cfg2,
            cache_len=CHECK_LEN + CHECK_STEPS)
        out = [logits.cpu()]
        for i in range(CHECK_STEPS):
            pos = CHECK_LEN + i
            logits, caches = model.decode_step(
                params, torch.from_numpy(seq[:, pos:pos + 1]).to(dev), caches, pos, cfg2)
            out.append(logits.cpu())
        outs[side] = out
        del caches
    errs = [float((a - b).abs().max()) for a, b in zip(outs["card"], outs["cpu"])]
    if not max(errs) <= F32_ATOL:
        raise AssertionError(f"{arch}: (c) card differs from the CPU at float32: {errs}")
    log(f"      (c) {cfg2.n_layers} layers, float32, a {CHECK_LEN}-token prefill"
        f"{f' over {cfg2.encoder_seq} random frames' if frames else ''} and {CHECK_STEPS} "
        f"decode steps: card against CPU max |err| of the logits {max(errs):.3e} (tolerance "
        f"{F32_ATOL}); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    B, S = EV_STEP_BATCH[arch]
    toks = rng.integers(0, cfg2.vocab, (B, S)).astype(np.int32)
    extra = ev_inputs(cfg2, rng, B, "cpu")
    optcfg = OptConfig(**OPT)
    sides = {}
    for side, params in (("card", card), ("cpu", host)):
        dev = params["embed"].device
        batch = {"tokens": torch.from_numpy(toks).to(dev),
                 **{k: v.to(dev) for k, v in extra.items()}}
        params, state, m = make_train_step(cfg2, optcfg)(params, init_opt_state(params, optcfg),
                                                         batch)
        # the gradients as the step used them: its first moments after one
        # step are (1 - b1) times the clipped gradients, in float32
        sides[side] = (float(m["loss"]), float(m["grad_norm"]), tree_leaves(state["m"]),
                       tree_leaves(params))
    (lc, nc, gc_, pc), (lh, nh, gh, ph) = sides["card"], sides["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    # per top-level leaf (vis_proj and enc_final_ln among them), the layers'
    # worst, and the global norm the step clipped by
    names = [k for k in sorted(card) for _ in tree_leaves(card[k])]
    grad_rel = {"norm": abs(nc - nh) / abs(nh)}
    for name, a, b in zip(names, gc_, gh):
        grad_rel[name] = max(grad_rel.get(name, 0.0), rel_l2(a, b))
    param_rel = max(rel_l2(a, b) for a, b in zip(pc, ph))
    if not (loss_rel <= STEP_LOSS_REL and max(grad_rel.values()) <= STEP_GRAD_REL
            and param_rel <= STEP_PARAM_REL):
        raise AssertionError(f"{arch}: (d) card against CPU: loss {loss_rel}, grads {grad_rel}, "
                             f"params {param_rel}")
    what = (f"{B} x {S} tokens with {cfg2.encoder_seq} random frames" if cfg2.is_encdec else
            f"{B} x {S} tokens after {cfg2.vision_tokens} random vision embeddings")
    log(f"      (d) {cfg2.n_layers} layers, float32, one step on {what}: card against CPU loss "
        f"relative {loss_rel:.3e} (tolerance {STEP_LOSS_REL}), grads (the step's first "
        f"moments) relative L2 "
        f"{ {k: float(f'{v:.3e}') for k, v in grad_rel.items()} } ({STEP_GRAD_REL}), "
        f"parameters after the step {param_rel:.3e} ({STEP_PARAM_REL}); "
        f"{time.perf_counter() - t0:.1f} s")
    del card, host, sides, gc_, gh, pc, ph
    gc.collect()
    torch.cuda.empty_cache()


def ev_training(cfg, seed: int, rng, device) -> None:
    """(e) EV_TRAIN_STEPS AdamW steps at full width in bf16 on one fixed
    batch: the losses finite and falling; step ms, tokens/s, peak memory."""
    params = model.init_params(cfg, seed, device=device)
    optcfg = OptConfig(**OPT)
    state = init_opt_state(params, optcfg)
    step = make_train_step(cfg, optcfg)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (EV_TRAIN_B, EV_TRAIN_S))
                                        .astype(np.int32)).to(device),
             **ev_inputs(cfg, rng, EV_TRAIN_B, device)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(EV_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.arch_id}: (e) losses {losses} are not finite and falling")
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"      (e) {EV_TRAIN_STEPS} AdamW steps in {cfg.dtype} on one batch of {EV_TRAIN_B} x "
        f"{EV_TRAIN_S} tokens with {cfg.encoder_seq} random frames each: losses "
        f"{[round(x, 4) for x in losses]}; step_ms {[round(x, 2) for x in step_ms]} (median "
        f"after the first {ms:.2f}), tokens/s {EV_TRAIN_B * EV_TRAIN_S / (ms / 1e3):.1f}; peak "
        f"device bytes {peak}")
    del params, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()


def ev_model(arch: str, seed: int, device: str = "cuda") -> dict:
    """Phase E for one model: (a)-(d), and (e) for whisper.  Returns the
    kernel launches of its window (all of its calls)."""
    t_start = time.perf_counter()
    cfg = ev_config(arch)
    full = get_config(arch)
    rng = np.random.default_rng(seed)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(params))
    cut = ("uncut" if cfg.n_layers == full.n_layers else
           f"cut from {full.n_layers} to {cfg.n_layers} layers (the uncut model: "
           f"{full.n_params() / 1e9:.1f} B parameters)")
    log(f"      {arch} [{cfg.family}], {cut}: segments "
        f"{[(g.kind, g.count) for g in model.model_segments(cfg)]}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv} kv) of {cfg.head_dim}, d_ff {cfg.d_ff} ({cfg.act}), "
        f"vocab {cfg.vocab} (padded {cfg.vocab_padded}); {n_params} parameters in {cfg.dtype} "
        f"drawn from seed {seed} in {time.perf_counter() - t0:.1f} s")
    a_launches, seq = ev_serving(arch, cfg, params, rng, device)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if arch in EV_DECODE_F32:
        ev_decode_f32(arch, seed, seq, device)
    ev_against_cpu(arch, seed, rng, device)
    if cfg.is_encdec:
        ev_training(cfg, seed, rng, device)
    launches = ops.kernel_launches()
    if launches != a_launches:
        raise AssertionError(f"{arch}: launches {launches} beyond (a)'s {a_launches}")
    log(f"      {arch}: {time.perf_counter() - t_start:.1f} s")
    return launches


def encdec_vlm_phase(seed: int, device: str = "cuda") -> dict:
    """Phase E: each model in turn, each freed before the next.  Returns the
    kernel launches of the models' windows, summed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = dict.fromkeys(ops.KERNELS, 0)
    for arch in EV_ARCHS:
        for k, n in ev_model(arch, seed, device).items():
            total[k] += n
    return total


MESH_SHAPE = (1, 1)  # (data, model) on the one card
MESH_NEW_TOKENS = 16
MESH_REL_TOL = 1e-3  # (a) prefill logits under the mesh against without, relative L2
SERVE_ARGS = ["--arch", LM_ARCH, "--requests", "16"]  # (c), the launcher's other options its own
# (e): packed batches of MESH_TRAIN_BATCH x 4,096 tokens, MESH_STEPS timed
# steps and one more under torch.profiler, each under the mesh and without it
MESH_STEPS = 3
MESH_MOE_ARCH = "deepseek-moe-16b"  # (f): at 2 layers, 1 dense + 1 MoE of 28
# (e), (f): one rank runs the plain path's kernels in its order, so bit for
# bit is expected; an op that differs is named, and the run held to phase T
# (d)'s bounds: losses within 1e-3 relative, each parameter leaf within 1e-3
# relative L2 (phase T (e)'s bound after an AdamW step)
MESH_STEP_REL = 1e-3
PSUM_SHAPE = (2048, 2048)  # (g): a qwen3-1.7b projection's float32 gradient
MESH_RESUME_BATCH = 1  # (h): 2 layers at full width (a 28-layer checkpoint is 17 GB)
# (h): bf16 moments (the optimizer's option), a 1.9 GB checkpoint in place
# of 3.1 GB: the save and two restores move it through sha1 and npz
MESH_RESUME_OPT = dict(OPT, moments_dtype="bfloat16")
MESH_RESUME_AT, MESH_RESUME_TO = 2, 4
TRAIN_MESH_ARGS = ["--arch", LM_ARCH, "--mesh", "single"]  # (i)
# (j)-(k): the SSM, hybrid, enc-dec and VLM families under the mesh against
# without it
MESH_ARCHS = ("mamba2-370m", "hymba-1.5b", "whisper-base", "llava-next-34b")
# (e), (f), (j) and (k): on one rank what they check, DTensor's dispatch of
# every op and bit-for-bit equality with no mesh, is the same at any depth,
# so every model they train, and those (j) serves, runs 2 layers at full
# width (`family_config` keeps hymba's first layer global and the second
# windowed, whose 1,024-slot ring the longer prompts still wrap; llava's 60
# layers are ~68 GB of bf16 weights); whisper-base runs its 6 + 6, and (a)-(c)
# serve qwen3-1.7b uncut
MESH_LAYERS = dict.fromkeys((LM_ARCH, "deepseek-moe-16b", "mamba2-370m", "hymba-1.5b",
                             "llava-next-34b"), 2)
# the first step (DTensor's first dispatch of each op, cuBLAS's first
# shapes) and the second timed alone, the third under torch.profiler
MESH_TRAIN_STEPS = 3
# (e), (f) and (k): packed batches of B x PACKED_LEN tokens where the family
# takes them in 4,096-token blocks (phase T (a) trains qwen3 on 2 of them
# without a mesh); whisper's text context is 448 tokens, so it trains on
# phase E (e)'s 8 x 448 tokens (not a block multiple: as tokens) over 8 x
# 1,500 frames
MESH_TRAIN_BATCH = 1


def served_on(params, cfg, ctx, reqs, device, max_len: int = None) -> dict:
    """Drain copies of `reqs` on a 4-slot engine (caches of `max_len`,
    LM_MAX_LEN if None): their tokens, the ticks, the median decode tick's
    wall ms, tokens/s, the peak device bytes of the drain and, from
    torch.profiler, the device busy ms of one more decode tick of all four
    slots (the third)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, n_slots=LM_SLOTS, max_len=max_len or LM_MAX_LEN, ctx=ctx,
                      device=device)
    mine = [Request(rid=r.rid, tokens=r.tokens, max_new_tokens=MESH_NEW_TOKENS) for r in reqs]
    for r in mine:
        eng.submit(r)
    ticks = []
    busy = None
    while eng.queue or any(s is not None for s in eng.slots):
        if len(ticks) == 2 and busy is None:
            busy = profiled(eng.step)[:2]
            continue
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = eng.step()
        torch.cuda.synchronize()
        ticks.append((n, (time.perf_counter() - t) * 1e3))
    decode_ms = [ms for _, ms in ticks[1:]]
    return {"tokens": {r.rid: r.out for r in mine}, "ticks": eng.steps,
            "tick_ms": sorted(decode_ms)[len(decode_ms) // 2],
            "tokens_per_s": sum(n for n, _ in ticks[1:]) / (sum(decode_ms) / 1e3),
            "busy_ms": busy[0], "top": busy[1], "peak": torch.cuda.max_memory_allocated()}


def warm_ms(fn) -> float:
    """Wall ms of a second call of `fn`, the first one warming it."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def prefill_ms(params, cfg, ctx, tokens: torch.Tensor, extra=None, cache_len: int = None
               ) -> float:
    """Warm wall ms of one prefill of `tokens` (with `extra` inputs) on the
    engine's caches (of `cache_len`, LM_MAX_LEN if None)."""
    batch = {"tokens": tokens, **(extra or {})}
    return warm_ms(lambda: model.prefill(params, batch, cfg, ctx,
                                         cache_len=cache_len or LM_MAX_LEN))


class PackedBatches:
    """A pipeline for `train`: B x S token ids from seed + i for the i-th
    batch, bit-packed at the config's k as the fused TokenPipeline hands
    them to the step; its cursor (i) resumes exactly."""

    def __init__(self, cfg, B: int, S: int, seed: int, device):
        self.cfg, self.B, self.S, self.seed, self.device, self.i = cfg, B, S, seed, device, 0

    def next_batch(self) -> dict:
        rng = np.random.default_rng(self.seed + self.i)
        self.i += 1
        toks = rng.integers(0, self.cfg.vocab, (self.B, self.S))
        k = model.token_bits(self.cfg)
        packed = np.stack([bitpack_encode(t, k) for t in toks]).view(np.int32)
        return {"packed": torch.from_numpy(packed).to(self.device)}

    def checkpoint_state(self) -> dict:
        return {"i": self.i}

    def restore_state(self, d: dict) -> None:
        self.i = d["i"]


def leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths in `tree_leaves` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in leaf_names(t, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def train_run(cfg, optcfg, ctx, batches, seed: int, device) -> dict:
    """make_train_step from seed's parameters (placed on ctx's mesh when ctx
    is given) over `batches`: each step but the last timed alone (wall ms
    after synchronize), the last under torch.profiler.  Returns the (loss,
    grad norm) of each step, the timed steps' ms, the bitunpack launches of
    each step, the last step's busy ms and top items, the peak device bytes
    and the parameters after the steps on the host."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(cfg, seed, device=device)
    if ctx is not None:
        params = shard_params(params, cfg, ctx)
    state = init_opt_state(params, optcfg)
    step = make_train_step(cfg, optcfg, ctx)
    metrics, ms, launches, busy = [], [], [], None
    for i, batch in enumerate(batches):
        before = bitunpack.KERNEL.launches
        if i == len(batches) - 1:
            out = {}
            busy = profiled(lambda: out.update(r=step(params, state, batch)))[:2]
            params, state, m = out["r"]
        else:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        launches.append(bitunpack.KERNEL.launches - before)
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(params)
    run = {"metrics": metrics, "ms": ms, "launches": launches, "busy": busy, "peak": peak,
           "n_params": sum(p.numel() for p in leaves), "names": leaf_names(params),
           "params": [plain(p).detach().cpu() for p in leaves]}
    del params, state, step, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return run


def same_runs(mesh: dict, none: dict, label: str) -> str:
    """'bit for bit' when both runs' losses, grad norms and parameters are
    equal; else names what differs, held to MESH_STEP_REL."""
    differ = [n for n, a, b in zip(mesh["names"], mesh["params"], none["params"])
              if not torch.equal(a, b)]
    if mesh["metrics"] == none["metrics"] and not differ:
        return "bit for bit"
    loss_rel = max(abs(a - b) / abs(b) for (a, _), (b, _) in zip(mesh["metrics"],
                                                                   none["metrics"]))
    param_rel = max(rel_l2(a, b) for a, b in zip(mesh["params"], none["params"]))
    if not (loss_rel <= MESH_STEP_REL and param_rel <= MESH_STEP_REL):
        raise AssertionError(f"{label} under the mesh against without it: losses "
                             f"{mesh['metrics']} against {none['metrics']} (relative {loss_rel}), "
                             f"parameters relative L2 {param_rel}, differing leaves {differ}; "
                             f"tolerance {MESH_STEP_REL}")
    return (f"not bit for bit: losses relative {loss_rel:.3e}, parameters relative L2 "
            f"{param_rel:.3e} (tolerance {MESH_STEP_REL}); differing leaves {differ}")


def mesh_training(ctx, seed: int, device, card: str) -> int:
    """Phase D (e) and (f): qwen3-1.7b and deepseek-moe-16b at MESH_LAYERS'
    depth and full width trained under the mesh and without it, their
    numbers printed beside `card` (the card's name and power limit).
    Returns the bitunpack launches they made."""
    optcfg = OptConfig(**OPT)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_LAYERS[LM_ARCH], remat=True)
    src = PackedBatches(cfg, MESH_TRAIN_BATCH, PACKED_LEN, seed, device)
    batches = [src.next_batch() for _ in range(MESH_STEPS + 1)]
    t0 = time.perf_counter()
    runs = {label: train_run(cfg, optcfg, c, batches, seed, device)
            for label, c in (("mesh", ctx), ("none", None))}
    verdict = same_runs(runs["mesh"], runs["none"], "(e)")
    tokens = MESH_TRAIN_BATCH * PACKED_LEN
    cut = "" if cfg.n_layers == get_config(LM_ARCH).n_layers else \
        f" cut to {cfg.n_layers} of {get_config(LM_ARCH).n_layers} layers"
    log(f"      (e) {cfg.arch_id}{cut} at full width, {cfg.dtype}, remat, AdamW, B "
        f"{MESH_TRAIN_BATCH} x S {PACKED_LEN} packed at k={model.token_bits(cfg)}, "
        f"{len(batches)} steps from seed {seed} under the mesh and without it: losses and grad "
        f"norms {runs['mesh']['metrics']}; "
        f"the losses and the {len(runs['mesh']['names'])} parameter leaves after the steps "
        f"{verdict}; {time.perf_counter() - t0:.1f} s")
    flops = train_flops(cfg, runs["mesh"]["n_params"], tokens, MESH_TRAIN_BATCH, PACKED_LEN)
    for label, run in runs.items():
        if any(n != 1 for n in run["launches"]):
            raise AssertionError(f"(e) {label}: bitunpack launches per step {run['launches']}")
        step_ms = sorted(run["ms"])[len(run["ms"]) // 2]
        busy_ms, top = run["busy"]
        log(f"      (e) {label}: step_ms (median of {len(run['ms'])}) {step_ms:.2f} "
            f"{[round(x, 2) for x in run['ms']]}; tokens/s {tokens / step_ms * 1e3:.1f}; peak "
            f"GB {run['peak'] / 1e9:.2f}; one step (the last): busy_ms={busy_ms:.3f} "
            f"idle_share={1 - busy_ms / step_ms:.3f} top={top}; "
            f"{flops / (step_ms / 1e3) / BF16_FLOPS_PER_S:.4f} of "
            f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s ({flops:.4e} model FLOPs a step); bitunpack "
            f"launches {run['launches']} [{card}]")
    launches = sum(sum(run["launches"]) for run in runs.values())
    del runs, batches

    # (f) the MoE family: the mesh moe_ffn's backward on the card
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MESH_MOE_ARCH), n_layers=MESH_LAYERS[MESH_MOE_ARCH],
                              remat=True)
    batches = [PackedBatches(cfg, MESH_TRAIN_BATCH, PACKED_LEN, seed, device).next_batch()]
    runs = {label: train_run(cfg, optcfg, c, batches, seed, device)
            for label, c in (("mesh", ctx), ("none", None))}
    verdict = same_runs(runs["mesh"], runs["none"], "(f)")
    log(f"      (f) {cfg.arch_id} cut to {cfg.n_layers} of 28 layers (1 dense + 1 MoE of "
        f"{cfg.moe_experts} experts, top {cfg.moe_top_k}, {cfg.moe_shared} shared), "
        f"{cfg.dtype}, one step of B {MESH_TRAIN_BATCH} x S {PACKED_LEN} packed under the mesh "
        f"and without it: loss and grad norm {runs['mesh']['metrics']}, parameters {verdict}; "
        f"busy_ms {runs['mesh']['busy'][0]:.3f} / {runs['none']['busy'][0]:.3f}; peak GB "
        f"{runs['mesh']['peak'] / 1e9:.2f}; bitunpack launches "
        f"{runs['mesh']['launches']} / {runs['none']['launches']}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return launches + sum(sum(run["launches"]) for run in runs.values())


def mesh_collectives(seed: int, device, card: str) -> None:
    """Phase D (g): hierarchical_psum and compressed_psum on NCCL over a
    (pod 1, data 1) mesh, against their host formulas in numpy float32."""
    pods = make_mesh((1, 1), ("pod", "data"), device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(PSUM_SHAPE, generator=g, device=device)
    err = torch.randn(PSUM_SHAPE, generator=g, device=device) * 0.01
    ms = {}
    for name, fn in (("hierarchical_psum", lambda: hierarchical_psum(x, "data", "pod", pods)),
                     ("compressed_psum", lambda: compressed_psum(x, err, "pod", pods))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = ((time.perf_counter() - t) * 1e3, out)
    hier = ms["hierarchical_psum"][1]
    total, new_err = ms["compressed_psum"][1]
    xh, eh = x.cpu().numpy(), err.cpu().numpy()
    comb = xh + eh
    scale = np.float32(np.abs(comb).max()) / np.float32(127.0) + np.float32(1e-12)
    q = np.clip(np.round(comb / scale), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * scale  # one rank: the sum of one dequantized term
    if not np.array_equal(hier.cpu().numpy(), xh):
        raise AssertionError("(g) hierarchical_psum over one rank is not the rank's own x")
    got_t, got_e = total.cpu().numpy(), new_err.cpu().numpy()
    t_err = float(np.abs(got_t - deq).max())
    e_err = float(np.abs(got_e - (comb - deq)).max())
    if t_err > 1e-6 * float(np.abs(deq).max()) or e_err > 1e-6:
        raise AssertionError(f"(g) compressed_psum against the host formula: sum max |diff| "
                             f"{t_err}, error {e_err}")
    log(f"      (g) NCCL, a (pod 1, data 1) mesh, float32 {PSUM_SHAPE}: hierarchical_psum "
        f"equals x bit for bit ({ms['hierarchical_psum'][0]:.3f} ms); compressed_psum's int8 "
        f"sum against numpy's max |diff| {t_err:.3e}, its new error {e_err:.3e} "
        f"({ms['compressed_psum'][0]:.3f} ms); one rank moves no bytes between cards [{card}]")


def mesh_checkpoint(ctx, seed: int, device, card: str) -> int:
    """Phase D (h): train() under the mesh at 2 layers of full width saves
    at step 2; the checkpoint restores onto the mesh as DTensors equal to
    the saved parameters; a resumed train() continues an uninterrupted
    run's losses.  Returns the bitunpack launches it made."""
    optcfg = OptConfig(**MESH_RESUME_OPT)
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=RESUME_LAYERS, remat=True)
    before = bitunpack.KERNEL.launches
    t0 = time.perf_counter()
    quiet = dict(ctx=ctx, seed=seed, log_every=10**9, log_fn=lambda s: None, device=device)

    def src():
        return PackedBatches(cfg, MESH_RESUME_BATCH, TRAIN_SEQ, seed, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_ckpt_") as d:
        first = train(cfg, optcfg, src(), steps=MESH_RESUME_AT, ckpt_dir=d,
                      ckpt_every=MESH_RESUME_AT, **quiet)
        saved = [plain(p) for p in tree_leaves(first["params"])]
        template = {"params": first["params"], "opt": first["opt_state"]}
        dims = {"params": model.param_dims(cfg),
                "opt": opt_state_dims(model.param_dims(cfg), first["params"], optcfg)}
        restored, manifest = CheckpointManager(d).restore_latest(template, ctx, dims)
        placed = tree_map(lambda p, dm: tuple(p.placements) == sharding_for(dm, ctx, p.shape),
                          restored["params"], dims["params"])
        if manifest["meta"]["step"] != MESH_RESUME_AT or not all(tree_leaves(placed)):
            raise AssertionError(f"(h) step {manifest['meta']['step']} restored, placed by its "
                                 f"dims: {placed}")
        leaves = tree_leaves(restored["params"])
        if not all(torch.equal(plain(a), b) for a, b in zip(leaves, saved)):
            raise AssertionError("(h) the restored parameters differ from the saved ones")
        del first, template, restored, leaves, saved
        logs = []
        resumed = train(cfg, optcfg, src(), steps=MESH_RESUME_TO, ckpt_dir=d,
                        ckpt_every=10**9, **dict(quiet, log_fn=logs.append))["losses"]
    whole = train(cfg, optcfg, src(), steps=MESH_RESUME_TO, **quiet)["losses"]
    if f"[train] resumed from step {MESH_RESUME_AT}" not in logs:
        raise AssertionError(f"(h) did not resume at step {MESH_RESUME_AT}: {logs}")
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole[MESH_RESUME_AT:]))
    if not gap <= RESUME_REL:
        raise AssertionError(f"(h) resumed {resumed} against {whole[MESH_RESUME_AT:]} (relative "
                             f"{gap}); tolerance {RESUME_REL}")
    log(f"      (h) {RESUME_LAYERS} layers at full width, B {MESH_RESUME_BATCH} x S {TRAIN_SEQ}, "
        f"{optcfg.moments_dtype} moments: "
        f"train() under the mesh saved step {MESH_RESUME_AT}, restored as DTensors placed by "
        f"param_dims, bit for bit; resumed losses {resumed} against the uninterrupted "
        f"{whole[MESH_RESUME_AT:]}: relative gap {gap:.3e} "
        f"({'bit for bit' if resumed == whole[MESH_RESUME_AT:] else 'not bit for bit'}; "
        f"tolerance {RESUME_REL}); bitunpack launches {bitunpack.KERNEL.launches - before}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return bitunpack.KERNEL.launches - before


def mesh_family_serving(arch: str, ctx, seed: int, device, card: str) -> int:
    """Phase D (j) for one model: a 4-slot engine under the mesh and without
    it (FAMILY_PROMPTS, whisper's EV_PROMPTS over zero frames) gives the same
    tokens and ticks; a PACKED_LEN-token prompt bit-packed under the mesh
    (whisper: 448 tokens over random frames, as tokens) against its tokens
    prefill without it; prefill ms, decode tick ms, busy ms, idle share and
    peak GB for both (whisper's encoder ms too).  Returns the bitunpack
    launches it made."""
    cfg = family_config(arch, MESH_LAYERS.get(arch))
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    params = model.init_params(cfg, seed, device=device)
    sharded = shard_params(params, cfg, ctx)
    prompts = EV_PROMPTS[arch] if cfg.is_encdec else FAMILY_PROMPTS
    max_len = EV_MAX_LEN.get(arch, FAMILY_MAX_LEN)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,))) for i, n in enumerate(prompts)]
    runs = {label: served_on(p, cfg, c, reqs, device, max_len)
            for label, p, c in (("mesh", sharded, ctx), ("none", params, None))}
    if runs["mesh"]["tokens"] != runs["none"]["tokens"] or \
            runs["mesh"]["ticks"] != runs["none"]["ticks"]:
        raise AssertionError(f"(j) {arch}: the engine under the mesh gave other tokens or ticks "
                             "than without it")
    before = bitunpack.KERNEL.launches
    extra = ev_inputs(cfg, rng, 1, device) if cfg.is_encdec else {}
    if cfg.is_encdec:
        n = EV_PROMPTS[arch][-1]
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        mesh_batch = {"tokens": torch.from_numpy(toks).to(device), **extra}
    else:
        n = PACKED_LEN
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int64)
        k_bits = model.token_bits(cfg)
        packed = np.stack([bitpack_encode(toks[0], k_bits)]).view(np.int32)
        mesh_batch = {"packed": torch.from_numpy(packed).to(device)}
    l_mesh = model.prefill(sharded, mesh_batch, cfg, ctx)[0].full_tensor().float()
    torch.cuda.synchronize()
    unpacks = bitunpack.KERNEL.launches - before
    if unpacks != (0 if cfg.is_encdec else 1):
        raise AssertionError(f"(j) {arch}: the packed prefill launched bitunpack {unpacks} times")
    plain_batch = {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device), **extra}
    l_none = model.prefill(params, plain_batch, cfg)[0].float()
    err = float((l_mesh - l_none).abs().max())
    rel = float((l_mesh - l_none).norm() / l_none.norm())
    if not rel <= MESH_REL_TOL:
        raise AssertionError(f"(j) {arch}: prefill logits under the mesh differ from without it: "
                             f"relative L2 {rel} > {MESH_REL_TOL}")
    cut = "" if cfg.n_layers == get_config(arch).n_layers else \
        f" cut to {cfg.n_layers} of {get_config(arch).n_layers} layers"
    n_tokens = sum(len(o) for o in runs["mesh"]["tokens"].values())
    log(f"      (j) {arch}{cut} at full width ({cfg.family}, {cfg.dtype}): {len(reqs)} requests "
        f"of {list(prompts)} tokens, {MESH_NEW_TOKENS} new each ({n_tokens} tokens), on "
        f"{LM_SLOTS} slots of {max_len} in {runs['mesh']['ticks']} ticks: the same tokens and "
        f"ticks under the mesh and without it; a {n}-token prefill "
        f"({'as tokens over random frames' if cfg.is_encdec else 'bit-packed'} under the mesh, "
        f"tokens without it): max |diff| {err:.3e}, relative L2 {rel:.3e} "
        f"({'bit for bit' if err == 0 else 'not bit for bit'}; tolerance {MESH_REL_TOL}); "
        f"bitunpack launches {unpacks} [{card}]")
    seq = torch.from_numpy(reqs[0].tokens[None].astype(np.int32)).to(device)
    for label, p, c in (("mesh", sharded, ctx), ("none", params, None)):
        run = runs[label]
        ms = prefill_ms(p, cfg, c, seq, extra, max_len)
        enc = ""
        if cfg.is_encdec:
            frames = extra["enc_embeds"]
            enc = f"encoder_ms (1 x {cfg.encoder_seq} frames, warm) " \
                f"{warm_ms(lambda: model.encode(p, frames, cfg, c)):.2f}; "
        log(f"      (j) {arch} {label}: prefill_ms ({prompts[0]} tokens, warm) {ms:.2f}; {enc}"
            f"decode_ms per tick (median) {run['tick_ms']:.2f}, tokens/s "
            f"{run['tokens_per_s']:.1f}; one decode tick: busy_ms={run['busy_ms']:.3f} "
            f"idle_share={1 - run['busy_ms'] / run['tick_ms']:.3f} top={run['top']}; peak GB "
            f"{run['peak'] / 1e9:.2f}; {time.perf_counter() - t0:.1f} s [{card}]")
    del params, sharded, runs
    gc.collect()
    torch.cuda.empty_cache()
    return unpacks


def mesh_family_training(arch: str, ctx, seed: int, device, card: str) -> int:
    """Phase D (k) for one model: MESH_TRAIN_STEPS AdamW steps with remat
    under the mesh and without it, bit for bit (losses, grad norms and
    parameters), step ms and idle share for both.  Returns the bitunpack
    launches it made."""
    optcfg = OptConfig(**OPT)
    cfg = dataclasses.replace(family_config(arch, MESH_LAYERS.get(arch)), remat=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        B, S = EV_TRAIN_B, EV_TRAIN_S
        batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                               .astype(np.int32)).to(device),
                    **ev_inputs(cfg, rng, B, device)} for _ in range(MESH_TRAIN_STEPS)]
    else:
        B, S = MESH_TRAIN_BATCH, PACKED_LEN
        src = PackedBatches(cfg, B, S, seed, device)
        batches = [{**src.next_batch(), **(ev_inputs(cfg, rng, B, device)
                                           if cfg.family == "vlm" else {})}
                   for _ in range(MESH_TRAIN_STEPS)]
    runs = {label: train_run(cfg, optcfg, c, batches, seed, device)
            for label, c in (("mesh", ctx), ("none", None))}
    verdict = same_runs(runs["mesh"], runs["none"], f"(k) {arch}")
    if verdict != "bit for bit":  # one rank runs the plain path's kernels in its order
        raise AssertionError(f"(k) {arch} under the mesh against without it: {verdict}")
    want = 0 if cfg.is_encdec else 1
    for label, run in runs.items():
        if any(n != want for n in run["launches"]):
            raise AssertionError(f"(k) {arch} {label}: bitunpack launches per step "
                                 f"{run['launches']}, not {want}")
    cut = "" if cfg.n_layers == get_config(arch).n_layers else \
        f" cut to {cfg.n_layers} of {get_config(arch).n_layers} layers"
    inputs = f"B {B} x S {S} " + ("tokens over random frames" if cfg.is_encdec else
                                  f"packed at k={model.token_bits(cfg)}")
    if cfg.family == "vlm":
        inputs += f" after {cfg.vision_tokens} vision embeddings"
    log(f"      (k) {arch}{cut} at full width, {cfg.dtype}, remat, AdamW, {inputs}, "
        f"{len(batches)} steps from seed {seed} under the mesh and without it: losses and grad "
        f"norms {runs['mesh']['metrics']}; the losses and the {len(runs['mesh']['names'])} "
        f"parameter leaves after the steps {verdict}; {time.perf_counter() - t0:.1f} s [{card}]")
    for label, run in runs.items():
        step_ms = run["ms"][-1]
        busy_ms, top = run["busy"]
        log(f"      (k) {arch} {label}: step_ms {step_ms:.2f} (the first {run['ms'][0]:.2f}); "
            f"one step (the last): busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / step_ms:.3f} "
            f"top={top}; peak GB {run['peak'] / 1e9:.2f}; bitunpack launches {run['launches']} "
            f"[{card}]")
    unpacks = sum(sum(run["launches"]) for run in runs.values())
    del runs, batches
    gc.collect()
    torch.cuda.empty_cache()
    return unpacks


def mesh_phase(seed: int, device: str = "cuda") -> dict:
    """Phase D.  Returns the kernel launches of its window, the whole phase."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_kernel_launches()
    dist.init_process_group(BACKENDS[device], store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), device=device)
        ctx = ShardingCtx(mesh=mesh, strategy="tp")
        cfg = get_config(LM_ARCH)
        rng = np.random.default_rng(seed)
        params = model.init_params(cfg, seed, device=device)
        sharded = shard_params(params, cfg, ctx)
        log(f"      {cfg.arch_id} at full width in {cfg.dtype} from seed {seed}; mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} over {dist.get_backend()}, "
            f"strategy {ctx.strategy}; embed placed {tuple(sharded['embed'].placements)}")

        # (a) the engine under the mesh and without it
        reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)))
                for i, n in enumerate(LM_PROMPTS)]
        runs = {label: served_on(p, cfg, c, reqs, device)
                for label, p, c in (("mesh", sharded, ctx), ("none", params, None))}
        got = {label: run["tokens"] for label, run in runs.items()}
        if got["mesh"] != got["none"] or runs["mesh"]["ticks"] != runs["none"]["ticks"]:
            raise AssertionError("(a) the engine under the mesh gave other tokens or ticks than "
                                 "without it")
        seq = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_PROMPTS[0])).astype(np.int32)
                               ).to(device)
        l_mesh = model.prefill(sharded, {"tokens": seq}, cfg, ctx)[0].full_tensor().float()
        l_none = model.prefill(params, {"tokens": seq}, cfg)[0].float()
        err = float((l_mesh - l_none).abs().max())
        rel = float((l_mesh - l_none).norm() / l_none.norm())
        if not rel <= MESH_REL_TOL:
            raise AssertionError(f"(a) prefill logits under the mesh differ from without it: "
                                 f"relative L2 {rel} > {MESH_REL_TOL}")
        n_tokens = sum(len(o) for o in got["mesh"].values())
        log(f"      (a) {len(reqs)} requests of {list(LM_PROMPTS)} tokens, {MESH_NEW_TOKENS} new "
            f"each ({n_tokens} tokens), on {LM_SLOTS} slots in {runs['mesh']['ticks']} ticks: "
            f"the same tokens under the mesh and without it; {LM_PROMPTS[0]}-token prefill "
            f"logits under the mesh against without: max |diff| {err:.3e}, relative L2 "
            f"{rel:.3e} ({'bit for bit' if err == 0 else 'not bit for bit'}; tolerance "
            f"{MESH_REL_TOL})")
        for label, p, c in (("mesh", sharded, ctx), ("none", params, None)):
            run = runs[label]
            ms = prefill_ms(p, cfg, c, seq)
            log(f"      (a) {label}: prefill_ms ({LM_PROMPTS[0]} tokens, warm) {ms:.2f}; "
                f"decode_ms per tick (median) {run['tick_ms']:.2f}, tokens/s "
                f"{run['tokens_per_s']:.1f}; one decode tick: busy_ms={run['busy_ms']:.3f} "
                f"idle_share={1 - run['busy_ms'] / run['tick_ms']:.3f} top={run['top']}")
        del runs

        # (b) a packed prompt under the mesh: one bitunpack on the rank's own words
        k_bits = model.token_bits(cfg)
        toks = rng.integers(0, cfg.vocab, (1, PACKED_LEN)).astype(np.int64)
        packed = torch.from_numpy(np.stack([bitpack_encode(toks[0], k_bits)]).view(np.int32))
        before = ops.kernel_launches()
        l_packed = model.prefill(sharded, {"packed": packed.to(device)}, cfg, ctx)[0]
        torch.cuda.synchronize()
        after = ops.kernel_launches()
        one = {k: after[k] - before[k] for k in after}
        l_tokens = model.prefill(sharded, {"tokens": torch.from_numpy(toks.astype(np.int32))
                                           .to(device)}, cfg, ctx)[0]
        if one != dict(dict.fromkeys(ops.KERNELS, 0), bitunpack=1):
            raise AssertionError(f"(b) the packed prefill under the mesh launched {one}, not one "
                                 "bitunpack")
        if not torch.equal(l_packed.full_tensor(), l_tokens.full_tensor()):
            raise AssertionError("(b) the packed prefill under the mesh differs from the tokens "
                                 "prefill")
        log(f"      (b) {PACKED_LEN}-token prompt packed at k={k_bits} under the mesh: one "
            "bitunpack launch on the rank's shard, logits bit-identical to the tokens prefill")
        del sharded, params

        # (c) the serve launcher
        stats = serve_launcher.main(SERVE_ARGS + ["--device", device])
        if stats["requests"] != 16 or stats["tokens"] != 16 * 16:
            raise AssertionError(f"(c) the serve launcher drained {stats}")
        log(f"      (c) launch.serve {' '.join(SERVE_ARGS)}: {stats['requests']} requests, "
            f"{stats['tokens']} tokens, {stats['tokens_per_s']:.1f} tokens/s, "
            f"{stats['ticks']} ticks in {stats['seconds']:.2f} s")

        # (e)-(f) training under the mesh, (g) the collectives, (h) checkpoints
        card = card_line()
        unpacks = 1 + mesh_training(ctx, seed, device, card)
        mesh_collectives(seed, device, card)
        unpacks += mesh_checkpoint(ctx, seed, device, card)

        # (i) the train launcher's production mesh needs its 256 ranks
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as d:
                train_launcher.main(TRAIN_MESH_ARGS + ["--corpus", d, "--device", device])
        except RuntimeError as e:
            if "needs 256 ranks, found 1" not in str(e):
                raise
            log(f"      (i) launch.train {' '.join(TRAIN_MESH_ARGS)}: RuntimeError: {e} [{card}]")
        else:
            raise AssertionError("(i) launch.train --mesh single ran on one rank")

        # (j) the SSM, hybrid, enc-dec and VLM families served, (k) trained
        served = {arch: mesh_family_serving(arch, ctx, seed, device, card) for arch in MESH_ARCHS}
        trained = {arch: mesh_family_training(arch, ctx, seed, device, card)
                   for arch in MESH_ARCHS}
        unpacks += sum(served.values()) + sum(trained.values())
        # (l) every bitunpack of the window: one a packed prefill, one a packed step
        log(f"      (l) bitunpack launches in phase D's window: {unpacks}: (b) 1, (e), (f) and "
            f"(h) one a step, (j) {served}, (k) {trained} [{card}]")
    finally:
        # (d)
        dist.destroy_process_group()
    launches = ops.kernel_launches()
    if launches != dict(dict.fromkeys(ops.KERNELS, 0), bitunpack=unpacks):
        raise AssertionError(f"phase D launched {launches}, not {unpacks} bitunpack")
    log(f"      (d) process group destroyed; {unpacks} bitunpack launches: (b) 1, the packed "
        "training batches of (e), (f), (h) and (k) one a step, (j)'s packed prefills one each")
    return launches


# ---------------------------------------------------------------------------
# phase R: the multi-pod dry run
# ---------------------------------------------------------------------------

# (arch, shape, the status the cell must come back with).  mamba2-370m x
# train_4k is left out: its trace (48 layers of 16 SSD chunks, forward and
# backward) takes longer than the phase's budget of 60 s (PERF.md section 6)
SSM_ARCH, HYBRID_ARCH, MOE_ARCH = FAMILY_ARCHS[:3]
GLU_ARCH = "gemma-7b"  # 16 heads of 256 on the 16 model ranks: the head-parallel arm
ENCDEC_ARCH = EV_ARCHS[0]  # whisper-base: 1,500 encoder frames, which 16 does not divide
DRYRUN_CELLS = ((LM_ARCH, "decode_32k", "ok"), (LM_ARCH, "train_4k", "ok"),
                (LM_ARCH, "long_500k", "skipped"), (SSM_ARCH, "decode_32k", "ok"),
                (HYBRID_ARCH, "decode_32k", "ok"), (MOE_ARCH, "decode_32k", "ok"),
                (GLU_ARCH, "train_4k", "ok"), (ENCDEC_ARCH, "decode_32k", "ok"))
DRYRUN_TIMEOUT_S = 300
# the reference's per-device FLOPs on the 16x16 mesh: the JAX package's dry
# run (`repro.launch.dryrun`, trip-aware HLO count) at 512 host devices, as
# PERF.md section 6 records them: qwen3-1.7b x train_4k, mamba2-370m x
# decode_32k, hymba-1.5b x decode_32k, gemma-7b x train_4k and
# whisper-base x decode_32k (jax 0.9 on the CPU)
TRAIN_4K_REFERENCE_FLOPS = 1.0105e14
SSM_DECODE_REFERENCE_FLOPS = 3.81599744e8
HYBRID_DECODE_REFERENCE_FLOPS = 2.000900096e9
GLU_TRAIN_REFERENCE_FLOPS = 2.86778837696512e14
ENCDEC_DECODE_REFERENCE_FLOPS = 2.59825664e8
# (arch, shape) -> (the reference's per-device FLOPs, the most the port may
# count over it): each product on rank 0's share (ROADMAP C.5; mamba2's SSD
# mixer on the rank's 2 of 32 heads, the conv over B and C whole; C.7:
# hymba's in_proj on the rank's columns, 3.49x before, its SSD mixer on
# every one of its 25 heads, which 16 does not divide; C.8: gemma's
# attention output projection's backward on the rank's heads, 1.302x
# before; C.9: whisper's cross-attention on the rank's uneven shard of the
# frames, 1.532x before)
DRYRUN_BOUNDS = {(LM_ARCH, "train_4k"): (TRAIN_4K_REFERENCE_FLOPS, 1.02),
                 (SSM_ARCH, "decode_32k"): (SSM_DECODE_REFERENCE_FLOPS, 1.02),
                 (HYBRID_ARCH, "decode_32k"): (HYBRID_DECODE_REFERENCE_FLOPS, 1.02),
                 (GLU_ARCH, "train_4k"): (GLU_TRAIN_REFERENCE_FLOPS, 1.02),
                 (ENCDEC_ARCH, "decode_32k"): (ENCDEC_DECODE_REFERENCE_FLOPS, 1.02)}
# (arch, shape) -> the most all-gather bytes a device: deepseek-moe-16b's
# decode reads its caches in the layout they are placed in (ROADMAP C.6),
# 10x below the 6.214e10 that resharding them every step moved (PERF.md)
DRYRUN_GATHERS = {(MOE_ARCH, "decode_32k"): 6.214e10 / 10}


def dryrun_phase(tmpdir: str, cells=DRYRUN_CELLS, bounds=DRYRUN_BOUNDS,
                 gathers=DRYRUN_GATHERS) -> list:
    """Phase R: each cell through the dry run's command line, in a
    subprocess of its own, all started together (each traces on one host
    core); a cell of `bounds` must count at most its factor times the
    reference's per-device FLOPs, and one of `gathers` at most its
    all-gather bytes.  Returns the records."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = []
    for arch, shape, _ in cells:
        out = os.path.join(tmpdir, f"dryrun_{arch}_{shape}.json")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--json", out], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=ROOT)))
    try:
        results = [p.communicate(timeout=DRYRUN_TIMEOUT_S) for _, p in procs]
    finally:
        for _, p in procs:  # a timeout or a failure leaves no process behind
            p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    records = []
    for (arch, shape, status), (out, proc), (stdout, stderr) in zip(cells, procs, results):
        if proc.returncode != 0:
            raise AssertionError(f"dry run {arch} x {shape} exited {proc.returncode}:\n"
                                 f"{stdout[-2000:]}\n{stderr[-4000:]}")
        with open(out) as f:
            [rec] = json.load(f)
        if rec["status"] != status:
            raise AssertionError(f"dry run {arch} x {shape}: status {rec['status']}, not "
                                 f"{status}: {rec}")
        if status == "ok":
            log(f"      {arch} x {shape} x {rec['mesh']} ({rec['strategy']}): ok, per device "
                f"flops {rec['flops']:.4e}, collective bytes {rec['collective_bytes']:.4e} "
                f"{rec['collectives']}, argument bytes {rec['memory']['argument_bytes']}, "
                f"output bytes {rec['memory']['output_bytes']}; trace {rec['lower_s']} s")
        else:
            log(f"      {arch} x {shape}: {rec['status']} ({rec['reason']})")
        if (arch, shape) in bounds:
            ref, most = bounds[arch, shape]
            ratio = rec["flops"] / ref
            log(f"      {arch} x {shape}: {ratio:.4f}x the reference's {ref:.4e} FLOPs a device "
                f"(at most {most}x)")
            if ratio > most:
                raise AssertionError(f"dry run {arch} x {shape}: {rec['flops']:.4e} FLOPs a "
                                     f"device, {ratio:.4f}x the reference's {ref:.4e}, over "
                                     f"{most}x")
        if (arch, shape) in gathers:
            got, most = rec["collectives"].get("all-gather", 0.0), gathers[arch, shape]
            log(f"      {arch} x {shape}: {got:.4e} all-gather bytes a device (at most "
                f"{most:.4e})")
            if got > most:
                raise AssertionError(f"dry run {arch} x {shape}: {got:.4e} all-gather bytes a "
                                     f"device, over {most:.4e}")
        records.append(rec)
    log(f"      {len(cells)} subprocesses, started together, in {seconds:.1f} s")
    return records


def kernels_line(records: dict, by_order: dict, once: dict) -> list:
    """Phase 10's record of each kernel: phase 3's numbers and its launches,
    summed over every counted window.  `by_order` maps a window's key (its
    name in the record) to its launches by file order, {order: {kernel: n}};
    `once` a window run once (phases 9, T, M, E and D) to {kernel: n}."""
    kernels = []
    for name, kern in ops.KERNELS.items():
        path, stack = records[name]["cases"][0], records[name]["cases"][1]
        size = ({"shape": path["shape"], "stack_shape": stack["shape"]} if "shape" in path
                else {"blocks": path["blocks"], "stack_blocks": stack["blocks"]})
        kernels.append({
            "name": name, "route": "cuda", "source": kern.source, "replaces": kern.replaces,
            "launches": sum(n[name] for w in by_order.values() for n in w.values())
            + sum(w[name] for w in once.values()),
            "max_abs_err": records[name]["max_abs_err"],
            "ms": path["ms"], "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "library_ms": path["library_ms"], **size,
            "stack_ms": stack["ms"], "stack_plain_ms": stack["plain_ms"],
            "stack_bound_ms": stack["bound_ms"], "stack_library_ms": stack["library_ms"],
            **{key: {o: n[name] for o, n in w.items()} for key, w in by_order.items()},
            **{key: w[name] for key, w in once.items()},
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
        elif name == "rle_decode":
            kernels[-1].update(
                library="torch.repeat_interleave of the runs by their lengths on the writer's "
                "pages (the expansion alone; a yardstick, never called by the port)",
                variant="1, 2 or 4 tiles a block: a warp a tile, a grid-stride walk of 8-warp "
                "CTAs (2 an SM), windows fetched 2 tiles ahead by cp.async, a byte rank table "
                "by shared atomics and a byte-wise prefix; 8 tiles a block (under 2 blocks an "
                "SM): a CTA a block, the 7-step search")
        elif name in ("fused_scan", "fused_scan_batch"):
            kernels[-1].update(
                variant="grid-stride walk: 512 threads a block, 8 rows a thread, the mask "
                "staged in shared memory and written 8 contiguous bytes a thread")
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available; nothing was run", file=sys.stderr)
        return 1

    # phase 1
    print(card_line(), flush=True)  # the card's name and power limit, as nvidia-smi gives them
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}; host: "
        f"{os.cpu_count()} cores, torch on {torch.get_num_threads()} threads")

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
        fabric_launches = {}
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

            # phase F: the scan fabric
            log(f"[F] {order}: the scan fabric on the card:")
            other = passes["sorted" if order == "unsorted" else "unsorted"]
            fabric_launches[order] = fabric_phase(readers, order, other)
            log(f"      launches {fabric_launches[order]}")

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

    # phase T
    log(f"[T] training on the card: {LM_ARCH} at full width, fed by the token pipeline")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        train_launches = training_phase(args.seed, d)
    log(f"      launches {train_launches}")

    # phase M
    t0 = time.perf_counter()
    log("[M] the decoder-only MoE, SSM and hybrid families served on the card at full width")
    family_launches = families_phase(args.seed)
    log(f"      launches {family_launches}; phase M took {time.perf_counter() - t0:.1f} s")

    # phase E
    t0 = time.perf_counter()
    log("[E] the enc-dec and VLM families served and trained on the card at full width")
    ev_launches = encdec_vlm_phase(args.seed)
    log(f"      launches {ev_launches}; phase E took {time.perf_counter() - t0:.1f} s")

    # phase D
    t0 = time.perf_counter()
    log(f"[D] serving and training under a device mesh on the card: {LM_ARCH} at full width, "
        f"then the SSM, hybrid, enc-dec and VLM families")
    dist_launches = mesh_phase(args.seed)
    log(f"      launches {dist_launches}; phase D took {time.perf_counter() - t0:.1f} s; the "
        f"script so far {time.perf_counter() - T0:.1f} s")

    # phase R
    t0 = time.perf_counter()
    log(f"[R] the multi-pod dry run on the CPU beside {card_line()}: {LM_ARCH}, {SSM_ARCH}, "
        f"{HYBRID_ARCH}, {MOE_ARCH}, {GLU_ARCH} and {ENCDEC_ARCH} on the 16x16 mesh over a fake "
        "process group, nothing computed")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        dryrun_phase(d)
    log(f"      phase R took {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - T0:.1f} s")

    # phase 10
    kernels = kernels_line(records, {
        "launches_by_order": launches, "launches_batched_pushdown_by_order": batched_launches,
        "launches_offload_by_order": offload_launches,
        "launches_service_by_order": service_launches,
        "launches_fabric_by_order": fabric_launches,
    }, {"launches_lm": lm_launches, "launches_train": train_launches,
        "launches_families": family_launches, "launches_encdec_vlm": ev_launches,
        "launches_dist": dist_launches})
    print(json.dumps({"kernels": kernels}), flush=True)
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the query, batched, offload, service, "
                             f"fabric, LM, training, families', enc-dec/VLM or mesh paths: "
                             f"{idle}")

    # phase 11
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
