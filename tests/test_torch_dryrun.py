"""The port's dry run (`launch/dryrun.py`) against the reference's, on smoke
configs on the 16x16 mesh.  Each side runs in a subprocess of its own (the
reference on 512 placeholder host devices, the port as rank 0 of torch's
`fake` process group), with `get_config` patched to `get_smoke_config` and
to four variants of it (`VARIANTS`: mamba2 with 16 SSM heads, deepseek with
16 heads and 16 KV heads, hymba with 5 heads at d 640, whisper over 60
frames).

Prefill and decode: the same status, `memory.argument_bytes` equal but where
the two place a decode's caches differently (`ARG_PARTED`, ROADMAP C.6 and
C.9) or the reference drops leaves the step never reads (`UNREAD`), and
per-device `flops` within 2% of the reference's trip-aware count, or the
ratio pinned in `PARTED` with the products that part them (ROADMAP C.5).
Training: status ok and the FLOPs ratio within 2%, or pinned
(`TRAIN_PARTED`).  Every cell: `memory.output_bytes` equal but for XLA's
output tuple table (`OUT_LEAVES`) and the caches a decode returns, and the
collective bytes by kind pinned on both sides (`COLLECTIVES`) with the
collectives that part them.  The port's products, listed by site in its
subprocess (`_LISTING`), show that the sites C.5, C.7, C.8 and C.9
repaired run on rank 0's share, the SSD mixer's on its own heads."""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses
import json
import os
import subprocess
import sys
from collections import defaultdict

import pytest

from tests.util import REPO, run_with_devices

# variants of the smoke configs, resolved by both sides' patched `get_config`:
# mamba2 with 16 SSM heads of 8 (d_inner 128 unchanged), which the 16 model
# ranks divide, and deepseek with its full config's 16 heads and 16 KV heads
# (the head-parallel attention, whose decode reads its caches in their
# layout: ROADMAP C.6).  hymba with `test_torch_families_mesh.py`'s
# hymba_seq heads (5 heads, 1 KV head and 5 SSM heads, which 16 does not
# divide, as the full config's 25, 5 and 25: the attention's sequence-
# parallel arm and flash-decode, the SSM's whole-heads arm) at d 640 with
# SSM heads of 64: an in_proj of (640, 661) whose 661 columns 16 does not
# divide either (as the full config's 6,457), and whose 846 KB of bf16
# outweigh the step's rows, as at full width (ROADMAP C.7).  On the parent of
# the repair its decode counted 2.616x the reference's FLOPs (4.1425e7
# against 1.5836e7): DTensor moved the step's 128 rows onto in_proj's `d`
# shards rather than gather the weight, and every model rank ran all 661
# columns, (128, 661) at K 40 over 4 layers, 2.707e7; with the columns on
# the model axis (`ssm._inner_cols`) it runs (128, 42) at K 40, 1.015x.
# whisper over 60 encoder frames, which the 16 model ranks do not divide
# (as the full config's 1,500; the smoke config's 48 divide them): its
# decode step's cross-attention caches in flash-decode's uneven shards of
# the frames, 4 a rank and none on the last (ROADMAP C.9).  On the parent
# of the repair its decode counted 1.027x the reference's FLOPs (8.8474e6
# against 8.6170e6): the caches fell back to their rows, and every model
# rank attended all 60 frames.
MAMBA16, DEEPSEEK16 = "mamba2-370m/16-heads", "deepseek-moe-16b/16-heads"
HYMBA5, WHISPER60 = "hymba-1.5b/5-heads", "whisper-base/60-frames"
VARIANTS = {MAMBA16: ("mamba2-370m", dict(ssm_heads=16, ssm_head_dim=8)),
            DEEPSEEK16: ("deepseek-moe-16b", dict(n_heads=16, n_kv=16)),
            HYMBA5: ("hymba-1.5b", dict(n_heads=5, n_kv=1, ssm_heads=5, d_model=640,
                                        ssm_head_dim=64)),
            WHISPER60: ("whisper-base", dict(encoder_seq=60))}
CELLS = (("qwen3-1.7b", "prefill_32k"), ("qwen3-1.7b", "decode_32k"),
         ("deepseek-moe-16b", "prefill_32k"), ("deepseek-moe-16b", "decode_32k"),
         ("mamba2-370m", "decode_32k"), ("hymba-1.5b", "decode_32k"),
         (MAMBA16, "decode_32k"), (DEEPSEEK16, "decode_32k"), (HYMBA5, "decode_32k"),
         (WHISPER60, "decode_32k"))
TRAIN = ("qwen3-1.7b", "train_4k")
# the training cells of ROADMAP C.8: the 16-head deepseek's head-parallel
# attention and whisper's gelu MLP and sequence-parallel attention
TRAINS_C8 = ((DEEPSEEK16, "train_4k"), ("whisper-base", "train_4k"))
TRAINS = (TRAIN, (MAMBA16, "train_4k")) + TRAINS_C8


def _config(arch: str):
    """The port's smoke config of `arch`, or of a variant's base."""
    from repro_torch.configs import get_smoke_config

    base, changes = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(get_smoke_config(base), **changes)

# port flops / reference flops of the cells where the two part by more than
# 2% (ROADMAP C.5), and the products that part them.  mamba2's 4 SSM heads
# do not divide the 16 model ranks: the whole-heads arm.  Its decode step
# runs the SSD mixer (`ssm._decode_mixer`) on each rank's 8 batch rows with
# every head and channel, on all 16 model ranks alike: the readout (8, 1,
# 128) @ K 16 and the depthwise conv (160, 8, 1) @ K 4, 129,024 FLOPs over
# 3 layers where the reference, `inner` sharded over the model axis, counts
# 8,064; the rest of the cell agrees: the head (8, 64) @ (64, 128), in_proj
# (8, 64) @ (64, 19) and out_proj.  With 16 heads each rank steps its own
# head (`ssm._Share`), and what remains is the depthwise conv over B and C,
# 32 of the rank's 40 conv channels, computed whole on every rank: (40, 8,
# 1) @ K 4, 7,680 FLOPs over 3 layers where the reference's 10 channels a
# rank count 1,920, the whole of the 5,760 that part the two.
PARTED = {
    ("mamba2-370m", "decode_32k"): 343040.0 / 222080.0,
    (MAMBA16, "decode_32k"): 227840.0 / 222080.0,
}
PARTED_MOST = {(MAMBA16, "decode_32k"): 1.03}  # from 1.545x with every head on each rank

# the training cells.  qwen3's and whisper's run below the reference's
# count: the reference's sequence-parallel arm (4 heads, which the 16 model
# ranks do not divide) runs the attention's o @ wo forward at the whole
# H x hd of 64 on every model rank, (65536, 64) @ K 64, and whisper's gelu
# MLP its h @ w2 forward at the whole d_ff of 128, (65536, 64) @ K 128,
# where the port runs each on the rank's shard (`transformer._out_proj`
# cuts o's heads as wo's rows, and w1's output keeps its ff shard).  15/16
# of those products is the whole gap: qwen3's o @ wo 1.611e9 over 3 layers;
# whisper's 2.147e9 over its 2 decoder layers' self- and cross-attention,
# its 2 decoder MLPs' 2.147e9, and its 2 encoder layers' o @ wo, (768, 64)
# @ K 64, 1.258e7.  Before ROADMAP C.8 the port ran the backward of both
# products whole instead (qwen3 1.033x, whisper 1.116x); with wo's weight
# gradient alone whole, qwen3's count equalled the reference's.  The MLP's
# down projection runs its backward on the rank's ff shard, and each
# attention's wo on its H x hd shard (`test_repaired_products_run_on_rank_0s_share`).
# mamba2's 16 heads scan one a rank (`test_ssd_products_run_on_the_ranks_heads`);
# the C . B product of each chunk (`ssd_scan`'s cb, (16, 32, 32) @ K 16) has
# no head dim and runs whole on every rank, 6.040e8 FLOPs over 3 layers
# forward and backward: at 1/16 of that the two would agree within 0.09%.
# out_proj's backward runs on the rank's channels because the output's
# constraint reduces its cotangent (`sharding.constrain_rows`).
TRAIN_PARTED = {
    TRAIN: 44593053696.0 / 46103003136.0,
    (MAMBA16, "train_4k"): 6465650688.0 / 5894307840.0,
    ("whisper-base", "train_4k"): 31332630528.0 / 35370958848.0,
}
TRAIN_MOST = {(MAMBA16, "train_4k"): 1.10}  # from 3.656x with every head on each rank

# rank 0's argument bytes of a decode cell less the reference's, where the
# two place the SSM's caches differently (ROADMAP C.6): the port keeps them
# in its step's layout, the reference by its heuristic (`specs.
# cache_sharding_dims`: the largest dim that 16 divides over `model`).  The
# conv state (L, 8 rows, 3, di + 2N) bf16 is placed by its rows alone (its
# new value is a shift of the whole), where the reference shards di + 2N:
# 16x the reference's bytes, mamba2's 23,040 against 1,440 (+21,600), each
# of hymba's 4 layers' 6,912 against 432.  The SSM state (L, 8, H, P, N)
# float32 is placed by its rows and, where 16 divides the heads, its heads,
# as the reference's of the 16-head variant (H its largest dim); with 4
# heads by its rows alone, where the reference shards P: mamba2's 196,608
# against 12,288 (+184,320), each of hymba's layers' 32,768 against 2,048,
# and of the 5-head hymba's 81,920 against 5,120 (its conv state 16,128
# against 1,008).  A decode step returns its caches, so its output bytes
# part alike.
# Whisper's cross-attention caches (L, 8 rows, Se, KV, hd) bf16 are placed
# by the port in flash-decode's uneven shards of the frames (ROADMAP C.9),
# by the reference on hd: 60 frames on 16 ranks give rank 0 4 frames of all
# 16 hd where the reference's hold all 60 of one, 2 layers x 8 x 4 heads x
# (64 - 60) x 2 bytes, +512 for each of ck and cv.
ARG_PARTED = {
    ("mamba2-370m", "decode_32k"): 21600 + 184320,
    ("hymba-1.5b", "decode_32k"): 4 * (6480 + 30720),
    (MAMBA16, "decode_32k"): 21600,
    (HYMBA5, "decode_32k"): 4 * (15120 + 76800),
    (WHISPER60, "decode_32k"): 2 * 512,
}
# rank 0's bytes of the leaves that a decode step never reads and that the
# reference's `jax.jit` drops from its arguments (`keep_unused=False`):
# whisper's encoder (its layer and final norms and projections) and the
# decoder's cross-attention x_wk and x_wv, whose keys and values the step
# reads from ck and cv, 1,152 + 128 bytes
UNREAD = {(WHISPER60, "decode_32k"): 1152 + 128}

# XLA's `output_size_in_bytes` counts the output tuple's table, 8 bytes a
# leaf, besides the leaves themselves: the logits and the stacked caches
# (k, v; deepseek's dense and MoE segments each; hymba's k, v, conv and
# state of each segment, and its ring), or the step's parameters, moments,
# step count and stats
OUT_LEAVES = {
    ("qwen3-1.7b", "prefill_32k"): 3, ("qwen3-1.7b", "decode_32k"): 3,
    ("deepseek-moe-16b", "prefill_32k"): 5, ("deepseek-moe-16b", "decode_32k"): 5,
    ("mamba2-370m", "decode_32k"): 3, ("hymba-1.5b", "decode_32k"): 13,
    (MAMBA16, "decode_32k"): 3, (DEEPSEEK16, "decode_32k"): 5, (HYMBA5, "decode_32k"): 13,
    (WHISPER60, "decode_32k"): 5,
    TRAIN: 43, (MAMBA16, "train_4k"): 37, (DEEPSEEK16, "train_4k"): 79,
    ("whisper-base", "train_4k"): 79,
}

# rank 0's collective bytes by kind, (port, reference).  They part because
# the two partitioners place the same step differently, the largest first:
#  - XLA splits the sequence-parallel attention's head dim across ranks
#    and all-reduces the float32 scores, (2, 1, 2, 1024, 32768) a q chunk:
#    1.031e11 of qwen3's prefill all-reduce bytes, 5.154e10 of deepseek's
#    (with 4.027e9 of its routed experts' (491520, 64) output), 6.442e9 of
#    the training step's (forward and backward); the port attends each
#    rank's q rows against the whole k and v with no collective;
#  - the reference's host devices move float32 where the port moves bf16
#    (the CPU compiler widens bf16 products and their collectives);
#  - only XLA issues `collective-permute` (slices such as the rotary
#    halves, the SSM's splits) and `all-to-all` (concatenations, gathers);
#    only the port `reduce-scatter` (the vocab-sharded head's logits, the
#    MoE's expert sums);
#  - the port's largest all-gathers: the embedding made whole on D
#    (`embed_lookup`'s constrain, 1.342e8 in both prefills), deepseek's
#    tokens gathered for the dispatch over the global batch
#    (`moe._routed_global`, 2.684e8, and 5.033e7 of their expert ids and
#    gates), the training loss's float32 logits (`softmax_xent`, 5.367e8;
#    mamba2's 16-head step too, beside its embedding made whole forward and
#    backward, 2 x 1.342e8, and in_proj's output gathered whole on its
#    last dim for the mixer's cut, `ssm._rows`, 1.195e8).
# The repair of ROADMAP C.5 moved bytes between kinds: the training MLP's
# cotangent is all-reduced at its output (`sharding.constrain_cotangent`:
# all-reduce 1.347e8 -> 1.851e8) where DTensor had gathered the down
# projection's weight and hidden state whole for its backward (all-gather
# 9.731e8 -> 9.227e8, reduce-scatter 1.102e7 -> 3.149e6); a decode's
# attention and SSM outputs are all-reduced over the model axis where they
# arise, so the MLP's weights and the head are no longer gathered (qwen3's
# decode all-gather 196,608 -> 53,248, reduce-scatter 35,584 -> 0);
# deepseek's experts sum their ff shards with a reduce-scatter onto the
# rows (3.355e7 in prefill).  The port's own bodies' collectives count too
# (`dryrun._INPLACE`): flash-decode's softmax statistics (13,824 all-reduce
# bytes of qwen3's decode), the MoE's gathers, and the SSD mixer's sum of
# squares for its gated norm where each rank runs its own heads
# (`ssm._gated_norm`: 192 bytes of the 16-head mamba2's decode, 3.146e6 of
# its training step, forward and backward).
# The repair of ROADMAP C.6 took out the all-gathers of a decode step's
# caches, which the dry run had placed by the reference's heuristic and the
# step read in its own layout: the SSM states of mamba2 and hymba, gathered
# to their rows (all-gather 277,888 -> 58,240 and 250,368 -> 91,648), and
# the 16-head deepseek's keys and values, resharded from their slots onto
# their heads (805,438,208 -> 107,264, its MoE's gathers alone; the
# reference's are 110,592 all-gather and 6,291,584 all-to-all bytes).  The
# 16-head mamba2's training step all-reduces out_proj's partial sums over
# the model axis, forward and backward (`sharding.constrain_cotangent`,
# 2 x 5.033e7), and reduce-scatters the gradient of in_proj's gathered
# output (7.471e6).
# The repair of ROADMAP C.7 puts in_proj's columns on the model axis in a
# decode step (`ssm._inner_cols`).  Where DTensor moves the step's rows onto
# the weight's `d` shards (the 5-head hymba), each rank now reduce-scatters
# its partial sums of its 42 columns onto its 8 rows, then gathers the
# columns (`ssm._rows`): reduce-scatter 44,352 -> 4,736 (4 layers x 672
# bytes, 8 rows of 42 bf16 columns, where all 661 took 4 x 10,576; the
# head's 2,048 unchanged) and all-gather 3,108,352 -> 3,151,360 (4 x 8 rows
# x 672 bf16 columns, 16 uneven shards of 42).  The rest of its
# all-gather bytes are DTensor's all-to-alls, which the fake process group
# runs as all-gathers: the step's rows moved onto the weights' `d` shards
# (in_proj's (128, 640), 655,360) and the model ranks' partial sums of the
# attention's, the SSM's and the MLP's outputs placed onto the rows (3 x
# 655,360); the other decode cells and both smoke SSM configs are unchanged.
# The repair of ROADMAP C.8 reduces each attention's output cotangent on the
# model axis (`sharding.constrain_rows`: qwen3's training all-reduce
# 185,077,736 -> 235,409,384, 3 layers of (16, 4096, 64) bf16 at the ring's
# 2x) and brings o's gradient from wo's H x hd shards back to its whole
# heads (all-gather 922,700,800 -> 947,842,048; reduce-scatter 3,149,152 ->
# 1,574,752).
COLLECTIVES = {
    ("qwen3-1.7b", "prefill_32k"): {
        "all-gather": (213927424, 255994880), "all-reduce": (117440512, 103183024128),
        "reduce-scatter": (512, 0), "collective-permute": (0, 11798528),
        "all-to-all": (0, 393216)},
    ("qwen3-1.7b", "decode_32k"): {
        "all-gather": (53248, 80896), "all-reduce": (28160, 67456),
        "collective-permute": (0, 1472), "all-to-all": (0, 368)},
    ("deepseek-moe-16b", "prefill_32k"): {
        "all-gather": (557863168, 335692288), "all-reduce": (117440768, 55767465984),
        "reduce-scatter": (33554944, 0), "collective-permute": (0, 15730944),
        "all-to-all": (0, 1572864)},
    ("deepseek-moe-16b", "decode_32k"): {
        "all-gather": (98048, 96768), "all-reduce": (28416, 591360),
        "reduce-scatter": (4096, 0), "collective-permute": (0, 2208), "all-to-all": (0, 512)},
    ("mamba2-370m", "decode_32k"): {  # all-gather 277,888 before C.6: the SSM states
        "all-gather": (58240, 72448), "all-reduce": (8192, 17344),
        "collective-permute": (0, 25088), "all-to-all": (0, 704)},
    ("hymba-1.5b", "decode_32k"): {  # all-gather 250,368 before C.6: the SSM states
        "all-gather": (91648, 139776), "all-reduce": (45056, 107776),
        "collective-permute": (0, 24736), "all-to-all": (0, 1216)},
    (MAMBA16, "decode_32k"): {  # the gated norm's sums of squares: 192 all-reduce bytes
        "all-gather": (58240, 72448), "all-reduce": (8384, 16576),
        "collective-permute": (0, 23840), "all-to-all": (0, 128)},
    (DEEPSEEK16, "decode_32k"): {  # all-gather 805,438,208 before C.6: the caches resharded
        "all-gather": (107264, 110592), "all-reduce": (14592, 565248),
        "reduce-scatter": (4096, 0), "collective-permute": (0, 288), "all-to-all": (0, 6291584)},
    (WHISPER60, "decode_32k"): {  # all-reduce 23,552 before C.9: the frames whole
        "all-gather": (51712, 560640), "all-reduce": (32768, 53760),
        "collective-permute": (0, 1312), "all-to-all": (0, 384)},
    (HYMBA5, "decode_32k"): {  # all-gather 3,108,352 and reduce-scatter 44,352 before C.7
        "all-gather": (3151360, 1468928), "all-reduce": (289280, 559872),
        "reduce-scatter": (4736, 0), "collective-permute": (0, 26016), "all-to-all": (0, 1280)},
    (MAMBA16, "train_4k"): {
        "all-gather": (928960768, 67227584), "all-reduce": (137913896, 339730240),
        "reduce-scatter": (7472776, 0), "collective-permute": (0, 256380928),
        "all-to-all": (0, 3833856)},
    TRAIN: {  # all-gather 922,700,800, all-reduce 185,077,736 before C.8
        "all-gather": (947842048, 808753536), "all-reduce": (235409384, 6834185600),
        "reduce-scatter": (1574752, 0), "collective-permute": (0, 19271680),
        "all-to-all": (0, 491520)},
    (DEEPSEEK16, "train_4k"): {
        "all-gather": (1665108480, 109257728), "all-reduce": (268963496, 5504497352),
        "reduce-scatter": (51907728, 0), "collective-permute": (0, 4864)},
    ("whisper-base", "train_4k"): {
        "all-gather": (995958784, 501235712), "all-reduce": (236984232, 172945184),
        "reduce-scatter": (2148608, 0), "collective-permute": (0, 22147072),
        "all-to-all": (0, 4206592)},
}

_CODE = r"""
import dataclasses, json, sys
sys.path.insert(0, {benchmarks!r})
from {pkg}.launch import dryrun
from {pkg} import configs
VARIANTS = {variants!r}

def get_config(arch):
    base, changes = VARIANTS.get(arch, (arch, {{}}))
    return dataclasses.replace(configs.get_smoke_config(base), **changes)

dryrun.get_config = get_config
{listing}
records = [dryrun.lower_cell(arch, shape, False) for arch, shape in {cells!r}]
{listed}
print(json.dumps(records))
"""

# the port's side also lists each cell's counted products by site: the
# function and source line of the innermost `repro_torch/models` frame
# (for a backward product, that of the forward op that made its autograd
# node), the output shape and the contraction's length, with their FLOPs,
# on the line before the records
_LISTING = r"""
import traceback, torch
from collections import defaultdict
torch.autograd.set_detect_anomaly(True, check_nan=False)  # a node keeps its forward's stack
LISTED, CELL = defaultdict(float), [None]

def _site():
    node = torch._C._current_autograd_node()
    if node is not None:
        frames = [f for f in node.metadata.get("traceback_", []) if "repro_torch/models" in f]
        if not frames:
            return "backward", "?", "?"
        head, _, code = frames[-1].strip().partition("\n")
        return "backward", head.rpartition(", in ")[2], code.strip()
    for fs in reversed(traceback.extract_stack()):
        if "repro_torch/models" in fs.filename:
            return "forward", fs.name, (fs.line or "").strip()
    return "forward", "?", "?"

_product, _lower = dryrun.LocalCounter._product, dryrun.lower_cell

def _listed(self, out, k):
    LISTED[(CELL[0],) + _site() + (tuple(out.shape), k)] += 2.0 * out.numel() * k
    return _product(self, out, k)

def _lower_listed(arch, shape, *args):
    CELL[0] = arch + " " + shape
    return _lower(arch, shape, *args)

dryrun.LocalCounter._product, dryrun.lower_cell = _listed, _lower_listed
"""


def _code(pkg: str) -> str:
    port = pkg == "repro_torch"
    return _CODE.format(pkg=pkg, cells=list(CELLS) + list(TRAINS), variants=VARIANTS,
                        benchmarks=os.path.join(REPO, "benchmarks"),
                        listing=_LISTING if port else "",
                        listed="print(json.dumps([list(k) + [v] for k, v in LISTED.items()]))"
                        if port else "")


def _port(args, timeout: int = 600) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=timeout)


@pytest.fixture(scope="module")
def records():
    # the port's side runs while the reference's does
    port_side = subprocess.Popen(
        [sys.executable, "-c", _code("repro_torch")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    try:
        ref = json.loads(run_with_devices(_code("repro"), n_devices=512, timeout=600)
                         .splitlines()[-1])
        stdout, stderr = port_side.communicate(timeout=600)
    finally:
        port_side.kill()
        port_side.wait()
    assert port_side.returncode == 0, stderr[-4000:]
    lines = stdout.splitlines()
    port = json.loads(lines[-1])
    products = defaultdict(list)  # (arch, shape) -> [(pass, function, line, shape, k, flops)]
    for cell, *site, shape, k, flops in json.loads(lines[-2]):
        products[tuple(cell.split())].append((*site, tuple(shape), k, flops))
    keys = list(CELLS) + list(TRAINS)
    return ({k: r for k, r in zip(keys, ref)}, {k: r for k, r in zip(keys, port)}, products)


def _same_outputs_and_collectives(ref, port, cell):
    assert port["memory"]["output_bytes"] + 8 * OUT_LEAVES[cell] == \
        ref["memory"]["output_bytes"] + ARG_PARTED.get(cell, 0)
    kinds = set(port["collectives"]) | set(ref["collectives"])
    got = {k: (port["collectives"].get(k, 0.0), ref["collectives"].get(k, 0.0)) for k in kinds}
    assert got == COLLECTIVES[cell]
    assert port["collective_bytes"] == sum(port["collectives"].values())


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_prefill_and_decode_cells_against_the_reference(records, cell):
    ref, port = records[0][cell], records[1][cell]
    assert port["status"] == ref["status"] == "ok"
    assert (port["arch"], port["shape"], port["mesh"], port["strategy"]) == \
        (ref["arch"], ref["shape"], ref["mesh"], ref["strategy"])
    assert port["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"] + ARG_PARTED.get(cell, 0) + UNREAD.get(cell, 0)
    ratio = port["flops"] / ref["flops"]
    if cell in PARTED:
        assert ratio == pytest.approx(PARTED[cell], rel=1e-9), ratio
        assert ratio <= PARTED_MOST.get(cell, ratio), ratio
    else:
        assert ratio == pytest.approx(1.0, rel=0.02), ratio
    _same_outputs_and_collectives(ref, port, cell)


def _training_cell(records, cell):
    ref, port = records[0][cell], records[1][cell]
    assert port["status"] == ref["status"] == "ok"
    ratio = port["flops"] / ref["flops"]
    if cell in TRAIN_PARTED:
        assert ratio == pytest.approx(TRAIN_PARTED[cell], rel=1e-9), ratio
        assert ratio <= TRAIN_MOST.get(cell, ratio), ratio
    else:
        assert ratio == pytest.approx(1.0, rel=0.02), ratio
    assert port["dot_bytes"] > 0
    # the step's inputs: parameters, AdamW's two bf16 moments and the step
    # count, and the packed batch; its outputs the same trees and the stats
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    _same_outputs_and_collectives(ref, port, cell)


def test_training_cell_traces(records):
    _training_cell(records, TRAIN)


def test_ssm_training_cell_runs_each_ranks_heads(records):
    """The 16-head mamba2 variant's training step, at most 1.10x the
    reference's per-device FLOPs (3.656x with every head on each model
    rank)."""
    _training_cell(records, (MAMBA16, "train_4k"))


@pytest.mark.parametrize("cell", TRAINS_C8, ids=[f"{a}-{s}" for a, s in TRAINS_C8])
def test_output_projections_train_on_rank_0s_share(records, cell):
    """ROADMAP C.8: the training cells whose output projections ran their
    backward at the whole H x hd and d_ff on every model rank, within 2% of
    the reference's per-device FLOPs or pinned in `TRAIN_PARTED`."""
    _training_cell(records, cell)


def _at(products, cell, pass_, function, code):
    """(output shape, contraction, FLOPs) of each product of `cell` whose
    site is `function` at a source line holding `code`; at least one."""
    got = [(shape, k, flops) for p, f, line, shape, k, flops in products[cell]
           if p == pass_ and f == function and code in line]
    assert got, (cell, pass_, function, code, sorted({(p, f, line) for p, f, line, *_
                                                     in products[cell]}))
    return got


def test_repaired_products_run_on_rank_0s_share(records):
    """The sites that ROADMAP C.5, C.7 and C.8 repaired, from the port's
    products listed by site: none runs at its cell's whole d_ff, expert ff,
    H x hd, vocabulary or batch on the 16x16 mesh, and each runs rank 0's
    share of its FLOPs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import SHAPES

    products, tp, dp = records[2], 16, 16
    qwen, ds = get_smoke_config("qwen3-1.7b"), get_smoke_config("deepseek-moe-16b")
    # training: both backward products of the MLP's down projection on the ff shard
    for shape, k, _ in _at(products, TRAIN, "backward", "glu_mlp", "@ wo"):
        dims = (*shape, k)
        assert qwen.d_ff not in dims and qwen.d_ff // tp in dims, (shape, k)
    # training: both backward products of each attention's output projection
    # on the rank's shard of H x hd (the head-parallel arm's heads, the
    # sequence-parallel arm's whole heads cut as wo's rows), and of
    # whisper's gelu MLP's w2 on the ff shard (ROADMAP C.8)
    for cell in (TRAIN,) + TRAINS_C8:
        cfg = _config(cell[0])
        for shape, k, _ in _at(products, cell, "backward", "_out_proj", "@ wo"):
            assert cfg.n_heads * cfg.head_dim // tp in (*shape, k), (cell, shape, k)
    whisper = _config("whisper-base")
    for shape, k, _ in _at(products, ("whisper-base", "train_4k"), "backward", "mlp_block",
                           '@ p[prefix + "w2"]'):
        dims = (*shape, k)
        assert whisper.d_ff not in dims and whisper.d_ff // tp in dims, (shape, k)
    for name in ("prefill_32k", "decode_32k"):
        cell = ("deepseek-moe-16b", name)
        tokens = SHAPES[name]["batch"] * (SHAPES[name]["seq"] if name == "prefill_32k" else 1)
        # the routed experts' three products on the ff shard of the data axis,
        # over the capacity segments of the global tokens
        for code in ("xs @ wg[e]", "xs @ wu[e]", "(a * hu) @ wo[e]"):
            for shape, k, _ in _at(products, cell, "forward", "_routed_local", code):
                dims = (*shape, k)
                assert ds.moe_d_ff not in dims and ds.moe_d_ff // dp in dims, (code, shape, k)
        # the router on rank 0's rows
        for shape, k, _ in _at(products, cell, "forward", "route", "@ router"):
            assert shape == (tokens // dp, ds.moe_experts) and k == ds.d_model, (shape, k)
    for cell in CELLS:
        cfg, B = _config(cell[0]), SHAPES[cell[1]]["batch"]
        vocab, D = cfg.vocab_padded, cfg.d_model
        [(shape, k, flops)] = _at(products, cell, "forward", "lm_head_logits", "h @ w")
        assert vocab not in (*shape, k) and flops == 2 * (B // dp) * (vocab // tp) * D, \
            (cell, shape, k)
        if cell[1] == "decode_32k":  # rank 0's rows, the vocab shard
            # (the 5-head hymba's head, its d of 640 sharded as in_proj's, runs
            # the whole batch at rank 0's d shard: DTensor moves the step's rows
            # onto the tied embedding's `d` shards, at the same FLOPs)
            rows, d = (B, D // dp) if cell == (HYMBA5, "decode_32k") else (B // dp, D)
            assert shape == (rows, vocab // tp) and k == d, (cell, shape, k)
    # whisper's cross-attention in a decode step, its two products on rank
    # 0's uneven shard of the encoder's frames (ROADMAP C.9): 4 of 60, never
    # all 60
    cfg, cell = _config(WHISPER60), (WHISPER60, "decode_32k")
    frames, share = cfg.encoder_seq, -(-cfg.encoder_seq // tp)
    got = _at(products, cell, "forward", "attend", "torch.einsum")
    assert all(frames not in (*shape, k) for shape, k, _ in got), got
    n = SHAPES["decode_32k"]["batch"] // dp * cfg.n_heads  # rank 0's rows x heads
    cross = [(shape, k) for shape, k, _ in got if share in (shape[-1], k)]
    assert sorted(cross) == sorted([((n, 1, cfg.head_dim), share),
                                    ((n, 1, share), cfg.head_dim)]), got
    # mamba2's in_proj on rank 0's rows of a decode step
    B = SHAPES["decode_32k"]["batch"]
    for shape, k, _ in _at(products, ("mamba2-370m", "decode_32k"), "forward",
                           "ssm_decode_step", '@ _inner_cols(p["in_proj"]'):
        assert shape[0] == B // dp, (shape, k)
    # every SSM and hybrid decode step's in_proj on rank 0's share (ROADMAP
    # C.7): its 1/tp of the columns, uneven shards of ceil(C / tp), of
    # either rank 0's rows at the whole d or the whole batch at its d shard
    # (where DTensor moves the step's rows onto the weight's); never every
    # column of the whole batch
    for cell in CELLS:
        cfg = _config(cell[0])
        if cell[1] != "decode_32k" or not cfg.ssm_heads:
            continue
        D, C = cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
        got = _at(products, cell, "forward", "ssm_decode_step", '@ _inner_cols(p["in_proj"]')
        for shape, k, _ in got:
            assert shape[-1] == -(-C // tp) and (shape[0], k) in ((B // dp, D), (B, D // dp)), \
                (cell, shape, k)
        assert sum(f for *_, f in got) == cfg.n_layers * 2 * (B // dp) * -(-C // tp) * D, cell


def test_ssd_products_run_on_the_ranks_heads(records):
    """ROADMAP C.5's remainder, from the port's products listed by site:
    with 16 SSM heads on the 16 model ranks, the SSD mixer runs rank 0's
    rows on its own head, forward and backward; with mamba2's 4 it runs
    every head (the whole-heads arm)."""
    from repro_torch.launch.specs import SHAPES

    products, tp, dp = records[2], 16, 16
    cfg = _config(MAMBA16)
    H, N, di, Q = cfg.ssm_heads, cfg.ssm_state, cfg.d_inner, cfg.ssm_chunk
    train, decode = (MAMBA16, "train_4k"), (MAMBA16, "decode_32k")
    rows = SHAPES["train_4k"]["batch"] // dp
    for pass_ in ("forward", "backward"):
        # the scan's products batched over rank 0's rows and its H/tp heads
        for code in ("y_intra =", "y_inter =", "s_new ="):
            for shape, k, _ in _at(products, train, pass_, "ssd_scan", code):
                assert shape[0] == rows * H // tp, (pass_, code, shape, k)
        # out_proj on the rank's channels (its rows of out_proj)
        for shape, k, _ in _at(products, train, pass_, "ssm_forward", '@ p["out_proj"]'):
            assert di not in (*shape, k) and di // tp in (*shape, k), (pass_, shape, k)
    # C . B has no head dim: whole on every rank (TRAIN_PARTED)
    for shape, k, _ in _at(products, train, "forward", "ssd_scan", "cb ="):
        assert shape == (rows, Q, Q) and k == N, (shape, k)
    rows = SHAPES["decode_32k"]["batch"] // dp
    # the decode step's conv on the rank's x channels, B and C; its readout
    # and out_proj on its head's channels
    [(shape, k, _)] = _at(products, decode, "forward", "_decode_mixer", '"bwc,wc->bc"')
    assert shape == (di // tp + 2 * N, rows, 1) and k == cfg.conv_width, (shape, k)
    [(shape, k, _)] = _at(products, decode, "forward", "_decode_mixer", '"bn,bhpn->bhp"')
    assert shape == (rows, 1, di // tp) and k == N, (shape, k)
    [(shape, k, _)] = _at(products, decode, "forward", "ssm_decode_step", '@ p["out_proj"]')
    assert shape == (rows, cfg.d_model) and k == di // tp, (shape, k)
    # 4 heads do not divide 16: every channel on each rank (PARTED)
    four = _config("mamba2-370m")
    [(shape, k, _)] = _at(products, ("mamba2-370m", "decode_32k"), "forward", "_decode_mixer",
                          '"bwc,wc->bc"')
    assert shape == (four.d_inner + 2 * four.ssm_state, rows, 1), (shape, k)


def test_records_keep_the_references_keys(records):
    """Every key of the reference's record; those with no torch counterpart
    hold None (module docstring)."""
    for cell in list(CELLS) + list(TRAINS):
        ref, port = records[0][cell], records[1][cell]
        assert set(port) == set(ref) and set(port["memory"]) == set(ref["memory"])
        assert port["compile_s"] is None and port["xla_flops_raw"] is None
        assert port["xla_bytes_raw"] is None
        assert port["memory"]["temp_bytes"] is None and port["memory"]["peak_bytes"] is None


def test_cli_skips_a_cell_and_exits_1_on_a_failed_one(tmp_path):
    out = tmp_path / "cells.json"
    proc = _port(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b", "--shape",
                  "long_500k", "--json", str(out)], timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    [rec] = json.loads(out.read_text())
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert "0 ok, 1 skipped, 0 failed" in proc.stdout
    proc = _port(["-m", "repro_torch.launch.dryrun", "--arch", "no-such-arch", "--shape",
                  "decode_32k"], timeout=120)
    assert proc.returncode == 1 and "0 ok, 0 skipped, 1 failed" in proc.stdout
