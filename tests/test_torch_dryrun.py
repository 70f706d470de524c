"""The port's dry run (`launch/dryrun.py`) against the reference's, on smoke
configs on the 16x16 mesh.  Each side runs in a subprocess of its own (the
reference on 512 placeholder host devices, the port as rank 0 of torch's
`fake` process group), with `get_config` patched to `get_smoke_config`.

Prefill and decode: the same status, `memory.argument_bytes` equal, and
per-device `flops` within 2% of the reference's trip-aware count, or the
ratio pinned in `PARTED` with the products that part them (ROADMAP C.5).
Training: status ok and the FLOPs ratio pinned (`TRAIN_PARTED`).  Every
cell: `memory.output_bytes` equal but for XLA's output tuple table
(`OUT_LEAVES`), and the collective bytes by kind pinned on both sides
(`COLLECTIVES`) with the collectives that part them.  The port's products,
listed by site in its subprocess (`_LISTING`), show that the sites C.5
repaired run on rank 0's share."""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import json
import os
import subprocess
import sys
from collections import defaultdict

import pytest

from tests.util import REPO, run_with_devices

CELLS = (("qwen3-1.7b", "prefill_32k"), ("qwen3-1.7b", "decode_32k"),
         ("deepseek-moe-16b", "prefill_32k"), ("deepseek-moe-16b", "decode_32k"),
         ("mamba2-370m", "decode_32k"), ("hymba-1.5b", "decode_32k"))
TRAIN = ("qwen3-1.7b", "train_4k")

# port flops / reference flops of the cells where the two part by more than
# 2% (ROADMAP C.5), and the products that part them.  mamba2's decode step
# runs its SSD mixer (`ssm._decode_mixer`) on each rank's 8 batch rows with
# every head and channel, on all 16 model ranks alike: the readout (8, 1,
# 128) @ K 16 and the depthwise conv (160, 8, 1) @ K 4, 129,024 FLOPs over
# 3 layers where the reference, `inner` sharded over the model axis, counts
# 8,064.  That layout is the port's (DTensor cannot reshard in_proj's output
# across the `inner` shards; ROADMAP C); the rest of the cell agrees: the
# head (8, 64) @ (64, 128), in_proj (8, 64) @ (64, 19) and out_proj.
PARTED = {
    ("mamba2-370m", "decode_32k"): 343040.0 / 222080.0,
}

# the training cell, parted by the backward of each attention's output
# projection (`transformer._out_proj`): the smoke config's 4 heads do not
# divide the 16 model ranks, and both of its products run at the whole
# H x hd of 64, (65536, 64) @ K 64 and (64, 64) @ K 65536, 2 x 1.611e9 over
# 3 layers; the reference runs its own q and o products whole in places
# (ROADMAP C.5).  The MLP's down projection runs its backward on the rank's
# ff shard of 8 (`test_repaired_products_run_on_rank_0s_share`).
TRAIN_PARTED = 47612952576.0 / 46103003136.0

# XLA's `output_size_in_bytes` counts the output tuple's table, 8 bytes a
# leaf, besides the leaves themselves: the logits and the stacked caches
# (k, v; deepseek's dense and MoE segments each; hymba's k, v, conv and
# state of each segment, and its ring), or the step's parameters, moments,
# step count and stats
OUT_LEAVES = {
    ("qwen3-1.7b", "prefill_32k"): 3, ("qwen3-1.7b", "decode_32k"): 3,
    ("deepseek-moe-16b", "prefill_32k"): 5, ("deepseek-moe-16b", "decode_32k"): 5,
    ("mamba2-370m", "decode_32k"): 3, ("hymba-1.5b", "decode_32k"): 13,
    TRAIN: 43,
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
#    gates), the training loss's float32 logits (`softmax_xent`, 5.367e8),
#    and in decode the SSM states placed as the step's rows
#    (`ssm._placed_as_rows`).
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
# bytes of qwen3's decode) and the MoE's gathers.
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
    ("mamba2-370m", "decode_32k"): {
        "all-gather": (277888, 72448), "all-reduce": (8192, 17344),
        "collective-permute": (0, 25088), "all-to-all": (0, 704)},
    ("hymba-1.5b", "decode_32k"): {
        "all-gather": (250368, 139776), "all-reduce": (45056, 107776),
        "collective-permute": (0, 24736), "all-to-all": (0, 1216)},
    TRAIN: {
        "all-gather": (922700800, 808753536), "all-reduce": (185077736, 6834185600),
        "reduce-scatter": (3149152, 0), "collective-permute": (0, 19271680),
        "all-to-all": (0, 491520)},
}

_CODE = r"""
import json, sys
sys.path.insert(0, {benchmarks!r})
from {pkg}.launch import dryrun
from {pkg} import configs
dryrun.get_config = configs.get_smoke_config
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
    return _CODE.format(pkg=pkg, cells=list(CELLS) + [TRAIN],
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
    ref = json.loads(run_with_devices(_code("repro"), n_devices=512, timeout=600)
                     .splitlines()[-1])
    proc = _port(["-c", _code("repro_torch")])
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    port = json.loads(lines[-1])
    products = defaultdict(list)  # (arch, shape) -> [(pass, function, line, shape, k, flops)]
    for cell, *site, shape, k, flops in json.loads(lines[-2]):
        products[tuple(cell.split())].append((*site, tuple(shape), k, flops))
    keys = list(CELLS) + [TRAIN]
    return ({k: r for k, r in zip(keys, ref)}, {k: r for k, r in zip(keys, port)}, products)


def _same_outputs_and_collectives(ref, port, cell):
    assert port["memory"]["output_bytes"] + 8 * OUT_LEAVES[cell] == \
        ref["memory"]["output_bytes"]
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
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    ratio = port["flops"] / ref["flops"]
    if cell in PARTED:
        assert ratio == pytest.approx(PARTED[cell], rel=1e-9), ratio
    else:
        assert ratio == pytest.approx(1.0, rel=0.02), ratio
    _same_outputs_and_collectives(ref, port, cell)


def test_training_cell_traces(records):
    ref, port = records[0][TRAIN], records[1][TRAIN]
    assert port["status"] == ref["status"] == "ok"
    assert port["flops"] / ref["flops"] == pytest.approx(TRAIN_PARTED, rel=1e-9)
    assert port["dot_bytes"] > 0
    # the step's inputs: parameters, AdamW's two bf16 moments and the step
    # count, and the packed batch; its outputs the same trees and the stats
    assert port["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"]
    _same_outputs_and_collectives(ref, port, TRAIN)


def _at(products, cell, pass_, function, code):
    """(output shape, contraction, FLOPs) of each product of `cell` whose
    site is `function` at a source line holding `code`; at least one."""
    got = [(shape, k, flops) for p, f, line, shape, k, flops in products[cell]
           if p == pass_ and f == function and code in line]
    assert got, (cell, pass_, function, code, sorted({(p, f, line) for p, f, line, *_
                                                     in products[cell]}))
    return got


def test_repaired_products_run_on_rank_0s_share(records):
    """The sites that ROADMAP C.5 repaired, from the port's products listed
    by site: none runs at its cell's whole d_ff, expert ff, vocabulary or
    batch on the 16x16 mesh, and each runs rank 0's share of its FLOPs."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.specs import SHAPES

    products, tp, dp = records[2], 16, 16
    qwen, ds = get_smoke_config("qwen3-1.7b"), get_smoke_config("deepseek-moe-16b")
    # training: both backward products of the MLP's down projection on the ff shard
    for shape, k, _ in _at(products, TRAIN, "backward", "glu_mlp", "@ wo"):
        dims = (*shape, k)
        assert qwen.d_ff not in dims and qwen.d_ff // tp in dims, (shape, k)
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
        cfg, B = get_smoke_config(cell[0]), SHAPES[cell[1]]["batch"]
        vocab, D = cfg.vocab_padded, cfg.d_model
        [(shape, k, flops)] = _at(products, cell, "forward", "lm_head_logits", "h @ w")
        assert vocab not in (*shape, k) and flops == 2 * (B // dp) * (vocab // tp) * D, \
            (cell, shape, k)
        if cell[1] == "decode_32k":  # rank 0's rows, the vocab shard
            assert shape == (B // dp, vocab // tp) and k == D, (cell, shape, k)
    # mamba2's in_proj on rank 0's rows of a decode step
    B = SHAPES["decode_32k"]["batch"]
    for shape, k, _ in _at(products, ("mamba2-370m", "decode_32k"), "forward",
                           "ssm_decode_step", '@ p["in_proj"]'):
        assert shape[0] == B // dp, (shape, k)


def test_records_keep_the_references_keys(records):
    """Every key of the reference's record; those with no torch counterpart
    hold None (module docstring)."""
    for cell in list(CELLS) + [TRAIN]:
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
