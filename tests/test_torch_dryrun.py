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
(`COLLECTIVES`) with the collectives that part them."""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import json
import os
import subprocess
import sys

import pytest

from tests.util import REPO, run_with_devices

CELLS = (("qwen3-1.7b", "prefill_32k"), ("qwen3-1.7b", "decode_32k"),
         ("deepseek-moe-16b", "prefill_32k"), ("deepseek-moe-16b", "decode_32k"),
         ("mamba2-370m", "decode_32k"), ("hymba-1.5b", "decode_32k"))
TRAIN = ("qwen3-1.7b", "train_4k")

# port flops / reference flops of the cells where the two part by more than
# 2% (ROADMAP C.5), and the products that part them:
#  - deepseek's routed experts (`moe._routed_local`): the port's (491520,
#    64) @ (64, 48) gate and up and (491520, 48) @ (48, 64) down run with
#    the expert's ff whole on rank 0, the reference's with it sharded over
#    the model axis, (491520, 64) @ (64, 3) and (3, 64); the router's
#    (1048576, 64) @ (64, 8) runs on the whole batch's rows;
#  - a decode's head (`layers.lm_head_logits`): the port's (128, 4) @ (4,
#    2048) on all 128 rows (the contraction's shard of a `Partial` input),
#    the reference's (8, 64) @ (64, 128) on rank 0's 8 rows and vocab
#    shard; mamba2's SSD in_proj likewise, (128, 4) @ (4, 292) against (8,
#    64) @ (64, 19).
# The attention products agree (2 x 5.154e10 in qwen3's and deepseek's
# prefill on both sides).
PARTED = {
    ("qwen3-1.7b", "decode_32k"): 15773696.0 / 12824576.0,
    ("deepseek-moe-16b", "prefill_32k"): 251138179072.0 / 114739412992.0,
    ("deepseek-moe-16b", "decode_32k"): 34977792.0 / 14011392.0,
    ("mamba2-370m", "decode_32k"): 2868224.0 / 222080.0,
}

# the training cell, parted by the backward of each MLP's down projection
# (`wo`): the gradient reaching it is `Partial` on the model axis, and
# DTensor runs both of its products at the whole d_ff of 128 on rank 0,
# (65536, 128) @ K 64 and (128, 64) @ K 65536, 2 x 3.221e9 over 3 layers,
# where the reference runs them at its 8-wide shard (ROADMAP C.5; 1.80x at
# full size)
TRAIN_PARTED = 53652750336.0 / 46103003136.0

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
#    and all-reduces the float32 scores, (2, 1, 2, 1024, 32768) a q chunk: 1.031e11 of qwen3's prefill all-reduce bytes, 5.154e10 of
#    deepseek's (with 4.027e9 of its routed experts' (491520, 64) output),
#    6.442e9 of the training step's (forward and backward); the port attends
#    each rank's q rows against the whole k and v with no collective;
#  - the reference's host devices move float32 where the port moves bf16
#    (the CPU compiler widens bf16 products and their collectives);
#  - only XLA issues `collective-permute` (slices such as the rotary
#    halves, the SSM's splits) and `all-to-all` (concatenations, gathers);
#    only DTensor `reduce-scatter` (the vocab-sharded head's logits);
#  - the port's largest all-gathers: the embedding made whole on D
#    (`embed_lookup`'s constrain, 1.342e8 in both prefills), deepseek's
#    tokens entering the experts (`_moe_ffn_mesh`, 2.684e8), the training
#    loss's float32 logits (`softmax_xent`, 5.367e8), and in decode the
#    SSM states placed as the step's rows (`ssm._placed_as_rows`) and the
#    MLP's weights.
COLLECTIVES = {
    ("qwen3-1.7b", "prefill_32k"): {
        "all-gather": (213927424, 255994880), "all-reduce": (117440512, 103183024128),
        "reduce-scatter": (512, 0), "collective-permute": (0, 11798528),
        "all-to-all": (0, 393216)},
    ("qwen3-1.7b", "decode_32k"): {
        "all-gather": (196608, 80896), "all-reduce": (90112, 67456),
        "reduce-scatter": (35584, 0), "collective-permute": (0, 1472), "all-to-all": (0, 368)},
    ("deepseek-moe-16b", "prefill_32k"): {
        "all-gather": (507826432, 335692288), "all-reduce": (117440512, 55767465984),
        "reduce-scatter": (512, 0), "collective-permute": (0, 15730944),
        "all-to-all": (0, 1572864)},
    ("deepseek-moe-16b", "decode_32k"): {
        "all-gather": (536320, 96768), "all-reduce": (73728, 591360),
        "reduce-scatter": (35520, 0), "collective-permute": (0, 2208), "all-to-all": (0, 512)},
    ("mamba2-370m", "decode_32k"): {
        "all-gather": (312448, 72448), "all-reduce": (45312, 17344),
        "reduce-scatter": (44160, 0), "collective-permute": (0, 25088), "all-to-all": (0, 704)},
    ("hymba-1.5b", "decode_32k"): {
        "all-gather": (250368, 139776), "all-reduce": (59392, 107776),
        "collective-permute": (0, 24736), "all-to-all": (0, 1216)},
    TRAIN: {
        "all-gather": (973081600, 808753536), "all-reduce": (134746088, 6834185600),
        "reduce-scatter": (11016544, 0), "collective-permute": (0, 19271680),
        "all-to-all": (0, 491520)},
}

_CODE = r"""
import json, sys
sys.path.insert(0, {benchmarks!r})
from {pkg}.launch import dryrun
from {pkg} import configs
dryrun.get_config = configs.get_smoke_config
print(json.dumps([dryrun.lower_cell(arch, shape, False) for arch, shape in {cells!r}]))
"""


def _code(pkg: str) -> str:
    return _CODE.format(pkg=pkg, cells=list(CELLS) + [TRAIN],
                        benchmarks=os.path.join(REPO, "benchmarks"))


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
    port = json.loads(proc.stdout.splitlines()[-1])
    keys = list(CELLS) + [TRAIN]
    return ({k: r for k, r in zip(keys, ref)}, {k: r for k, r in zip(keys, port)})


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
