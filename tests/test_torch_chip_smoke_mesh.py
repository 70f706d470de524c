"""chip_smoke.py's mesh phase (phase D: serving and training under a device
mesh) rehearsed on the CPU with plain kernels counted as launches: qwen3's
and deepseek's smoke configs at float32, 2 layers and 2 heads in place of the full
width, prompts of 24-48 tokens with 8 new each on 64-slot caches, the
launcher on the smoke config, training batches of 1 x 4,096 packed tokens
(2 steps each under the mesh and without it; a checkpoint at step 1,
resumed to 2), a 64 x 64 gradient for the
collectives; then (j)-(l) on mamba2's, hymba's, whisper's and llava's smoke
configs at float32 and 2 layers (hymba's first global, its second windowed
over 32 slots), prompts of 36-48 tokens (whisper's 16-40) on 64-slot
caches, and 2 training steps on 1 x 4,096 packed tokens (whisper 2 x 32
tokens over its 48 frames); a gloo process group of one rank on a HashStore in
place of NCCL.  It passes every check (on one rank the mesh serves and
trains bit for bit as no mesh does), launches bitunpack once for (b), once
for each of (j)'s packed prefills and once a packed training step in its
window, and destroys its process group, also when a check fails.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from tests.test_torch_chip_smoke import on_cpu, plain_launches  # noqa: F401 (fixtures)


@pytest.fixture
def mesh_on_cpu(monkeypatch, on_cpu, plain_launches):  # noqa: F811
    """The smoke configs at float32, 2 layers and 2 heads (the training
    parts run at the packed block's 4,096 tokens), on 2 torch threads so
    that parallel test workers do not oversubscribe the cores."""
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config", lambda arch: dataclasses.replace(
        get_smoke_config(arch), dtype="float32", n_layers=2, n_heads=2, n_kv=2))
    monkeypatch.setattr(chip_smoke, "LM_PROMPTS", (24, 32, 40, 48))
    monkeypatch.setattr(chip_smoke, "LM_MAX_LEN", 64)
    monkeypatch.setattr(chip_smoke, "MESH_NEW_TOKENS", 8)
    monkeypatch.setattr(chip_smoke, "SERVE_ARGS", chip_smoke.SERVE_ARGS + ["--smoke"])
    monkeypatch.setattr(chip_smoke, "MESH_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "MESH_RESUME_AT", 1)
    monkeypatch.setattr(chip_smoke, "MESH_RESUME_TO", 2)
    monkeypatch.setattr(chip_smoke, "PSUM_SHAPE", (64, 64))
    monkeypatch.setattr(chip_smoke, "card_line", lambda: CARD)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def families_on_cpu(monkeypatch, mesh_on_cpu):
    """(j)-(k): the four families' smoke configs at float32 and 2 layers,
    short prompts, whisper's batch cut to 2 x 32 and 2 training steps (the
    first timed, the second profiled).  The 4,096-token
    training steps cost most, so attention takes 2 heads over 1 KV head and
    the SSD chunks of 256 (mamba2's own): 16 a layer, not 256."""
    from repro_torch.configs import get_smoke_config

    def config(arch, n_layers=None):
        cfg = get_smoke_config(arch)
        heads = dict(n_heads=2, n_kv=1) if cfg.n_heads else {}
        return dataclasses.replace(cfg, dtype="float32", n_layers=2, ssm_chunk=256,
                                   global_layers=(0,) if cfg.global_layers else (), **heads)

    monkeypatch.setattr(chip_smoke, "family_config", config)
    monkeypatch.setattr(chip_smoke, "FAMILY_PROMPTS", (36, 40, 44, 48))
    monkeypatch.setattr(chip_smoke, "FAMILY_MAX_LEN", 64)
    monkeypatch.setattr(chip_smoke, "EV_PROMPTS", {"whisper-base": (16, 24, 32, 40)})
    monkeypatch.setattr(chip_smoke, "EV_MAX_LEN", {"whisper-base": 64})
    monkeypatch.setattr(chip_smoke, "EV_TRAIN_B", 2)
    monkeypatch.setattr(chip_smoke, "EV_TRAIN_S", 32)
    monkeypatch.setattr(chip_smoke, "MESH_TRAIN_STEPS", 2)


CARD = "a CPU rehearsal, no card"  # in place of nvidia-smi's name and power limit
# (b), then (e) 2 runs of MESH_STEPS + 1 steps, (f) 2 runs of one step, (h)
# 1 step saved, 1 resumed and 2 uninterrupted; (j) mamba2's, hymba's and
# llava's packed prefills, (k) their 2 runs of 2 packed steps
UNPACKS = 1 + 2 * 2 + 2 + 4 + 3 + 3 * 2 * 2


def test_mesh_phase_rehearsal(mesh_on_cpu, families_on_cpu, capsys):
    launches = chip_smoke.mesh_phase(0, device="cpu")
    out = capsys.readouterr().out
    for part in ("mesh {'data': 1, 'model': 1} over gloo, strategy tp",
                 "(a) 4 requests of [24, 32, 40, 48] tokens, 8 new each (32 tokens)",
                 "the same tokens under the mesh and without it",
                 "max |diff| 0.000e+00, relative L2 0.000e+00 (bit for bit",
                 "(a) mesh: prefill_ms (24 tokens, warm)", "(a) none: prefill_ms",
                 "idle_share=", "(b) 4096-token prompt packed at k=9 under the mesh: one "
                 "bitunpack launch", "(c) launch.serve --arch qwen3-1.7b --requests 16 --smoke: "
                 "16 requests, 256 tokens",
                 "(e) qwen3-smoke at full width, float32, remat, AdamW, B 1 x S 4096 packed at "
                 "k=9, 2 steps from seed 0 under the mesh and without it",
                 "parameter leaves after the steps bit for bit", "(e) mesh: step_ms (median of 1)",
                 "(e) none: step_ms", f"bitunpack launches [1, 1] [{CARD}]",
                 "(f) deepseek-moe-smoke cut to 2 of 28 layers (1 dense + 1 MoE of 8 experts, "
                 "top 3, 2 shared), float32", "bitunpack launches [1] / [1]; ",
                 "parameters bit for bit",
                 "(g) NCCL, a (pod 1, data 1) mesh, float32 (64, 64): hierarchical_psum equals x "
                 "bit for bit", "compressed_psum's int8 sum against numpy's max |diff| 0.000e+00",
                 "(h) 2 layers at full width, B 1 x S 4096, bfloat16 moments: train() under the "
                 "mesh saved step 1, "
                 "restored as DTensors placed by param_dims, bit for bit",
                 "(bit for bit; tolerance 0.001); bitunpack launches 4; ",
                 "(i) launch.train --arch qwen3-1.7b --mesh single: RuntimeError: mesh (16, 16) "
                 f"needs 256 ranks, found 1 in the process group [{CARD}]",
                 f"(d) process group destroyed; {UNPACKS} bitunpack launches"):
        assert part in out, part
    for arch, family in (("mamba2-370m", "ssm"), ("hymba-1.5b", "hybrid"),
                         ("whisper-base", "audio"), ("llava-next-34b", "vlm")):
        encdec = family == "audio"
        prompts = "[16, 24, 32, 40]" if encdec else "[36, 40, 44, 48]"
        assert (f"(j) {arch} at full width ({family}, float32): 4 requests of {prompts} tokens, "
                "8 new each (32 tokens), on 4 slots of 64 in ") in out, arch
        assert ("ticks: the same tokens and ticks under the mesh and without it; a "
                f"{40 if encdec else 4096}-token prefill") in out
        assert ("max |diff| 0.000e+00, relative L2 0.000e+00 (bit for bit; tolerance 0.001); "
                f"bitunpack launches {0 if encdec else 1} [{CARD}]") in out
        for label in ("mesh", "none"):
            assert f"(j) {arch} {label}: prefill_ms" in out
            assert f"(k) {arch} {label}: step_ms" in out and "(the first " in out
        batch = "B 2 x S 32 tokens over random frames" if encdec else "B 1 x S 4096 packed at k=9"
        assert (f"(k) {arch} at full width, float32, remat, AdamW, {batch}") in out
    assert "encoder_ms (1 x 48 frames, warm)" in out
    assert "packed at k=9 after 16 vision embeddings, 2 steps from seed 0" in out
    assert out.count("parameter leaves after the steps bit for bit") == 5  # (e) and (k)
    assert (f"(l) bitunpack launches in phase D's window: {UNPACKS}: (b) 1, (e), (f) and (h) "
            "one a step, (j) {'mamba2-370m': 1, 'hymba-1.5b': 1, 'whisper-base': 0, "
            "'llava-next-34b': 1}, (k) {'mamba2-370m': 4, 'hymba-1.5b': 4, 'whisper-base': 0, "
            f"'llava-next-34b': 4}} [{CARD}]") in out
    assert launches == dict(dict.fromkeys(chip_smoke.ops.KERNELS, 0), bitunpack=UNPACKS)
    assert not dist.is_initialized()


def test_mesh_phase_stops_when_the_mesh_engine_differs(mesh_on_cpu, monkeypatch, capsys):
    """An engine under the mesh whose tokens come back one off: the phase
    raises at (a)'s comparison, prints nothing after it, and still destroys
    its process group."""
    served = chip_smoke.served_on

    def off_by_one(params, cfg, ctx, reqs, device):
        run = served(params, cfg, ctx, reqs, device)
        if ctx is not None:
            run["tokens"] = {rid: [t + 1 for t in out] for rid, out in run["tokens"].items()}
        return run

    monkeypatch.setattr(chip_smoke, "served_on", off_by_one)
    with pytest.raises(AssertionError, match=r"\(a\) the engine under the mesh gave other tokens"):
        chip_smoke.mesh_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "(a)" not in out and "(b)" not in out
    assert not dist.is_initialized()


def test_mesh_phase_stops_when_a_familys_mesh_engine_differs(mesh_on_cpu, families_on_cpu,
                                                             monkeypatch, capsys):
    """hymba's engine under the mesh gives its tokens one off: the phase
    raises at (j)'s comparison for hymba, after mamba2's lines and before
    any of its own, and still destroys its process group.  (e)-(h), which
    the rehearsal above holds, return at once here."""
    served = chip_smoke.served_on
    monkeypatch.setattr(chip_smoke, "mesh_training", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "mesh_collectives", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "mesh_checkpoint", lambda *a: 0)

    def off_by_one(params, cfg, ctx, reqs, device, max_len=None):
        run = served(params, cfg, ctx, reqs, device, max_len)
        if ctx is not None and cfg.family == "hybrid":
            run["tokens"] = {rid: [t + 1 for t in out] for rid, out in run["tokens"].items()}
        return run

    monkeypatch.setattr(chip_smoke, "served_on", off_by_one)
    with pytest.raises(AssertionError, match=r"\(j\) hymba-1.5b: the engine under the mesh gave "
                       "other tokens"):
        chip_smoke.mesh_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "(j) mamba2-370m mesh: prefill_ms" in out
    assert "(j) hymba-1.5b" not in out and "(k)" not in out and "(l)" not in out
    assert not dist.is_initialized()


def test_same_runs_names_what_differs_and_holds_it_to_the_bound():
    """(e)/(f)'s comparison: equal runs are bit for bit; a leaf off by a
    rounding is named and held to MESH_STEP_REL; past it the phase fails."""
    def run(scale=1.0, loss=6.0):
        return {"metrics": [(loss, 1.0)], "names": ["embed", "final_ln"],
                "params": [torch.ones(4) * scale, torch.zeros(3)]}

    assert chip_smoke.same_runs(run(), run(), "(e)") == "bit for bit"
    verdict = chip_smoke.same_runs(run(1 + 1e-6), run(), "(e)")
    assert verdict.startswith("not bit for bit: losses relative 0.000e+00, parameters "
                              "relative L2 9.537e-07 (tolerance 0.001)")
    assert verdict.endswith("differing leaves ['embed']")
    with pytest.raises(AssertionError, match=r"\(e\) under the mesh against without it"):
        chip_smoke.same_runs(run(1.01), run(), "(e)")
    with pytest.raises(AssertionError, match=r"against \[\(6.0, 1.0\)\] \(relative 0.0099"):
        chip_smoke.same_runs(run(loss=6.06), run(), "(e)")
