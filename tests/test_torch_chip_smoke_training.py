"""chip_smoke.py's training phase (phase T) rehearsed on the CPU with plain
kernels counted as launches: it passes every check, and it stops when the
engine mode's batches differ from the host mode's.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import pytest
import torch

import chip_smoke
from tests.test_torch_chip_smoke import on_cpu, plain_launches  # noqa: F401 (fixtures)

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
