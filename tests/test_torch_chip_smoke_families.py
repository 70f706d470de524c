"""chip_smoke.py's families phase (phase M: the MoE, SSM and hybrid
families) rehearsed on the CPU with plain kernels counted as launches.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import chip_smoke
from tests.test_torch_chip_smoke import on_cpu, plain_launches  # noqa: F401 (fixtures)

@pytest.fixture
def families_on_cpu(monkeypatch, on_cpu, plain_launches):
    """The families' smoke configs at float32 in place of the full widths in
    bfloat16 (llama4's 4 layers cut to 2 as the full one is), prompts of 40-64
    tokens on 96-slot caches (hymba's windows of 32 wrap); the card's memory
    counters faked.  float32, since (b)'s bf16 bound is the full widths': at
    d_model 64 the logits are ~0.1 and bf16 decode and prefill differ by
    relative L2 0.03-0.15 (deepseek and llama4 smoke)."""
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config",
                        lambda arch: dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    monkeypatch.setattr(chip_smoke, "FAMILY_PROMPTS", (40, 48, 56, 64))
    monkeypatch.setattr(chip_smoke, "FAMILY_MAX_LEN", 96)
    monkeypatch.setattr(chip_smoke, "CHECK_LEN", 32)
    for name in ("reset_peak_memory_stats", "max_memory_allocated", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)


def test_families_phase_rehearsal(families_on_cpu, capsys):
    launches = chip_smoke.families_phase(0, device="cpu")
    out = capsys.readouterr().out
    for arch in chip_smoke.FAMILY_ARCHS:
        assert f"      {arch} [" in out, arch
    for part in ("[hybrid], uncut", "llama4-maverick-400b [moe], cut from 4 to 2 layers",
                 "(a) 4096-token prompt packed at k=9", "second engine gives the same tokens",
                 "decode_ms per tick", "idle_share=", "(c) 2 layers, float32",
                 "in float32 drawn from seed 0",
                 "(c) 2 layers, 8 experts, float32", "routing ids equal in 9 MoE calls",
                 "at the model's capacity 1.25: relative L2",
                 "with every entry within capacity (moe_capacity E): relative L2",
                 "on the card, decode at 32 against the 33-token prefill"):
        assert part in out, part
    # one bitunpack a family (its packed prefill), nothing else
    assert launches == dict(dict.fromkeys(chip_smoke.ops.KERNELS, 0), bitunpack=4)


def test_families_phase_holds_decode_in_float32_where_bf16_tips_the_router(
        families_on_cpu, monkeypatch, capsys):
    """Where (b)'s decode routes the last token to other experts than the
    prefill, the phase holds decode ≡ prefill in float32 at full width."""
    monkeypatch.setattr(chip_smoke, "FAMILY_ARCHS", ("deepseek-moe-16b",))
    seen = []

    def tipped(params, cfg, seq):
        got = against(params, cfg, seq)
        seen.append((cfg.dtype, cfg.moe_capacity))
        return dict(got, flipped=1) if len(seen) == 1 else got

    against = chip_smoke.decode_against_prefill
    monkeypatch.setattr(chip_smoke, "decode_against_prefill", tipped)
    chip_smoke.families_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "where the decode routes as the prefill" in out
    assert "(b) float32 at full width, every entry within capacity: decode at 40" in out
    assert seen[:3] == [("float32", 8.0), ("float32", 1.25), ("float32", 8.0)]


def test_family_config_cuts_hymba_to_a_global_and_a_windowed_layer():
    real = chip_smoke.get_config
    assert chip_smoke.family_config("mamba2-370m") == real("mamba2-370m")
    assert chip_smoke.family_config("llama4-maverick-400b").n_layers == 2
    cut = chip_smoke.family_config("hymba-1.5b", 2)
    segs = chip_smoke.model.model_segments(cut)
    assert [(s.count, s.window) for s in segs] == [(1, None), (1, cut.window)]


def test_families_phase_stops_when_packed_prompts_differ(families_on_cpu, monkeypatch, capsys):
    """A packed prompt that unpacks one off: the phase raises at the first
    family's (a) and prints nothing after its header."""
    unpack = chip_smoke.model.unpack_tokens
    monkeypatch.setattr(chip_smoke.model, "unpack_tokens", lambda *a: unpack(*a) + 1)
    with pytest.raises(AssertionError, match="mamba2-370m: the packed-prompt prefill differs"):
        chip_smoke.families_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "mamba2-370m [ssm]" in out and "(a)" not in out and "hymba" not in out
