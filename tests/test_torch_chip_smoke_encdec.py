"""chip_smoke.py's enc-dec and VLM phase (phase E) rehearsed on the CPU with
plain kernels counted as launches.
"""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import pytest
import torch

import chip_smoke
from tests.test_torch_chip_smoke import on_cpu, plain_launches  # noqa: F401 (fixtures)

@pytest.fixture
def encdec_vlm_on_cpu(monkeypatch, on_cpu, plain_launches):
    """whisper's and llava's smoke configs at float32 in place of the full
    widths in bfloat16 (llava's 3 layers cut to 2 as the full one is cut),
    prompts of 24-48 tokens on 64-slot caches, 32-token checks, (d) at B 1 x
    24 and (e) at 2 x 32; the card's memory counters faked.  float32 for
    (b)'s bound, as in the families' rehearsal."""
    from repro_torch.configs import get_smoke_config

    monkeypatch.setattr(chip_smoke, "get_config",
                        lambda arch: dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    monkeypatch.setattr(chip_smoke, "EV_LAYERS", {"llava-next-34b": 2})
    monkeypatch.setattr(chip_smoke, "EV_DECODE_F32", {"llava-next-34b": 1})
    prompts = (24, 32, 40, 48)
    monkeypatch.setattr(chip_smoke, "EV_PROMPTS", dict.fromkeys(chip_smoke.EV_ARCHS, prompts))
    monkeypatch.setattr(chip_smoke, "EV_NEW_TOKENS", dict.fromkeys(chip_smoke.EV_ARCHS, 6))
    monkeypatch.setattr(chip_smoke, "EV_MAX_LEN", dict.fromkeys(chip_smoke.EV_ARCHS, 64))
    monkeypatch.setattr(chip_smoke, "EV_CHECK_AT", dict.fromkeys(chip_smoke.EV_ARCHS, 48))
    monkeypatch.setattr(chip_smoke, "EV_STEP_BATCH", dict.fromkeys(chip_smoke.EV_ARCHS, (1, 24)))
    monkeypatch.setattr(chip_smoke, "CHECK_LEN", 32)
    for name, n in (("EV_TRAIN_B", 2), ("EV_TRAIN_S", 32)):
        monkeypatch.setattr(chip_smoke, name, n)
    for name in ("reset_peak_memory_stats", "max_memory_allocated", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)


def test_encdec_vlm_phase_rehearsal(encdec_vlm_on_cpu, capsys):
    launches = chip_smoke.encdec_vlm_phase(0, device="cpu")
    out = capsys.readouterr().out
    for part in ("whisper-base [audio], uncut: segments [('enc', 2), ('decx', 2)]",
                 "llava-next-34b [vlm], cut from 3 to 2 layers",
                 "(a) 4096-token prompt packed at k=9", "with 48 random frames",
                 "'ck', 'cv', 'k', 'v'", "with random (1, 16, 64) vision embeddings the same "
                 "logits bit for bit", "second engine gives the same tokens",
                 "decode at 48 against the 49-token prefill (random frames)",
                 "the encoder alone over 48 frames", "decode_ms per tick", "idle_share=",
                 "beside 0.03125; by depth {1: ", "held in float32 at 1 layers below",
                 "(b) float32 at full width, 1 layers: decode at 48 against the 49-token",
                 "(c) 2 layers, float32, a 32-token prefill over 48 random frames",
                 "(d) 2 layers, float32, one step on 1 x 24 tokens with 48 random frames",
                 "(d) 2 layers, float32, one step on 1 x 24 tokens after 16 random vision",
                 "'enc_final_ln'", "'vis_proj'",
                 "(e) 4 AdamW steps in float32 on one batch of 2 x 32 tokens"):
        assert part in out, part
    # one bitunpack a model (its packed prefill), nothing else
    assert launches == dict(dict.fromkeys(chip_smoke.ops.KERNELS, 0), bitunpack=2)


def test_encdec_vlm_phase_stops_when_packed_prompts_differ(encdec_vlm_on_cpu, monkeypatch,
                                                           capsys):
    """A packed prompt that unpacks one off: the phase raises at whisper's
    (a) and prints nothing after its header."""
    unpack = chip_smoke.model.unpack_tokens
    monkeypatch.setattr(chip_smoke.model, "unpack_tokens", lambda *a: unpack(*a) + 1)
    with pytest.raises(AssertionError, match="whisper-base: the packed-prompt prefill differs"):
        chip_smoke.encdec_vlm_phase(0, device="cpu")
    out = capsys.readouterr().out
    assert "whisper-base [audio]" in out and "(a)" not in out and "llava" not in out


def test_encdec_vlm_phase_stops_when_prefill_reads_the_image(encdec_vlm_on_cpu, monkeypatch,
                                                             capsys):
    """A prefill that lets the vision embeddings move its logits: the phase
    raises at llava's (a), the reference's trait broken."""
    monkeypatch.setattr(chip_smoke, "EV_ARCHS", ("llava-next-34b",))
    prefill = chip_smoke.model.prefill

    def reads_image(params, batch, cfg, *a, **kw):
        logits, caches = prefill(params, batch, cfg, *a, **kw)
        return (logits + batch["embeds"].float().mean() if "embeds" in batch else logits), caches

    monkeypatch.setattr(chip_smoke.model, "prefill", reads_image)
    with pytest.raises(AssertionError, match="llava-next-34b: prefill read the vision"):
        chip_smoke.encdec_vlm_phase(0, device="cpu")
    assert "llava-next-34b [vlm]" in capsys.readouterr().out
