"""The port's ServeEngine against `repro.serve.engine.ServeEngine` on the
granite smoke config at float32 (converted parameters, the requests of
tests/test_serve.py): the same tokens per request and the same number of
ticks; then drain semantics and greedy determinism as tests/test_serve.py
checks them, and the engine's device rules.  The same comparison on the
mamba2, hymba, deepseek-moe, llama4, whisper and llava smoke configs
(hymba's prompts and new tokens run its 32-slot rings past their wrap; both
engines serve whisper from frames of zeros and llava without reading an
image), and the batched cache that the first admission builds: the SSM's
float32 state and the rings spliced slot by slot, whisper's empty encoder
segment and its unpadded ck/cv."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.model import init_params as jinit_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models import model
from repro_torch.models.model import params_from_reference
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(scope="module")
def served():
    cfg_j = dataclasses.replace(jget_smoke("granite-3-8b"), dtype="float32")
    cfg_t = dataclasses.replace(get_smoke_config("granite-3-8b"), dtype="float32")
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(1))
    params_t = params_from_reference(jax.tree.map(np.asarray, params_j), device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    return [cls(rid=i, tokens=rng.integers(0, vocab, (8 + i,)), max_new_tokens=6)
            for i in range(5)]


def test_same_tokens_and_ticks_as_reference(served):
    cfg_j, cfg_t, params_j, params_t = served
    ref = JServeEngine(params_j, cfg_j, n_slots=3, max_len=96)
    port = ServeEngine(params_t, cfg_t, n_slots=3, max_len=96, device="cpu")
    for r in _requests(JRequest, cfg_j.vocab):
        ref.submit(r)
    for r in _requests(Request, cfg_t.vocab):
        port.submit(r)
    want = {r.rid: r.out for r in ref.run_until_drained()}
    got = {r.rid: r.out for r in port.run_until_drained()}
    assert got == want
    assert port.steps == ref.steps


def test_drains_all_requests(served):
    _, cfg, _, params = served
    eng = ServeEngine(params, cfg, n_slots=3, max_len=96, device="cpu")
    for r in _requests(Request, cfg.vocab):
        eng.submit(r)
    done = eng.run_until_drained()
    assert len(done) == 5
    assert all(len(r.out) == 6 for r in done)
    assert eng.steps <= 12  # slots overlap: fewer ticks than serial (30)


def test_greedy_is_deterministic(served):
    _, cfg, _, params = served
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (12,))
    outs = []
    for _ in range(2):
        eng = ServeEngine(params, cfg, n_slots=2, max_len=64, device="cpu")
        eng.submit(Request(rid=0, tokens=prompt, max_new_tokens=5))
        outs.append(eng.run_until_drained()[0].out)
    assert outs[0] == outs[1]


def test_shared_decode_position_follows_reference(served):
    """Two prompts of different lengths decode at ONE position, the longer
    one's (the reference's `max(slot_pos[active])`): the shorter slot's
    keys land past its prompt, yet both engines agree token for token."""
    cfg_j, cfg_t, params_j, params_t = served
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg_j.vocab, (n,)) for n in (5, 17)]
    outs = []
    for eng, req in ((JServeEngine(params_j, cfg_j, n_slots=2, max_len=40), JRequest),
                     (ServeEngine(params_t, cfg_t, n_slots=2, max_len=40, device="cpu"), Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, tokens=p, max_new_tokens=8))
        outs.append({r.rid: r.out for r in eng.run_until_drained()})
    assert outs[0] == outs[1]


def test_engine_device_rules(served):
    _, cfg, _, params = served
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ServeEngine(params, cfg, device="cuda")
    meta = {**params, "embed": params["embed"].to("meta")}
    with pytest.raises(RuntimeError, match="parameters lie on meta"):
        ServeEngine(meta, cfg, device="cpu")


FAMILIES = ["mamba2-370m", "hymba-1.5b", "deepseek-moe-16b", "llama4-maverick-400b-a17b",
            "whisper-base", "llava-next-34b"]


def _family(arch, dtype="float32"):
    cfg_j = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    cfg_t = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params_j = jinit_params(cfg_j, jax.random.PRNGKey(1))
    return cfg_j, cfg_t, params_j, params_from_reference(jax.tree.map(np.asarray, params_j),
                                                         device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_same_tokens_and_ticks_as_reference(arch):
    """Five requests of 20-44 tokens, 12 new tokens each, on 3 slots of 96:
    token for token and tick for tick the JAX engine's."""
    cfg_j, cfg_t, params_j, params_t = _family(arch)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg_j.vocab, (20 + 6 * i,)) for i in range(5)]
    ref = JServeEngine(params_j, cfg_j, n_slots=3, max_len=96)
    port = ServeEngine(params_t, cfg_t, n_slots=3, max_len=96, device="cpu")
    for eng, req in ((ref, JRequest), (port, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, tokens=p, max_new_tokens=12))
    want = {r.rid: r.out for r in ref.run_until_drained()}
    got = {r.rid: r.out for r in port.run_until_drained()}
    assert got == want and len(got) == 5
    assert port.steps == ref.steps


def test_batched_cache_keeps_each_leafs_dtype_and_ring():
    """hymba smoke in bfloat16: the first admission's cache defines the
    batched one, whose SSM state stays float32 and whose windowed segments
    hold `window`-slot rings; each admission writes its own slot with the
    single prefill's cache and leaves the others."""
    _, cfg, _, params = _family("hymba-1.5b", "bfloat16")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in (40, 9)]
    eng = ServeEngine(params, cfg, n_slots=3, max_len=64, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=4))
    eng._admit()
    segs = model.model_segments(cfg)
    for seg, c in zip(segs, eng.caches):
        assert c["state"].dtype == torch.float32 and c["k"].dtype == torch.bfloat16
        assert c["k"].shape[:3] == (seg.count, 3, seg.window or 64)
    for slot, p in enumerate(prompts):
        _, one = model.prefill(params, {"tokens": torch.from_numpy(p.astype(np.int32))[None]},
                               cfg, cache_len=64)
        for b, s in zip(eng.caches, one):
            assert all(torch.equal(b[k][:, slot:slot + 1], s[k]) for k in s)
    assert all(not c[k][:, 2].any() for c in eng.caches for k in c)  # slot 2 never admitted


def test_encdec_batched_cache_and_the_zero_frames(monkeypatch):
    """whisper smoke in bfloat16: the batched cache keeps the encoder
    segment's `{}` and the decoder's ck/cv at the encoder's 48 frames (not
    padded to max_len); every admission's prefill sees 48 frames of zeros in
    bfloat16 on the engine's device, and llava's sees 16 vision embeddings
    of zeros, as the reference's engine builds them."""
    seen = []
    prefill = engine_mod.prefill

    def spy(p, batch, c, *a, **kw):
        seen.append({k: (tuple(v.shape), v.dtype, v.device.type, bool(v.any()))
                     for k, v in batch.items() if k != "tokens"})
        return prefill(p, batch, c, *a, **kw)

    monkeypatch.setattr(engine_mod, "prefill", spy)
    rng = np.random.default_rng(13)
    _, cfg, _, params = _family("whisper-base", "bfloat16")
    eng = ServeEngine(params, cfg, n_slots=2, max_len=64, device="cpu")
    for i, n in enumerate((12, 30)):
        eng.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab, (n,)), max_new_tokens=3))
    eng._admit()
    _, cfg_l, _, params_l = _family("llava-next-34b", "bfloat16")
    vlm = ServeEngine(params_l, cfg_l, n_slots=1, max_len=32, device="cpu")
    vlm.submit(Request(rid=0, tokens=rng.integers(0, cfg_l.vocab, (9,)), max_new_tokens=2))
    vlm._admit()
    frames = ((1, cfg.encoder_seq, cfg.d_model), torch.bfloat16, "cpu", False)
    assert seen == [{"enc_embeds": frames}] * 2 + [
        {"embeds": ((1, cfg_l.vision_tokens, cfg_l.d_model), torch.bfloat16, "cpu", False)}]
    assert eng.caches[0] == {}
    c = eng.caches[1]
    assert c["k"].shape[:3] == (cfg.n_layers, 2, 64)
    assert c["ck"].shape[:3] == (cfg.n_layers, 2, cfg.encoder_seq)
    assert len(eng.run_until_drained()) == 2 and eng.caches[0] == {}


def test_argmax_over_the_padded_vocabulary_as_the_reference():
    """A trait of the reference that the port follows: the engine takes the
    argmax over all vocab_padded logits: nothing keeps it off the padded
    columns of the head, which init draws as it draws the real ones.  qwen3
    smoke (512 ids padded to 2,048, the head tied to the embedding) with the
    padded rows, which no token < vocab looks up, scaled by 100 on both
    sides: both engines hand out the same ids >= vocab."""
    cfg_j, cfg_t, params_j, params_t = _family("qwen3-1.7b")
    assert cfg_t.tie_embeddings
    params_j = {**params_j, "embed": params_j["embed"].at[cfg_j.vocab:].multiply(100.0)}
    params_t["embed"][cfg_t.vocab:] *= 100.0
    outs = []
    for eng, req in ((JServeEngine(params_j, cfg_j, n_slots=3, max_len=96), JRequest),
                     (ServeEngine(params_t, cfg_t, n_slots=3, max_len=96, device="cpu"), Request)):
        for r in _requests(req, cfg_j.vocab):
            eng.submit(r)
        outs.append({r.rid: r.out for r in eng.run_until_drained()})
    assert outs[0] == outs[1]
    ids = [t for o in outs[1].values() for t in o]
    assert max(ids) >= cfg_t.vocab and max(ids) < cfg_t.vocab_padded
