"""The port's training data path (`repro_torch.data`) against the JAX
package's: `write_corpus` files byte-identical, and in each of the `host`,
`engine` (quality >= 40) and `fused` modes the same batches, batch for
batch, with equal `stats` and `checkpoint_state()`; then
`tests/test_pipeline.py`'s four cases on the port.

Every comparison is exact: tokens are integers, and the packed words are
the file's own bits.
"""

import filecmp

import numpy as np
import pytest
import torch

from repro.data.corpus import write_corpus as jwrite_corpus
from repro.data.pipeline import TokenPipeline as JPipeline
from repro_torch.configs import get_smoke_config
from repro_torch.core.engine import DatapathEngine
from repro_torch.data.corpus import write_corpus
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models.model import unpack_tokens

CORPUS = dict(n_tokens=200_000, vocab=512, n_shards=2, row_group_size=32768)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("corpus")), **CORPUS)


def _pipe(paths, *a, **kw):
    return TokenPipeline(paths, *a, device="cpu", **kw)


def test_write_corpus_byte_identical_to_the_reference(tmp_path, corpus):
    want = jwrite_corpus(str(tmp_path / "ref"), **CORPUS)
    assert len(want) == len(corpus) == 2
    for a, b in zip(corpus, want):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


@pytest.mark.parametrize("mode,quality,B,S,n", [
    ("host", 40, 4, 4096, 6),
    ("engine", 40, 4, 4096, 6),
    ("host", None, 2, 8192, 8),
    ("engine", None, 2, 8192, 8),
    ("fused", None, 4, 8192, 8),
    ("fused", 40, 4, 8192, 8),
])
def test_batches_stats_and_cursor_equal_the_reference(corpus, mode, quality, B, S, n):
    """n batches that reach the second shard (fused: the next epoch; a shard
    is 25 blocks)."""
    mine = _pipe(corpus, B, S, mode=mode, quality_min=quality)
    ref = JPipeline(corpus, B, S, mode=mode, quality_min=quality)
    key = "packed" if mode == "fused" else "tokens"
    for i in range(n):
        got, want = mine.next_batch(), ref.next_batch()
        assert set(got) == {key}
        assert got[key].device.type == "cpu" and got[key].dtype == torch.int32
        w = np.asarray(want[key])
        if mode == "fused":
            w = w.view(np.int32)
        assert np.array_equal(got[key].numpy(), w), (mode, i)
        assert mine.stats == ref.stats, (mode, i)
        assert mine.checkpoint_state() == ref.checkpoint_state(), (mode, i)
    assert mine.state.shard == 1 or mine.state.epoch > 0


def test_engine_mode_runs_the_kernels_on_the_engine(corpus, monkeypatch):
    """engine mode with a threshold: a compact=True plan, decoded by
    bitunpack (token) and rle_decode (quality) and compacted by
    filter_compact, each through the engine's ops dispatch."""
    calls = []
    for name in ("bitunpack", "rle_decode", "filter_compact"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                            _r(*a, **k))[1])
    pipe = _pipe(corpus, 1, 256, mode="engine", quality_min=40)
    pipe.next_batch()
    assert {"bitunpack", "rle_decode", "filter_compact"} <= set(calls), calls
    assert pipe.stats["host_bytes_decoded"] == 0


def test_default_engine_and_device(corpus, monkeypatch):
    pipe = _pipe(corpus, 1, 64, mode="engine")
    assert pipe.engine.device == torch.device("cpu") and pipe.engine.offload == "preloaded"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="engine runs on"):
        TokenPipeline(corpus, 1, 64, engine=DatapathEngine(device="cpu"), device="cuda")
    with pytest.raises(ValueError, match="unknown mode"):
        _pipe(corpus, 1, 64, mode="disk")


def test_the_card_is_the_default(corpus, monkeypatch):
    """TokenPipeline runs on the card unless asked for the CPU: without one
    it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TokenPipeline(corpus, 1, 64, mode="host")


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's cases, on the port
# ---------------------------------------------------------------------------


def test_host_engine_parity(corpus):
    a = _pipe(corpus, 4, 512, mode="host", quality_min=40)
    b = _pipe(corpus, 4, 512, mode="engine", quality_min=40)
    for _ in range(3):
        assert torch.equal(a.next_batch()["tokens"], b.next_batch()["tokens"])
    assert b.stats["host_bytes_decoded"] == 0  # engine mode: zero host decode
    assert a.stats["host_bytes_decoded"] > 0


def test_fused_blocks_decode_to_same_tokens(corpus):
    cfg = get_smoke_config("qwen3-1.7b")
    f = _pipe(corpus, 2, 4096, mode="fused")  # no filter: block-exact
    h = _pipe(corpus, 2, 4096, mode="host")
    toks = unpack_tokens(f.next_batch()["packed"], 4096, cfg)
    assert torch.equal(toks, h.next_batch()["tokens"])
    # DMA accounting is row-group granular: 9-bit packing (vocab 512)
    # carries ~9/32 of the plain bytes for the touched row group
    assert f.stats["dma_bytes"] <= 0.35 * 32768 * 4


def test_determinism_and_resume(corpus):
    a = _pipe(corpus, 2, 256, mode="host")
    for _ in range(4):
        a.next_batch()
    state = a.checkpoint_state()
    nxt = a.next_batch()["tokens"]

    b = _pipe(corpus, 2, 256, mode="host")
    for _ in range(4):
        b.next_batch()
    assert b.checkpoint_state() == state

    c = _pipe(corpus, 2, 256, mode="host")
    c.restore_state(state)
    # the pool remainder is not checkpointed; resume restarts at the
    # cursor's row group — the guarantee is no token is ever skipped
    assert c.next_batch()["tokens"].shape == nxt.shape


def test_quality_pushdown_filters(corpus):
    hi = _pipe(corpus, 2, 1024, mode="host", quality_min=95)
    lo = _pipe(corpus, 2, 1024, mode="host", quality_min=None)
    hi.next_batch(), lo.next_batch()
    # a strict filter consumes more row groups for the same token count
    assert hi.state.row_group + hi.state.shard * 100 >= lo.state.row_group
