"""The families' packed prompts and `forward_train` against the JAX package
(tests moved here from test_torch_models.py, whose helpers and tolerances
they share, so that parallel workers share the two files' time out): the
prompt packed at each family's own k ≡ its tokens bit for bit, and each
family's loss, aux loss and float32 gradients against the reference's.
"""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.lakeformat.encodings import bitpack_encode
from repro.models import model as jmodel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import model
from tests.test_torch_models import (
    BF16_ATOL,
    F32_ATOL,
    FAMILIES,
    GRAD_REL,
    _configs,
    _extra,
    _jbatch,
    _params,
    _t,
    _tbatch,
)


@pytest.mark.parametrize("arch", FAMILIES)
def test_packed_prompt_at_each_familys_k(arch):
    """The smoke config with the full config's vocabulary, so that the
    prompt packs at the family's own k (mamba2 16, hymba 15, deepseek 17,
    llama4 18, whisper 16, llava 16 bits): packed ≡ tokens bit for bit, the
    cross-attention's ck/cv included, one bitunpack."""
    cfg = dataclasses.replace(get_smoke_config(arch), vocab=get_config(arch).vocab)
    k = model.token_bits(cfg)
    assert k == {"mamba2-370m": 16, "hymba-1.5b": 15, "deepseek-moe-16b": 17,
                 "llama4-maverick-400b-a17b": 18, "whisper-base": 16,
                 "llava-next-34b": 16}[arch]
    params = model.init_params(cfg, 2, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (1, 4096)).astype(np.int64)
    extra = {k: _t(v).bfloat16() for k, v in _extra(cfg, rng, 1).items()}
    packed = np.stack([bitpack_encode(toks[0], k)])
    ops.reset_dispatch_count()
    l_packed, c_packed = model.prefill(params, {"packed": _t(packed.view(np.int32)), **extra},
                                       cfg)
    assert ops.dispatch_count() == 1
    l_tokens, c_tokens = model.prefill(params, {"tokens": _t(toks.astype(np.int32)), **extra},
                                       cfg)
    assert torch.equal(l_packed, l_tokens)
    for a, b in zip(c_packed, c_tokens):
        assert all(torch.equal(a[key], b[key]) for key in b)


# ---------------------------------------------------------------------------
# forward_train on the families
# ---------------------------------------------------------------------------


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_and_grads_against_reference(arch, dtype):
    """The loss with the MoE layers' aux loss added, the aux loss itself
    (float32 within 1e-7; bfloat16 within 1e-4, the float32 router reading
    activations that round apart), and at float32 every leaf's gradient
    (relative L2 per leaf)."""
    cj, ct = _configs(arch, dtype)
    pj, pt = _params(cj, 0)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cj.vocab, (2, 64)).astype(np.int32)
    extra = _extra(cj, rng, 2)

    def jloss(p):
        return jmodel.forward_train(p, _jbatch(toks, extra), cj)

    (lj, mj), gj = (jax.jit(jax.value_and_grad(jloss, has_aux=True))(pj) if dtype == "float32"
                    else (jax.jit(jloss)(pj), None))
    leaves = jax.tree_util.tree_leaves(pt)
    for leaf in leaves:
        leaf.requires_grad_(dtype == "float32")
    lt, mt = model.forward_train(pt, _tbatch(toks, extra), ct)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=atol, rtol=0)
    np.testing.assert_allclose(float(mt["aux_loss"].detach()), float(mj["aux_loss"]),
                               atol=1e-7 if dtype == "float32" else 1e-4, rtol=0)
    assert (float(mj["aux_loss"]) > 0) == bool(ct.moe_experts)
    if dtype == "float32":
        gt = torch.autograd.grad(lt, leaves)
        for got, want in zip(gt, jax.tree_util.tree_leaves(gj)):
            assert tuple(got.shape) == want.shape and got.dtype == torch.float32
            assert _rel(got.numpy(), want) <= GRAD_REL
