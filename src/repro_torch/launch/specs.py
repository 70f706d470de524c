"""Stand-ins for every (arch x shape) cell: tensors with no storage.

Port of `repro/launch/specs.py`.  The four assigned shapes:

    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill
    decode_32k   seq 32,768  global_batch 128   -> decode_step (1 token, KV=32k)
    long_500k    seq 524,288 global_batch 1     -> decode_step (sub-quadratic only)

Train/prefill token inputs are BIT-PACKED (the datapath feature is on in
production), at k = ceil(log2 vocab) bits in 4096-token blocks, as the
port's int32 views of the reference's uint32 words.  Frontend stubs
([audio]/[vlm]) are precomputed embedding specs.

A stand-in is a fake tensor (`torch._subclasses.fake_tensor.FakeTensor`):
shape, dtype and device, and no storage, so nothing here allocates.  All
of them belong to one `FakeTensorMode`: the one active when a function here
is called (the dry run's), else this module's own (`fake_mode()`).  Under a
mesh a stand-in is a DTensor with `sharding.sharding_for`'s placements, its
local tensor rank's fake shard (the reference's `ShapeDtypeStruct` with a
`NamedSharding`); without a mesh it is a plain fake tensor.
`cache_specs_from_eval` runs the port's `prefill` on stand-ins to infer the
decode caches' shapes, the counterpart of `jax.eval_shape`.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch.distributed.sharding import ShardingCtx, sharding_for
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import packed_token_shape, param_shapes
from repro_torch.train.optimizer import tree_map

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# the prompt that `cache_specs_from_eval` runs into caches of S slots
EVAL_PROMPT = 256

_FAKE: Optional[FakeTensorMode] = None


def fake_mode() -> FakeTensorMode:
    """The active FakeTensorMode, else this module's own (made once; it
    accepts real tensors as inputs, such as a table cached at import)."""
    global _FAKE
    active = detect_fake_mode()
    if active is not None:
        return active
    if _FAKE is None:
        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


class DTensorOnFakes(TorchDispatchMode):
    """Runs each DTensor op's own bookkeeping (the index arithmetic of its
    placements, on small tensors that it makes) on real tensors, outside the
    fake mode, and its local ops on the fake shards in their fake mode (a
    fake tensor takes its own mode along).  Under the fake mode alone that
    bookkeeping's tensors would be fake too, and a `_StridedShard` offset
    read from one (`.tolist()`) raises.

    Hooks for a subclass: `on_dtensor` sees each op on DTensors with its
    result, `depth` above 0 inside it; `local` runs every op on plain (fake)
    tensors, the step's own and some of DTensor's local ones (not those of
    an op whose placements DTensor has cached: it runs them below this
    mode)."""

    def __init__(self):
        super().__init__()
        self._to_dtensor = False
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._to_dtensor:  # the op re-dispatched just below: DTensor's turn
                self._to_dtensor = False
                return NotImplemented
            self.depth += 1
            try:
                with unset_fake_temporarily(), self:
                    self._to_dtensor = True
                    out = func(*args, **kwargs)
            finally:
                self.depth -= 1
            return self.on_dtensor(func, args, out)
        return self.local(func, args, kwargs)

    def on_dtensor(self, func, args, out):
        return out

    def local(self, func, args, kwargs):
        return func(*args, **kwargs)


@contextlib.contextmanager
def faking():
    """A context in which tensor factories make stand-ins and DTensor ops
    run on them: `fake_mode()` and a `DTensorOnFakes`, each entered unless
    one is active already."""
    with contextlib.ExitStack() as stack:
        if detect_fake_mode() is None:
            stack.enter_context(fake_mode())
        if not any(isinstance(m, DTensorOnFakes) for m in _get_current_dispatch_mode_stack()):
            stack.enter_context(DTensorOnFakes())
        yield


def cell_supported(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 512k decode requires sub-quadratic attention "
                       "(DESIGN.md §6)")
    return True, ""


def stand_in(shape, dtype: torch.dtype, dims, ctx: ShardingCtx, activation: bool = True):
    """A stand-in of `shape` and `dtype`, placed by `sharding_for(dims)`
    under a mesh (inputs and caches are data: the activation path's
    strategy-aware batch widening unless `activation=False`)."""
    shape = tuple(shape)
    with faking():
        t = torch.empty(shape, dtype=dtype)
        place = sharding_for(dims, ctx, shape, activation=activation) if ctx.enabled else None
        if place is None:
            return t
        return distribute_tensor(t, ctx.mesh, place, src_data_rank=None)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_specs(cfg: ModelConfig, ctx: ShardingCtx):
    """Stand-ins of `init_params(cfg)`'s tree, placed as parameters are
    stored (`activation=False`)."""
    shapes, dims = param_shapes(cfg)
    dt = _dtype(cfg)

    def build(shp, dm, name):
        dtype = torch.float32 if name in ("A_log", "dt_bias") else dt
        return stand_in(shp, dtype, dm, ctx, activation=False)

    out: Dict[str, Any] = {}
    for name, shp in shapes.items():
        if name == "segments":
            out["segments"] = [
                {k: build(s, dims["segments"][i][k], k) for k, s in seg.items()}
                for i, seg in enumerate(shapes["segments"])
            ]
        else:
            out[name] = build(shp, dims[name], name)
    return out


def batch_specs(cfg: ModelConfig, shape_name: str, ctx: ShardingCtx,
                packed: bool = True) -> Dict[str, Any]:
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    dt = _dtype(cfg)
    batch: Dict[str, Any] = {}
    if info["kind"] in ("train", "prefill"):
        if packed and cfg.decode_bitpack and S % 4096 == 0:
            shp = packed_token_shape(cfg, B, S)
            batch["packed"] = stand_in(shp, torch.int32, ("batch", None, None, None), ctx)
        else:
            batch["tokens"] = stand_in((B, S), torch.int32, ("batch", None), ctx)
        if cfg.family == "vlm":
            batch["embeds"] = stand_in((B, cfg.vision_tokens, cfg.d_model), dt,
                                       ("batch", None, None), ctx)
        if cfg.is_encdec:
            batch["enc_embeds"] = stand_in((B, cfg.encoder_seq, cfg.d_model), dt,
                                           ("batch", None, None), ctx)
    return batch


def cache_sharding_dims(shape: Tuple[int, ...], ctx: ShardingCtx):
    """Heuristic logical dims for cache leaves (L, B, ...): batch on dp,
    largest remaining tp-divisible axis on model."""
    dims: list = [None] * len(shape)
    if len(shape) >= 2:
        dims[1] = "batch"
    tp = ctx.tp if ctx.enabled else 1
    if tp > 1 and len(shape) > 2:
        best, best_size = None, 0
        for i in range(2, len(shape)):
            if shape[i] % tp == 0 and shape[i] > best_size:
                best, best_size = i, shape[i]
        if best is not None:
            dims[best] = "seq_tp"
    return tuple(dims)


def cache_specs_from_eval(cfg: ModelConfig, shape_name: str, ctx: ShardingCtx):
    """The decode caches' stand-ins: shapes and dtypes from the port's
    `prefill` run on stand-ins (nothing is computed or allocated), each
    leaf then placed by `cache_sharding_dims`.  The tree is `prefill`'s: a
    list of one dict a segment (`{}` for an enc-dec model's encoder).

    The prompt is `EVAL_PROMPT` tokens (S if shorter) into caches of
    `cache_len=S` slots: no cache leaf's shape depends on the prompt's
    length (attention caches hold cache_len slots, rings their window, SSM
    states and cross-attention caches neither), and a trace of 524,288
    tokens through the SSD's chunk loop takes minutes."""
    from repro_torch.models.model import prefill

    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    dt = _dtype(cfg)
    with faking():
        batch = {"tokens": torch.empty((B, min(S, EVAL_PROMPT)), dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["embeds"] = torch.empty((B, cfg.vision_tokens, cfg.d_model), dtype=dt)
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=dt)
        pspecs = param_specs(cfg, ctx)
        with torch.no_grad():
            _, caches = prefill(pspecs, batch, cfg, ctx, cache_len=S)

    def attach(leaf):
        dims = cache_sharding_dims(tuple(leaf.shape), ctx)
        return stand_in(tuple(leaf.shape), leaf.dtype, dims, ctx)

    return tree_map(attach, caches)
