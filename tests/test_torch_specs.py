"""The port's `launch/specs.py` against the reference's: for every arch of
`list_archs()` x every shape x {no mesh, 16x16 `tp`, 16x16 `fsdp`, 2x16x16
`tp`}, each parameter and batch leaf's shape, dtype and placements equal to
the reference's, with the reference's PartitionSpec mapped through the port's
`placements_for`; `cell_supported` equal for every cell; and the decode
caches that `cache_specs_from_eval` infers equal to the reference's
`eval_shape` ones (smoke configs: the port infers them by running its
prefill on stand-ins, layer by layer).

Each side runs in a subprocess of its own: the reference on 512
placeholder host devices, the port as rank 0 of torch's `fake` process
group (global to its process, so never a pytest worker's)."""

from __future__ import annotations

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from repro_torch.configs import list_archs
from repro_torch.distributed.sharding import placements_for
from tests.util import REPO, run_with_devices

MESHES = {"none": None, "tp": (False, "tp"), "fsdp": (False, "fsdp"), "pod": (True, "tp")}
AXES = {False: (("data", "model"), (16, 16)), True: (("pod", "data", "model"), (2, 16, 16))}
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CACHE_MESHES = ("none", "tp")  # caches: decode shapes of every arch, smoke configs

# Both sides print one JSON object: {"params|arch|mesh": {path: [shape, dtype,
# spec]}, "batch|arch|shape|mesh": ..., "cache|arch|shape|mesh": ...,
# "supported|arch|shape": [ok, why]}.  The reference's spec is its
# PartitionSpec's entries; the port's the placements' reprs.
_COMMON = r"""
import json, sys

def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: record(tree)}

MESHES = {"none": None, "tp": (False, "tp"), "fsdp": (False, "fsdp"), "pod": (True, "tp")}
out = {}
"""

REF = _COMMON + r"""
import jax
from repro.configs import get_config, get_smoke_config, list_archs
from repro.distributed.sharding import ShardingCtx
from repro.launch import specs as S
from repro.launch.mesh import production_ctx

def record(x):
    sh = getattr(x, "sharding", None)
    spec = None if sh is None else [list(e) if isinstance(e, tuple) else e for e in sh.spec]
    return [list(x.shape), str(x.dtype), spec]

for mesh, how in MESHES.items():
    ctx = ShardingCtx(mesh=None) if how is None else production_ctx(multi_pod=how[0],
                                                                  strategy=how[1])
    for arch in list_archs():
        cfg = get_config(arch)
        out[f"params|{arch}|{mesh}"] = leaves(S.param_specs(cfg, ctx))
        for shape in S.SHAPES:
            out[f"batch|{arch}|{shape}|{mesh}"] = leaves(S.batch_specs(cfg, shape, ctx))
            out[f"supported|{arch}|{shape}"] = list(S.cell_supported(cfg, shape))
            if mesh in CACHE_MESHES and S.SHAPES[shape]["kind"] == "decode" and \
                    S.cell_supported(cfg, shape)[0]:
                out[f"cache|{arch}|{shape}|{mesh}"] = leaves(
                    S.cache_specs_from_eval(get_smoke_config(arch), shape, ctx))
print(json.dumps(out))
"""

PORT = _COMMON + r"""
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.launch import dryrun, specs as S

def record(x):
    place = getattr(x, "placements", None)
    spec = None if place is None else [repr(p) for p in place]
    return [list(x.shape), str(x.dtype).replace("torch.", ""), spec]

for mesh, how in MESHES.items():  # the 2x16x16 mesh last: its world is 512
    ctx = ShardingCtx(mesh=None) if how is None else dryrun.fake_ctx(*how)
    for arch in list_archs():
        cfg = get_config(arch)
        out[f"params|{arch}|{mesh}"] = leaves(S.param_specs(cfg, ctx))
        for shape in S.SHAPES:
            out[f"batch|{arch}|{shape}|{mesh}"] = leaves(S.batch_specs(cfg, shape, ctx))
            out[f"supported|{arch}|{shape}"] = list(S.cell_supported(cfg, shape))
            if mesh in CACHE_MESHES and S.SHAPES[shape]["kind"] == "decode" and \
                    S.cell_supported(cfg, shape)[0]:
                out[f"cache|{arch}|{shape}|{mesh}"] = leaves(
                    S.cache_specs_from_eval(get_smoke_config(arch), shape, ctx))
print(json.dumps(out))
"""


def _port_side(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def sides():
    cache = f"CACHE_MESHES = {CACHE_MESHES!r}\n"
    ref = json.loads(run_with_devices(cache + REF, n_devices=512, timeout=600).splitlines()[-1])
    port = json.loads(_port_side(cache + PORT).splitlines()[-1])
    return ref, port


def _want(leaf, mesh: str):
    """The reference's leaf in the port's terms: its spec through
    `placements_for` on the mesh's axes, and uint32 token words as the port's
    int32 views of them."""
    shape, dtype, spec = leaf
    dtype = "int32" if dtype == "uint32" else dtype
    if MESHES[mesh] is None:
        assert spec is None
        return [shape, dtype, None]
    names, sizes = AXES[MESHES[mesh][0]]
    stand_in = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
    spec = spec + (None,) * (len(shape) - len(spec))
    return [shape, dtype, [repr(p) for p in placements_for(spec, stand_in, shape)]]


def _same(ref_tree, port_tree, mesh: str):
    assert sorted(port_tree) == sorted(ref_tree)
    for path, leaf in ref_tree.items():
        assert port_tree[path] == _want(leaf, mesh), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_batch_specs_equal_the_reference(sides, arch, mesh):
    ref, port = sides
    _same(ref[f"params|{arch}|{mesh}"], port[f"params|{arch}|{mesh}"], mesh)
    for shape in SHAPE_NAMES:
        key = f"batch|{arch}|{shape}|{mesh}"
        _same(ref[key], port[key], mesh)


@pytest.mark.parametrize("arch", list_archs())
def test_cell_supported_and_cache_specs_equal_the_reference(sides, arch):
    ref, port = sides
    decode_cells = 0
    for shape in SHAPE_NAMES:
        key = f"supported|{arch}|{shape}"
        assert port[key] == ref[key], key
        for mesh in CACHE_MESHES:
            key = f"cache|{arch}|{shape}|{mesh}"
            assert (key in port) == (key in ref), key
            if key in ref:
                _same(ref[key], port[key], mesh)
                decode_cells += 1
    assert decode_cells >= len(CACHE_MESHES)  # decode_32k at least


def test_stand_ins_hold_no_storage():
    """A stand-in is a fake tensor: it has the spec's shape and dtype, and
    making one for a 400B model's expert stack allocates nothing."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import local_ctx
    from repro_torch.launch import specs as S

    params = S.param_specs(get_config("llama4-maverick-400b"), local_ctx())
    experts = [v for seg in params["segments"] for k, v in seg.items() if v.dim() == 4]
    assert experts and all(isinstance(v, FakeTensor) for v in experts)
    assert sum(v.numel() for v in experts) > 3e11
    assert experts[0].dtype == torch.bfloat16
    batch = S.batch_specs(get_config("qwen3-1.7b"), "train_4k", local_ctx())
    assert set(batch) == {"packed"} and batch["packed"].dtype == torch.int32
