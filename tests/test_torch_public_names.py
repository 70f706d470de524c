"""The port keeps the reference's modules and public names: the two trees'
module lists are equal but for the port's own modules, each ported module's
top-level public names include the reference's but for a short list that
has no meaning in the port, and the names that the port once lacked (the
bucket ladder of `kernels/ops.py`, `kernels/ref.bitunpack_flat`,
`distributed/sharding.tree_shardings`) equal the reference's value for
value.  A submodule that a package's `__init__.py` imports is no name of
its own here: the module lists' test checks it."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import ast
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.model import param_shapes as jparam_shapes
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ShardingCtx, placements_for
from repro_torch.kernels import ops, ref
from repro_torch.models.model import param_shapes
from tests.util import REPO

SRC = Path(REPO) / "src"
PORT_ONLY = {"__init__.py", "core/agreement.py", "kernels/build.py"}

# Public names of the reference that have no meaning in the port, by module.
NO_MEANING = {
    # the Pallas kernels and their TPU tiling constants: the port's kernels
    # are CUDA (`csrc/`), launched by wrappers of their own names
    "kernels/agg_push.py": {"DEFAULT_GROUP", "fused_agg_pallas", "grouped_agg_pallas"},
    "kernels/bitunpack.py": {"DEFAULT_GROUP", "bitunpack_pallas"},
    "kernels/bloom_probe.py": {"BLOCK", "DEFAULT_GROUP", "bloom_probe_pallas"},
    "kernels/delta_decode.py": {"DEFAULT_GROUP", "delta_decode_pallas"},
    "kernels/dict_decode.py": {"DEFAULT_GROUP", "ONE_HOT_MAX", "SELECT_MAX_K",
                               "dict_decode_batch_pallas", "dict_decode_pallas"},
    "kernels/filter_compact.py": {"BLOCK", "filter_compact_pallas"},
    "kernels/flash_attention.py": {"DEFAULT_BK", "DEFAULT_BQ", "NEG_INF",
                                   "flash_attention_pallas"},
    "kernels/fused_scan.py": {"DEFAULT_GROUP", "fused_scan_batch_pallas", "fused_scan_pallas"},
    "kernels/rle_decode.py": {"DEFAULT_GROUP", "rle_decode_pallas"},
    # shims across JAX versions (distributed/compat.py's docstring)
    "distributed/compat.py": {"axis_size", "shard_map_nocheck"},
    # the TPU's inter-chip link; the port's is NVLINK_BW (launch/mesh.py)
    "launch/mesh.py": {"ICI_BW"},
    # the reference engine's settable padding default: the port's engine
    # pads no stack, so only `bucket_blocks(n, mode)` is kept, for callers
    "kernels/ops.py": {"BUCKET_MODE", "set_bucket_mode"},
}


def _modules(pkg: str) -> set:
    root = SRC / pkg
    return {str(p.relative_to(root)) for p in root.rglob("*.py")}


def _public_names(path: Path) -> set:
    """Top-level names a module binds (functions, classes, assigned names;
    in a package's `__init__.py` also the names it imports, but for its
    own submodules), less those starting with an underscore."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        out.add(e.id)
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names
                       if not (path.parent / f"{a.name}.py").exists()
                       and not (path.parent / a.name / "__init__.py").exists())
    return {n for n in out if not n.startswith("_")}


def test_module_lists_equal_but_the_ports_own():
    assert _modules("repro_torch") - PORT_ONLY == _modules("repro")


@pytest.mark.parametrize("module", sorted(_modules("repro")))
def test_each_ported_module_keeps_the_references_public_names(module):
    want = _public_names(SRC / "repro" / module) - NO_MEANING.get(module, set())
    missing = want - _public_names(SRC / "repro_torch" / module)
    assert not missing, f"{module} lacks {sorted(missing)}"
    # the list holds only names the reference has and the port lacks
    gone = NO_MEANING.get(module, set()) - _public_names(SRC / "repro" / module)
    assert not gone, gone


def test_bucket_blocks_every_count_in_both_modes():
    assert jops.BUCKET_MODE == "ladder"
    for mode in ("ladder", "pow2"):
        got = [ops.bucket_blocks(n, mode) for n in range(1, 4097)]
        assert got == [jops.bucket_blocks(n, mode) for n in range(1, 4097)], mode
    assert [ops.bucket_blocks(n) for n in range(1, 4097)] == \
        [jops.bucket_blocks(n) for n in range(1, 4097)]


def test_bucket_blocks_defaults_to_the_ladder_and_refuses_an_unknown_mode():
    assert [ops.bucket_blocks(n) for n in (5, 7, 9)] == [6, 8, 12]
    assert [ops.bucket_blocks(n, "pow2") for n in (5, 7, 9)] == [8, 8, 16]
    with pytest.raises(ValueError, match="unknown bucket mode"):
        ops.bucket_blocks(5, "pow3")
    with pytest.raises(ValueError):
        ops.bucket_blocks(0)


@pytest.mark.parametrize("k", range(1, 33))
def test_bitunpack_flat_every_k_against_the_reference(k):
    rng = np.random.default_rng(k)
    words = rng.integers(0, 2**32, (3, k, 128), dtype=np.uint64).astype(np.uint32)
    for n in (1, 4095, 3 * 4096 - 7, 3 * 4096):
        want = np.asarray(jref.bitunpack_flat(jax.numpy.asarray(words), k, n))
        got = ref.bitunpack_flat(torch.from_numpy(words.view(np.int32)), k, n)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _walk(v, f"{path}/{key}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b", "hymba-1.5b"])
@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_tree_shardings_against_the_reference(arch, strategy):
    """Every parameter's placements on a (2, 4) mesh equal the reference's
    NamedSharding spec mapped through `placements_for`; None without a
    mesh."""
    names, sizes = ("data", "model"), (2, 4)
    mesh = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    jmesh = AbstractMesh(sizes, names)
    shapes, dims = param_shapes(get_config(arch))
    jshapes, jdims = jparam_shapes(jget_config(arch))
    got = dict(_walk(sharding.tree_shardings(dims, ShardingCtx(mesh=mesh, strategy=strategy),
                                             shapes)))
    want = dict(_walk(jsharding.tree_shardings(
        jdims, jsharding.ShardingCtx(mesh=jmesh, strategy=strategy), jshapes)))
    shape_of = dict(_walk(shapes))
    assert sorted(got) == sorted(want) and len(got) > 10
    for path, sh in want.items():
        spec = tuple(sh.spec) + (None,) * (len(shape_of[path]) - len(sh.spec))
        assert got[path] == placements_for(spec, mesh, shape_of[path]), path
    none = sharding.tree_shardings(dims, ShardingCtx(mesh=None), shapes)
    assert all(v is None for _, v in _walk(none))
