"""The port's `CheckpointManager` (`repro_torch.train.checkpoint`): round
trip (bf16 included), corrupted-latest fallback, retention, the on-disk
format shared with the JAX package's (each restores the other's checkpoint
bit for bit), and a fallback that stops at the device: a failure while
moving the leaves onto the template's device leaves `restore_latest`."""

import tests.torch_threads  # noqa: F401 (one torch thread a test process)
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JManager
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.train import checkpoint
from repro_torch.train.checkpoint import CheckpointManager


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b16": torch.ones(5, dtype=torch.bfloat16) * 1.5},
        "opt": [torch.zeros(2, dtype=torch.int32)],
    }


def _mixed(seed):
    """Leaves of every dtype a training checkpoint holds, random bits."""
    rng = np.random.default_rng(seed)
    b16 = rng.integers(0, 2**16, (4, 7), dtype=np.uint16)
    b16[0, :3] = [0x7FC0, 0xFF80, 0x8000]  # NaN, -inf, -0.0
    return {
        "params": {"embed": rng.standard_normal((6, 5)).astype(np.float32),
                   "segments": [{"wq": b16, "ln1": rng.standard_normal(5).astype(np.float32)}]},
        "opt": {"m": {"embed": rng.standard_normal((6, 5)).astype(np.float32)},
                "step": np.array(7, np.int32)},
    }


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype == np.uint16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    if tree.dtype == np.uint16:
        return jnp.asarray(tree.view(ml_dtypes.bfloat16))
    return jnp.asarray(tree)


def _bits_t(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bits_j(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _leaves(tree, prefix=""):
    return checkpoint._flatten(tree, prefix)


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    m.save(3, tree, meta={"step": 3})
    out, manifest = m.restore_latest(tree)
    assert manifest["step"] == 3
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    assert out["params"]["b16"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["b16"].float(), torch.full((5,), 1.5))
    assert out["opt"][0].dtype == torch.int32 and isinstance(out["opt"], list)


def test_corrupted_latest_falls_back(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    m.save(1, tree, meta={"step": 1})
    m.save(2, tree, meta={"step": 2})
    with open(os.path.join(str(tmp_path), "step_00000002", "arrays.npz"), "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef" * 8)
    out, manifest = m.restore_latest(tree)
    assert manifest["step"] == 1  # fell back to the previous intact step


@pytest.mark.parametrize("damage", ["truncated", "manifest", "checksum", "missing_key"])
def test_each_unreadable_step_falls_back(tmp_path, damage):
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    m.save(1, tree, meta={"step": 1})
    m.save(2, tree, meta={"step": 2})
    step2 = os.path.join(str(tmp_path), "step_00000002")
    if damage == "truncated":
        with open(os.path.join(step2, "arrays.npz"), "r+b") as f:
            f.truncate(100)
    elif damage == "manifest":
        with open(os.path.join(step2, "manifest.json"), "w") as f:
            f.write("{not json")
    else:
        with open(os.path.join(step2, "manifest.json")) as f:
            manifest = json.load(f)
        if damage == "checksum":
            manifest["checksums"]["params/w"] = "0" * 12
        else:  # the template asks for a key the step does not list
            manifest["keys"].remove("params/w")
            del manifest["checksums"]["params/w"]
        with open(os.path.join(step2, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    out, manifest = m.restore_latest(tree)
    assert manifest["step"] == 1


def test_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        m.save(s, tree)
    assert m.list_steps() == [3, 4]


def test_failure_moving_onto_the_device_is_not_swallowed(tmp_path, monkeypatch):
    """Only reading and checking fall back: an error raised while a leaf is
    put on its device (a CUDA error, an out-of-memory) leaves
    restore_latest, and no older step is tried."""
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    m.save(1, tree, meta={"step": 1})
    m.save(2, tree, meta={"step": 2})
    tried = []

    def failing_move(arr, dtype_name, device):
        tried.append(dtype_name)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(checkpoint, "_from_storable", failing_move)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        m.restore_latest(tree)
    assert len(tried) == 1

    def card_error(arr, dtype_name, device):
        raise RuntimeError("CUDA error: an illegal memory access was encountered (injected)")

    monkeypatch.setattr(checkpoint, "_from_storable", card_error)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        m.restore_latest(tree)


def test_restore_puts_each_leaf_on_its_template_device(tmp_path, monkeypatch):
    m = CheckpointManager(str(tmp_path))
    tree = _tree()
    m.save(1, tree)
    devices = []
    real = checkpoint._from_storable

    def spy(arr, dtype_name, device):
        devices.append(device)
        return real(arr, dtype_name, device)

    monkeypatch.setattr(checkpoint, "_from_storable", spy)
    m.restore_latest(tree)
    assert devices == [torch.device("cpu")] * 3


@pytest.fixture
def one_rank_mesh():
    """A (data 1, model 1) mesh over a gloo process group of one rank in
    this process, torn down after."""
    import torch.distributed as dist

    from repro_torch.distributed.compat import make_mesh

    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_restore_onto_a_mesh_gives_dtensors(tmp_path, one_rank_mesh):
    """A mesh save (DTensor leaves: the one rank gathers and writes) restored
    onto the mesh: every leaf with dims a DTensor placed by them, bit for
    bit; a None subtree stays plain; the file is one device's."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    ctx = ShardingCtx(mesh=one_rank_mesh)
    tree = _tree()
    on_mesh = {"params": {k: distribute_tensor(v, one_rank_mesh, [Replicate(), Replicate()])
                          for k, v in tree["params"].items()}, "opt": tree["opt"]}
    CheckpointManager(str(tmp_path / "mesh")).save(1, on_mesh, meta={"step": 1})
    CheckpointManager(str(tmp_path / "one")).save(1, tree, meta={"step": 1})
    for name in ("manifest.json", "arrays.npz"):
        assert (tmp_path / "mesh" / "step_00000001" / name).read_bytes() == \
            (tmp_path / "one" / "step_00000001" / name).read_bytes()
    dims = {"params": {"w": ("d", "heads"), "b16": (None,)}, "opt": None}
    got, manifest = CheckpointManager(str(tmp_path / "mesh")).restore_latest(_tree(), ctx, dims)
    assert manifest["meta"] == {"step": 1}
    for k, v in tree["params"].items():
        leaf = got["params"][k]
        assert isinstance(leaf, DTensor) and leaf.device_mesh is one_rank_mesh
        assert tuple(leaf.placements) == (Replicate(), Replicate())
        assert leaf.dtype == v.dtype and torch.equal(leaf.full_tensor(), v)
    assert not isinstance(got["opt"][0], DTensor) and torch.equal(got["opt"][0], tree["opt"][0])


def test_same_format_as_the_reference(tmp_path):
    """The same tree saved by both packages: the same manifest (keys,
    dtypes, checksums, meta) and the same arrays under the same npz names."""
    src = _mixed(0)
    JManager(str(tmp_path / "j")).save(5, _as_jax(src), meta={"step": 5, "pipeline": {"a": 1}})
    CheckpointManager(str(tmp_path / "t")).save(5, _as_torch(src),
                                                meta={"step": 5, "pipeline": {"a": 1}})
    man = {}
    arrays = {}
    for side in ("j", "t"):
        d = tmp_path / side / "step_00000005"
        man[side] = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as data:
            arrays[side] = {k: data[k] for k in data.files}
    assert man["t"] == man["j"]
    assert man["t"]["dtypes"]["params/segments/0/wq"] == "bfloat16"
    assert sorted(arrays["t"]) == sorted(arrays["j"])
    for k in arrays["j"]:
        assert arrays["t"][k].dtype == arrays["j"][k].dtype
        assert np.array_equal(arrays["t"][k], arrays["j"][k])


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    src = _mixed(1)
    JManager(str(tmp_path)).save(3, _as_jax(src), meta={"step": 3})
    template = _as_torch(_mixed(2))
    out, manifest = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert manifest["step"] == 3
    got, want = _leaves(out), _leaves(_as_torch(src))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), k
        assert np.array_equal(_bits_t(g), _bits_t(w)), k


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    src = _mixed(3)
    CheckpointManager(str(tmp_path)).save(4, _as_torch(src), meta={"step": 4})
    template = _as_jax(_mixed(4))
    out, manifest = JManager(str(tmp_path)).restore_latest(template)
    assert manifest["step"] == 4
    got, want = _leaves(out), _leaves(_as_jax(src))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        assert np.array_equal(_bits_j(g), _bits_j(w)), k
