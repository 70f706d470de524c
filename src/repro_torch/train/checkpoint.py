"""Fault-tolerant checkpointing: atomic and integrity-checked.

Port of `repro/train/checkpoint.py`, with its on-disk format:

    <dir>/step_<N>.tmp-<pid>/   (staging)
    <dir>/step_<N>/
        manifest.json   {step, checksums, dtypes, meta, keys}
        arrays.npz      flattened tree leaves (path-keyed, "/" stored as "|")

Keys are `_flatten`'s "a/b/0" paths (dict keys sorted), dtypes the numpy
names ("bfloat16", fp8 stored as same-width unsigned ints), checksums the
first 12 hex digits of the sha1 of each stored array's bytes.  So a
checkpoint written by either package restores in the other bit for bit.

Save is write-to-staging + fsync + atomic rename: a crash mid-save never
corrupts the latest checkpoint.  `restore_latest` verifies checksums and
falls back to the previous step when a step cannot be read (a corrupt or
truncated file, a checksum mismatch, a missing key).  Only reading and
checking sit under that fallback: moving the leaves onto the template's
devices comes after it, so a CUDA error or an out-of-memory there leaves
`restore_latest` instead of passing for an older step.  Retention keeps the
newest K.

Under a mesh a tree's DTensor leaves are gathered with `full_tensor()` on
every rank (a collective: every rank calls `save`), rank 0 alone writes,
stages and renames, and a barrier follows; the file is the same as one
device's.  `restore_latest(template, ctx, dims)` reads and checks on every
rank, then `reshard` places each leaf by `sharding_for(dims)` on the
current mesh, whatever mesh the step was saved on (the reference's elastic
re-mesh).  Where the reference's `reshard` maps over `dims` and raises at a
`None` subtree (`jax.tree.map`: "Expected dict, got None"), the port leaves
that subtree's leaves as plain tensors on their template's device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import ShardingCtx, sharding_for

# npz cannot represent bfloat16 or fp8: stored as same-width unsigned ints
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8),
}
_BY_TORCH = {dt: name for name, (dt, _) in _EXOTIC.items()}
_SIGNED = {1: (torch.int8, np.int8), 2: (torch.int16, np.int16)}  # numpy <-> torch bits

# what a step that cannot be read raises: the fallback takes these, nothing else
_UNREADABLE = (OSError, ValueError, KeyError, zipfile.BadZipFile, EOFError)


def _to_storable(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (an array npz can hold, the reference's dtype name)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()  # a collective: every rank gathers
    t = leaf.detach().cpu()
    if t.dtype in _BY_TORCH:
        name = _BY_TORCH[t.dtype]
        tview, _ = _SIGNED[t.element_size()]
        return t.view(tview).numpy().view(_EXOTIC[name][1]), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy that torch may own
    if dtype_name in _EXOTIC:
        _, nview = _SIGNED[arr.itemsize]
        return torch.from_numpy(arr.view(nview)).view(_EXOTIC[dtype_name][0]).to(device)
    return torch.from_numpy(arr).to(device)


def _flatten(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys()):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{prefix}{i}/"))
        return out
    return [(prefix.rstrip("/"), tree)]


def _unflatten(template, leaf_fn, prefix=""):
    """The template's structure with each leaf replaced by
    leaf_fn(template leaf, key)."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaf_fn, f"{prefix}{k}/") for k in template}
    if isinstance(template, list):
        return [_unflatten(v, leaf_fn, f"{prefix}{i}/") for i, v in enumerate(template)]
    if isinstance(template, tuple):
        return tuple(_unflatten(v, leaf_fn, f"{prefix}{i}/") for i, v in enumerate(template))
    return leaf_fn(template, prefix.rstrip("/"))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> str:
        """Write `tree` as step `step`.  With DTensor leaves every rank of
        their mesh calls it: each leaf is gathered, the mesh's first rank
        writes, and every rank leaves after a barrier."""
        flat = _flatten(tree)
        mesh = next((leaf.device_mesh for _, leaf in flat if isinstance(leaf, DTensor)), None)
        arrays = {}
        for key, leaf in flat:
            arrays[key] = _to_storable(leaf)
        final = os.path.join(self.dir, f"step_{step:08d}")
        if mesh is None:
            return self._write(step, flat, arrays, meta, final)
        try:
            if dist.get_rank() == int(mesh.mesh.min()):
                self._write(step, flat, arrays, meta, final)
        finally:
            dist.barrier()
        return final

    def _write(self, step: int, flat, stored: Dict[str, Tuple[np.ndarray, str]],
               meta: Optional[dict], final: str) -> str:
        arrays = {key: arr for key, (arr, _) in stored.items()}
        dtypes = {key: name for key, (_, name) in stored.items()}
        checksums = {key: hashlib.sha1(arr.tobytes()).hexdigest()[:12]
                     for key, arr in arrays.items()}
        staging = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=self.dir)
        try:
            npz_path = os.path.join(staging, "arrays.npz")
            np.savez(npz_path, **{k.replace("/", "|"): v for k, v in arrays.items()})
            manifest = {
                "step": step,
                "checksums": checksums,
                "dtypes": dtypes,
                "meta": meta or {},
                "keys": [k for k, _ in flat],
            }
            with open(os.path.join(staging, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(staging, final)  # atomic publish
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        self._retain()
        return final

    def _retain(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    # ------------------------------------------------------------------
    def _load_step(self, step: int, template: Any) -> Tuple[Dict[str, np.ndarray], dict]:
        """The template's leaves from step `step`, checksum-verified, as
        stored numpy arrays by key."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key in manifest["keys"]:
                arr = data[key.replace("/", "|")]
                got = hashlib.sha1(arr.tobytes()).hexdigest()[:12]
                if got != manifest["checksums"][key]:
                    raise IOError(f"checksum mismatch at {key} in step {step}")
                flat[key] = arr
        return {key: flat[key] for key, _ in _flatten(template)}, manifest

    def restore_latest(self, template: Any, ctx: Optional[ShardingCtx] = None,
                       dims: Optional[Any] = None) -> Tuple[Optional[Any], Optional[dict]]:
        """Try newest -> oldest; verify integrity; put each leaf on its
        template leaf's device (the CPU for a leaf that is not a tensor), then,
        with a mesh in `ctx` and `dims`, place it on the mesh (`reshard`)."""
        for step in reversed(self.list_steps()):
            try:
                flat, manifest = self._load_step(step, template)
            except _UNREADABLE:
                continue  # corrupted: fall back to the previous checkpoint
            dtypes = manifest.get("dtypes", {})

            def leaf(tmpl, key):
                arr = flat[key]
                device = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
                return _from_storable(arr, dtypes.get(key, str(arr.dtype)), device)

            tree = _unflatten(template, leaf)
            if ctx is not None and ctx.enabled and dims is not None:
                tree = reshard(tree, dims, ctx)
            return tree, manifest
        return None, None


def _is_dims(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def reshard(tree: Any, dims: Any, ctx: ShardingCtx) -> Any:
    """Every leaf of `tree` (each rank holding all of it) as a DTensor
    placed by `sharding_for(dims)` on the CURRENT mesh, each rank keeping its
    own shard without communication: the elastic-scaling entry point (the
    mesh the tree was saved on does not matter).  A `None` in `dims` leaves
    its subtree's leaves as they are."""
    if dims is None:
        return tree
    if _is_dims(dims):
        place = sharding_for(dims, ctx, tuple(tree.shape))
        return distribute_tensor(tree, ctx.mesh, place, src_data_rank=None)
    if isinstance(tree, dict):
        return {k: reshard(v, dims[k], ctx) for k, v in tree.items()}
    return [reshard(v, d, ctx) for v, d in zip(tree, dims)]
