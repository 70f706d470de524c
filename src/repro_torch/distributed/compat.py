"""The device mesh: `make_mesh` and `use_mesh`, the port of
`repro/distributed/compat.py`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, its dims named as the reference's mesh axes
("data", "model"; "pod" in front on the multi-pod mesh).  On the card its
collectives run on NCCL; gloo serves only a caller that asks for the CPU
(`device="cpu"`, as the tests do).  Nothing falls back: asking for the card
without one, or over a process group of another backend, raises
`RuntimeError`.

The reference's other shims have no counterpart here, because what they
bridge is a split between JAX versions:
  - `shard_map` / `shard_map_nocheck`: a per-shard body is written with
    `DTensor.to_local` / `DTensor.from_local` (what
    `torch.distributed.tensor.experimental.local_map` wraps) around plain
    collectives on the mesh dim's group; torch has no replication check to
    turn off.
  - `axis_size(name)` inside a shard body: `mesh.size(dim)` is static and
    readable anywhere, and `ShardingCtx.axis_size` reads it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device: str = "cuda") -> DeviceMesh:
    """A mesh of `axis_shapes` ranks named `axis_names`, over the default
    process group, on the card (NCCL) unless the caller asks for the CPU
    (gloo).  The process group is initialized from the environment
    (`MASTER_ADDR`, `RANK`, ...) when no one has initialized it yet."""
    if device not in BACKENDS:
        raise ValueError(f"device {device!r} is not one of {sorted(BACKENDS)}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda'): no CUDA card is available")
    backend = BACKENDS[device]
    if not dist.is_initialized():
        dist.init_process_group(backend)
    if dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh(device={device!r}) needs a {backend} process group, "
                           f"not {dist.get_backend()}")
    n = 1
    for s in axis_shapes:
        n *= s
    if n != dist.get_world_size():
        raise RuntimeError(f"mesh {tuple(axis_shapes)} needs {n} ranks, the process group "
                           f"has {dist.get_world_size()}")
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device, tuple(axis_shapes), mesh_dim_names=tuple(axis_names))


def use_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """Context manager making `mesh` the current one (`DeviceMesh` is its
    own context manager)."""
    return mesh
