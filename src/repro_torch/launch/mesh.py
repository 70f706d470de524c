"""Production mesh construction.

Port of `repro/launch/mesh.py`.  A FUNCTION (not a module-level constant),
so importing this module touches no process group.

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; the pod axis is pure
data parallelism across hosts, the inner axes within them.

Each rank is one card, its collectives on NCCL (`distributed.compat`);
`device="cpu"` builds the same mesh over gloo.  Without that many ranks in
the process group it raises `RuntimeError`, as the reference does without
that many devices.
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch.distributed.compat import make_mesh
from repro_torch.distributed.sharding import ShardingCtx


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    found = dist.get_world_size() if dist.is_initialized() else 0
    if found != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, found {found} in the process group")
    return make_mesh(shape, axes, device=device)


def production_ctx(*, multi_pod: bool = False, strategy: str = "tp",
                   device: str = "cuda") -> ShardingCtx:
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    return ShardingCtx(mesh=mesh, dp_axes=dp_axes, strategy=strategy)


# NVIDIA H100 SXM 80GB, data sheet, at its 700 W power limit (roofline
# denominators; a card set below 700 W runs slower, so compare measurements
# with the card's power limit beside them)
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card, H100 SXM at 700 W
HBM_BW = 3.35e12  # HBM3 bytes/s per card, H100 SXM at 700 W
NVLINK_BW = 450e9  # NVLink 4 bytes/s per direction per card (900 GB/s both), H100 SXM
