"""Sharding context: the one-device part of `repro/distributed/sharding.py`.

`ShardingCtx` as `local_ctx()` builds it (no mesh), and `constrain`, which
is the identity without a mesh.  Meshes, `spec_for`, the sharding rules and
the `HashRing` of the scan fabric wait for ROADMAP.md item A.6 (and A.4 for
the ring); `constrain` under a mesh raises `NotImplementedError` naming it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

# the ROADMAP.md section A item that the NotImplementedError messages name
DISTRIBUTED = "A.6 distributed and launch"


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {DISTRIBUTED})")


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """The reference's context less its axis names and activation strategy,
    which only a mesh reads."""

    mesh: Optional[Any] = None

    @property
    def enabled(self) -> bool:
        return self.mesh is not None


def local_ctx() -> ShardingCtx:
    """No-mesh context: one device."""
    return ShardingCtx(mesh=None)


def constrain(x: torch.Tensor, dims: Sequence[Optional[str]], ctx: ShardingCtx) -> torch.Tensor:
    """The reference's sharding constraint on logical dims: the identity
    without a mesh."""
    if not ctx.enabled:
        return x
    raise _later("sharding constraints under a mesh")
