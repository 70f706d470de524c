"""Sharding: the one-device part of `repro/distributed/sharding.py`, and the
scan fabric's consistent-hash ring.

`ShardingCtx` as `local_ctx()` builds it (no mesh), and `constrain`, which
is the identity without a mesh.  Meshes, `spec_for` and the sharding rules
wait for ROADMAP.md item A.6; `constrain` under a mesh raises
`NotImplementedError` naming it.

`rg_key` and `HashRing` map row groups to the fabric's pods
(`datapath/fabric.py`), key for key as the reference's do: both hash with
sha1, so the two packages route every row group to the same pod.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Any, Dict, Iterable, List, Optional, Sequence

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


def rg_key(path: str, rg: int) -> str:
    """Canonical ring key for a row group: ownership is per (table file,
    row group), so one table's groups spread across the whole fleet."""
    return f"{path}#rg{rg}"


class HashRing:
    """Consistent-hash ring mapping keys -> node ids (fabric pods).

    Each node is hashed onto the ring at `replicas` virtual points
    (sha1 of "node#i" — never Python `hash()`, which is salted per
    process and would re-shuffle ownership on every restart).  A key
    is owned by the first virtual point clockwise from its hash.

    Properties the fabric relies on (tests/test_torch_fabric_parts.py):
      * deterministic: same nodes -> same ownership, any process
      * minimal movement: removing a node re-homes only the arcs that
        node owned; adding one steals only the arcs it now owns —
        every other key keeps its owner (the drain/replay path re-hashes
        a dead pod's row groups without touching survivors' caches)
      * balanced: virtual points smooth per-node load to ~1/N
    """

    def __init__(self, nodes: Iterable[str] = (), replicas: int = 64):
        assert replicas >= 1
        self.replicas = replicas
        self._points: List[int] = []  # sorted virtual-point hashes
        self._owner_at: Dict[int, str] = {}  # point hash -> node id
        self.nodes: List[str] = []
        for n in nodes:
            self.add_node(n)

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")

    def _vpoints(self, node: str) -> List[int]:
        return [self._hash(f"{node}#{i}") for i in range(self.replicas)]

    def add_node(self, node: str) -> None:
        if node in self.nodes:
            return
        self.nodes.append(node)
        for h in self._vpoints(node):
            # sha1 collisions across 8 bytes are not a practical concern;
            # last-add wins keeps the structure consistent regardless
            if h not in self._owner_at:
                bisect.insort(self._points, h)
            self._owner_at[h] = node

    def remove_node(self, node: str) -> None:
        if node not in self.nodes:
            return
        self.nodes.remove(node)
        for h in self._vpoints(node):
            if self._owner_at.get(h) == node:
                del self._owner_at[h]
                i = bisect.bisect_left(self._points, h)
                if i < len(self._points) and self._points[i] == h:
                    del self._points[i]

    def owner(self, key: str) -> str:
        if not self._points:
            raise ValueError("HashRing has no nodes")
        h = self._hash(key)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0  # wrap: first point clockwise
        return self._owner_at[self._points[i]]

    def owners(self, keys: Iterable[str]) -> Dict[str, str]:
        return {k: self.owner(k) for k in keys}
