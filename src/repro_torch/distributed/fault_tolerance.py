"""Fault tolerance: heartbeats, stragglers, elasticity, and the scan
fabric's pod drain.  Port of `repro/distributed/fault_tolerance.py`, which
imports nothing of JAX; the code is the reference's, line for line.

The *policies* are built and tested against simulated telemetry:

  HeartbeatMonitor  — declares hosts dead after `timeout_s` silence (on an
                      injectable `clock`: the fabric passes its tick count);
                      produces a RestartPlan (same-size restart if spares
                      exist, else shrink to the largest feasible mesh)
  StragglerDetector — robust per-step timing stats (median); flags hosts
                      slower than `factor` x median; policy choices:
                      'observe' | 'skip_batch' (drop the straggler's
                      microbatch that step) | 'evict' (treat as failed)
  plan_elastic_mesh — largest (data, model) mesh fitting the survivors,
                      keeping the model axis (TP needs full shards — you
                      shrink DP, never TP)
  plan_pod_drain    — the fabric's death path: remove a pod from the ring
                      and say which row-group keys re-home where

The mechanisms a RestartPlan triggers on a mesh are
`train.checkpoint.CheckpointManager.restore_latest(template, ctx, dims)`
and its `reshard`, which place a checkpoint on a mesh of another shape;
the fabric's drain is real (`datapath/fabric.py`).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class RestartPlan:
    dead_hosts: List[str]
    surviving_hosts: List[str]
    action: str  # 'none' | 'restart_same' | 'shrink'
    new_mesh: Optional[Tuple[int, int]] = None  # (data, model)


class HeartbeatMonitor:
    def __init__(self, hosts: List[str], timeout_s: float = 60.0,
                 spares: int = 0, clock=time.monotonic):
        self.timeout = timeout_s
        self.spares = spares
        self.clock = clock
        self.last_seen: Dict[str, float] = {h: clock() for h in hosts}

    def beat(self, host: str, at: Optional[float] = None):
        self.last_seen[host] = self.clock() if at is None else at

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]

    def plan(self, mesh_shape: Tuple[int, int]) -> RestartPlan:
        dead = self.dead_hosts()
        alive = [h for h in self.last_seen if h not in dead]
        if not dead:
            return RestartPlan([], alive, "none")
        if len(dead) <= self.spares:
            return RestartPlan(dead, alive, "restart_same", mesh_shape)
        new_mesh = plan_elastic_mesh(len(alive), mesh_shape)
        return RestartPlan(dead, alive, "shrink", new_mesh)


def plan_elastic_mesh(n_hosts_alive: int, old_mesh: Tuple[int, int],
                      chips_per_host: int = 4) -> Tuple[int, int]:
    """Largest (data, model) mesh on surviving chips; model axis preserved
    (TP shards are not divisible), data axis shrinks to the largest
    power-of-two that fits."""
    data, model = old_mesh
    chips = n_hosts_alive * chips_per_host
    max_data = max(1, chips // model)
    new_data = 1
    while new_data * 2 <= max_data:
        new_data *= 2
    return (new_data, model)


@dataclasses.dataclass
class PodDrainPlan:
    """What the scan fabric must do when a pod dies (DESIGN.md §15).

    `reassigned` maps each row-group key the dead pod owned to its new
    owner on the post-removal ring; `replay` lists the in-flight scan ids
    that had uncollected work on the dead pod and must re-submit their
    remaining row groups to the survivors.  Collected sub-results are
    fabric-held and survive — replay granularity is the pod sub-scan, so
    a scan resumes from its last *completed* slice, never from scratch."""

    dead: str
    survivors: List[str]
    reassigned: Dict[str, str]  # row-group key -> new owner pod
    replay: List[object]        # in-flight scan ids to re-submit


def plan_pod_drain(dead: str, ring, owned_keys: List[str],
                   in_flight: List[object]) -> PodDrainPlan:
    """Drain a dead pod: remove it from the ring (minimal moved arc —
    only ITS keys re-home), then map every key it owned to the survivor
    that now owns it.  `ring` is mutated (the fabric's live ring).
    Raises if the dead pod was the last one: there is nowhere to drain."""
    ring.remove_node(dead)
    if not ring.nodes:
        raise RuntimeError(f"pod {dead!r} was the last node; cannot drain")
    reassigned = {k: ring.owner(k) for k in owned_keys}
    assert all(o != dead for o in reassigned.values())
    return PodDrainPlan(
        dead=dead,
        survivors=list(ring.nodes),
        reassigned=reassigned,
        replay=list(in_flight),
    )


class StragglerDetector:
    def __init__(self, factor: float = 2.0, min_samples: int = 5,
                 policy: str = "observe"):
        self.factor = factor
        self.min_samples = min_samples
        self.policy = policy
        self.times: Dict[str, List[float]] = {}

    def record(self, host: str, step: int, seconds: float):
        self.times.setdefault(host, []).append(seconds)

    def stragglers(self) -> List[str]:
        if not self.times:
            return []
        recent = {h: ts[-self.min_samples:] for h, ts in self.times.items()
                  if len(ts) >= self.min_samples}
        if not recent:
            return []
        med = statistics.median(v for ts in recent.values() for v in ts)
        return [h for h, ts in recent.items()
                if statistics.median(ts) > self.factor * med]

    def action_for(self, host: str) -> str:
        if host not in self.stragglers():
            return "none"
        return {"observe": "log", "skip_batch": "skip_batch", "evict": "evict"}[self.policy]

    def report(self) -> dict:
        out = {}
        for h, ts in self.times.items():
            out[h] = {
                "n": len(ts),
                "median_s": statistics.median(ts),
                "p_max_s": max(ts),
            }
        out["stragglers"] = self.stragglers()
        return out
