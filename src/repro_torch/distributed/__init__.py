"""Distributed runtime: sharding rules and the device mesh, the gradient
collectives (`collectives`), the scan fabric's ring and fault-tolerance
policies."""

from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    PodDrainPlan,
    RestartPlan,
    StragglerDetector,
    plan_elastic_mesh,
    plan_pod_drain,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    HashRing,
    ShardingCtx,
    constrain,
    local_ctx,
    rg_key,
    spec_for,
)
