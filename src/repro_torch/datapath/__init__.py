"""datapath — the SmartNIC's storage tiers, cost model and flight recorder,
port of `repro.datapath` (ROADMAP.md A.4a).

blockstore.py unified tiered BlockStore (encoded pages / decoded columns
              / prefiltered results): one byte ledger, cost-aware
              eviction priced by the cost model, window-scoped decode
              pins, the DecodePool shim, the fabric's PeerFetcher
costmodel.py  per-encoding decode rates keyed by the device timed ("cuda",
              "cpu") or "host", calibrated on the port's kernels, and
              decode-seconds estimates from footer metadata
netsim.py     storage->NIC bandwidth/latency model and prefetch overlap
trace.py      flight recorder: per-request span trees, bounded ring,
              Chrome-trace export, decode/filter/rest stage attribution

The rest of `repro.datapath` is not ported yet.  Its names raise
NotImplementedError naming the ROADMAP.md item that brings them: A.4b for
the service (`service.py`, `scheduler.py`, `policy.py`, `faults.py` and
`telemetry.py`), A.4c for the fabric (`fabric.py` and `catalog.py`).
"""

from repro_torch.datapath.blockstore import (  # noqa: F401
    TIERS,
    BlockEntry,
    BlockStore,
    DecodePool,
    PeerFetcher,
    StoreView,
)
from repro_torch.datapath.costmodel import (  # noqa: F401
    NOMINAL_RATES_GBPS,
    CostModel,
    RowGroupCost,
    measure_rates,
)
from repro_torch.datapath.netsim import (  # noqa: F401
    DecodeModel,
    LinkModel,
    PrefetchPipeline,
    SliceClock,
)
from repro_torch.datapath.trace import (  # noqa: F401
    PAPER_FIG2_PCT,
    STAGES,
    FlightRecorder,
    RequestTrace,
    Tracer,
)

SERVICE_ITEM = "A.4b the datapath service"
FABRIC_ITEM = "A.4c the scan fabric"

# every other public name of `repro.datapath`, by the ROADMAP.md item that
# ports it
LATER = {
    **dict.fromkeys((
        "DatapathService", "Pod", "QueueFull", "QuotaExceeded", "ScanRequest",
        "ServiceClient", "TenantQuota", "Ticket",  # service.py
        "form_batch", "run_tick",  # scheduler.py
        "AdaptiveOffloadPolicy", "StaticPolicy", "coalesce_compatible",  # policy.py
        "CircuitBreaker", "FaultInjector", "FaultPlan", "FetchFailed", "FetchTimeout",
        "Overloaded", "Quarantined", "RetryPolicy", "StorageFault",
        "TransientFetchError",  # faults.py
        "Telemetry", "jain_index", "quantile",  # telemetry.py
    ), SERVICE_ITEM),
    **dict.fromkeys(("ScanFabric", "FabricTicket",  # fabric.py
                     "Catalog", "Snapshot"), FABRIC_ITEM),  # catalog.py
}


def __getattr__(name: str):
    item = LATER.get(name)
    if item is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    raise NotImplementedError(f"repro_torch.datapath.{name} is not ported yet "
                              f"(ROADMAP.md {item})")
