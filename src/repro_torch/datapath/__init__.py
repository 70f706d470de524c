"""datapath — the SmartNIC as a shared, scheduled, multi-tenant service,
port of `repro.datapath` (ROADMAP.md A.4a and A.4b).

service.py    Pod (née DatapathService): bounded queue, admission control,
              quotas, per-tenant WFQ virtual time + actual-cost
              reconciliation, auto-tuned coalescing hold window; a pod
              built without an engine runs on the card
scheduler.py  fair-share batch formation (wfq/fifo, row-group preemption,
              cross-tick coalescing holds) + shared decode windows +
              batched and cross-request stacked dispatch, reconciled by
              actual kernel launches; a kernel's own failure is never
              parked on a ticket
policy.py     adaptive raw/preloaded/prefiltered/pre-aggregated choice per
              request, hold-window footprint compatibility
faults.py     storage fault plane: deterministic fault schedules
              (FaultPlan), bounded retry/backoff/timeout/hedge
              (RetryPolicy + FaultInjector on the engine's storage-read
              seam), per-target circuit breaker, typed errors
telemetry.py  queue depth, decoded-bytes-saved, per-tenant p50/p99/p99.9,
              Jain index, estimated-vs-actual decode-cost ledger, fault
              ledger, cost-model provenance
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

The fabric (`fabric.py`, `catalog.py`) is not ported yet: its four names
raise NotImplementedError naming ROADMAP.md A.4c.
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
from repro_torch.datapath.faults import (  # noqa: F401
    CircuitBreaker,
    FaultInjector,
    FaultPlan,
    FetchFailed,
    FetchTimeout,
    Overloaded,
    Quarantined,
    RetryPolicy,
    StorageFault,
    TransientFetchError,
)
from repro_torch.datapath.policy import (  # noqa: F401
    AdaptiveOffloadPolicy,
    StaticPolicy,
    coalesce_compatible,
)
from repro_torch.datapath.scheduler import form_batch, run_tick  # noqa: F401
from repro_torch.datapath.service import (  # noqa: F401
    DatapathService,
    Pod,
    QueueFull,
    QuotaExceeded,
    ScanRequest,
    ServiceClient,
    TenantQuota,
    Ticket,
)
from repro_torch.datapath.telemetry import Telemetry, jain_index, quantile  # noqa: F401
from repro_torch.datapath.trace import (  # noqa: F401
    PAPER_FIG2_PCT,
    STAGES,
    FlightRecorder,
    RequestTrace,
    Tracer,
)

FABRIC_ITEM = "A.4c the scan fabric"

# every other public name of `repro.datapath`, by the ROADMAP.md item that
# ports it
LATER = dict.fromkeys(("ScanFabric", "FabricTicket",  # fabric.py
                       "Catalog", "Snapshot"), FABRIC_ITEM)  # catalog.py


def __getattr__(name: str):
    item = LATER.get(name)
    if item is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    raise NotImplementedError(f"repro_torch.datapath.{name} is not ported yet "
                              f"(ROADMAP.md {item})")
