"""core — the datapath offload engine, port of `repro.core`.

plan.py      pushed-down scan plans + predicate algebra
zonemap.py   metadata-only row-group pruning
engine.py    DatapathEngine: decode + filter (sequential or batched) and
             aggregate pushdown on the card, in every offload mode
cache.py     BlockCache, the facade over the datapath's tiered BlockStore
agg.py       host-side partial-aggregate algebra of the pushdown
queries.py   the TPC-H-shaped query suite (Q1, Q6, Q12, Q14, Q15, Q19)
agreement.py when two runs of a query agree (tolerance, Q15's near-tie rule)
tpch.py      synthetic TPC-H-like data generator
"""

from repro_torch.core import agg  # noqa: F401
from repro_torch.core.cache import BlockCache  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    DatapathEngine,
    ResumableScan,
    ScanResult,
    ScanStats,
    group_domain,
)
from repro_torch.core.plan import (  # noqa: F401
    And,
    BloomProbe,
    Cmp,
    InSet,
    Or,
    ScanPlan,
    and_,
    or_,
)
from repro_torch.core.zonemap import prune_row_groups  # noqa: F401
