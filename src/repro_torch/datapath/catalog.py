"""Catalog — the fabric's shared table registry with snapshot isolation.

Every pod in a ScanFabric resolves table names through ONE catalog, so
the fleet agrees on what "table t" means.  Mutations (register / drop)
bump a monotonic global version and copy-on-write the name->reader map;
a scan pins the version current at submission (`pin()`) and keeps
reading that immutable view for its whole lifetime — a mid-scan
re-registration is invisible to in-flight scans and visible to every
scan submitted after it.  That is snapshot isolation, not serializable
DDL: two concurrent registrations last-write-win on the name, which is
exactly the lake-catalog semantic the paper's appliance sits under.

Pins are bookkeeping only (no locks, nothing is copied at pin time):
`release()` retires the pin so `pinned_versions()` reports what any
compaction / vacuum job must still keep readable.

Port of `repro.datapath.catalog`, line for line: it holds readers and
counts pins, and touches no tensor.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """An immutable view of the catalog at one version.  The `tables`
    dict is never mutated after the snapshot is taken (the catalog
    copies on write), so readers resolved through it stay valid no
    matter what the live catalog does."""

    version: int
    tables: Dict[str, object]

    def table(self, name: str):
        try:
            return self.tables[name]
        except KeyError:
            raise KeyError(
                f"table {name!r} not in catalog snapshot v{self.version} "
                f"(has: {sorted(self.tables)})"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self.tables


class Catalog:
    def __init__(self):
        self._tables: Dict[str, object] = {}
        self._version = 0
        # version -> live pin count; pins retire via release()
        self._pins: Dict[int, int] = collections.Counter()

    @property
    def version(self) -> int:
        return self._version

    # -- mutations (copy-on-write; each bumps the global version) --------
    def register(self, name: str, reader) -> int:
        """Bind `name` to `reader` (new table or replacement — lake
        commits swap the manifest the same way).  Returns the new
        catalog version."""
        tables = dict(self._tables)
        tables[name] = reader
        self._tables = tables
        self._version += 1
        return self._version

    def drop(self, name: str) -> int:
        if name not in self._tables:
            raise KeyError(f"table {name!r} not in catalog")
        tables = dict(self._tables)
        del tables[name]
        self._tables = tables
        self._version += 1
        return self._version

    # -- reads -----------------------------------------------------------
    def resolve(self, name: str):
        """The LATEST reader for `name` — admission-time resolution.
        In-flight scans must use their pinned snapshot instead."""
        try:
            return self._tables[name]
        except KeyError:
            raise KeyError(f"table {name!r} not in catalog "
                           f"(has: {sorted(self._tables)})") from None

    def tables(self) -> List[str]:
        return sorted(self._tables)

    # -- snapshot pins ---------------------------------------------------
    def pin(self) -> Snapshot:
        """Pin the current version for one scan.  O(1): the returned
        Snapshot aliases the current copy-on-write map."""
        self._pins[self._version] += 1
        return Snapshot(self._version, self._tables)

    def release(self, snap: Optional[Snapshot]) -> None:
        """Retire one pin (idempotent for None, strict otherwise)."""
        if snap is None:
            return
        n = self._pins.get(snap.version, 0)
        if n <= 0:
            raise RuntimeError(f"catalog version {snap.version} has no live pins")
        if n == 1:
            del self._pins[snap.version]
        else:
            self._pins[snap.version] = n - 1

    def pinned_versions(self) -> List[int]:
        """Versions still readable by an in-flight scan — the floor any
        vacuum/compaction job must respect."""
        return sorted(self._pins)
