"""Calibrated, encoding-aware decode cost model — the WFQ currency mint.

Port of `repro.datapath.costmodel`.  The same public names and the same
pricing, estimation and persistence; what differs is what a table is keyed
by and what calibration times:

  key        The reference keys its tables by `kernels.ops` backend.  The
             port has no backend switch (a kernel call is routed by its
             operand's device), so a table is keyed by what it timed: the
             device type, `"cuda"` (the hand-written kernels) or `"cpu"`
             (their plain versions), or `"host"` (the engine's numpy
             decode baseline, `DatapathEngine(backend="host")`).  A table
             timed under one key never prices another: `load` raises
             KeyError for a missing key, and `active_backend` takes the
             device from the caller and never probes for a card.
  measure    `CostModel.calibrate(backend)` times `ops.bitunpack`,
             `ops.dict_decode`, `ops.delta_decode`, `ops.rle_decode` and
             PLAIN's `ops.device_put` on tensors on that device (on the card:
             the CUDA kernels), synchronizing before and after each timed
             call, after one untimed call that builds the kernel library.
             On the card a kernel's build or launch error propagates: no
             nominal table hides it.  On the CPU (and for `host`) a failed
             calibration falls back to the nominal table, as the
             reference's does.
  estimate   `estimate_row_groups()` prices `engine.decode_footprint`,
             whose aggregate entries follow the port's path (one pass per
             MAX_GROUPS-wide window, core/engine.py).
  unify      `decode_model()` / `pipeline()` hand the same table to netsim.

The process-default model (`set_default_cost_model`) is what a default-
constructed `netsim.DecodeModel` prices with.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.datapath.netsim import (
    INTERPOD_BANDWIDTH_GBPS,
    INTERPOD_LATENCY_US,
    DecodeModel,
    LinkModel,
    PrefetchPipeline,
)

# Decoded-output GB/s per encoding when no calibration is available: the
# reference's table.  Any systematic error is what reconciliation corrects,
# so these need only be sane.
NOMINAL_RATES_GBPS: Dict[str, float] = {
    "plain": 20.0,  # device put of already-decoded bytes
    "rle": 12.0,
    "bitpack": 10.0,
    "dict": 8.0,
    "delta": 6.0,
    # pushed-down aggregate reduction (ops.grouped_agg_batch /
    # ops.fused_agg_batch), priced per processed value byte
    "agg": 8.0,
}

# Fixed per-launch overhead when no calibration is available: zero until
# measured, as in the reference.
NOMINAL_LAUNCH_OVERHEAD_S = 0.0

# The key of a table whose caller names none: the port's entry points run
# on the card unless asked for the CPU.
DEFAULT_BACKEND = "cuda"
BACKENDS = ("cuda", "cpu", "host")


def active_backend(device, backend: str = "auto") -> str:
    """The table key for an engine on `device` with decode `backend`
    ("auto": the device's kernels, "host": the numpy baseline).  Reads the
    device the caller names; never asks whether a card is present."""
    if backend == "host":
        return "host"
    return torch.device(device).type


_DEFAULT_MODEL: Optional["CostModel"] = None


def set_default_cost_model(cm: Optional["CostModel"]) -> Optional["CostModel"]:
    """Install `cm` as the process-default table; returns the previous one."""
    global _DEFAULT_MODEL
    prev, _DEFAULT_MODEL = _DEFAULT_MODEL, cm
    return prev


def default_cost_model() -> "CostModel":
    """The registered process-default model, or a nominal table."""
    return _DEFAULT_MODEL if _DEFAULT_MODEL is not None else CostModel()


@dataclasses.dataclass
class RowGroupCost:
    """One row group's estimated decode price: `nbytes` the engine will
    materialize, `seconds` the estimated device time (including work that
    is processed but never materialized)."""

    nbytes: int
    seconds: float


def _sync(backend: str) -> None:
    if backend == "cuda":
        torch.cuda.synchronize()


def _median_seconds(fn, repeats: int, backend: str) -> float:
    """Median wall seconds of one call of `fn`, synchronizing the card
    before and after each timed call.  One untimed call first: on the card
    the first kernel call builds the kernel library, which must never land
    in a rate."""
    fn()
    _sync(backend)
    times = []
    for _ in range(repeats):
        _sync(backend)
        t0 = time.perf_counter()
        fn()
        _sync(backend)
        times.append(time.perf_counter() - t0)
    times.sort()
    return max(times[len(times) // 2], 1e-9)


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown cost-model backend {backend!r}: one of {BACKENDS}")
    return backend


def _decoders(backend: str, n: int, seed: int):
    """(encoding, decoded values, timed call) for each encoding, with the
    value distributions of the reference's calibration."""
    from repro_torch.kernels import ops
    from repro_torch.lakeformat import encodings as E

    rng = np.random.default_rng(seed)
    host = backend == "host"
    dev = "cpu" if host else backend

    def col(enc, nv, dtype, k=0, **bufs):
        return E.EncodedColumn(enc, nv, dtype, k, bufs)

    out = []
    buf = rng.standard_normal(n).astype(np.float32)
    c = col(E.Encoding.PLAIN, n, "float32", plain=buf)
    out.append(("plain", n, (lambda: E.decode_column_host(c)) if host
                else (lambda: ops.device_put(buf, dev))))

    v = rng.integers(0, 1 << 16, size=n, dtype=np.uint64)
    packed = E.bitpack_encode(v, 16)
    c_bp = col(E.Encoding.BITPACK, n, "int32", 16, packed=packed)
    p = ops.to_tensor(packed, dev)
    out.append(("bitpack", n, (lambda: E.decode_column_host(c_bp)) if host
                else (lambda: ops.bitunpack(p, 16, n))))

    v = rng.choice(np.array([1, 5, 9, 13, 20, 44, 90], dtype=np.int64), size=n)
    b = E.dict_encode(v)
    k_d = int(b.pop("_k")[0])
    c_d = col(E.Encoding.DICT, n, "int32", k_d, **b)
    pk_d = ops.to_tensor(b["packed"], dev)
    d = ops.to_tensor(b["dictionary"].astype(np.int32), dev)
    out.append(("dict", n, (lambda: E.decode_column_host(c_d)) if host
                else (lambda: ops.dict_decode(pk_d, d, k_d, n))))

    v = np.cumsum(rng.integers(0, 16, size=n)).astype(np.int64)
    b = E.delta_encode(v)
    k_z = int(b.pop("_k")[0])
    c_z = col(E.Encoding.DELTA, n, "int32", k_z, **b)
    pk_z = ops.to_tensor(b["packed"], dev)
    bs = ops.to_tensor(b["bases"].astype(np.int32), dev)
    out.append(("delta", n, (lambda: E.decode_column_host(c_z)) if host
                else (lambda: ops.delta_decode(pk_z, bs, k_z, n))))

    # RLE at most 2^17 rows off the card, as the reference's (its plain
    # version expands runs eagerly); the card's kernel takes all n
    nr = n if backend == "cuda" else min(n, 1 << 17)
    v = np.repeat(rng.integers(0, 100, size=max(nr // 64, 1)), 64).astype(np.int32)[:nr]
    b = E.rle_encode(v)
    c_r = col(E.Encoding.RLE, len(v), "int32", **b)
    rv, re_ = ops.to_tensor(b["rle_values"], dev), ops.to_tensor(b["rle_ends"], dev)
    out.append(("rle", len(v), (lambda: E.decode_column_host(c_r)) if host
                else (lambda: ops.rle_decode(rv, re_, len(v)))))
    return out


def measure_rates(backend: str = DEFAULT_BACKEND, n: int = 1 << 18, repeats: int = 3,
                  seed: int = 0, overhead_s: float = 0.0) -> Dict[str, float]:
    """Time each decode path into decoded-output GB/s: the port's
    `kernels.ops` entry points on tensors on `backend`'s device ("cuda":
    the CUDA kernels, "cpu": their plain versions), or the numpy decoders
    for "host".  Raises on any failure.  `overhead_s`, the measured
    per-launch cost, is subtracted from each timed call (floored at 5% of
    it), so the rates price marginal per-byte work."""
    _check_backend(backend)

    def _marginal(t: float) -> float:
        return max(t - overhead_s, t * 0.05)

    rates: Dict[str, float] = {}
    for enc, nv, fn in _decoders(backend, n, seed):
        t = _median_seconds(fn, repeats, backend)
        rates[enc] = nv * 4 / _marginal(t) / 1e9
    return rates


def measure_launch_overhead(backend: str = DEFAULT_BACKEND, repeats: int = 5,
                            seed: int = 0) -> float:
    """Fixed per-launch cost: the median wall time of a one-block decode,
    whose work is negligible next to the launch."""
    from repro_torch.kernels import ops
    from repro_torch.lakeformat import encodings as E

    _check_backend(backend)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 8, size=E.PACK_BLOCK, dtype=np.uint64)
    packed = E.bitpack_encode(v, 8)
    if backend == "host":
        return _median_seconds(lambda: E.bitpack_decode_np(packed, 8, E.PACK_BLOCK),
                               repeats, backend)
    p = ops.to_tensor(packed, backend)
    return _median_seconds(lambda: ops.bitunpack(p, 8), repeats, backend)


class CostModel:
    """Per-encoding decode rates + link parameters, with estimation and
    persistence.  `source` records provenance: 'nominal', 'calibrated', or
    'nominal-fallback' (calibration attempted off the card and failed)."""

    def __init__(
        self,
        rates: Optional[Dict[str, float]] = None,
        source: str = "nominal",
        backend: Optional[str] = None,
        link_bandwidth_gbps: float = 12.5,
        link_latency_us: float = 10.0,
        launch_overhead_s: float = NOMINAL_LAUNCH_OVERHEAD_S,
        interpod_bandwidth_gbps: float = INTERPOD_BANDWIDTH_GBPS,
        interpod_latency_us: float = INTERPOD_LATENCY_US,
        link_source: str = "nominal",
    ):
        self.rates = dict(NOMINAL_RATES_GBPS)
        if rates:
            self.rates.update({k: float(v) for k, v in rates.items() if v and v > 0})
        self.source = source
        # nothing measures the storage link yet: its provenance is kept
        # apart from the kernel rates'
        self.link_source = link_source
        self.backend = backend or DEFAULT_BACKEND
        self.link_bandwidth_gbps = link_bandwidth_gbps
        self.link_latency_us = link_latency_us
        self.launch_overhead_s = max(0.0, float(launch_overhead_s))
        self.interpod_bandwidth_gbps = interpod_bandwidth_gbps
        self.interpod_latency_us = interpod_latency_us

    # -- pricing -----------------------------------------------------------
    def rate_gbps(self, encoding: str = "plain") -> float:
        return self.rates.get(encoding, self.rates["plain"])

    def decode_seconds(self, nbytes: int, encoding: str = "plain") -> float:
        return nbytes / (self.rate_gbps(encoding) * 1e9)

    def launch_seconds(self, n_launches: int) -> float:
        """Fixed cost of `n_launches` kernel launches; zero until calibrated."""
        return n_launches * self.launch_overhead_s

    # -- estimation (footer metadata only) ---------------------------------
    def estimate_row_groups(
        self, engine, reader, plan, row_groups, pred=None
    ) -> List[RowGroupCost]:
        """Per-row-group (materialized bytes, estimated seconds) from
        `engine.decode_footprint`: one launch per footprint entry, which is
        the sequential path's bill (the batched path launches per bucket
        and reconciles against ScanStats.kernel_launches)."""
        out = []
        for fp in engine.decode_footprint(reader, plan, row_groups, pred=pred):
            nbytes = 0
            seconds = 0.0
            for col in fp["columns"].values():
                seconds += (self.decode_seconds(col["nbytes"], col["encoding"])
                            + self.launch_overhead_s)
                if col["materialized"]:
                    nbytes += col["nbytes"]
            out.append(RowGroupCost(nbytes, seconds))
        return out

    # -- netsim unification ------------------------------------------------
    def decode_model(self) -> DecodeModel:
        return DecodeModel(decode_gbps=self.rate_gbps("plain"), rates=dict(self.rates),
                           launch_overhead_s=self.launch_overhead_s)

    def link_model(self) -> LinkModel:
        return LinkModel(bandwidth_gbps=self.link_bandwidth_gbps,
                         latency_us=self.link_latency_us)

    def interpod_link_model(self) -> LinkModel:
        """The pod<->pod hop a fabric peer fetch pays."""
        return LinkModel(bandwidth_gbps=self.interpod_bandwidth_gbps,
                         latency_us=self.interpod_latency_us)

    def peer_fetch_seconds(self, nbytes: int) -> float:
        """One slice's peer-fetched bytes over the inter-pod hop."""
        if nbytes <= 0:
            return 0.0
        return self.interpod_link_model().fetch_seconds(nbytes)

    def pipeline(self) -> PrefetchPipeline:
        return PrefetchPipeline(link=self.link_model(), decode=self.decode_model())

    # -- calibration -------------------------------------------------------
    @classmethod
    def calibrate(cls, backend: str = DEFAULT_BACKEND, n: int = 1 << 18, repeats: int = 3,
                  **kw) -> "CostModel":
        """Measure the launch overhead, then the rates net of it.  On the
        card any failure propagates: a kernel that does not build or launch
        is a fault, not a reason to price with guesses.  Elsewhere a failure
        gives the nominal table (`source='nominal-fallback'`)."""
        _check_backend(backend)
        try:
            overhead = measure_launch_overhead(backend=backend, repeats=max(repeats, 3))
            rates = measure_rates(backend=backend, n=n, repeats=repeats, overhead_s=overhead)
        except Exception:  # noqa: BLE001 — best effort off the card only
            if backend == "cuda":
                raise
            return cls(source="nominal-fallback", backend=backend, **kw)
        return cls(rates=rates, source="calibrated", backend=backend,
                   launch_overhead_s=overhead, **kw)

    # -- persistence -------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "rates_gbps": {k: self.rates[k] for k in sorted(self.rates)},
            "source": self.source,
            "link_source": self.link_source,
            "backend": self.backend,
            "link_bandwidth_gbps": self.link_bandwidth_gbps,
            "link_latency_us": self.link_latency_us,
            "launch_overhead_s": self.launch_overhead_s,
            "interpod_bandwidth_gbps": self.interpod_bandwidth_gbps,
            "interpod_latency_us": self.interpod_latency_us,
        }

    def save(self, path: str) -> str:
        """Write this table under its key, merging into an existing
        per-backend file; a legacy flat file is folded in under its
        recorded key."""
        data: dict = {"format": "per-backend", "backends": {}}
        try:
            with open(path) as f:
                old = json.load(f)
            if isinstance(old.get("backends"), dict):
                data["backends"].update(old["backends"])
            elif "rates_gbps" in old:
                data["backends"][old.get("backend", DEFAULT_BACKEND)] = old
        except (OSError, ValueError):
            pass
        data["backends"][self.backend] = self.to_dict()
        with open(path, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def _from_dict(cls, d: dict) -> "CostModel":
        return cls(
            rates=d.get("rates_gbps"),
            source=d.get("source", "calibrated"),
            link_source=d.get("link_source", "nominal"),
            backend=d.get("backend", DEFAULT_BACKEND),
            link_bandwidth_gbps=d.get("link_bandwidth_gbps", 12.5),
            link_latency_us=d.get("link_latency_us", 10.0),
            launch_overhead_s=d.get("launch_overhead_s", NOMINAL_LAUNCH_OVERHEAD_S),
            interpod_bandwidth_gbps=d.get("interpod_bandwidth_gbps", INTERPOD_BANDWIDTH_GBPS),
            interpod_latency_us=d.get("interpod_latency_us", INTERPOD_LATENCY_US),
        )

    @classmethod
    def load(cls, path: str, backend: Optional[str] = None) -> "CostModel":
        """Load the table for `backend` (default: "cuda") from a
        per-backend file; KeyError when that key has no entry.  Legacy flat
        files load as-is."""
        with open(path) as f:
            d = json.load(f)
        if isinstance(d.get("backends"), dict):
            be = backend or DEFAULT_BACKEND
            entry = d["backends"].get(be)
            if entry is None:
                raise KeyError(f"no calibration for backend {be!r} in {path}")
            return cls._from_dict(entry)
        return cls._from_dict(d)

    @classmethod
    def load_or_nominal(cls, path: Optional[str],
                        backend: Optional[str] = None) -> "CostModel":
        """`load`, degrading to the nominal table on a missing file, corrupt
        JSON or an absent key."""
        if path:
            try:
                return cls.load(path, backend=backend)
            except (OSError, ValueError, KeyError):
                pass
        return cls(backend=backend)


def main(argv=None) -> int:
    """Calibrate (or emit the nominal table), print, persist.

        python -m repro_torch.datapath.costmodel --backend cuda --out calibration.json
    """
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--backend", default=DEFAULT_BACKEND, choices=BACKENDS,
                    help="the table's key: the device timed, or host for the numpy baseline")
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None, help="write/merge the per-backend table as JSON")
    ap.add_argument("--nominal", action="store_true",
                    help="skip measurement, emit the nominal table")
    args = ap.parse_args(argv)
    cm = (CostModel(backend=args.backend) if args.nominal
          else CostModel.calibrate(backend=args.backend, n=args.n, repeats=args.repeats))
    for enc in sorted(cm.rates):
        print(f"costmodel.{enc},{cm.rates[enc]:.3f} GB/s,"
              f"source={cm.source},backend={cm.backend}")
    print(f"costmodel.launch_overhead,{cm.launch_overhead_s * 1e6:.1f} us,"
          f"source={cm.source},backend={cm.backend}")
    if args.out:
        cm.save(args.out)
        print(f"costmodel.saved,{args.out},backend={cm.backend}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
