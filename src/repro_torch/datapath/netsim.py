"""Storage->NIC hop model: bandwidth/latency + double-buffered prefetch.

Port copy of `repro.datapath.netsim` (stdlib only), kept in step with it; a
default-constructed `DecodeModel` reads the port's process-default cost
model (`repro_torch.datapath.costmodel`).

The SmartNIC sits between disaggregated storage and the host, so every
scan pays a network fetch for its encoded bytes before it can decode.
`LinkModel` is the per-transfer cost model; `PrefetchPipeline` simulates
the double-buffered overlap the device uses — while row group i decodes,
row group i+1 is in flight — the two-slot double buffering a decode
kernel uses for its own loads, one level up.

This is a simulated clock (no sleeping): the scheduler feeds it the real
encoded/decoded byte counts per row group and records the modeled
serial vs overlapped times in telemetry, which is what lets a CPU-only
container still reproduce the paper's "fetch hides behind decode" claim.

Block-store hits never enter the pipeline: a row group served from the
unified store (decoded tier, window-pinned decodes, or encoded pages)
pulls zero bytes over the storage->NIC hop, and the scheduler feeds this
model only the row groups whose slice actually fetched — at row-group
granularity, so one resident group in a multi-group slice is not billed
for its neighbors' transfers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class LinkModel:
    """One storage->NIC link.  Defaults: ~100 GbE, 10us one-way latency."""

    bandwidth_gbps: float = 12.5  # gigaBYTES/s (100 Gbit/s)
    latency_us: float = 10.0

    def fetch_seconds(self, nbytes: int) -> float:
        return self.latency_us * 1e-6 + nbytes / (self.bandwidth_gbps * 1e9)


# Inter-pod hop (fabric peer block-store fetch): pods share a rack-local
# switch, so pod<->pod transfers run wider and shallower than the
# storage->NIC hop (400 GbE-class, ~2us).  Pulling a row group from a
# peer's tier is therefore strictly cheaper than re-fetching it from
# disaggregated storage at ANY size — and a peer's DECODED tier also
# skips the decode entirely.  costmodel.CostModel persists these per
# backend next to the storage-link parameters.
INTERPOD_BANDWIDTH_GBPS = 50.0
INTERPOD_LATENCY_US = 2.0


def interpod_link(bandwidth_gbps: float = INTERPOD_BANDWIDTH_GBPS,
                  latency_us: float = INTERPOD_LATENCY_US) -> LinkModel:
    """The pod<->pod hop the ScanFabric prices peer fetches with."""
    return LinkModel(bandwidth_gbps=bandwidth_gbps, latency_us=latency_us)


@dataclasses.dataclass
class DecodeModel:
    """On-device decode rate in decoded-output gigabytes/s.

    `rates` is an optional per-encoding table (plain/bitpack/dict/delta/
    rle -> GB/s) — the calibrated table from datapath/costmodel.py — so
    the prefetch simulation prices an RLE row group differently from
    PLAIN.  Encodings absent from the table (and encoding=None callers)
    fall back to the scalar `decode_gbps`.  `launch_overhead_s` is the
    calibrated fixed cost per kernel dispatch (costmodel's per-launch
    term): the sequential scan pays it once per (row group, column), the
    batched scan once per bucket — pass `launches` to bill it.

    A DEFAULT-constructed model resolves every field from the
    process-default cost model's per-backend table (costmodel.
    default_cost_model — the one DatapathService registers), NOT from a
    stale module-level constant: after calibration, the simulated
    fetch/decode overlap and what the scheduler charges come from ONE
    table.  Passing `decode_gbps` explicitly keeps the old scalar-model
    semantics (rates stays None unless given)."""

    decode_gbps: Optional[float] = None
    rates: Optional[Dict[str, float]] = None
    launch_overhead_s: Optional[float] = None

    def __post_init__(self):
        if self.decode_gbps is None:
            from repro_torch.datapath import costmodel as _cm  # avoid import cycle

            cm = _cm.default_cost_model()
            self.decode_gbps = cm.rate_gbps("plain")
            if self.rates is None:
                self.rates = dict(cm.rates)
            if self.launch_overhead_s is None:
                self.launch_overhead_s = cm.launch_overhead_s
        elif self.launch_overhead_s is None:
            self.launch_overhead_s = 0.0

    def rate_gbps(self, encoding: Optional[str] = None) -> float:
        if encoding is not None and self.rates:
            return self.rates.get(encoding, self.decode_gbps)
        return self.decode_gbps

    def decode_seconds(self, nbytes: int, encoding: Optional[str] = None,
                       launches: int = 0) -> float:
        return (nbytes / (self.rate_gbps(encoding) * 1e9)
                + launches * self.launch_overhead_s)


class SliceClock:
    """Streaming fetch/decode pipeline clock across DISPATCH SLICES — the
    batched scan loop's simulated steady state.

    The stateless `PrefetchPipeline.simulate` models overlap only within
    one call, but the batched scheduler dispatches one slice per tick: the
    next slice's storage->NIC fetch is issued while this slice's bucketed
    batch decode still runs, ACROSS the tick boundary.  This clock carries
    that state: `feed(nbytes, decode_seconds)` starts the slice's fetch as
    soon as the link is free and its decode when both the fetch has landed
    and the device is free.  `serial_s` / `overlapped_s` / `saved_s` are
    cumulative over the whole run — saved_s is exactly the fetch time the
    pipelining hid."""

    def __init__(self, link: Optional[LinkModel] = None):
        self.link = link or LinkModel()
        self.link_free = 0.0  # when the storage->NIC link is next free
        self.device_free = 0.0  # when the decoder is next free
        self.serial_s = 0.0
        self.slices = 0

    def feed(self, nbytes: int, decode_seconds: float,
             extra_fetch_s: float = 0.0) -> Dict[str, float]:
        """Advance the clock by one slice; returns that slice's fetch
        anatomy so the flight recorder can show hidden-vs-exposed fetch
        time PER SLICE: `exposed_s` is how long the decoder actually
        stalled waiting for this slice's fetch to land (including link
        backlog), `hidden_s` the part of the transfer that overlapped
        earlier decode work.  `extra_fetch_s` is fault-plane time the
        slice's fetch additionally occupied the link with (retries,
        backoff, latency spikes, hedge exposure — ScanStats.fault_wait_s
        deltas from datapath/faults.py), so chaos runs show their tail in
        the same anatomy."""
        fetch_s = self.link.fetch_seconds(nbytes) if nbytes > 0 else 0.0
        fetch_s += max(0.0, float(extra_fetch_s))
        fetch_done = self.link_free + fetch_s
        start = max(fetch_done, self.device_free)
        exposed = max(0.0, fetch_done - self.device_free)
        self.device_free = start + decode_seconds
        self.link_free = fetch_done  # the next slice's fetch follows at once
        self.serial_s += fetch_s + decode_seconds
        self.slices += 1
        return {
            "fetch_s": fetch_s,
            "decode_s": decode_seconds,
            "exposed_s": exposed,
            "hidden_s": max(0.0, fetch_s - exposed),
            "start_s": start,
            "done_s": self.device_free,
        }

    @property
    def overlapped_s(self) -> float:
        return max(self.device_free, self.link_free)

    @property
    def saved_s(self) -> float:
        return max(0.0, self.serial_s - self.overlapped_s)


class PrefetchPipeline:
    """Two-slot fetch/decode overlap over a sequence of transfer units.

    serial     = sum(fetch_i) + sum(decode_i)
    overlapped = fetch_0 + sum_i max(fetch_{i+1}, decode_i) + decode_last

    The unit granularity is the caller's: the sequential scheduler feeds
    one unit per ROW GROUP (fetch of group i+1 hides behind its neighbor's
    decode); the batched scheduler feeds one unit per DISPATCH SLICE, so
    the next slice's whole fetch hides behind this slice's bucketed batch
    decode — fetch and decode pipeline instead of alternating.
    """

    def __init__(self, link: LinkModel = None, decode: DecodeModel = None):
        self.link = link or LinkModel()
        self.decode = decode or DecodeModel()

    def simulate(
        self,
        encoded_bytes: Sequence[int],
        decoded_bytes: Sequence[int],
        decode_seconds: Optional[Sequence[float]] = None,
    ) -> Dict[str, float]:
        """`decode_seconds` (one entry per row group) overrides the scalar
        decode-rate model — the scheduler passes per-group times computed
        by the encoding-aware cost model, so the overlap simulation and the
        WFQ charge come from one table."""
        assert len(encoded_bytes) == len(decoded_bytes)
        if decode_seconds is not None:
            assert len(decode_seconds) == len(encoded_bytes)
        if not encoded_bytes:
            return {"serial_s": 0.0, "overlapped_s": 0.0, "saved_s": 0.0, "overlap_pct": 0.0}
        fetch: List[float] = [self.link.fetch_seconds(b) for b in encoded_bytes]
        dec: List[float] = (
            [float(s) for s in decode_seconds]
            if decode_seconds is not None
            else [self.decode.decode_seconds(b) for b in decoded_bytes]
        )
        serial = sum(fetch) + sum(dec)
        overlapped = fetch[0]
        for i in range(len(fetch) - 1):
            overlapped += max(fetch[i + 1], dec[i])
        overlapped += dec[-1]
        saved = serial - overlapped
        return {
            "serial_s": serial,
            "overlapped_s": overlapped,
            "saved_s": saved,
            "overlap_pct": 100.0 * saved / serial if serial > 0 else 0.0,
        }
