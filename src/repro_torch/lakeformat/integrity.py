"""Page integrity: per-page checksums for lakeformat files.

Port copy of `repro.lakeformat.integrity`, kept in step with it so both packages read
and write the same bytes; the port never imports the JAX package.

The storage->NIC hop is a network hop, and networks corrupt bytes.  The
writer stamps a CRC32 of every encoded page (one column of one row
group) into the footer; the engine verifies it on every storage fetch
(core/engine._storage_read) before the page can reach a decode kernel.
Legacy files whose footers predate the field fall back to UNVERIFIED —
they still read, but bit-rot on them is invisible (telemetry counts the
unverified pages so the operator can see the exposure).

The checksum covers everything a decode kernel consumes: the encoding
tag, row count, dtype, bit width, and every buffer's name, dtype, shape
and raw bytes — so a truncated (short-read) buffer fails exactly like a
flipped bit.  CRC32 (zlib) runs at GB/s on commodity CPUs, which keeps
verification noise against even the calibrated decode rates.

This module lives in lakeformat (not datapath) on purpose: core/engine
may not import the datapath package (package-init import cycle), but it must
be able to verify pages and raise the typed error.  The fault plane
(datapath/faults.py) re-exports `CorruptPageError` for service callers.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from repro_torch.lakeformat.encodings import EncodedColumn


class CorruptPageError(RuntimeError):
    """A fetched page failed checksum verification.  Raised by the engine
    BEFORE the page can reach a decode kernel; the fault plane quarantines
    the page key in the BlockStore and re-fetches."""

    def __init__(self, msg: str, table: str = "", rg: int = -1,
                 column: str = ""):
        super().__init__(msg)
        self.table = table
        self.rg = rg
        self.column = column


def page_checksum(col: EncodedColumn) -> int:
    """CRC32 over one encoded page's metadata + buffer bytes.

    Buffers are folded in sorted-name order so the checksum is a pure
    function of the page's content, independent of dict insertion order.
    """
    crc = zlib.crc32(
        f"{col.encoding.value}|{col.n}|{col.dtype}|{col.k}".encode()
    )
    for name in sorted(col.buffers):
        buf = np.ascontiguousarray(col.buffers[name])
        head = f"|{name}|{buf.dtype}|{buf.shape}".encode()
        crc = zlib.crc32(buf.tobytes(), zlib.crc32(head, crc))
    return crc & 0xFFFFFFFF


def verify_page(col: EncodedColumn, expected: Optional[int]) -> bool:
    """True iff the page matches `expected`.  `expected is None` (legacy
    footer without the field) verifies trivially — the caller decides
    whether to count the page as unverified."""
    if expected is None:
        return True
    return page_checksum(col) == int(expected)
