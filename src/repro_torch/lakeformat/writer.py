"""lakeformat binary writer.

Port copy of `repro.lakeformat.writer`, kept in step with it so both packages read
and write the same bytes; the port never imports the JAX package.

File layout (little-endian):

    [ magic b'LAKE1\\0\\0\\0' ]
    [ buffer blob 0 ][ pad to 64B ] [ buffer blob 1 ] ...
    [ footer: JSON utf-8 ]
    [ footer_len: uint64 ][ magic ]

The JSON footer holds the schema, per-row-group encodings, buffer offsets
and dtypes, zone maps (min/max/count per column per row group), and string
dictionaries.  Buffers are raw C-order bytes.  All metadata needed for
pruning lives in the footer so pruning never touches data bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.lakeformat.encodings import EncodedColumn, Encoding, encode_column
from repro_torch.lakeformat.integrity import page_checksum
from repro_torch.lakeformat.schema import ColumnSchema, TableSchema, strings_to_codes

MAGIC = b"LAKE1\0\0\0"
ALIGN = 64
DEFAULT_ROW_GROUP = 65536


# Equi-width value histogram bins per row-group zone map.  16 keeps the
# footer entry tiny (16 ints) while letting the offload policy see value
# skew inside a row group instead of assuming uniform-over-[min,max] —
# a clustered column's narrow range predicate estimates near-0 or near-1
# per group rather than a flat width ratio (core/zonemap._frac_true).
ZONE_HIST_BINS = 16


def _zone_map(values: np.ndarray):
    if values.size == 0:
        return {"min": 0, "max": 0, "count": 0}
    is_f = values.dtype.kind == "f"
    lo, hi = values.min(), values.max()
    zm = {
        "min": float(lo) if is_f else int(lo),
        "max": float(hi) if is_f else int(hi),
        "count": int(values.shape[0]),
    }
    if hi > lo:
        counts, _ = np.histogram(values, bins=ZONE_HIST_BINS,
                                 range=(float(lo), float(hi)))
        zm["hist"] = [int(c) for c in counts]
    return zm


class LakeWriter:
    def __init__(self, path: str, schema: TableSchema, row_group_size: int = DEFAULT_ROW_GROUP):
        self.path = path
        self.schema = schema
        self.row_group_size = row_group_size
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._offset = len(MAGIC)
        self._row_groups: List[dict] = []
        self._string_dicts: Dict[str, List[str]] = {}
        self._string_maps: Dict[str, Dict[str, int]] = {}
        self._n_rows = 0

    # -- buffers ----------------------------------------------------------
    def _write_buffer(self, arr: np.ndarray) -> dict:
        pad = (-self._offset) % ALIGN
        if pad:
            self._f.write(b"\0" * pad)
            self._offset += pad
        raw = np.ascontiguousarray(arr).tobytes()
        off = self._offset
        self._f.write(raw)
        self._offset += len(raw)
        return {"offset": off, "nbytes": len(raw), "dtype": str(arr.dtype), "shape": list(arr.shape)}

    # -- row groups -------------------------------------------------------
    def write_row_group(self, columns: Dict[str, np.ndarray]):
        """columns: name -> 1-D numpy array (or list of str for str columns)."""
        n = None
        meta_cols = {}
        for cs in self.schema.columns:
            vals = columns[cs.name]
            if cs.dtype == "str":
                codes, dictionary = strings_to_codes(vals, self._string_maps.get(cs.name))
                self._string_maps[cs.name] = {s: i for i, s in enumerate(dictionary)}
                self._string_dicts[cs.name] = dictionary
                vals = codes
            vals = np.asarray(vals)
            if n is None:
                n = vals.shape[0]
            assert vals.shape[0] == n, f"ragged row group at {cs.name}"
            enc = encode_column(vals, cs.encoding, dtype=cs.storage_dtype)
            bufmeta = {name: self._write_buffer(buf) for name, buf in enc.buffers.items()}
            meta_cols[cs.name] = {
                "encoding": enc.encoding.value,
                "n": enc.n,
                "dtype": enc.dtype,
                "k": enc.k,
                "buffers": bufmeta,
                "zonemap": _zone_map(vals),
                "encoded_bytes": enc.encoded_bytes(),
                # Per-page CRC32 over the encoded buffers; verified by the
                # engine on every storage fetch.  Footers that predate this
                # field read back as unverified (reader returns None).
                "checksum": page_checksum(enc),
            }
        self._row_groups.append({"n": n, "columns": meta_cols})
        self._n_rows += int(n or 0)

    # -- finish -----------------------------------------------------------
    def close(self):
        footer = {
            "schema": {
                "name": self.schema.name,
                "columns": [
                    {"name": c.name, "dtype": c.dtype, "encoding": c.encoding}
                    for c in self.schema.columns
                ],
            },
            "row_groups": self._row_groups,
            "string_dicts": self._string_dicts,
            "n_rows": self._n_rows,
            "row_group_size": self.row_group_size,
        }
        blob = json.dumps(footer).encode("utf-8")
        self._f.write(blob)
        self._f.write(struct.pack("<Q", len(blob)))
        self._f.write(MAGIC)
        self._f.close()


def write_table(
    path: str,
    schema: TableSchema,
    columns: Dict[str, Sequence],
    row_group_size: int = DEFAULT_ROW_GROUP,
) -> str:
    """Write a whole table dict at once, splitting into row groups."""
    w = LakeWriter(path, schema, row_group_size)
    first = columns[schema.columns[0].name]
    n = len(first)
    for start in range(0, max(n, 1), row_group_size):
        stop = min(start + row_group_size, n)
        if stop <= start:
            break
        rg = {}
        for cs in schema.columns:
            col = columns[cs.name]
            rg[cs.name] = col[start:stop] if not isinstance(col, np.ndarray) else col[start:stop]
        w.write_row_group(rg)
    w.close()
    return path
