"""lakeformat binary reader.

Port copy of `repro.lakeformat.reader`, kept in step with it so both packages read
and write the same bytes; the port never imports the JAX package.

The reader never decodes: it hands back `EncodedColumn`s (raw buffers +
metadata).  Decoding is the job of the datapath engine (core/engine.py) —
on-device by default, mirroring the SmartNIC position in the paper.
Zone maps are available without touching data bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.lakeformat.encodings import EncodedColumn, Encoding
from repro_torch.lakeformat.writer import MAGIC


class LakeReader:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        if data[: len(MAGIC)] != MAGIC or data[-len(MAGIC):] != MAGIC:
            raise ValueError(f"{path}: not a lakeformat file")
        (footer_len,) = struct.unpack("<Q", data[-len(MAGIC) - 8 : -len(MAGIC)])
        footer_start = len(data) - len(MAGIC) - 8 - footer_len
        self.footer = json.loads(data[footer_start : footer_start + footer_len])
        self._data = data
        self.n_rows: int = self.footer["n_rows"]
        self.n_row_groups: int = len(self.footer["row_groups"])
        self.column_names: List[str] = [c["name"] for c in self.footer["schema"]["columns"]]
        self.string_dicts: Dict[str, List[str]] = self.footer.get("string_dicts", {})

    # -- metadata ----------------------------------------------------------
    def zonemaps(self, column: str) -> List[dict]:
        return [rg["columns"][column]["zonemap"] for rg in self.footer["row_groups"]]

    def row_group_meta(self, rg: int) -> dict:
        return self.footer["row_groups"][rg]

    def page_checksum_meta(self, rg: int, column: str) -> Optional[int]:
        """Footer checksum for one page, or None on legacy files written
        before the field existed (those pages read back unverified)."""
        cmeta = self.footer["row_groups"][rg]["columns"].get(column)
        if cmeta is None:
            return None
        ck = cmeta.get("checksum")
        return None if ck is None else int(ck)

    def decoded_dtype(self, column: str) -> np.dtype:
        """Dtype of the DECODED device column: float32 columns decode to
        float32, everything else (ints, string codes) to int32.  Lets the
        engine build schema-correct empty results without decoding."""
        for c in self.footer["schema"]["columns"]:
            if c["name"] == column:
                return np.dtype("float32" if c["dtype"] == "float32" else "int32")
        raise KeyError(column)

    def string_code(self, column: str, value: str) -> int:
        """Host-side constant folding: a string predicate constant -> code."""
        try:
            return self.string_dicts[column].index(value)
        except ValueError:
            return -1  # matches nothing

    def encoded_bytes(self, columns: Optional[Sequence[str]] = None) -> int:
        total = 0
        for rg in self.footer["row_groups"]:
            for name, c in rg["columns"].items():
                if columns is None or name in columns:
                    total += c["encoded_bytes"]
        return total

    # -- data --------------------------------------------------------------
    def _buffer(self, meta: dict) -> np.ndarray:
        off, nbytes = meta["offset"], meta["nbytes"]
        dt = np.dtype(meta["dtype"])
        arr = np.frombuffer(self._data, dtype=dt, count=nbytes // dt.itemsize, offset=off)
        return arr.reshape(meta["shape"])

    def read_encoded(self, rg: int, columns: Optional[Sequence[str]] = None) -> Dict[str, EncodedColumn]:
        """Raw encoded column buffers for one row group (zero decode work)."""
        rgmeta = self.footer["row_groups"][rg]
        out = {}
        for name, cmeta in rgmeta["columns"].items():
            if columns is not None and name not in columns:
                continue
            bufs = {bname: self._buffer(bmeta) for bname, bmeta in cmeta["buffers"].items()}
            out[name] = EncodedColumn(
                encoding=Encoding(cmeta["encoding"]),
                n=cmeta["n"],
                dtype=cmeta["dtype"],
                k=cmeta["k"],
                buffers=bufs,
            )
        return out
