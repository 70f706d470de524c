"""CSV / JSON-lines writers and host parsers: the paper's slow baselines.

Port copy of `repro/lakeformat/textformat.py`, kept in step with it so both
packages write the same bytes and parse them to the same columns; the port
never imports the JAX package.

The paper (Fig. 3a) measures TPC-H directly on CSV and JSON at 14-16x lower
throughput than Parquet.  These parsers are deliberately the straightforward
host implementations (split/str->number conversion per field), because the
point being reproduced is that text parsing is serial, branchy CPU work:
the card never sees text.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.lakeformat.schema import TableSchema, strings_to_codes


def write_csv(path: str, schema: TableSchema, columns: Dict[str, Sequence]) -> str:
    names = schema.names()
    n = len(columns[names[0]])
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for i in range(n):
            row = []
            for cs in schema.columns:
                v = columns[cs.name][i]
                if cs.dtype == "float32":
                    row.append(f"{float(v):.6f}")
                elif cs.dtype == "str":
                    row.append(str(v))
                else:
                    row.append(str(int(v)))
            f.write(",".join(row) + "\n")
    return path


def write_jsonl(path: str, schema: TableSchema, columns: Dict[str, Sequence]) -> str:
    names = schema.names()
    n = len(columns[names[0]])
    with open(path, "w") as f:
        for i in range(n):
            rec = {}
            for cs in schema.columns:
                v = columns[cs.name][i]
                if cs.dtype == "float32":
                    rec[cs.name] = float(v)
                elif cs.dtype == "str":
                    rec[cs.name] = str(v)
                else:
                    rec[cs.name] = int(v)
            f.write(json.dumps(rec) + "\n")
    return path


def parse_csv(path: str, schema: TableSchema) -> Dict[str, np.ndarray]:
    """Straightforward per-field CSV parse (quote-free dialect)."""
    cols: Dict[str, List] = {c.name: [] for c in schema.columns}
    with open(path) as f:
        header = f.readline().rstrip("\n").split(",")
        idx = {name: header.index(name) for name in cols}
        for line in f:
            parts = line.rstrip("\n").split(",")
            for cs in schema.columns:
                raw = parts[idx[cs.name]]
                if cs.dtype == "float32":
                    cols[cs.name].append(float(raw))
                elif cs.dtype == "str":
                    cols[cs.name].append(raw)
                else:
                    cols[cs.name].append(int(raw))
    return _finalize(schema, cols)


def parse_jsonl(path: str, schema: TableSchema) -> Dict[str, np.ndarray]:
    cols: Dict[str, List] = {c.name: [] for c in schema.columns}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            for cs in schema.columns:
                cols[cs.name].append(rec[cs.name])
    return _finalize(schema, cols)


def _finalize(schema: TableSchema, cols: Dict[str, List]) -> Dict[str, np.ndarray]:
    """Parsed fields as column arrays: strings as their int32 codes in order
    of first appearance, floats as float32, the rest as int32."""
    out = {}
    for cs in schema.columns:
        if cs.dtype == "str":
            codes, _ = strings_to_codes(cols[cs.name])
            out[cs.name] = codes
        elif cs.dtype == "float32":
            out[cs.name] = np.asarray(cols[cs.name], dtype=np.float32)
        else:
            out[cs.name] = np.asarray(cols[cs.name], dtype=np.int32)
    return out
