"""Table/column schemas for lakeformat.

Port copy of `repro.lakeformat.schema`, kept in step with it so both packages read
and write the same bytes; the port never imports the JAX package.

Strings are dictionary-mapped to int32 codes at the schema layer (the
per-file string dictionary lives in the footer); on-device predicates on
string columns become integer code comparisons, as in real columnar engines.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ColumnSchema:
    name: str
    dtype: str  # 'int32' | 'float32' | 'str'
    encoding: str = "auto"  # encoding hint: auto|plain|bitpack|dict|rle|delta

    @property
    def storage_dtype(self) -> str:
        return "int32" if self.dtype == "str" else self.dtype


@dataclasses.dataclass
class TableSchema:
    name: str
    columns: List[ColumnSchema]

    def __post_init__(self):
        self._by_name = {c.name: c for c in self.columns}

    def column(self, name: str) -> ColumnSchema:
        return self._by_name[name]

    def names(self) -> List[str]:
        return [c.name for c in self.columns]


def strings_to_codes(values, existing: Optional[Dict[str, int]] = None):
    """Map an array/list of strings to int32 codes + the dictionary (list)."""
    mapping: Dict[str, int] = dict(existing or {})
    codes = np.empty(len(values), dtype=np.int32)
    for i, v in enumerate(values):
        code = mapping.get(v)
        if code is None:
            code = len(mapping)
            mapping[v] = code
        codes[i] = code
    dictionary = [None] * len(mapping)
    for s, c in mapping.items():
        dictionary[c] = s
    return codes, dictionary
