"""lakeformat: the columnar storage substrate ("Parquet" analog), port copy.

The port keeps its own copy of the numpy-only file format so that it never
imports the JAX package; the writer produces byte-identical files from the
same inputs, and `from_numpy_column` carries an encoded page read by either
package's reader into this package's types.
"""

from __future__ import annotations

import numpy as np

from repro_torch.lakeformat.encodings import (  # noqa: F401
    LANES,
    PACK_BLOCK,
    RLE_OUT_BLOCK,
    RLE_WINDOW,
    SUBLANES,
    EncodedColumn,
    Encoding,
    bitpack_decode_np,
    bitpack_encode,
    bits_needed,
    decode_column_host,
    encode_column,
)
from repro_torch.lakeformat.reader import LakeReader  # noqa: F401
from repro_torch.lakeformat.schema import ColumnSchema, TableSchema  # noqa: F401
from repro_torch.lakeformat.writer import LakeWriter, write_table  # noqa: F401


def from_numpy_column(col) -> EncodedColumn:
    """An encoded page from either package's reader (or encoder) as this
    package's `EncodedColumn`, with its buffers copied into writable,
    contiguous numpy arrays (the reader's arrays are read-only views of the
    file).  The page's bytes, and so its checksum, are unchanged."""
    return EncodedColumn(
        encoding=Encoding(col.encoding.value),
        n=int(col.n),
        dtype=str(col.dtype),
        k=int(col.k),
        buffers={name: np.array(buf, copy=True, order="C")
                 for name, buf in col.buffers.items()},
    )
