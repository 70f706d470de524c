"""Host-side (numpy) encoders + host decoders for lakeformat encodings.

Port copy of `repro.lakeformat.encodings`, kept in step with it so both packages read
and write the same bytes; the port never imports the JAX package.

The bit layout is co-designed with the TPU decoder (kernels/bitunpack.py):

BITPACK(k), 1 <= k <= 32
------------------------
Values are grouped into blocks of PACK_BLOCK = 4096, viewed as a (32, 128)
matrix in *row-major value order* (value v sits at row s = v // 128,
lane l = v % 128).  Each lane packs its 32 values vertically into exactly
k uint32 words: row s occupies bits [s*k, (s+1)*k) of the lane's 32*k-bit
budget.  Packed block shape: (k, 128) uint32.

The decoder therefore needs, per row s (statically unrolled, 32 rows):
    w0, sh = divmod(s*k, 32)
    val    = packed[w0] >> sh            # vector over 128 lanes
    if sh + k > 32: val |= packed[w0+1] << (32 - sh)
    out[s] = val & ((1 << k) - 1)
-- no gathers, no transposes, per-row-constant shifts: pure VPU work.
This is the FastLanes-style "unified transposed layout" adapted to the
8x128 TPU vector register shape.

RLE
---
Outputs are blocked at RLE_OUT_BLOCK = 1024.  The writer clips runs at
block boundaries so each block is self-contained, and requires
<= RLE_WINDOW = 128 runs per block (else the caller falls back to
BITPACK/DICT).  Per block we store `values[128]` and exclusive
cumulative `ends[128]` (within-block, padded by repeating the final
end=1024).  Decode of one block is a (1024 x 128) one-hot times
(128,) values contraction -- MXU-friendly.

DELTA(k)
--------
Per PACK_BLOCK block: int32 base + zigzag-encoded deltas bitpacked at k
bits.  Decode = bitunpack -> unzigzag -> prefix sum + base.

DICT(k)
-------
`dictionary` (plain values) + BITPACK(k) codes, k = bits(len(dict)).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Optional

import numpy as np

PACK_BLOCK = 4096  # values per bitpack block
LANES = 128
SUBLANES = 32  # PACK_BLOCK == SUBLANES * LANES
RLE_OUT_BLOCK = 1024
RLE_WINDOW = 128

_U32 = np.uint32
_MASK32 = np.uint64(0xFFFFFFFF)


class Encoding(enum.Enum):
    PLAIN = "plain"
    BITPACK = "bitpack"
    DICT = "dict"
    RLE = "rle"
    DELTA = "delta"


@dataclasses.dataclass
class EncodedColumn:
    """One column of one row group, encoded."""

    encoding: Encoding
    n: int  # logical value count
    dtype: str  # logical dtype: 'int32' | 'float32'
    k: int = 0  # bit width for BITPACK/DICT/DELTA
    # Buffers (all numpy, layout per encoding):
    #  BITPACK: packed (nblocks, k, 128) uint32
    #  DICT:    packed codes + dictionary (ndict,) of logical dtype
    #  RLE:     rle_values (nblk, 128) int32/float32, rle_ends (nblk, 128) int32
    #  DELTA:   packed zigzag deltas + bases (nblocks,) int32
    #  PLAIN:   plain (n,) logical dtype
    buffers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def encoded_bytes(self) -> int:
        return sum(int(b.nbytes) for b in self.buffers.values())

    def plain_bytes(self) -> int:
        return self.n * 4


def padded_rows(n: int) -> int:
    """Rows the engine actually materializes for an n-row row group: decode
    output is padded to the PACK_BLOCK boundary (kernel block shape), so
    honest decoded-byte accounting must size L, not n."""
    return -(-n // PACK_BLOCK) * PACK_BLOCK


def bits_needed(max_value: int) -> int:
    """Bits to represent values in [0, max_value]."""
    if max_value <= 0:
        return 1
    return max(1, int(max_value).bit_length())


# ---------------------------------------------------------------------------
# BITPACK
# ---------------------------------------------------------------------------


def _pad_to_blocks(values: np.ndarray) -> np.ndarray:
    n = values.shape[0]
    nblocks = max(1, math.ceil(n / PACK_BLOCK))
    out = np.zeros(nblocks * PACK_BLOCK, dtype=np.uint64)
    out[:n] = values.astype(np.uint64)
    return out.reshape(nblocks, SUBLANES, LANES)


def bitpack_encode(values: np.ndarray, k: int) -> np.ndarray:
    """Pack non-negative ints < 2**k.  Returns (nblocks, k, 128) uint32."""
    assert 1 <= k <= 32, k
    v = _pad_to_blocks(values)
    if np.any(v >= (np.uint64(1) << np.uint64(k))):
        raise ValueError(f"value does not fit in {k} bits")
    nblocks = v.shape[0]
    packed = np.zeros((nblocks, k, LANES), dtype=np.uint64)
    for s in range(SUBLANES):
        off = s * k
        w0, sh = divmod(off, 32)
        acc = v[:, s, :] << np.uint64(sh)
        packed[:, w0, :] |= acc & _MASK32
        if sh + k > 32:
            packed[:, w0 + 1, :] |= acc >> np.uint64(32)
    return packed.astype(_U32)


def bitpack_decode_np(packed: np.ndarray, k: int, n: int) -> np.ndarray:
    """Host decoder (oracle for the jnp/Pallas decoders).  Returns uint32 (n,)."""
    assert packed.ndim == 3 and packed.shape[1] == k and packed.shape[2] == LANES
    p = packed.astype(np.uint64)
    nblocks = p.shape[0]
    mask = (np.uint64(1) << np.uint64(k)) - np.uint64(1)
    rows = np.empty((nblocks, SUBLANES, LANES), dtype=np.uint64)
    for s in range(SUBLANES):
        off = s * k
        w0, sh = divmod(off, 32)
        val = p[:, w0, :] >> np.uint64(sh)
        if sh + k > 32:
            val |= p[:, w0 + 1, :] << np.uint64(32 - sh)
        rows[:, s, :] = val & mask
    return rows.reshape(-1)[:n].astype(_U32)


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------


def _compute_runs(values: np.ndarray):
    """Return (run_values, run_lengths)."""
    n = values.shape[0]
    if n == 0:
        return values[:0], np.zeros(0, dtype=np.int64)
    change = np.nonzero(np.diff(values))[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [n]])
    return values[starts], ends - starts


def rle_encode(values: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Block-aligned RLE.  Returns None if any block exceeds RLE_WINDOW runs."""
    n = values.shape[0]
    nblk = max(1, math.ceil(n / RLE_OUT_BLOCK))
    padded = np.zeros(nblk * RLE_OUT_BLOCK, dtype=values.dtype)
    padded[:n] = values
    if n:
        padded[n:] = values[-1]
    blocks = padded.reshape(nblk, RLE_OUT_BLOCK)
    out_vals = np.zeros((nblk, RLE_WINDOW), dtype=values.dtype)
    out_ends = np.zeros((nblk, RLE_WINDOW), dtype=np.int32)
    for b in range(nblk):
        rv, rl = _compute_runs(blocks[b])
        if rv.shape[0] > RLE_WINDOW:
            return None
        ends = np.cumsum(rl)
        r = rv.shape[0]
        out_vals[b, :r] = rv
        out_ends[b, :r] = ends
        out_vals[b, r:] = rv[-1] if r else 0
        out_ends[b, r:] = RLE_OUT_BLOCK
    return {"rle_values": out_vals, "rle_ends": out_ends}


def rle_decode_np(bufs: Dict[str, np.ndarray], n: int) -> np.ndarray:
    vals, ends = bufs["rle_values"], bufs["rle_ends"]
    nblk = vals.shape[0]
    j = np.arange(RLE_OUT_BLOCK)
    out = np.empty((nblk, RLE_OUT_BLOCK), dtype=vals.dtype)
    for b in range(nblk):
        idx = np.searchsorted(ends[b], j, side="right")
        out[b] = vals[b][np.minimum(idx, RLE_WINDOW - 1)]
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# DELTA
# ---------------------------------------------------------------------------


def _zigzag(d: np.ndarray) -> np.ndarray:
    d = d.astype(np.int64)
    return ((d << 1) ^ (d >> 63)).astype(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    return ((z >> np.uint64(1)).astype(np.int64)) ^ -(z & np.uint64(1)).astype(np.int64)


def delta_encode(values: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Per-block base + zigzag deltas.  Returns None if deltas need > 30 bits."""
    v = values.astype(np.int64)
    n = v.shape[0]
    nblocks = max(1, math.ceil(n / PACK_BLOCK))
    padded = np.zeros(nblocks * PACK_BLOCK, dtype=np.int64)
    padded[:n] = v
    if n:
        padded[n:] = v[-1]
    blocks = padded.reshape(nblocks, PACK_BLOCK)
    bases = blocks[:, 0].astype(np.int64)
    deltas = np.diff(blocks, axis=1, prepend=blocks[:, :1])  # delta[0] == 0
    zz = _zigzag(deltas.reshape(-1))
    kmax = bits_needed(int(zz.max())) if zz.size else 1
    if kmax > 30:
        return None
    packed = bitpack_encode(zz, kmax)
    return {"packed": packed, "bases": bases.astype(np.int64), "_k": np.array([kmax])}


def delta_decode_np(bufs: Dict[str, np.ndarray], k: int, n: int) -> np.ndarray:
    packed, bases = bufs["packed"], bufs["bases"]
    nblocks = packed.shape[0]
    zz = bitpack_decode_np(packed, k, nblocks * PACK_BLOCK)
    deltas = _unzigzag(zz).reshape(nblocks, PACK_BLOCK)
    out = np.cumsum(deltas, axis=1) + bases[:, None]
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# DICT
# ---------------------------------------------------------------------------


def dict_encode(values: np.ndarray, max_dict: int = 1 << 16) -> Optional[Dict[str, np.ndarray]]:
    dictionary, codes = np.unique(values, return_inverse=True)
    if dictionary.shape[0] > max_dict:
        return None
    k = bits_needed(dictionary.shape[0] - 1)
    packed = bitpack_encode(codes.astype(np.uint64), k)
    return {"packed": packed, "dictionary": dictionary, "_k": np.array([k])}


def dict_decode_np(bufs: Dict[str, np.ndarray], k: int, n: int) -> np.ndarray:
    codes = bitpack_decode_np(bufs["packed"], k, n)
    return bufs["dictionary"][codes]


# ---------------------------------------------------------------------------
# Column-level entry points
# ---------------------------------------------------------------------------


def _as_storage_ints(values: np.ndarray) -> np.ndarray:
    """Bit-cast float32 to uint32 so float columns can ride integer encodings."""
    if values.dtype == np.float32:
        return values.view(np.uint32).astype(np.uint64)
    return values.astype(np.int64)


def encode_column(
    values: np.ndarray,
    encoding: Encoding | str = "auto",
    dtype: Optional[str] = None,
) -> EncodedColumn:
    """Encode one column.  'auto' picks, in order: RLE (if runs are long),
    DICT (if low cardinality), DELTA (if sorted-ish ints), BITPACK
    (non-negative ints), PLAIN."""
    n = int(values.shape[0])
    dtype = dtype or ("float32" if values.dtype.kind == "f" else "int32")
    if isinstance(encoding, str) and encoding != "auto":
        encoding = Encoding(encoding)

    def make(enc, k=0, **bufs):
        return EncodedColumn(encoding=enc, n=n, dtype=dtype, k=k, buffers=bufs)

    if encoding == Encoding.PLAIN:
        return make(Encoding.PLAIN, plain=values.astype(dtype))

    if encoding in (Encoding.RLE, "auto") or encoding == "auto":
        pass  # fallthrough logic below

    ints = _as_storage_ints(values)

    if encoding == Encoding.RLE or encoding == "auto":
        # RLE only pays off (and fits the window) with long runs.
        rv, _ = _compute_runs(values)
        if rv.shape[0] * 8 <= n or encoding == Encoding.RLE:
            bufs = rle_encode(values.astype(dtype))
            if bufs is not None:
                return make(Encoding.RLE, **bufs)
            if encoding == Encoding.RLE:
                raise ValueError("RLE window exceeded; use auto")

    if encoding == Encoding.DICT or encoding == "auto":
        card = np.unique(values).shape[0] if n else 0
        if encoding == Encoding.DICT or (card and card <= max(16, n // 4) and card <= (1 << 16)):
            bufs = dict_encode(values)
            if bufs is not None:
                k = int(bufs.pop("_k")[0])
                return make(Encoding.DICT, k=k, **bufs)
            if encoding == Encoding.DICT:
                raise ValueError("dictionary too large")

    if encoding == Encoding.DELTA or encoding == "auto":
        if dtype == "int32":
            is_sortedish = n > 1 and np.mean(np.diff(ints) >= 0) > 0.9
            if encoding == Encoding.DELTA or is_sortedish:
                bufs = delta_encode(ints)
                if bufs is not None:
                    k = int(bufs.pop("_k")[0])
                    return make(Encoding.DELTA, k=k, **bufs)
                if encoding == Encoding.DELTA:
                    raise ValueError("delta overflow")

    if encoding == Encoding.BITPACK or encoding == "auto":
        if dtype == "int32" and n and ints.min() >= 0:
            k = bits_needed(int(ints.max()))
            if k < 32 or encoding == Encoding.BITPACK:
                return make(Encoding.BITPACK, k=k, packed=bitpack_encode(ints, k))
        elif encoding == Encoding.BITPACK:
            raise ValueError("bitpack requires non-negative ints")

    return make(Encoding.PLAIN, plain=values.astype(dtype))


def decode_column_host(col: EncodedColumn) -> np.ndarray:
    """Full host decode (the 'CPU does everything' baseline)."""
    e, n = col.encoding, col.n
    if e == Encoding.PLAIN:
        return col.buffers["plain"][:n]
    if e == Encoding.BITPACK:
        out = bitpack_decode_np(col.buffers["packed"], col.k, n)
        return out.view(np.float32) if col.dtype == "float32" else out.astype(np.int32)
    if e == Encoding.DICT:
        out = dict_decode_np(col.buffers, col.k, n)
        return out.astype(col.dtype) if col.dtype != "float32" else out.astype(np.float32)
    if e == Encoding.RLE:
        return rle_decode_np(col.buffers, n).astype(col.dtype)
    if e == Encoding.DELTA:
        return delta_decode_np(col.buffers, col.k, n).astype(np.int32)
    raise ValueError(e)
