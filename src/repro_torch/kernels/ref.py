"""Plain PyTorch versions of the port's kernels: the semantic ground truth.

Each function transcribes the function of the same name in
`repro/kernels/ref.py` op for op.  The CPU path runs them (a CPU tensor is
the only thing that routes here, `kernels/ops.py`), the tests hold them
bit-exact against the JAX reference, and `chip_smoke.py` holds each CUDA
kernel bit-exact against them on the card.

Packed words are int32 views of the file's uint32 words: torch's CPU shift
ops are missing for uint32, so every shift here is on int32 and arithmetic
right shifts are masked back to logical ones.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.lakeformat.encodings import (
    LANES,
    PACK_BLOCK,
    RLE_OUT_BLOCK,
    RLE_WINDOW,
    SUBLANES,
)


def _check(packed: torch.Tensor, k: int) -> None:
    assert packed.dim() == 3 and packed.shape[1] == k and packed.shape[2] == LANES, (
        tuple(packed.shape), k)
    assert packed.dtype == torch.int32, packed.dtype


def _srl(x: torch.Tensor, sh: int) -> torch.Tensor:
    """Logical right shift of int32 words (arithmetic shift, then mask)."""
    return x if sh == 0 else (x >> sh) & ((1 << (32 - sh)) - 1)


# ---------------------------------------------------------------------------
# bitunpack
# ---------------------------------------------------------------------------


def bitunpack(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 words -> (nblocks, 32, 128) int32 values.

    Row s of lane l is bits [s*k, s*k + k) of the lane's k words; k = 32
    passes the words through (values >= 2^31 come out negative)."""
    _check(packed, k)
    nb = packed.shape[0]
    if k == 32:
        return packed.reshape(nb, SUBLANES, LANES).clone()
    mask = (1 << k) - 1
    rows = []
    for s in range(SUBLANES):
        w0, sh = divmod(s * k, 32)
        val = _srl(packed[:, w0, :], sh)
        if sh + k > 32:
            val = val | (packed[:, w0 + 1, :] << (32 - sh))
        rows.append(val & mask)
    return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# dict decode
# ---------------------------------------------------------------------------


def dict_decode(packed: torch.Tensor, dictionary: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) codes + (D,) dictionary -> (nblocks, 32, 128)
    values; codes clip to [0, D-1] (jnp.take mode="clip")."""
    codes = bitunpack(packed, k).clamp(0, dictionary.shape[0] - 1)
    return dictionary.index_select(0, codes.reshape(-1)).reshape(codes.shape)


# ---------------------------------------------------------------------------
# rle decode
# ---------------------------------------------------------------------------


def rle_decode(values: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """(nblk, 128) run values + (nblk, 128) exclusive cumulative ends ->
    (nblk, 1024) values of the runs' dtype.

    Position j takes run rank(j) = |{r : ends[r] <= j}|, found by an
    upper-bound search over the block's nondecreasing ends (the writer's
    invariant) and clipped to the window, so the writer's padding runs
    (end = 1024, the final value repeated) re-read that value."""
    e = ends.to(torch.int32).contiguous()
    j = torch.arange(RLE_OUT_BLOCK, dtype=torch.int32, device=e.device)
    rank = torch.searchsorted(e, j.expand(e.shape[0], RLE_OUT_BLOCK).contiguous(), right=True)
    idx = rank.clamp(max=RLE_WINDOW - 1)
    return torch.gather(values, 1, idx)


# ---------------------------------------------------------------------------
# delta decode
# ---------------------------------------------------------------------------


def _unzigzag_i32(z: torch.Tensor) -> torch.Tensor:
    return _srl(z, 1) ^ -(z & 1)


def delta_decode(packed: torch.Tensor, bases: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) zigzag deltas + (nblocks,) bases -> (nblocks, 4096)
    int32, the inclusive prefix sum in value order v = s*128 + l plus the
    block's base, wrapping mod 2^32 as int32 does.

    torch's cumsum of int32 accumulates in int64, so the sums are taken in
    int64 (exact) and cast back once, which wraps to the same int32."""
    d = _unzigzag_i32(bitunpack(packed, k)).to(torch.int64)
    lane_cs = torch.cumsum(d, dim=2)  # within-row prefix
    row_tot = lane_cs[:, :, -1]  # (nb, 32)
    row_carry = torch.cumsum(row_tot, dim=1) - row_tot  # exclusive
    out = lane_cs + row_carry[:, :, None] + bases.to(torch.int64)[:, None, None]
    return out.to(torch.int32).reshape(packed.shape[0], PACK_BLOCK)


# ---------------------------------------------------------------------------
# stream compaction
# ---------------------------------------------------------------------------


def filter_compact(values: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block stable compaction: values (nblk, B) of any dtype, mask
    (nblk, B) bool -> (survivors packed to the front of each block, zeros
    after them; counts (nblk,) int32).

    Each survivor is scattered to its slot cumsum(mask) - 1; the rest go to
    a spare column that is cut off.  Exact for every dtype.  The reference
    computes the same permutation as an f32 one-hot contraction, which
    equals this on finite values other than -0.0 (ROADMAP.md C)."""
    nblk, width = values.shape
    pos = torch.cumsum(mask, dim=1) - 1
    slot = torch.where(mask, pos, width)
    out = torch.zeros((nblk, width + 1), dtype=values.dtype, device=values.device)
    out.scatter_(1, slot, values)
    return out[:, :width].contiguous(), mask.sum(dim=1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# bloom filter: murmur-style double hashing over a byte-per-bit filter
# ---------------------------------------------------------------------------
#
# The reference hashes in uint32.  torch's CPU has no uint32 shifts, so the
# words live in int64 in [0, 2^32): shifts are then logical, and a product
# mod 2^32 is taken in 16-bit halves (_mul32) so no int64 product overflows.

_U32 = 0xFFFFFFFF
_BLOOM_C1 = 0xCC9E2D51
_BLOOM_C2 = 0x1B873593


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): both partial products
    stay below 2^49."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _U32


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bloom_hashes(keys: torch.Tensor, n_hashes: int, n_bits: int) -> List[torch.Tensor]:
    """Double hashing: idx_i = (h1 + i*h2) mod n_bits, n_bits a power of two.
    Keys are int32 read as uint32; the indices are int64."""
    ku = keys.to(torch.int64) & _U32
    h1 = _mix(_mul32(ku, _BLOOM_C1))
    h2 = _mix(_mul32(ku, _BLOOM_C2)) | 1
    mod = n_bits - 1
    return [(h1 + i * h2) & mod for i in range(n_hashes)]


def bloom_build(keys: torch.Tensor, n_bits: int, n_hashes: int = 4) -> torch.Tensor:
    """(n_bits,) uint8 filter, one byte per bit, on the keys' device."""
    bits = torch.zeros((n_bits,), dtype=torch.uint8, device=keys.device)
    for idx in bloom_hashes(keys, n_hashes, n_bits):
        bits.index_fill_(0, idx.reshape(-1), 1)
    return bits


def bloom_probe(keys: torch.Tensor, bits: torch.Tensor, n_hashes: int = 4) -> torch.Tensor:
    """Membership mask of the keys' shape (bool; no false negatives)."""
    out = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    for idx in bloom_hashes(keys, n_hashes, bits.shape[0]):
        out = out & (bits.index_select(0, idx.reshape(-1)).reshape(keys.shape) > 0)
    return out


# ---------------------------------------------------------------------------
# fused scan: decode (bitpack|dict) -> range predicate -> mask + counts
# ---------------------------------------------------------------------------


def fused_scan(
    packed: torch.Tensor,
    k: int,
    lo,
    hi,
    dictionary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode one filter column and evaluate lo <= v <= hi in one pass.

    Returns (mask (nblocks, 4096) bool, per-block survivor counts (nblocks,)
    int32).  The bounds are int32 and compare in the decoded values' dtype,
    as `lo.astype(vals.dtype)` does in the reference."""
    vals = bitunpack(packed, k) if dictionary is None else dict_decode(packed, dictionary, k)
    vals = vals.reshape(packed.shape[0], PACK_BLOCK)
    lo_t = torch.as_tensor(lo, dtype=torch.int32).to(vals.dtype)
    hi_t = torch.as_tensor(hi, dtype=torch.int32).to(vals.dtype)
    mask = (vals >= lo_t.to(vals.device)) & (vals <= hi_t.to(vals.device))
    return mask, mask.sum(dim=1, dtype=torch.int32)
