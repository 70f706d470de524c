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

from typing import Optional, Tuple

import torch

from repro_torch.lakeformat.encodings import LANES, PACK_BLOCK, SUBLANES


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
