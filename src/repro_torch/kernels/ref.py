"""Plain PyTorch versions of the port's kernels: the semantic ground truth.

Each function transcribes the function of the same name in
`repro/kernels/ref.py` op for op; the batch forms `dict_decode_batch` and
`fused_scan_batch` transcribe `_ref_dict_decode_batch` and
`_ref_fused_scan_batch` of `repro/kernels/ops.py`.  The CPU path runs them (a CPU tensor is
the only thing that routes here, `kernels/ops.py`), the tests hold them
bit-exact against the JAX reference, and `chip_smoke.py` holds each CUDA
kernel bit-exact against them on the card.

`mha` is the plain attention of `repro/kernels/ref.py`, the oracle of the
`flash_attention` kernel; unlike the decoders it is held to a tolerance,
since the two sum in different orders.

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


def bitunpack_flat(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 words -> the first n values, flat (n,) int32."""
    return bitunpack(packed, k).reshape(-1)[:n]


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


# ---------------------------------------------------------------------------
# batched forms: many pages stacked along the block axis
# ---------------------------------------------------------------------------


def dict_decode_batch(packed: torch.Tensor, dicts: torch.Tensor, sizes: torch.Tensor,
                      page: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) codes, (P, Dmax) page dictionaries, (P,) true sizes
    and (nblocks,) block -> page index -> (nblocks, 32, 128) values of the
    dictionaries' dtype.  Each block clips its codes to [0, size - 1] of its
    own page, size taken as at least 1 (the reference wrapper's
    `np.maximum(sizes, 1)`) and at most Dmax; a page index outside [0, P)
    is clamped into it."""
    codes = bitunpack(packed, k).to(torch.int64)
    n_pages, dmax = dicts.shape
    pg = page.to(torch.int64).clamp(0, n_pages - 1)
    lim = sizes.to(torch.int64).clamp(1, dmax)[pg] - 1  # (nblocks,)
    c = torch.minimum(codes.clamp(min=0), lim[:, None, None])
    flat = pg[:, None, None] * dmax + c
    return dicts.reshape(-1).index_select(0, flat.reshape(-1)).reshape(codes.shape)


def fused_scan_batch(packed: torch.Tensor, k: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Stacked (nblocks, k, 128) BITPACK words with per-block int32 bounds
    lo, hi (nblocks,) -> survivor mask (nblocks, 4096) bool, lo <= v <= hi."""
    vals = bitunpack(packed, k).reshape(packed.shape[0], PACK_BLOCK)
    return (vals >= lo.to(torch.int32)[:, None]) & (vals <= hi.to(torch.int32)[:, None])


# ---------------------------------------------------------------------------
# grouped aggregate pushdown: per-block partial accumulators
# ---------------------------------------------------------------------------

# int32 sums are exact as a 16-bit hi/lo split per block (ref.py:212-217 of
# the reference): both partial sums fit int32 for a 4096-row block.
AGG_INT_SHIFT = 16
AGG_INT_MASK = 0xFFFF
# identity fills of a (block, group) cell with no counted row
AGG_INT_MIN_IDENT = 2**31 - 1
AGG_INT_MAX_IDENT = -(2**31)
AGG_FLT_MIN_IDENT = float("inf")
AGG_FLT_MAX_IDENT = float("-inf")
# The float sum's fixed order, shared with csrc/agg_push.cu.  It depends on
# row positions alone (not on n_groups, a window's shift, the block count or
# the launch shape), so windows side by side equal the whole domain and the
# card equals the CPU bit for bit.  "Owner" l of AGG_OWNERS takes the rows
# AGG_CHUNK * (AGG_OWNERS * i + l) + j, for i = 0, 1, ... and j = 0 ..
# AGG_CHUNK - 1, in row order (rows 4l..4l+3, then 128 + 4l.., ...), adding
# each counted row into its own slot of the row's group, zero-started; the
# AGG_OWNERS slots of a group then fold by a halving tree (slot[l] +=
# slot[l + s] for s = 16, 8, ..., 1).  A cell with no counted row, or only
# -0.0 rows, is +0.0.
AGG_OWNERS = 32
AGG_CHUNK = 4


def _float_key(bits: torch.Tensor) -> torch.Tensor:
    """int32 float bits -> int32 keys in the floats' order (-0.0 before
    +0.0).  The map is its own inverse."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _key_of(x: float) -> int:
    return int(_float_key(torch.tensor([x], dtype=torch.float32).view(torch.int32))[0])


def grouped_agg(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                n_groups: int) -> Tuple[torch.Tensor, ...]:
    """(nblk, 4096) int32|float32 values + (nblk, 4096) int32 group ids +
    (nblk, 4096) mask -> per-block partial accumulators, each (nblk, n_groups):

      cnt  int32    counted rows: mask != 0 and 0 <= gid < n_groups
      s0   float32  the block sum (float values), in the fixed order above
           int32    the sum of v >> 16 (int values, arithmetic shift)
      s1   int32    the sum of v & 0xFFFF (int values; zeros for float)
      mn   values' dtype, the minimum (identity fill for an empty cell)
      mx   values' dtype, the maximum (identity fill for an empty cell)

    A float cell with a NaN member has mn = mx = NaN (0x7FC00000), as
    jnp.min/max propagate it; float min and max are taken on the bits'
    order, so -0.0 < +0.0.  Every int plane equals the reference's bit for
    bit; the float s0 differs from it only by the order of the adds.  Rows
    are scattered to (block, group) cells, never expanded to a one-hot
    (nblk, 4096, n_groups) cube."""
    nb, width = values.shape
    G = n_groups
    dev = values.device
    g = gids.to(torch.int32)
    counted = (mask.to(torch.int32) != 0) & (g >= 0) & (g < G)
    slot = torch.where(counted, g, G).to(torch.int64)  # G: a spare cell, cut off

    def scatter(src: torch.Tensor, fill, reduce: str) -> torch.Tensor:
        out = torch.full((nb, G + 1), fill, dtype=src.dtype, device=dev)
        if reduce == "sum":
            out.scatter_add_(1, slot, src)
        else:
            out.scatter_reduce_(1, slot, src, reduce, include_self=True)
        return out[:, :G].contiguous()

    cnt = scatter(torch.ones_like(g), 0, "sum")
    if values.dtype.is_floating_point:
        T, C = AGG_OWNERS, AGG_CHUNK
        v = values.to(torch.float32)

        def by_step(x: torch.Tensor) -> torch.Tensor:
            """(nb, width) -> (nb, steps, T): [b, s, l] is owner l's s-th row."""
            x = x.reshape(nb, width // (T * C), T, C).transpose(2, 3)
            return x.reshape(nb, width // T, T)

        acc = torch.zeros((nb, G + 1, T), dtype=torch.float32, device=dev)
        vs, ss = by_step(v), by_step(slot)
        for i in range(width // T):
            acc.scatter_add_(1, ss[:, i:i + 1], vs[:, i:i + 1])
        acc = acc[:, :G]
        s = T // 2
        while s:
            acc[:, :, :s] += acc[:, :, s:2 * s]
            s //= 2
        s0 = acc[:, :, 0].contiguous()
        s1 = torch.zeros_like(cnt)
        nan = torch.isnan(v)
        key = _float_key(v.view(torch.int32))
        kmin = scatter(torch.where(nan, _key_of(AGG_FLT_MIN_IDENT), key),
                       _key_of(AGG_FLT_MIN_IDENT), "amin")
        kmax = scatter(torch.where(nan, _key_of(AGG_FLT_MAX_IDENT), key),
                       _key_of(AGG_FLT_MAX_IDENT), "amax")
        has_nan = scatter(nan.to(torch.int32), 0, "amax") != 0
        mn = torch.where(has_nan, float("nan"), _float_key(kmin).view(torch.float32))
        mx = torch.where(has_nan, float("nan"), _float_key(kmax).view(torch.float32))
        return cnt, s0, s1, mn.to(values.dtype), mx.to(values.dtype)
    vi = values.to(torch.int32)
    s0 = scatter(vi >> AGG_INT_SHIFT, 0, "sum")
    s1 = scatter(vi & AGG_INT_MASK, 0, "sum")
    mn = scatter(vi, AGG_INT_MIN_IDENT, "amin")
    mx = scatter(vi, AGG_INT_MAX_IDENT, "amax")
    return cnt, s0, s1, mn.to(values.dtype), mx.to(values.dtype)


def fused_agg_scan(packed: torch.Tensor, k: int, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """BITPACK decode -> masked ungrouped aggregate: `grouped_agg` of the
    unpacked int32 values at n_groups = 1 (shapes (nblk, 1))."""
    vals = bitunpack(packed, k).reshape(packed.shape[0], PACK_BLOCK)
    return grouped_agg(vals, torch.zeros_like(vals), mask, 1)


# ---------------------------------------------------------------------------
# attention (oracle for the flash_attention kernel)
# ---------------------------------------------------------------------------


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
        window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention.  q: (B,H,Sq,D), k/v: (B,Hkv,Sk,D); GQA by head
    repeat (q head h reads kv head h // (H/Hkv)).  Logits and softmax in
    float32, masked logits -1e30 (a row that sees no key averages V over all
    Sk keys), ends aligned (query i sits at position i + Sk - Sq); the output
    has q's dtype."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hkv != H:
        rep = H // Hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    Sk = k.shape[2]
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)  # align ends (decode-friendly)
    ki = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (ki <= qi)
    if window is not None:
        m = m & (ki > qi - window)
    logits = torch.where(m[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
