"""Public kernel API of the port: the same names, shapes and dtypes as
`repro/kernels/ops.py`: decode, the fused range filter, stream compaction,
the bloom semijoin, their batched (`*_batch`) forms over pages stacked
along the block axis, the aggregate pushdown and attention.

There is no `backend` switch: each call is routed by its operand's device.
A CUDA tensor launches the hand-written Hopper kernel (and raises if the
kernel cannot run); a CPU tensor runs the plain PyTorch version in
`kernels/ref.py`.  Nothing falls back from one to the other.

The module-level dispatch counter mirrors the reference's: every public
call counts the launches it issues, including PLAIN's device put, so the
engine's `kernel_launches` and the benchmarks' dispatch metric compare one
to one with the JAX package.  `flash_attention` counts none, as in the
reference; its kernel's `launches` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import agg_push as _agg_push
from repro_torch.kernels import bitunpack as _bitunpack
from repro_torch.kernels import bloom_probe as _bloom_probe
from repro_torch.kernels import delta_decode as _delta_decode
from repro_torch.kernels import dict_decode as _dict_decode
from repro_torch.kernels import filter_compact as _filter_compact
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import fused_scan as _fused_scan
from repro_torch.kernels import ref
from repro_torch.kernels import rle_decode as _rle_decode

MAX_GROUPS = _agg_push.MAX_GROUPS

# every hand-written kernel (build.Kernel: source, replaced TPU kernel,
# launch count), in the order of PERF.md's kernel table
KERNELS = {k.name: k for k in (
    _bitunpack.KERNEL, _dict_decode.KERNEL, _delta_decode.KERNEL, _fused_scan.KERNEL,
    _rle_decode.KERNEL, _filter_compact.KERNEL, _bloom_probe.KERNEL,
    _dict_decode.BATCH, _fused_scan.BATCH, _agg_push.GROUPED, _agg_push.FUSED,
    _flash_attention.KERNEL,
)}

# ---------------------------------------------------------------------------
# device-dispatch accounting
# ---------------------------------------------------------------------------

_DISPATCHES = 0


def _count(n: int = 1) -> None:
    global _DISPATCHES
    _DISPATCHES += n


def dispatch_count() -> int:
    """Device dispatches issued through this module since the last reset."""
    return _DISPATCHES


def reset_dispatch_count() -> int:
    """Zero the dispatch counter; returns the value it had."""
    global _DISPATCHES
    n, _DISPATCHES = _DISPATCHES, 0
    return n


def kernel_launches() -> dict:
    """CUDA launches of each kernel since its last reset."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_kernel_launches() -> dict:
    """Zero every kernel's launch count; returns the values they had."""
    return {name: k.reset() for name, k in KERNELS.items()}


_TRANSFERS = 0


def transfer_count() -> int:
    """Host-to-device copies (`to_tensor` calls) since the last reset."""
    return _TRANSFERS


def reset_transfer_count() -> int:
    """Zero the copy counter; returns the value it had."""
    global _TRANSFERS
    n, _TRANSFERS = _TRANSFERS, 0
    return n


# ---------------------------------------------------------------------------
# batch-padding buckets
# ---------------------------------------------------------------------------

# The port's engine pads no stack (`core/engine.py`: `batch_pad_blocks`
# stays 0), so nothing in the engine reads this.  It keeps the reference's
# values for callers such as a benchmark's pad sweep; the reference's
# settable default (`BUCKET_MODE`, `set_bucket_mode`) has no reader here.
def bucket_blocks(n: int, mode: str = "ladder") -> int:
    """A stacked block count padded to its bucket, as the reference's
    engine pads its batch launches.

    'ladder' (default): two rungs per octave, {2^m, 3*2^(m-1)}, i.e. 1, 2,
    3, 4, 6, 8, 12, 16, 24, 32, ...; 'pow2': the next power of two."""
    if n <= 0:
        raise ValueError(f"block count must be positive, got {n}")
    if mode not in ("ladder", "pow2"):
        raise ValueError(f"unknown bucket mode {mode!r}: 'ladder' or 'pow2'")
    p = 1 << (n - 1).bit_length()  # next power of two >= n
    if mode == "pow2" or p < 4:
        return p
    mid = 3 * (p // 4)  # the mid-octave rung 3*2^(m-2)
    return mid if n <= mid else p


def _on_card(*tensors: torch.Tensor) -> bool:
    """True when the operands lie on a CUDA device, False on the CPU."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------


def to_tensor(buf: np.ndarray, device) -> torch.Tensor:
    """A numpy page buffer as a tensor on `device`.  uint32 words become an
    int32 view of the same bits; read-only buffers (the reader's views of
    the file) are copied first, so torch never aliases read-only memory.
    Each call is one host-to-device copy on a card (`transfer_count`)."""
    global _TRANSFERS
    _TRANSFERS += 1
    arr = np.asarray(buf)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    arr = np.require(arr, requirements=("C", "W"))
    return torch.from_numpy(arr).to(device)


def device_put(buf: np.ndarray, device) -> torch.Tensor:
    """Counted host->device transfer: PLAIN 'decode' is a device put."""
    _count()
    return to_tensor(buf, device)


# ---------------------------------------------------------------------------
# decode kernels
# ---------------------------------------------------------------------------


def bitunpack(packed: torch.Tensor, k: int, n: Optional[int] = None) -> torch.Tensor:
    """(nblocks,k,128) int32 words -> flat (n,) int32 (or (nb,32,128) if n is None)."""
    _count()
    out = _bitunpack.bitunpack(packed, k) if _on_card(packed) else ref.bitunpack(packed, k)
    return out if n is None else out.reshape(-1)[:n]


def dict_decode(packed: torch.Tensor, dictionary: torch.Tensor, k: int,
                n: Optional[int] = None) -> torch.Tensor:
    """(nblocks,k,128) code words + (D,) dictionary -> (nb,32,128) values of
    the dictionary's dtype (flat (n,) if n is given)."""
    _count()
    if _on_card(packed, dictionary):
        out = _dict_decode.dict_decode(packed, dictionary, k)
    else:
        out = ref.dict_decode(packed, dictionary, k)
    return out if n is None else out.reshape(-1)[:n]


def rle_decode(values: torch.Tensor, ends: torch.Tensor,
               n: Optional[int] = None) -> torch.Tensor:
    """(nblk, 128) run values + (nblk, 128) int32 ends -> (nblk, 1024) values
    of the runs' dtype (flat (n,) if n is given)."""
    _count()
    if _on_card(values, ends):
        out = _rle_decode.rle_decode(values, ends)
    else:
        out = ref.rle_decode(values, ends)
    return out if n is None else out.reshape(-1)[:n]


def delta_decode(packed: torch.Tensor, bases: torch.Tensor, k: int,
                 n: Optional[int] = None) -> torch.Tensor:
    """(nblocks,k,128) zigzag words + (nblocks,) int32 bases -> (nb,4096) int32
    (flat (n,) if n is given)."""
    _count()
    if _on_card(packed, bases):
        out = _delta_decode.delta_decode(packed, bases, k)
    else:
        out = ref.delta_decode(packed, bases, k)
    return out if n is None else out.reshape(-1)[:n]


def filter_compact(values: torch.Tensor, mask: torch.Tensor):
    """values (nblk, 1024), mask (nblk, 1024) bool -> (compacted, counts (nblk,) int32).

    An integer column counts two dispatches, as in the reference, whose TPU
    kernel compacts ints in two 16-bit halves; the port's kernel compacts
    any 32-bit column exactly in one launch."""
    _count(1 if values.dtype.is_floating_point else 2)
    if _on_card(values, mask):
        return _filter_compact.filter_compact(values, mask)
    return ref.filter_compact(values, mask)


def bloom_build(keys: torch.Tensor, n_bits: int, n_hashes: int = 4) -> torch.Tensor:
    """(n_bits,) uint8 filter of the keys, on their device.  Plain torch on
    both devices, as in the reference, where it is no Pallas kernel either."""
    return ref.bloom_build(keys, n_bits, n_hashes)


def bloom_probe(keys: torch.Tensor, bits: torch.Tensor, n_hashes: int = 4) -> torch.Tensor:
    """keys (nblk, 1024) int32 -> membership (nblk, 1024) bool."""
    _count()
    if _on_card(keys, bits):
        return _bloom_probe.bloom_probe(keys, bits, n_hashes)
    return ref.bloom_probe(keys, bits, n_hashes)


def fused_scan(packed: torch.Tensor, k: int, lo: int, hi: int,
               dictionary: Optional[torch.Tensor] = None):
    """-> (mask (nblocks, 4096) bool, counts (nblocks,) int32) for lo <= v <= hi."""
    _count()
    operands = (packed,) if dictionary is None else (packed, dictionary)
    if _on_card(*operands):
        return _fused_scan.fused_scan(packed, k, lo, hi, dictionary)
    return ref.fused_scan(packed, k, lo, hi, dictionary)


# ---------------------------------------------------------------------------
# batched multi-page decode: one launch per (encoding, k, dtype) bucket
# ---------------------------------------------------------------------------


def bitunpack_batch(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Stacked (nblocks, k, 128) words -> (nblocks, 32, 128) int32 in ONE
    dispatch (the `bitunpack` kernel over the whole stack)."""
    _count()
    return _bitunpack.bitunpack(packed, k) if _on_card(packed) else ref.bitunpack(packed, k)


def dict_decode_batch(packed: torch.Tensor, dicts: torch.Tensor, sizes: torch.Tensor,
                      page: torch.Tensor, k: int) -> torch.Tensor:
    """Multi-page dict decode in ONE dispatch: packed (nblocks, k, 128)
    stacked codes; dicts (P, Dmax) page dictionaries padded to a common
    width; sizes (P,) true lengths; page (nblocks,) block -> page.  Returns
    (nblocks, 32, 128) values of dicts' dtype, bit-identical per page to
    `dict_decode(packed_p, dicts[p, :sizes[p]], k)`."""
    _count()
    if _on_card(packed, dicts, sizes, page):
        return _dict_decode.dict_decode_batch(packed, dicts, sizes, page, k)
    return ref.dict_decode_batch(packed, dicts, sizes, page, k)


def delta_decode_batch(packed: torch.Tensor, bases: torch.Tensor, k: int) -> torch.Tensor:
    """Stacked (nblocks, k, 128) zigzag words + (nblocks,) bases ->
    (nblocks, 4096) int32 in ONE dispatch (blocks are self-contained)."""
    _count()
    if _on_card(packed, bases):
        return _delta_decode.delta_decode(packed, bases, k)
    return ref.delta_decode(packed, bases, k)


def rle_decode_batch(values: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Stacked (nblk, 128) run values + ends -> (nblk, 1024) in ONE dispatch
    (the writer clips runs at block boundaries, so blocks are independent)."""
    _count()
    if _on_card(values, ends):
        return _rle_decode.rle_decode(values, ends)
    return ref.rle_decode(values, ends)


def fused_scan_batch(packed: torch.Tensor, k: int, lo: torch.Tensor,
                     hi: torch.Tensor) -> torch.Tensor:
    """Batched fused decode + filter: stacked (nblocks, k, 128) BITPACK
    words with per-block int32 bounds lo, hi (nblocks,) -> survivor mask
    (nblocks, 4096) bool in ONE dispatch."""
    _count()
    if _on_card(packed, lo, hi):
        return _fused_scan.fused_scan_batch(packed, k, lo, hi)
    return ref.fused_scan_batch(packed, k, lo, hi)


def grouped_agg_batch(values: torch.Tensor, gids: torch.Tensor, mask: torch.Tensor,
                      n_groups: int) -> Tuple[torch.Tensor, ...]:
    """Grouped aggregate over stacked decoded blocks in ONE dispatch:
    values/gids/mask (nblocks, 4096) -> 5 x (nblocks, n_groups) partial
    accumulators (cnt, s0, s1, mn, mx; `ref.grouped_agg`'s layout)."""
    assert 1 <= n_groups <= MAX_GROUPS, n_groups
    _count()
    if _on_card(values, gids, mask):
        return _agg_push.grouped_agg(values, gids, mask, n_groups)
    return ref.grouped_agg(values, gids, mask, n_groups)


def fused_agg_batch(packed: torch.Tensor, k: int, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """BITPACK decode fused with the masked ungrouped aggregate in ONE
    dispatch: stacked (nblocks, k, 128) words + (nblocks, 4096) mask ->
    5 x (nblocks, 1) int32.  The decoded values never leave the kernel."""
    _count()
    if _on_card(packed, mask):
        return _agg_push.fused_agg(packed, k, mask)
    return ref.fused_agg_scan(packed, k, mask)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, scale: Optional[float] = None,
                    bq: int = 256, bk: int = 256) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D) in q's dtype: `ref.mha`'s
    function (ends aligned, GQA, optional sliding window).  `bq`/`bk` are
    accepted for the reference's signature; the kernel's tiles are its own
    (64 rows, 64 keys)."""
    del bq, bk
    if _on_card(q, k, v):
        return _flash_attention.flash_attention(q, k, v, causal=causal, window=window,
                                                scale=scale)
    return ref.mha(q, k, v, causal=causal, window=window, scale=scale)
