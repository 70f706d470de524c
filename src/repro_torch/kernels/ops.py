"""Public kernel API of the port: the same names, shapes and dtypes as
`repro/kernels/ops.py` for the sequential scan path: decode, the fused
range filter, stream compaction and the bloom semijoin.

There is no `backend` switch: each call is routed by its operand's device.
A CUDA tensor launches the hand-written Hopper kernel (and raises if the
kernel cannot run); a CPU tensor runs the plain PyTorch version in
`kernels/ref.py`.  Nothing falls back from one to the other.

The module-level dispatch counter mirrors the reference's: every public
call counts the launches it issues, including PLAIN's device put, so the
engine's `kernel_launches` and the benchmarks' dispatch metric compare one
to one with the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import bitunpack as _bitunpack
from repro_torch.kernels import bloom_probe as _bloom_probe
from repro_torch.kernels import delta_decode as _delta_decode
from repro_torch.kernels import dict_decode as _dict_decode
from repro_torch.kernels import filter_compact as _filter_compact
from repro_torch.kernels import fused_scan as _fused_scan
from repro_torch.kernels import ref
from repro_torch.kernels import rle_decode as _rle_decode

# the CUDA wrappers, each with its own launch count
KERNELS = {
    "bitunpack": _bitunpack,
    "dict_decode": _dict_decode,
    "delta_decode": _delta_decode,
    "fused_scan": _fused_scan,
    "rle_decode": _rle_decode,
    "filter_compact": _filter_compact,
    "bloom_probe": _bloom_probe,
}

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
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_kernel_launches() -> dict:
    """Zero every kernel's launch count; returns the values they had."""
    return {name: mod.reset_launches() for name, mod in KERNELS.items()}


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
    the file) are copied first, so torch never aliases read-only memory."""
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
