"""Hopper kernel: fused k-bit unpack + dictionary lookup (csrc/dict_decode.cu).

Port of `dict_decode_pallas` (repro/kernels/dict_decode.py:146), with the
semantics of `repro/kernels/ref.py` dict_decode: codes clip to the TRUE
dictionary length.  Entries move as raw 32-bit words, so one kernel serves
int32 and float32 dictionaries.  A dictionary of up to
`SHARED_DICT_MAX_BYTES` is staged in shared memory; a larger one is read
from global memory.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import LANES, SUBLANES

SOURCE = "src/repro_torch/kernels/csrc/dict_decode.cu"
REPLACES = "src/repro/kernels/dict_decode.py:146"

# H100's opt-in dynamic shared memory per block (227 KiB): 58,112 entries.
# dict_encode allows 65,536 (256 KiB), which takes the global-memory branch.
SHARED_DICT_MAX_BYTES = 232_448

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> int:
    """Zero the launch count; returns the value it had."""
    global launches
    n, launches = launches, 0
    return n


def uses_shared(dict_len: int) -> bool:
    """Whether a dictionary of `dict_len` 4-byte entries is staged in shared
    memory (True) or read from global memory (False)."""
    return 0 < dict_len * 4 <= SHARED_DICT_MAX_BYTES


def dict_decode(packed: torch.Tensor, dictionary: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 code words + (D,) int32/float32 dictionary on
    the card -> (nblocks, 32, 128) values of the dictionary's dtype."""
    global launches
    nb = build.check_packed(packed, k)
    build.check_operand(dictionary, "dictionary", (torch.int32, torch.float32), (None,),
                        packed.device)
    if dictionary.numel() == 0:
        raise ValueError("dictionary must not be empty")
    d = int(dictionary.numel())
    out = torch.empty((nb, SUBLANES, LANES), dtype=dictionary.dtype, device=packed.device)
    if nb:
        build.launch("rt_dict_decode", packed.device, packed, dictionary, d, out,
                     nb, k, int(uses_shared(d)))
        launches += 1
    return out
