"""Hopper kernels: fused k-bit unpack + dictionary lookup (csrc/dict_decode.cu).

`dict_decode` ports `dict_decode_pallas` (repro/kernels/dict_decode.py:146),
with the semantics of `repro/kernels/ref.py` dict_decode: codes clip to the
TRUE dictionary length.  `dict_decode_batch` ports
`dict_decode_batch_pallas` (repro/kernels/dict_decode.py:97): many pages'
blocks in one launch, each clipping to and reading its own page's
dictionary, which stays one (P, Dmax) row per page on the card.  Entries
move as raw 32-bit words, so each kernel serves int32 and float32
dictionaries, and each reads its dictionary in place through the read-only
cache.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.lakeformat.encodings import LANES, SUBLANES

SOURCE = "src/repro_torch/kernels/csrc/dict_decode.cu"
KERNEL = build.Kernel("dict_decode", SOURCE, "src/repro/kernels/dict_decode.py:146")
BATCH = build.Kernel("dict_decode_batch", SOURCE, "src/repro/kernels/dict_decode.py:97")

def dict_decode(packed: torch.Tensor, dictionary: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 code words + (D,) int32/float32 dictionary on
    the card -> (nblocks, 32, 128) values of the dictionary's dtype."""
    nb = build.check_packed(packed, k)
    build.check_operand(dictionary, "dictionary", (torch.int32, torch.float32), (None,),
                        packed.device)
    if dictionary.numel() == 0:
        raise ValueError("dictionary must not be empty")
    d = int(dictionary.numel())
    out = torch.empty((nb, SUBLANES, LANES), dtype=dictionary.dtype, device=packed.device)
    if nb:
        build.launch("rt_dict_decode", packed.device, packed, dictionary, d, out, nb, k)
        KERNEL.launches += 1
    return out


def dict_decode_batch(packed: torch.Tensor, dicts: torch.Tensor, sizes: torch.Tensor,
                      page: torch.Tensor, k: int) -> torch.Tensor:
    """(nblocks, k, 128) int32 code words, (P, Dmax) int32/float32 page
    dictionaries, (P,) int32 true sizes and (nblocks,) int32 page index, all
    on the card -> (nblocks, 32, 128) values of the dictionaries' dtype."""
    nb = build.check_packed(packed, k)
    build.check_operand(dicts, "dicts", (torch.int32, torch.float32), (None, None),
                        packed.device)
    n_pages, dmax = (int(d) for d in dicts.shape)
    if n_pages == 0 or dmax == 0:
        raise ValueError("dicts must hold at least one entry per page")
    build.check_operand(sizes, "sizes", (torch.int32,), (n_pages,), packed.device)
    build.check_operand(page, "page", (torch.int32,), (nb,), packed.device)
    out = torch.empty((nb, SUBLANES, LANES), dtype=dicts.dtype, device=packed.device)
    if nb:
        build.launch("rt_dict_decode_batch", packed.device, packed, dicts, dmax, n_pages,
                     sizes, page, out, nb, k)
        BATCH.launches += 1
    return out
