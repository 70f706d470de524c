"""Hopper kernels: causal / GQA / sliding-window attention with an online
softmax, on two routes (csrc/flash_attention_wgmma.cu and
csrc/flash_attention.cu).

Port of `flash_attention_pallas` (repro/kernels/flash_attention.py:82) with
the semantics of its oracle `repro/kernels/ref.py` mha, whose plain
counterpart is `repro_torch.kernels.ref.mha`: unlike the Pallas kernel it
aligns the ends, so Sq may differ from Sk under `causal`, and neither length
need be a multiple of a tile.  The wrapper launches the CUDA kernel on CUDA
tensors and nothing else; `kernels.ops` picks between it and `ref.mha` by the
operands' device.

The route is a rule on dtype and head dim, decided before the launch:
bfloat16 operands with D in WGMMA_HEAD_DIMS (64, 128, 256: rows that are whole
128-byte swizzle atoms) go to the `wgmma` kernel fed by TMA; float32 operands,
and bfloat16 at D in (16, 32), go to the "tf32x3" kernel, whose `mma.sync`
products split each float32 operand into two TF32 parts and add three TF32
passes, which holds float32's 3e-5 tolerance where one TF32 pass does not.
A launch that fails raises on either route.  `KERNEL.launches` counts both;
`ROUTE_LAUNCHES` counts each.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

SOURCES = {"wgmma": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
           "tf32x3": "src/repro_torch/kernels/csrc/flash_attention.cu"}
# the record names the source of the route a model's bf16 layer takes
KERNEL = build.Kernel("flash_attention", SOURCES["wgmma"],
                      "src/repro/kernels/flash_attention.py:82")

HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the two routes take together
WGMMA_HEAD_DIMS = (64, 128, 256)  # the tensor-core kernel's, bfloat16 only
ROUTE_LAUNCHES = {"wgmma": 0, "tf32x3": 0}
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MAX = 65535  # the grid's y (heads) and z (batch) extents


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes operands of `dtype` and `head_dim`: "wgmma" for
    bfloat16 with D in WGMMA_HEAD_DIMS, else "tf32x3"."""
    return "wgmma" if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS else "tf32x3"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) contiguous float32 or bfloat16 on the
    card -> (B,H,Sq,D) in q's dtype, on the route `route` gives.  Raises on a
    head dim outside HEAD_DIMS, H % Hkv != 0, a non-contiguous or misaligned
    operand (4 elements; 16 bytes on the wgmma route, whose TMA loads need a
    16-byte-aligned base and rows of D * 2 bytes, a multiple of 16 for every
    D it takes), or a launch the card refuses."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, Sq, D), got {tuple(q.shape)}")
    B, H, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    build.check_operand(q, "q", tuple(_BF16), (B, H, Sq, D))
    if k.dim() != 4:
        raise ValueError(f"k must be (B, Hkv, Sk, D), got {tuple(k.shape)}")
    Hkv, Sk = k.shape[1], k.shape[2]
    build.check_operand(k, "k", (q.dtype,), (B, Hkv, Sk, D), q.device)
    build.check_operand(v, "v", (q.dtype,), (B, Hkv, Sk, D), q.device)
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if Sk == 0:
        raise ValueError("attention over no keys")
    if B > _GRID_MAX or H > _GRID_MAX:
        raise ValueError(f"B={B} or H={H} exceeds the grid's {_GRID_MAX}")
    way = route(q.dtype, D)
    align = 16 if way == "wgmma" else 4 * q.element_size()
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be aligned to {align} bytes")
    if window is not None and not -2**31 <= window < 2**31:
        raise ValueError(f"window {window} outside int32")
    scale = float(scale) if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B * H * Sq:
        args = (int(causal), int(window is not None), 0 if window is None else window, scale)
        if way == "wgmma":
            build.launch("rt_flash_attention_wgmma", q.device, q, k, v, out, B, H, Hkv, Sq, Sk,
                         D, *args)
        else:
            build.launch("rt_flash_attention", q.device, q, k, v, out, B, H, Hkv, Sq, Sk, D,
                         *args, _BF16[q.dtype])
        KERNEL.launches += 1
        ROUTE_LAUNCHES[way] += 1
    return out
