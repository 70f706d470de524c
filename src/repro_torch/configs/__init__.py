"""Per-architecture configs (exact assigned numbers) + reduced smoke configs.

A copy of `repro/configs`: `get_config` / `get_smoke_config` resolve the
same ids and aliases as the reference, and `list_archs()` lists the same ten
architectures.
"""

from __future__ import annotations

import importlib
from typing import List

ARCH_IDS = [
    "llama4_maverick_400b",
    "deepseek_moe_16b",
    "qwen3_1_7b",
    "gemma_7b",
    "mistral_large_123b",
    "granite_3_8b",
    "mamba2_370m",
    "whisper_base",
    "llava_next_34b",
    "hymba_1_5b",
]

# external ids (as assigned) -> module names
ALIASES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma-7b": "gemma_7b",
    "mistral-large-123b": "mistral_large_123b",
    "granite-3-8b": "granite_3_8b",
    "mamba2-370m": "mamba2_370m",
    "whisper-base": "whisper_base",
    "llava-next-34b": "llava_next_34b",
    "hymba-1.5b": "hymba_1_5b",
}


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    if name not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def list_archs() -> List[str]:
    return list(ARCH_IDS)
