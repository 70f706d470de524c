"""llava-next-34b [vlm] — 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Anyres tiling frontend is a STUB: input_specs() provides precomputed patch
embeddings prepended to the token stream.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        rope_theta=5_000_000.0,
        vision_tokens=576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llava-smoke",
        family="vlm",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        vision_tokens=16,
        remat=False,
    )
