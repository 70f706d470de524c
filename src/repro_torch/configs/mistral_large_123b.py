"""mistral-large-123b [dense] — 88L d=12288 96H (GQA kv=8) d_ff=28672
vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mistral-large-123b",
        family="dense",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv=8,
        head_dim=128,
        d_ff=28672,
        vocab=32768,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mistral-large-smoke",
        family="dense",
        n_layers=4,
        d_model=96,
        n_heads=6,
        n_kv=2,
        head_dim=16,
        d_ff=256,
        vocab=512,
        remat=False,
    )
