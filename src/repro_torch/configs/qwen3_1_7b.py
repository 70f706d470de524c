"""qwen3-1.7b [dense] — 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm per head; tied embeddings.  [hf:Qwen/Qwen3-8B; hf]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv=8,
        head_dim=128,
        d_ff=6144,
        vocab=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        qk_norm=True,
        tie_embeddings=True,
        remat=False,
    )
