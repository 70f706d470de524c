"""gemma-7b [dense] — 28L d=3072 16H (kv=16, MHA) head_dim=256 d_ff=24576
vocab=256000.  GeGLU, sqrt(d) embedding scaling, (1+w) RMSNorm.
[arXiv:2403.08295; hf]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv=16,
        head_dim=256,
        d_ff=24576,
        vocab=256000,
        act="geglu",
        embed_scale=True,
        norm_plus_one=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv=4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        act="geglu",
        embed_scale=True,
        norm_plus_one=True,
        tie_embeddings=True,
        remat=False,
    )
