"""granite-3-8b [dense] — 40L d=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]  (Granite's logit/residual
multipliers omitted — standard pre-norm GQA stack, noted in DESIGN.md.)
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        head_dim=128,
        d_ff=12800,
        vocab=49155,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv=2,
        head_dim=16,
        d_ff=128,
        vocab=515,   # deliberately odd: exercises vocab padding
        tie_embeddings=True,
        remat=False,
    )
