"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) d_ff=5504, ssm_state=16.
Parallel attention + mamba heads in every layer; sliding-window attention
(1024) except 3 global layers (first / middle / last).  Runs long_500k.
[arXiv:2411.13676; hf]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        window=1024,
        global_layers=(0, 16, 31),
        ssm_state=16,
        ssm_heads=25,
        ssm_head_dim=128,   # d_inner = 3200 = 2*d
        conv_width=4,
        ssm_chunk=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="hymba-smoke",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        window=32,
        global_layers=(0, 3),
        ssm_state=8,
        ssm_heads=4,
        ssm_head_dim=32,
        conv_width=4,
        ssm_chunk=16,
        tie_embeddings=True,
        remat=False,
    )
