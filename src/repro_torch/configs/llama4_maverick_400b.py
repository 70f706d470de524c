"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 routed top-1 + 1 shared, interleaved every other layer
("early fusion" multimodal stack; text-only cells here).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv=8,
        head_dim=128,
        d_ff=8192,
        vocab=202048,
        rope_theta=500_000.0,
        moe_experts=128,
        moe_top_k=1,
        moe_shared=1,
        moe_d_ff=8192,
        moe_period=2,       # every 2nd layer is MoE (interleaved)
        moe_first_dense=0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="llama4-smoke",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        moe_experts=8,
        moe_top_k=1,
        moe_shared=1,
        moe_d_ff=96,
        moe_period=2,
        remat=False,
    )
