"""deepseek-moe-16b [moe] — 28L d=2048 16H (kv=16, MHA) vocab=102400.
Fine-grained MoE: 64 routed top-6 + 2 shared experts, expert d_ff=1408;
first layer is a dense FFN (d_ff=10944) per arXiv:2401.06066.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        head_dim=128,
        d_ff=10944,          # dense first layer (paper); experts use moe_d_ff
        vocab=102400,
        moe_experts=64,
        moe_top_k=6,
        moe_shared=2,
        moe_d_ff=1408,
        moe_period=1,
        moe_first_dense=1,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="deepseek-moe-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv=4,
        head_dim=16,
        d_ff=160,
        vocab=512,
        moe_experts=8,
        moe_top_k=3,
        moe_shared=2,
        moe_d_ff=48,
        moe_period=1,
        moe_first_dense=1,
        remat=False,
    )
