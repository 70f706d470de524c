"""mamba2-370m [ssm] — 48L d=1024, attention-free, ssm_state=128.
SSD (state-space duality) chunked scan.  [arXiv:2405.21060; unverified]
d_inner = 2*d = 2048, 32 heads x head_dim 64.  Runs long_500k.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        d_ff=0,             # attention-free, no MLP block
        vocab=50280,
        ssm_state=128,
        ssm_heads=32,
        ssm_head_dim=64,
        ssm_expand=2,
        conv_width=4,
        ssm_chunk=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-smoke",
        family="ssm",
        n_layers=3,
        d_model=64,
        d_ff=0,
        vocab=512,
        ssm_state=16,
        ssm_heads=4,
        ssm_head_dim=32,
        conv_width=4,
        ssm_chunk=32,
        tie_embeddings=True,
        remat=False,
    )
