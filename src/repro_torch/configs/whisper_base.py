"""whisper-base [audio] — enc-dec, 6L encoder + 6L decoder, d=512 8H (kv=8)
d_ff=2048 vocab=51865.  Conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, 1500, 512).  [arXiv:2212.04356; unverified]
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        act="gelu",
        encoder_layers=6,
        encoder_seq=1500,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        act="gelu",
        encoder_layers=2,
        encoder_seq=48,
        remat=False,
    )
