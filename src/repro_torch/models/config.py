"""ModelConfig — one dataclass describing every assigned architecture.

A copy of `repro/models/config.py`.  Families: dense | moe | ssm | hybrid |
audio (enc-dec) | vlm; the port runs all six.  The exact per-arch
instantiations live in `repro_torch/configs/<id>.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_PAD = 2048  # embedding tables padded so 'vocab' always TP-shards


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0

    # attention details
    act: str = "swiglu"  # swiglu | geglu | gelu (non-gated: whisper)
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window size (hybrid SWA layers)
    global_layers: Tuple[int, ...] = ()  # full-attention layer ids (hybrid)
    attn_scale: Optional[float] = None
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    norm_plus_one: bool = False  # gemma RMSNorm (1 + w)

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0  # number of shared (always-on) experts
    moe_d_ff: int = 0
    moe_period: int = 1  # every Nth layer is MoE...
    moe_first_dense: int = 0  # ...after this many leading dense layers
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend frames

    # vlm
    vision_tokens: int = 0  # stub patch embeddings prepended to the stream

    # numerics / execution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs: ~8ND -> 6ND)
    attn_block: int = 1024  # jnp blocked-attention kv chunk
    attn_impl: str = "blocked"  # blocked | dense | pallas
    microbatches: int = 1  # grad-accumulation steps inside train_step
    decode_bitpack: bool = True  # datapath: train tokens arrive bit-packed

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, VOCAB_PAD)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim if self.ssm_heads else self.ssm_expand * self.d_model

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k?  SSM and hybrid (SWA+SSM) can."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def moe_layer_ids(self) -> Tuple[int, ...]:
        if self.moe_experts == 0:
            return ()
        return tuple(
            i
            for i in range(self.n_layers)
            if i >= self.moe_first_dense and (i - self.moe_first_dense) % self.moe_period == self.moe_period - 1
        )

    def n_params(self) -> int:
        """Analytic parameter count (unpadded vocab)."""
        d, f = self.d_model, self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = self._ssm_params()
            return emb + self.n_layers * per
        attn = d * (self.n_heads + 2 * self.n_kv) * self.head_dim + self.n_heads * self.head_dim * d
        dense_ffn = 3 * d * f
        moe_ids = set(self.moe_layer_ids())
        total = emb
        for i in range(self.n_layers):
            total += attn + 2 * d  # attn + norms
            if self.family == "hybrid":
                total += self._ssm_params()
            if i in moe_ids:
                total += d * self.moe_experts * 3 * self.moe_d_ff
                total += self.moe_shared * 3 * d * self.moe_d_ff
                total += d * self.moe_experts  # router
            else:
                total += dense_ffn
        if self.is_encdec:
            enc = self.encoder_layers * (attn + dense_ffn + 2 * d)
            xattn = self.n_layers * (attn + d)
            total += enc + xattn
        return total

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        if self.moe_experts == 0:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        inactive = (self.moe_experts - self.moe_top_k) * 3 * d * self.moe_d_ff
        return total - len(self.moe_layer_ids()) * inactive

    def _ssm_params(self) -> int:
        d, di, n = self.d_model, self.d_inner, self.ssm_state
        h = self.ssm_heads
        # in_proj (z, x, B, C, dt) + conv + out_proj + A/D/dt_bias + norms
        in_p = d * (2 * di + 2 * n * (h and 1 or 1) * 1 + h)
        in_p = d * (2 * di + 2 * self.ssm_state * self._ssm_groups() + h)
        return in_p + self.conv_width * (di + 2 * self.ssm_state * self._ssm_groups()) + di * d + 3 * h + 2 * d

    def _ssm_groups(self) -> int:
        return 1  # single B/C group (Mamba2 default ngroups=1)
