"""The LM consumer's models, the decoder-only families (port of `repro.models`)."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    build_model,
    decode_step,
    init_params,
    loss_fn,
    param_dims,
    param_shapes,
    params_from_reference,
    prefill,
)
