"""The LM consumer's models, the decoder-only families (port of `repro.models`)."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    init_params,
    param_shapes,
    params_from_reference,
    prefill,
)
