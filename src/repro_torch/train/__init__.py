"""Training substrate: optimizers, checkpointing, the training loop (port
of `repro.train`)."""

from repro_torch.train.optimizer import OptConfig, init_opt_state, apply_updates  # noqa: F401
from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
