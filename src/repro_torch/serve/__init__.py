"""Serving runtime: slot-based continuous batching over prefill/decode."""

from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
