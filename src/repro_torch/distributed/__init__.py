"""Distributed runtime: the one-device sharding context (the rest of
`repro.distributed` waits for ROADMAP.md item A.6)."""

from repro_torch.distributed.sharding import ShardingCtx, constrain, local_ctx  # noqa: F401
