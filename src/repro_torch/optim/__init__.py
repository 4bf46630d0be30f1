"""Optimisation: AdamW, the warmup-cosine schedule, and FD-compressed
data-parallel gradient aggregation with error feedback."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    CompressionStats,
    FDCompressConfig,
    compress_and_aggregate,
    init_residuals,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWState",
    "CompressionStats",
    "FDCompressConfig",
    "adamw_init",
    "adamw_update",
    "compress_and_aggregate",
    "init_residuals",
    "warmup_cosine",
]
