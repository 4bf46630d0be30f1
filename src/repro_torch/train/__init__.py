"""Training: the plain and the FD-compressed data-parallel train steps."""
from repro_torch.train.step import (
    TrainConfig,
    TrainState,
    aggregate_shards,
    init_train_state,
    make_compressed_train_step,
    make_train_step,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "aggregate_shards",
    "init_train_state",
    "make_compressed_train_step",
    "make_train_step",
]
