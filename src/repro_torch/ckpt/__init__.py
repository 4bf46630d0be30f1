"""Fault-tolerant checkpointing: atomic, hashed, device-agnostic, async.

Public surface re-exported from ``repro_torch.ckpt.checkpoint`` — see its
module docstring for the on-disk layout, which is the reference's.
"""
from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    read_extra,
    read_manifest,
    read_subset,
    restore,
    save,
)

__all__ = [
    "AsyncCheckpointer",
    "latest_step",
    "read_extra",
    "read_manifest",
    "read_subset",
    "restore",
    "save",
]
