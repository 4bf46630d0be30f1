"""repro_torch: Continuous Matrix Approximation on Distributed Data, on PyTorch/CUDA.

The PyTorch port of ``repro``, subpackage for subpackage, with the Pallas
kernels rewritten as hand-written CUDA C++ for Hopper (``sm_90a``).

Core entry points:
    repro_torch.core     — FD sketch, shard protocols P1/P2, tracker
    repro_torch.query    — coordinator query serving (store -> engine)
    repro_torch.runtime  — protocol registry, the streaming pipeline and
                           its packed multi-tenant ingest
    repro_torch.ckpt     — checkpoints in the reference's format
    repro_torch.kernels  — CUDA kernels, their wrappers and plain oracles
    repro_torch.models   — the decoder LM (serving path) and its configs
                           (``repro_torch.configs``)
    repro_torch.serve    — batched prefill + decode (``ServeEngine``);
                           ``python -m repro_torch.launch.serve`` drives it

Every entry point takes ``device=``; left as ``None`` it means the CUDA
card, and raises when there is none.  Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels on the host.
"""
from __future__ import annotations

import numpy as np
import torch

__version__ = "1.0.0"

__all__ = ["f32_on", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller says.

    ``None`` means the CUDA card; with no card that is an error, never a
    quiet fall back to the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions instead"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def f32_on(device: torch.device, x) -> torch.Tensor:
    """``x`` (a tensor or anything numpy reads) as a contiguous f32 tensor on
    ``device``.

    Host arrays are copied, so read-only numpy arrays (published snapshots)
    are safe to hand over.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(x, np.float32), device=device)
