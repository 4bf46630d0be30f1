"""Wrappers for the FD shrink kernels: checks, device dispatch, launch counts.

``fd_gram`` and ``fd_project`` take one ``(L, d)`` buffer or a stacked
``(T, L, d)`` pack, so one CUDA kernel each serves the reference's single
and tenant-batched Pallas kernels.  Dispatch is by the tensors' device:

  * CUDA — launch the hand-written kernel (``csrc/*.cu``) or raise;
  * CPU  — run the plain PyTorch version from ``ref.py``.

Operands must be f32, contiguous and on one device; the kernels mask
ragged L and d themselves, so no padding copies are made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel

__all__ = ["FD_GRAM", "FD_GRAM_BATCHED", "FD_PROJECT", "FD_PROJECT_BATCHED", "fd_gram",
           "fd_project", "operands_on_cpu"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# One source each serves the reference's single and tenant-batched Pallas
# kernels; a launch of one buffer (T = 1) counts as the single kernel's, a
# launch of a stack (T > 1) as the batched one's.
FD_GRAM = CudaKernel("fd_gram.cu", "fd_gram_launch", [_P, _P, _I, _I, _I])
FD_GRAM_BATCHED = CudaKernel("fd_gram.cu", "fd_gram_launch", [_P, _P, _I, _I, _I])
FD_PROJECT = CudaKernel("fd_project.cu", "fd_project_launch", [_P, _P, _P, _P, _I, _I, _I])
FD_PROJECT_BATCHED = CudaKernel("fd_project.cu", "fd_project_launch",
                                [_P, _P, _P, _P, _I, _I, _I])


def operands_on_cpu(**tensors: torch.Tensor) -> bool:
    """Check a kernel's operands; True if they lie on the CPU, False on CUDA.

    Raises on another device, mixed devices, a dtype other than f32 or a
    non-contiguous tensor: the CUDA kernels take nothing else.
    """
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        where = {k: str(t.device) for k, t in tensors.items()}
        raise ValueError(f"operands on different devices: {where}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (device,) = devices
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device.type == "cpu"


def fd_gram(b: torch.Tensor) -> torch.Tensor:
    """``B @ B.T`` in f32: (L, d) -> (L, L), or stacked (T, L, d) -> (T, L, L)."""
    if b.ndim not in (2, 3):
        raise ValueError(f"fd_gram wants (L, d) or (T, L, d), got {tuple(b.shape)}")
    if operands_on_cpu(b=b):
        return ref.ref_fd_gram(b) if b.ndim == 2 else ref.ref_fd_gram_batched(b)
    bs = b if b.ndim == 3 else b[None]
    t, l, d = bs.shape
    g = torch.empty((t, l, l), dtype=torch.float32, device=b.device)
    if g.numel():
        (FD_GRAM if t == 1 else FD_GRAM_BATCHED).launch(b.device, bs.data_ptr(), g.data_ptr(),
                                                        t, l, d)
    return g if b.ndim == 3 else g[0]


def fd_project(w: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``diag(w) @ (U.T @ B)``: (L,), (L, L), (L, d) -> (L, d), or stacked
    (T, L), (T, L, L), (T, L, d) -> (T, L, d)."""
    if b.ndim not in (2, 3):
        raise ValueError(f"fd_project wants b as (L, d) or (T, L, d), got {tuple(b.shape)}")
    stacked = b.ndim == 3
    t, l, d = b.shape if stacked else (1, *b.shape)
    want_w, want_u = ((t, l), (t, l, l)) if stacked else ((l,), (l, l))
    if tuple(w.shape) != want_w or tuple(u.shape) != want_u:
        raise ValueError(
            f"fd_project shape mismatch: w{tuple(w.shape)} u{tuple(u.shape)} b{tuple(b.shape)}"
        )
    if operands_on_cpu(w=w, u=u, b=b):
        return (ref.ref_fd_project_batched if stacked else ref.ref_fd_project)(w, u, b)
    out = torch.empty_like(b)
    if out.numel():
        (FD_PROJECT if t == 1 else FD_PROJECT_BATCHED).launch(
            b.device, w.data_ptr(), u.data_ptr(), b.data_ptr(), out.data_ptr(), t, l, d
        )
    return out
