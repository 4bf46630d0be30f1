"""Public entry points of the matrix kernels.

* ``fd_gram`` / ``fd_project`` — FD shrink products (see fd_ops.py).
* ``fd_shrink`` / ``fd_spectra`` — the batched FD shrink and spectrum
  refresh: one Gram launch, one batched ``torch.linalg.eigh``, one
  projection launch for a whole ``(T, L, d)`` pack.
* ``quadform`` / ``quadform_packed`` — batched ``||B x_j||^2``, one launch
  of ``csrc/quadform.cu`` for one sketch or a packed stack of them.
* ``levscore`` — batched ridge leverage scores ``x_j^T M x_j``, one launch
  of ``csrc/levscore.cu``.

Dispatch is by the tensors' device, as in fd_ops.py: CUDA launches the
kernel or raises, CPU runs the plain version from ``ref.py``.
``launch_counts`` reads each kernel's launch count; ``reset_launch_counts``
sets them to zero.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.fd_ops import FD_GRAM, FD_PROJECT, fd_gram, fd_project, operands_on_cpu

__all__ = [
    "KERNELS",
    "fd_gram",
    "fd_project",
    "fd_shrink",
    "fd_spectra",
    "launch_counts",
    "levscore",
    "quadform",
    "quadform_packed",
    "reset_launch_counts",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
QUADFORM = CudaKernel("quadform.cu", "quadform_launch", [_P, _P, _P, _I, _I, _I, _I])
LEVSCORE = CudaKernel("levscore.cu", "levscore_launch", [_P, _P, _P, _P, _I, _I, _L])
# Width of the column slabs of M in csrc/levscore.cu (kCols): the kernel
# keeps one partial per slab and query row in scratch.
LEVSCORE_SLAB = 128

# Every hand-written kernel of the port, by name.
KERNELS = {"fd_gram": FD_GRAM, "fd_project": FD_PROJECT, "quadform": QUADFORM,
           "levscore": LEVSCORE}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel on the card since the last reset."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def quadform_packed(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cross-tenant packed ``||B_t x_tj||^2``: (T, L, d) x (T, N, d) -> (T, N).

    One launch serves every tenant in the pack.  Ragged per-tenant query
    counts can be zero-padded to a shared N: zero directions answer 0.
    """
    if b.ndim != 3 or x.ndim != 3 or x.shape[0] != b.shape[0] or x.shape[2] != b.shape[2]:
        raise ValueError(f"quadform_packed shape mismatch: b{tuple(b.shape)} x{tuple(x.shape)}")
    if operands_on_cpu(b=b, x=x):
        return ref.ref_quadform_packed(b, x)
    t, l, d = b.shape
    n = x.shape[1]
    q = torch.empty((t, n), dtype=torch.float32, device=b.device)
    if q.numel():
        QUADFORM.launch(b.device, b.data_ptr(), x.data_ptr(), q.data_ptr(), t, l, n, d)
    return q


def quadform(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``||B x_j||^2``: (L, d) x (N, d) -> (N,).  L = 0 answers zeros."""
    if b.ndim != 2 or x.ndim != 2 or x.shape[1] != b.shape[1]:
        raise ValueError(f"quadform shape mismatch: b{tuple(b.shape)} x{tuple(x.shape)}")
    if operands_on_cpu(b=b, x=x):
        return ref.ref_quadform(b, x)
    return quadform_packed(b[None], x[None])[0]


def levscore(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ridge leverage scores ``x_j^T M x_j``: (d, d) x (N, d) -> (N,).

    M need not be symmetric; only ``x^T M x`` is computed.  N = 0 (and
    d = 0) answer without a launch.
    """
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"scoring factor must be square (d, d), got {tuple(m.shape)}")
    if x.ndim != 2 or x.shape[1] != m.shape[0]:
        raise ValueError(f"levscore shape mismatch: m{tuple(m.shape)} x{tuple(x.shape)}")
    if operands_on_cpu(m=m, x=x):
        return ref.ref_levscore(m, x)
    n, d = x.shape
    out = torch.zeros(n, dtype=torch.float32, device=x.device)
    if n and d:
        part = torch.empty(-(-d // LEVSCORE_SLAB) * n, dtype=torch.float32, device=x.device)
        LEVSCORE.launch(x.device, m.data_ptr(), x.data_ptr(), out.data_ptr(), part.data_ptr(),
                        n, d, part.numel())
    return out


def fd_shrink(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FD shrink: (T, 2l, d) -> (B' (T, 2l, d), delta (T,)).

    One Gram launch, ONE batched ``eigh`` over the (T, 2l, 2l) Grams, one
    projection launch with the ``diag(w)`` rescale in its epilogue.
    Numerics match ``ref.ref_fd_shrink``; also accepts an unstacked (2l, d)
    buffer and returns ((2l, d), ()).
    """
    squeeze = b.ndim == 2
    bs = b[None] if squeeze else b
    lam, u = ref.eigh_descending(fd_gram(bs))
    w, delta = ref.shrink_weights(lam, bs.shape[1] // 2)
    out = fd_project(w.contiguous(), u.contiguous(), bs)
    if squeeze:
        return out[0], delta[0]
    return out, delta


def fd_spectra(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched sketch spectra: (T, l, d) -> (s (T, l), vt (T, l, d)).

    Singular values descending and right singular directions of every
    stacked sketch, up to per-row sign; rows whose singular value is below
    ``1e-7 * s_max`` come back zero.  Requires l <= d.
    """
    if b.ndim != 3 or b.shape[1] > b.shape[2]:
        raise ValueError(f"fd_spectra wants stacked (T, l, d) with l <= d, got {tuple(b.shape)}")
    lam, u = ref.eigh_descending(fd_gram(b))
    s, w = ref.spectra_weights(lam)
    return s, fd_project(w.contiguous(), u.contiguous(), b)
