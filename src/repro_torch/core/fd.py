"""Frequent Directions (FD) sketch — the paper's core matrix substrate.

Two implementations, cross-validated in tests:

* ``FDState`` + ``fd_*`` functions — fixed-shape tensor implementation (the
  production path).  Uses the Ghashami--Phillips fast variant: a ``2l x d``
  buffer, shrinking back to at most ``l`` non-zero rows each time the
  buffer fills.  The shrink is computed with the Gram trick (``G = B B^T``
  is ``2l x 2l``; ``eigh`` on it instead of an SVD of ``2l x d``), whose
  two products map onto the CUDA kernels ``fd_gram`` / ``fd_project``.
  Every function also takes a stacked state — ``buf`` (..., 2l, d) with
  (...) scalars — and advances the sketches together, one batched shrink
  per chunk: the protocols' site axis, and a pack's tenant axis before it.

* ``FDSketch`` — a plain-numpy, item-at-a-time oracle with the exact
  conditional-shrink semantics of the paper.

Guarantee (Liberty'13, as quoted in the paper):  for sketch parameter ``l``
and any unit vector ``x``::

    0 <= ||A x||^2 - ||B x||^2 <= delta_sum <= 2 ||A||_F^2 / l

where ``delta_sum`` is the accumulated shrink mass (tracked in the state, so
callers get the *instance-specific* bound, usually far tighter).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

__all__ = [
    "FDState",
    "fd_init",
    "fd_update",
    "fd_update_stream",
    "fd_merge",
    "fd_query",
    "fd_matrix",
    "fd_shrink",
    "FDSketch",
]


class FDState(NamedTuple):
    """Fixed-shape Frequent Directions sketch state.

    buf:       (2l, d) row buffer; rows [0, l) hold the current sketch, rows
               [l, 2l) are the staging area for incoming rows.
    frob:      () f32 — exact total squared Frobenius norm seen so far.
    delta_sum: () f32 — accumulated shrink mass; instance error bound.
    n_seen:    () i32 — number of rows consumed (excludes zero padding).

    A stacked state has the same leading axes (T, or T and m) on every leaf.
    """

    buf: torch.Tensor
    frob: torch.Tensor
    delta_sum: torch.Tensor
    n_seen: torch.Tensor

    @property
    def l(self) -> int:  # noqa: E743 - matches paper notation
        """Sketch row budget ``l`` (paper notation)."""
        return self.buf.shape[-2] // 2

    @property
    def d(self) -> int:
        """Row dimensionality ``d``."""
        return self.buf.shape[-1]


def fd_init(l: int, d: int, dtype=torch.float32, *, device=None) -> FDState:
    """Create an empty sketch with parameter ``l`` (buffer holds ``2l`` rows)."""
    if l < 1:
        raise ValueError(f"FD sketch parameter l must be >= 1, got {l}")
    device = resolve_device(device)
    return FDState(
        buf=torch.zeros((2 * l, d), dtype=dtype, device=device),
        frob=torch.zeros((), dtype=torch.float32, device=device),
        delta_sum=torch.zeros((), dtype=torch.float32, device=device),
        n_seen=torch.zeros((), dtype=torch.int32, device=device),
    )


def fd_shrink(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One FD shrink of a full ``(2l, d)`` buffer, or of a stack of them with
    any number of leading axes (``(T, 2l, d)``, a pack's ``(T, m, 2l, d)``).

    Returns ``(new_buf, delta)`` where ``new_buf`` has at most ``l`` non-zero
    rows (sorted by decreasing singular value) and ``delta`` is the shrink
    threshold ``sigma_l^2`` removed from every retained direction.  On a
    CUDA buffer the Gram and projection products run the CUDA kernels; on
    a CPU buffer, their plain PyTorch versions (``kernels.ops.fd_shrink``).
    All the stacked buffers go through one launch of each kernel and one
    batched ``eigh``.
    """
    new_buf, delta = ops.fd_shrink(buf.float().contiguous())
    return new_buf.to(buf.dtype), delta


def fd_update(state: FDState, chunk: torch.Tensor) -> FDState:
    """Absorb a chunk of exactly ``l`` rows (zero-pad short chunks).

    Zero rows are free: they do not perturb the sketch and are excluded from
    ``frob`` / ``n_seen`` automatically (norm 0, count via non-zero test).
    """
    l = state.l
    if tuple(chunk.shape) != (*state.buf.shape[:-2], l, state.d):
        raise ValueError(
            f"fd_update wants a {(*state.buf.shape[:-2], l, state.d)} chunk, "
            f"got {tuple(chunk.shape)}"
        )
    row_sq = chunk.float().square().sum(-1)
    buf = torch.cat([state.buf[..., :l, :], chunk.to(state.buf.dtype)], dim=-2)
    new_buf, delta = fd_shrink(buf)
    return FDState(
        buf=new_buf,
        frob=state.frob + row_sq.sum(-1),
        delta_sum=state.delta_sum + delta,
        n_seen=state.n_seen + (row_sq > 0).sum(-1, dtype=torch.int32),
    )


def fd_update_stream(state: FDState, rows: torch.Tensor) -> FDState:
    """Absorb ``(n, d)`` rows (``(..., n, d)`` for a stacked state) as l-row
    chunks, n padded up to a multiple of l with zero rows."""
    l = state.l
    n = rows.shape[-2]
    n_chunks = -(-n // l)
    pad = n_chunks * l - n
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    for c in range(n_chunks):
        state = fd_update(state, rows[..., c * l : (c + 1) * l, :])
    return state


def fd_merge(a: FDState, b: FDState) -> FDState:
    """Merge two sketches (mergeable-summaries property, used by protocol P1).

    Stacks the <=l live rows of each into one 2l buffer and shrinks once.
    Error bounds add: delta_sum_merged <= delta_a + delta_b + delta_shrink.
    """
    l = a.l
    if b.buf.shape != a.buf.shape:
        raise ValueError("fd_merge requires identically-shaped sketches")
    buf = torch.cat([a.buf[..., :l, :], b.buf[..., :l, :]], dim=-2)
    new_buf, delta = fd_shrink(buf)
    return FDState(
        buf=new_buf,
        frob=a.frob + b.frob,
        delta_sum=a.delta_sum + b.delta_sum + delta,
        n_seen=a.n_seen + b.n_seen,
    )


def fd_query(state: FDState, x: torch.Tensor) -> torch.Tensor:
    """``||B x||^2`` — the paper's tracked quantity, for unit direction x.

    x: (d,) -> (); (d, N) -> (N,).  Unstacked state.
    """
    return (state.buf.float() @ x.float()).square().sum(0)


def fd_matrix(state: FDState) -> torch.Tensor:
    """The sketch matrix B (l x d): the live rows of the buffer."""
    return state.buf[..., : state.l, :]


# ---------------------------------------------------------------------------
# Numpy oracle — exact item-at-a-time semantics for the event-driven engine.
# ---------------------------------------------------------------------------


class FDSketch:
    """Plain-numpy Frequent Directions with per-item conditional shrink.

    This is the paper's algorithm verbatim: rows are appended one at a time
    into the first empty slot; when the buffer fills, shrink.  Used as the
    oracle for the tensor implementation.
    """

    def __init__(self, l: int, d: int):
        self.l = l
        self.d = d
        self.buf = np.zeros((2 * l, d), np.float64)
        self.fill = 0
        self.frob = 0.0
        self.delta_sum = 0.0
        self.n_seen = 0

    def append(self, row: np.ndarray) -> None:
        """Absorb one stream row (shrinks when the buffer fills)."""
        if self.fill == self.buf.shape[0]:
            self._shrink()
        self.buf[self.fill] = row
        self.fill += 1
        self.frob += float(row @ row)
        self.n_seen += 1

    def extend(self, rows: np.ndarray) -> None:
        # Vectorized fast path: fill in slabs, shrink when full.
        """Absorb an (n, d) batch of rows."""
        i = 0
        n = rows.shape[0]
        self.frob += float(np.sum(rows * rows))
        self.n_seen += n
        while i < n:
            if self.fill == self.buf.shape[0]:
                self._shrink()
            take = min(n - i, self.buf.shape[0] - self.fill)
            self.buf[self.fill : self.fill + take] = rows[i : i + take]
            self.fill += take
            i += take

    def _shrink(self) -> None:
        g = self.buf @ self.buf.T
        lam, u = np.linalg.eigh(g)
        lam = np.maximum(lam[::-1], 0.0)
        u = u[:, ::-1]
        delta = lam[self.l]
        w = np.sqrt(np.maximum(lam - delta, 0.0) / np.maximum(lam, 1e-300))
        w[lam <= 1e-300] = 0.0
        self.buf = (w[:, None] * (u.T @ self.buf))
        self.delta_sum += float(delta)
        self.fill = self.l

    def matrix(self) -> np.ndarray:
        """Current sketch rows (fill x d)."""
        return self.buf[: self.fill]

    def query(self, x: np.ndarray) -> float:
        """``||B x||^2`` — the sketch's estimate of ``||A x||^2``."""
        v = self.buf[: self.fill] @ x
        return float(v @ v)

    def merge(self, other: "FDSketch") -> None:
        """Fold another FD sketch in (mergeable-summaries merge)."""
        self.extend(other.matrix())
        # extend() already added other's frob/n via rows; but rows of a sketch
        # under-count the true stream mass — correct with other's bookkeeping.
        self.frob += other.frob - float(np.sum(other.matrix() ** 2))
        self.n_seen += other.n_seen - other.matrix().shape[0]
        self.delta_sum += other.delta_sum

    def covariance_error(self, a: np.ndarray) -> float:
        """``||A^T A - B^T B||_2 / ||A||_F^2`` — the paper's err metric."""
        b = self.matrix()
        m = a.T @ a - b.T @ b
        return float(np.linalg.norm(m, 2) / max(np.sum(a * a), 1e-300))

    # -- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of the sketch (exact float round-trip)."""
        return {
            "buf": self.buf.tolist(),
            "fill": self.fill,
            "frob": self.frob,
            "delta_sum": self.delta_sum,
            "n_seen": self.n_seen,
        }

    @classmethod
    def from_state(cls, state: dict, l: int, d: int) -> "FDSketch":
        """Rebuild a sketch from ``state_dict`` output (state identity)."""
        fd = cls(l, d)
        fd.buf = np.asarray(state["buf"], np.float64)
        fd.fill = int(state["fill"])
        fd.frob = float(state["frob"])
        fd.delta_sum = float(state["delta_sum"])
        fd.n_seen = int(state["n_seen"])
        return fd
