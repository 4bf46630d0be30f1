"""Continuous distributed matrix tracking as a training-telemetry service.

``DistributedMatrixTracker`` rides along a training run: each data-parallel
shard is a paper "site", the rows it feeds are (sub-sampled) token
hidden-states or gradient rows, and the coordinator sketch gives, at any
step, streaming answers to:

  * ``query(x)``  — ||A x||^2 for any direction x (the paper's guarantee)
  * ``top_directions(k)`` — streaming PCA of everything seen so far
  * ``stable_rank()``     — ||A||_F^2 / sigma_1^2, a live collapse metric

at the paper's O((m/eps) log beta N) communication cost instead of shipping
activations anywhere.

The tracker is a thin facade over the runtime protocol registry
(``repro_torch.runtime.registry``): protocol dispatch, sketch extraction,
the Frobenius estimate, message accounting, and the quadform query path
all come from the registered ``SketchProtocol``.  The m sites are the site
axis of one device, where the reference takes a mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.comm import CommReport

__all__ = ["DistributedMatrixTracker", "TrackerSnapshot"]


class TrackerSnapshot(NamedTuple):
    """Point-in-time tracker view: top-k spectrum, mass, and message costs."""
    basis: np.ndarray  # (k, d) top right-singular directions
    singular_values: np.ndarray  # (k,)
    frob_estimate: float
    stable_rank: float
    messages: CommReport


class DistributedMatrixTracker:
    """Facade over the registry's super-step engine (default: protocol P2)."""

    def __init__(
        self,
        m: int,
        d: int,
        *,
        eps: float = 0.1,
        protocol: str = "P2",
        rows_per_step: int = 0,
        device=None,
    ):
        # Lazy: runtime sits above core in the layering.
        from repro_torch.runtime.registry import create_protocol

        self._proto = create_protocol(protocol, engine="shard", m=m, d=d, eps=eps, device=device)
        self.cfg = self._proto.cfg
        self.protocol = protocol
        self.rows_per_step = rows_per_step

    @property
    def state(self):
        """The underlying protocol's live state."""
        return self._proto.state

    @property
    def rows_fed(self) -> int:
        """Stream rows absorbed so far."""
        return self._proto.rows_seen

    def update(self, rows) -> None:
        """Absorb a global (m * b, d) batch of rows; site i takes slice i."""
        self._proto.step(rows)

    def sketch_matrix(self) -> np.ndarray:
        """The coordinator's current sketch matrix B (host numpy)."""
        return self._proto.matrix()

    def frob_estimate(self) -> float:
        """Coordinator estimate of ``||A||_F^2`` (uniform across protocols)."""
        return self._proto.frob_estimate()

    def query(self, x) -> float:
        """``||B x||^2`` via the shared ``kernels.ops.quadform`` path — the
        same kernel the serving engine launches."""
        return self._proto.query(np.asarray(x))

    def query_batch(self, x) -> np.ndarray:
        """Batched ``||B x_j||^2`` over the same quadform path."""
        return self._proto.query_batch(np.asarray(x))

    def publish(self, store, tenant: str = "default", *, meta: dict | None = None,
                published_at: float = 0.0):
        """Publish the coordinator sketch into a ``repro_torch.query.SketchStore``.

        Snapshots are immutable and versioned, so the serving layer answers
        batched queries against a pinned version while training keeps
        streaming rows into this tracker.  Returns the ``SketchSnapshot``.
        """
        md = {"protocol": self.protocol, "m": self.cfg.m}
        if meta:
            md.update(meta)
        return store.publish(
            tenant,
            self.sketch_matrix(),
            frob=self.frob_estimate(),
            eps=self.cfg.eps,
            n_seen=self.rows_fed,
            meta=md,
            published_at=published_at,
        )

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self._proto.comm_report()

    def state_payload(self):
        """Live protocol state as ``(arrays, meta)`` (pipeline checkpoints)."""
        return self._proto.state_payload()

    def restore_payload(self, arrays, meta) -> None:
        """Restore state captured by ``state_payload`` bit-identically."""
        self._proto.restore_payload(arrays, meta)

    def snapshot(self, k: int = 8) -> TrackerSnapshot:
        """Materialize a point-in-time view: top-k spectrum + stable rank + comm."""
        b = self.sketch_matrix()
        u, s, vt = np.linalg.svd(b, full_matrices=False)
        k = min(k, s.shape[0])
        frob = float(np.sum(s**2))
        sr = frob / max(float(s[0] ** 2), 1e-30) if s.size else 0.0
        return TrackerSnapshot(
            basis=vt[:k],
            singular_values=s[:k],
            frob_estimate=frob,
            stable_rank=sr,
            messages=self.comm_report(),
        )
