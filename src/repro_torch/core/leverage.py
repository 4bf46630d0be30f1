"""Leverage-score row sampling: the fourth protocol kind's math.

The paper's randomized matrix protocols (P3/P3wr) sample rows by squared
norm, which is known to be weak for low-rank structure: a direction can
carry most of the *spectral* information while holding little Frobenius
mass.  Leverage-score sampling — the workhorse of distributed PCA
(Boutsidis--Woodruff--Zhong) and the natural companion to Frequent
Directions sketches (Ghashami et al.) — samples rows by how much of the
stream's row space they explain.  This module supplies the workload's
math in the same two-implementation shape as the other kinds:

  * ``ridge_factor`` / ``ridge_scores`` — the python oracle: streaming
    approximate *ridge* leverage scores computed against a live sketch,
    ``tau_i = a_i^T (B^T B + lambda I)^+ a_i``.  The ridge ``lambda``
    (adaptively ``eps * F_hat``) keeps the pseudo-inverse stable and
    caps the effective dimension at the directions FD would retain.
  * ``LevState`` + ``lev_*`` — a fixed-shape tensor reservoir of
    ``(row, score, weight)`` triples, sorted by descending score; the
    all-pad state (every score zero) is the identity of ``lev_merge``,
    which is what lets ``lev_p1_step`` ship candidates as a masked
    gather over the site axis.
  * ``LeverageP1Stream`` / ``LeverageP2Stream`` — event-driven site ->
    coordinator protocols in the paper's style: deterministic threshold
    propagation on score-mass growth (sites forward a row outright when
    its score crosses the broadcast threshold, everything else rides an
    FD residual sketch shipped on mass growth) and the cheaper
    score-weighted reservoir-sampling variant.  Communication is counted
    via ``CommLog`` in the paper's units.
  * snapshot codec — published leverage state is an ``(n, d + 2)``
    ``[row | score | weight]`` f32 table (one immutable 2-D array per
    ``SketchStore`` version); ``table_subspace`` / ``table_scores`` are
    the single implementation every query surface shares.

Query semantics: the published table is an importance-weighted row
sample ``A_sample``; ``||A_sample x||^2 = sum_i w_i (a_i . x)^2``
estimates ``||A x||^2`` (the subspace query), and scoring a vector
against the sample's ridge-regularized Gram answers "how novel is this
row" (the score query).  Both are served inside packed sweeps by
``repro_torch.query.engine``.

A port of the reference's ``core/leverage.py``: the numpy oracle, codec,
event streams and host-side table encoders are copied (imports
rewritten); ``serve_subspace`` launches the port's ``quadform`` kernel on
the caller's device, and the reservoir (``LevState``, ``lev_*``) is torch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

import torch

from repro_torch import f32_on, resolve_device
from repro_torch.core.fd import FDSketch

__all__ = [
    "QUERY_SUBSPACE",
    "QUERY_SCORE",
    "subspace_query",
    "score_query",
    "ridge_factor",
    "ridge_scores",
    "encode_leverage_snapshot",
    "decode_leverage_snapshot",
    "weighted_rows",
    "table_subspace",
    "serve_subspace",
    "table_scores",
    "build_p1_table",
    "LevState",
    "lev_init",
    "lev_merge",
    "lev_merge_spill",
    "LeverageResult",
    "LeverageP1Stream",
    "LeverageP2Stream",
    "LEVERAGE_STREAMS",
    "run_leverage_protocol",
    "default_cap",
    "default_lambda",
]

#: Query-row mode tags for leverage tenants: a packed-service query is a
#: ``(d + 1,)`` row ``[mode, x_1..x_d]`` — ``QUERY_SUBSPACE`` asks for the
#: importance-weighted estimate of ``||A x||^2``; ``QUERY_SCORE`` for the
#: approximate ridge leverage score of ``x`` against the published sample.
QUERY_SUBSPACE = 0.0
QUERY_SCORE = 1.0


def subspace_query(x: np.ndarray) -> np.ndarray:
    """Build the ``(d + 1,)`` query row asking for ``||A x||^2``."""
    x = np.asarray(x, np.float32).ravel()
    return np.concatenate([np.array([QUERY_SUBSPACE], np.float32), x])


def score_query(x: np.ndarray) -> np.ndarray:
    """Build the ``(d + 1,)`` query row asking for the ridge score of ``x``.

    Score answers are *diagnostics* ("how novel is this direction?") on
    the ~[0, d_eff] scale: unlike subspace answers they are not covered
    by the served ``error_bound`` certificate, which is in ``eps * F_hat``
    (stream-mass) units.
    """
    x = np.asarray(x, np.float32).ravel()
    return np.concatenate([np.array([QUERY_SCORE], np.float32), x])


def default_cap(eps: float) -> int:
    """Default reservoir capacity: ``O(1/eps)`` rows, floor 16."""
    return max(16, math.ceil(4.0 / eps))


def default_lambda(eps: float, f_hat: float) -> float:
    """The adaptive ridge ``lambda = eps * max(F_hat, 1)``.

    Directions with ``sigma^2 < eps * ||A||_F^2`` are exactly the ones the
    eps-level FD sketch is allowed to shrink away, so regularizing at that
    scale caps the score mass at the retained effective dimension.
    """
    return eps * max(float(f_hat), 1.0)


# ---------------------------------------------------------------------------
# Python oracle: ridge leverage scoring against a sketch.
# ---------------------------------------------------------------------------


def ridge_factor(rows: np.ndarray, weights, lam: float) -> np.ndarray:
    """The scoring factor ``M = (sum_i w_i a_i a_i^T + lambda I)^+``.

    ``rows`` is ``(k, d)``; ``weights`` broadcasts over rows (pass 1.0 for
    a plain sketch).  ``lam > 0`` makes the Gram positive definite, so the
    pseudo-inverse is a true inverse and scoring is numerically stable
    even for rank-deficient sketches.  Returned as f64 ``(d, d)``.
    """
    rows = np.asarray(rows, np.float64)
    if rows.ndim != 2:
        raise ValueError(f"scoring rows must be (k, d), got shape {rows.shape}")
    if lam <= 0.0:
        raise ValueError(f"ridge lambda must be > 0, got {lam}")
    d = rows.shape[1]
    w = np.broadcast_to(np.asarray(weights, np.float64), (rows.shape[0],))
    g = (rows * w[:, None]).T @ rows + lam * np.eye(d)
    return np.linalg.pinv(g)


def ridge_scores(factor: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Batched quadratic forms ``tau_j = x_j^T M x_j`` (numpy reference).

    The oracle the CUDA ``levscore`` kernel is validated against; the
    event-driven streams score with this, the serving engine launches the
    fused kernel.
    """
    x = np.asarray(x, np.float64)
    return np.sum((x @ np.asarray(factor, np.float64)) * x, axis=-1)


# ---------------------------------------------------------------------------
# Snapshot codec + shared query paths over the published (n, d+2) table.
# ---------------------------------------------------------------------------


def encode_leverage_snapshot(table: np.ndarray) -> np.ndarray:
    """Validate + freeze a leverage table into the store's ``(n, d+2)`` form.

    Columns ``[0, d)`` hold the sampled (or sketch) rows, column ``d`` the
    score each row was kept at, column ``d+1`` its importance weight.
    Scores and weights must be finite and non-negative.  This is the
    matrix a ``SketchStore`` snapshot carries for a leverage tenant.
    """
    t = np.asarray(table, np.float32)
    if t.ndim != 2 or t.shape[1] < 3:
        raise ValueError(
            f"leverage snapshot table must be (n, d+2) with d >= 1, got {t.shape}"
        )
    if t.shape[0]:
        tail = t[:, -2:]
        if not np.all(np.isfinite(tail)) or tail.min() < 0.0:
            raise ValueError(
                "leverage snapshot scores and weights must be finite and >= 0"
            )
    return t


def decode_leverage_snapshot(
    matrix: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Invert ``encode_leverage_snapshot``: ``(rows, scores, weights)``."""
    m = np.asarray(matrix)
    if m.ndim != 2 or m.shape[1] < 3:
        raise ValueError(
            f"leverage snapshot matrix must be (n, d+2) with d >= 1, got {m.shape}"
        )
    return m[:, :-2], m[:, -2], m[:, -1]


def weighted_rows(rows: np.ndarray, weights) -> np.ndarray:
    """The scaled sample ``sqrt(w_i) a_i`` whose plain quadratic form IS the
    subspace estimate: ``||weighted_rows(A_s, w) x||^2 = sum_i w_i (a_i.x)^2``.

    The one place the weighting convention lives — the numpy reference
    (``table_subspace``), the registry interface, and the serving engine
    all build their sample through this before squaring (the kernel
    surfaces hand it to ``ops.quadform``), so the convention cannot
    drift between live and published answers.
    """
    rows = np.asarray(rows)
    return rows * np.sqrt(np.maximum(np.asarray(weights), 0.0))[:, None]


def table_subspace(table: np.ndarray, xs) -> np.ndarray:
    """Importance-weighted ``||A x||^2`` estimates per direction row.

    ``sum_i w_i (a_i . x)^2`` over the published sample — the numpy
    reference path; the kernel surfaces serve the same table through
    ``serve_subspace``.
    """
    xs = np.atleast_2d(np.asarray(xs, np.float64))
    rows, _, w = decode_leverage_snapshot(table)
    if rows.shape[0] == 0:
        return np.zeros(xs.shape[0], np.float32)
    proj = xs @ weighted_rows(np.asarray(rows, np.float64), w).T  # (n_query, k)
    return np.sum(proj * proj, axis=1).astype(np.float32)


def serve_subspace(table: np.ndarray, xs, *, device=None) -> np.ndarray:
    """Kernel-served twin of ``table_subspace``: one ``quadform`` launch.

    THE implementation every kernel surface uses — the live registry
    interface (``LeverageProtocol.subspace_query_batch``) and the serving
    engine's packed-sweep path (``QueryEngine._leverage_batch``) both
    call this, so live and published answers cannot drift in decode,
    weighting, empty-sample, or kernel conventions.  ``device`` is where
    the kernel runs (``None``: the CUDA card).
    """
    from repro_torch.kernels.ops import quadform

    rows, _, w = decode_leverage_snapshot(table)
    xs = np.atleast_2d(np.asarray(xs, np.float32))
    if rows.shape[0] == 0:  # empty sample: every quadratic form is 0
        return np.zeros(xs.shape[0], np.float32)
    device = resolve_device(device)
    return quadform(
        f32_on(device, weighted_rows(rows, w)), f32_on(device, xs)
    ).cpu().numpy()


def table_scores(table: np.ndarray, xs, lam: float) -> np.ndarray:
    """Ridge leverage scores of ``xs`` against the published sample's Gram."""
    xs = np.atleast_2d(np.asarray(xs, np.float64))
    rows, _, w = decode_leverage_snapshot(table)
    factor = ridge_factor(rows, w, lam)
    return ridge_scores(factor, xs).astype(np.float32)


def build_p1_table(
    kept_rows: np.ndarray, kept_scores, residual_rows: np.ndarray, lam: float
) -> np.ndarray:
    """Assemble the deterministic P1 estimator table, ``(k, d+2)`` f32.

    Kept (forwarded) rows ride at weight 1 with the score they were kept
    at; live (non-zero) residual-sketch rows ride at weight 1 with their
    ridge score against the residual's own factor.  The ONE encoder both
    P1 engines publish through — the event stream
    (``LeverageP1Stream.result``) and the shard super-step
    (``core.distributed.lev_p1_table``) — so the two engines cannot
    drift in what they serve.
    """
    d = residual_rows.shape[1] if residual_rows.ndim == 2 else kept_rows.shape[1]
    parts = []
    if kept_rows.shape[0]:
        kept = np.asarray(kept_rows, np.float64)
        parts.append(np.concatenate(
            [kept, np.asarray(kept_scores, np.float64)[:, None],
             np.ones((kept.shape[0], 1))], axis=1))
    res = np.asarray(residual_rows, np.float64)
    res = res[np.einsum("rd,rd->r", res, res) > 0]
    if res.shape[0]:
        factor = ridge_factor(res, 1.0, lam)
        parts.append(np.concatenate(
            [res, ridge_scores(factor, res)[:, None],
             np.ones((res.shape[0], 1))], axis=1))
    if not parts:
        return np.zeros((0, d + 2), np.float32)
    return np.concatenate(parts, axis=0).astype(np.float32)


# ---------------------------------------------------------------------------
# Fixed-shape tensor reservoir (the super-step engine's state).
# ---------------------------------------------------------------------------


class LevState(NamedTuple):
    """Leverage reservoir as fixed-shape tensors (pad score ``0``).

    Invariant: entries are sorted by descending score, pad slots (score 0,
    zero row, zero weight) at the tail.  An all-pad state is the identity
    of ``lev_merge`` — the property the super-step engine's masked
    candidate shipping relies on.
    """

    rows: torch.Tensor  # (cap, d) f32 — sampled rows, zero on pad
    scores: torch.Tensor  # (cap,) f32 — score at keep time, 0 = empty slot
    weights: torch.Tensor  # (cap,) f32 — importance weight, 0 on pad


def lev_init(cap: int, d: int, *, device=None) -> LevState:
    """The empty reservoir at capacity ``cap`` (merge identity)."""
    device = resolve_device(device)
    return LevState(
        rows=torch.zeros((cap, d), dtype=torch.float32, device=device),
        scores=torch.zeros((cap,), dtype=torch.float32, device=device),
        weights=torch.zeros((cap,), dtype=torch.float32, device=device),
    )


def lev_merge_spill(
    state: LevState, rows: torch.Tensor, scores: torch.Tensor, weights: torch.Tensor
) -> tuple[LevState, torch.Tensor]:
    """Merge candidate triples into the reservoir; return what spilled out.

    Keeps the top-``cap`` entries of the union by score, ties resolved
    toward the incumbent state (the lower index, as the reference's
    ``lax.top_k`` does): a stable descending sort, whose order does not
    depend on the device, so merging an all-pad candidate batch is
    bit-identical.  The second return value is the ``(n_cand + cap, d)``
    tensor of *dropped* rows (zero rows elsewhere) — the caller folds them
    into its residual sketch so reservoir overflow never loses mass.
    Leading axes (a pack's tenants) are batch axes: each reservoir merges
    and sorts its own candidates.
    """
    cap = state.scores.shape[-1]
    all_rows = torch.cat([state.rows, rows.float()], dim=-2)
    all_scores = torch.cat([state.scores, scores.float()], dim=-1)
    all_weights = torch.cat([state.weights, weights.float()], dim=-1)
    order = torch.sort(all_scores, dim=-1, descending=True, stable=True).indices
    top_idx = order[..., :cap]
    keep_mask = torch.zeros_like(all_scores, dtype=torch.bool).scatter(-1, top_idx, True)
    top_scores = all_scores.gather(-1, top_idx)
    top_rows = all_rows.gather(-2, top_idx[..., None].expand(*top_idx.shape, all_rows.shape[-1]))
    # Pad slots that survived carry stale row/weight data only if a
    # zero-score candidate had non-zero payload; mask them out for the
    # all-pad == identity property.
    live = top_scores > 0.0
    new = LevState(
        rows=torch.where(live[..., None], top_rows, 0.0),
        scores=top_scores,
        weights=torch.where(live, all_weights.gather(-1, top_idx), 0.0),
    )
    spilled = torch.where((~keep_mask[..., None]) & (all_scores[..., None] > 0.0), all_rows, 0.0)
    return new, spilled


def lev_merge(a: LevState, b: LevState) -> LevState:
    """Merge two reservoirs, keeping ``a``'s capacity (all-pad b = identity)."""
    merged, _ = lev_merge_spill(a, b.rows, b.scores, b.weights)
    return merged


# ---------------------------------------------------------------------------
# Event-driven site -> coordinator protocols (paper-style accounting).
# ---------------------------------------------------------------------------


@dataclass
class LeverageResult:
    """The coordinator's current leverage sample, queryable at any time."""

    table: np.ndarray  # (k, d+2) [row | score | weight]
    f_hat: float  # coordinator estimate of ||A||_F^2
    lam: float  # ridge lambda the sample was scored at
    comm: "object"  # CommLog in the paper's units
    m: int
    eps: float

    def subspace(self, xs) -> np.ndarray:
        """Importance-weighted ``||A x||^2`` estimate per direction row."""
        return table_subspace(self.table, xs)

    def scores(self, xs) -> np.ndarray:
        """Ridge leverage score of each queried vector vs the sample."""
        return table_scores(self.table, xs, self.lam)


class LeverageP1Stream:
    """Leverage P1: deterministic threshold propagation on score-mass growth.

    Every site scores each arriving row against the coordinator's last
    broadcast ridge factor ``M = (B^T B + lambda I)^+``.  A row whose
    score crosses the broadcast threshold ``theta`` is forwarded outright
    (it carries subspace information the summary lacks); everything else
    is absorbed into the site's FD residual sketch, shipped to the
    coordinator when the site's unshipped mass crosses the matrix-P1
    threshold ``(eps/2m) F_hat``.  The coordinator keeps the forwarded
    rows (capacity ``s``; on overflow ``theta`` doubles and the pruned
    rows fold into the residual sketch, so no mass is ever dropped) and
    rebroadcasts factor + threshold whenever its received mass grows by a
    ``1 + eps/2`` factor or ``theta`` doubles.

    The published estimator is ``kept rows (weight 1) + residual FD rows
    (weight 1)``, so the served ``||A x||^2`` inherits the deterministic
    FD envelope: kept rows are exact, residual mass is underestimated by
    at most ``eps ||A||_F^2`` (FD shrink + unshipped site tails).
    """

    def __init__(self, m, eps, d, rng=None, l=None, s=None):
        from repro_torch.core.protocols import CommLog

        if l is None:
            l = max(2, math.ceil(4.0 / eps))  # FD err 2/l <= eps/2
        if s is None:
            s = default_cap(eps)
        self.m, self.eps, self.d, self.l, self.s = m, eps, d, l, s
        self.comm = CommLog()
        self.site_fd = [FDSketch(l, d) for _ in range(m)]
        self.site_f = [0.0] * m
        self.coord_fd = FDSketch(l, d)  # residual sketch at C
        self.kept_rows: list[np.ndarray] = []  # forwarded rows (f32)
        self.kept_scores: list[float] = []
        self.f_res = 0.0  # residual mass received at C
        self.mass_kept = 0.0  # exact mass of the kept rows
        self.f_hat = 1.0
        self.theta = 1.0
        self._factor = ridge_factor(
            np.zeros((0, d)), 1.0, default_lambda(eps, self.f_hat)
        )

    def _coord_mass(self) -> float:
        return self.f_res + self.mass_kept

    def _rebroadcast(self) -> None:
        """Recompute + broadcast the ridge factor (and current threshold)."""
        self.comm.broadcast_events += 1
        rows = [self.coord_fd.matrix().astype(np.float64)]
        if self.kept_rows:
            rows.append(np.stack(self.kept_rows).astype(np.float64))
        b = np.concatenate(rows, axis=0)
        lam = default_lambda(self.eps, self._coord_mass())
        self._factor = ridge_factor(b, 1.0, lam)

    def step(self, rows, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly
        where the last batch left off."""
        m, eps = self.m, self.eps
        rows = np.asarray(rows)
        row_sq = np.einsum("nd,nd->n", rows, rows)
        for i, j in enumerate(np.asarray(sites).tolist()):
            a = rows[i].astype(np.float64)
            score = float(a @ (self._factor @ a))
            if score >= self.theta:
                # Forward the row outright: one row message.
                self.comm.item_msgs += 1
                self.kept_rows.append(rows[i].astype(np.float32))
                self.kept_scores.append(score)
                self.mass_kept += float(row_sq[i])
                if len(self.kept_rows) > self.s:
                    # Overflow: double theta, fold pruned rows into the
                    # residual sketch (coordinator-local, no messages).
                    self.theta *= 2.0
                    keep_r, keep_s = [], []
                    for r, sc in zip(self.kept_rows, self.kept_scores):
                        if sc >= self.theta:
                            keep_r.append(r)
                            keep_s.append(sc)
                        else:
                            self.coord_fd.append(r.astype(np.float64))
                            self.mass_kept -= float(r.astype(np.float64) @ r)
                            self.f_res += float(r.astype(np.float64) @ r)
                    self.kept_rows, self.kept_scores = keep_r, keep_s
                    self._rebroadcast()
            else:
                fd = self.site_fd[j]
                fd.append(rows[i])
                self.site_f[j] += float(row_sq[i])
                if self.site_f[j] >= (eps / (2 * m)) * self.f_hat:
                    mat = fd.matrix()
                    nz = mat[np.einsum("rd,rd->r", mat, mat) > 0]
                    self.comm.sketch_rows += int(nz.shape[0])
                    self.comm.scalar_msgs += 1
                    self.coord_fd.merge(fd)
                    self.f_res += self.site_f[j]
                    self.site_fd[j] = FDSketch(self.l, self.d)
                    self.site_f[j] = 0.0
                    if self._coord_mass() / self.f_hat > 1.0 + eps / 2.0:
                        self.f_hat = self._coord_mass()
                        self._rebroadcast()

    def result(self) -> LeverageResult:
        """The coordinator's current sample table (callable at any time)."""
        lam = default_lambda(self.eps, self._coord_mass())
        kept = (np.stack(self.kept_rows) if self.kept_rows
                else np.zeros((0, self.d), np.float32))
        table = build_p1_table(kept, self.kept_scores, self.coord_fd.matrix(), lam)
        return LeverageResult(table, self._coord_mass(), lam, self.comm,
                              self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        from repro_torch.core.protocols import _comm_state

        return {
            "site_fd": [fd.state_dict() for fd in self.site_fd],
            "site_f": list(self.site_f),
            "coord_fd": self.coord_fd.state_dict(),
            "kept_rows": [r.tolist() for r in self.kept_rows],
            "kept_scores": list(self.kept_scores),
            "f_res": self.f_res,
            "mass_kept": self.mass_kept,
            "f_hat": self.f_hat,
            "theta": self.theta,
            "factor": np.asarray(self._factor).tolist(),
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        from repro_torch.core.protocols import _comm_from_state

        self.site_fd = [FDSketch.from_state(s, self.l, self.d)
                        for s in state["site_fd"]]
        self.site_f = [float(f) for f in state["site_f"]]
        self.coord_fd = FDSketch.from_state(state["coord_fd"], self.l, self.d)
        self.kept_rows = [np.asarray(r, np.float32) for r in state["kept_rows"]]
        self.kept_scores = [float(s) for s in state["kept_scores"]]
        self.f_res = float(state["f_res"])
        self.mass_kept = float(state["mass_kept"])
        self.f_hat = float(state["f_hat"])
        self.theta = float(state["theta"])
        self._factor = np.asarray(state["factor"], np.float64)
        self.comm = _comm_from_state(state["comm"])


class LeverageP2Stream:
    """Leverage P2: score-weighted reservoir sampling (the cheap variant).

    Distributed priority sampling without replacement keyed by the
    *mass-scaled* ridge score ``s_i = lambda * tau_i`` — for a row
    orthogonal to the current sample this is exactly ``||a_i||^2``, for a
    well-covered row it decays toward zero, and at cold start (empty
    factor) it reduces to the matrix-P3 squared-norm key, so priorities
    stay on one scale across factor refreshes.  Site ``j`` draws
    ``rho_i = s_i / u_i`` and forwards the row when ``rho_i`` crosses the
    broadcast threshold; the coordinator keeps everything above it,
    doubling the threshold (one broadcast, which also refreshes the
    scoring factor) whenever the next round fills.  The kept set is a
    *threshold* sample — every item with ``rho_i >= tau`` — so each row's
    inclusion probability is exactly ``min(1, s_i / tau)`` and it carries
    the Horvitz--Thompson importance weight ``w_i = max(s_i, tau) / s_i``
    (deterministic given the keep, never a function of the drawn ``u``),
    making ``sum w_i (a_i . x)^2`` an unbiased estimate of
    ``||A x||^2`` — randomized, so the registry spec carries the
    sampling protocols' looser error factor.
    """

    def __init__(self, m, eps, d, rng, s=None):
        from repro_torch.core.protocols import CommLog

        if s is None:
            s = max(16, math.ceil(2.0 / eps**2))
        self.m, self.eps, self.d, self.s = m, eps, d, s
        self.rng = rng
        self.comm = CommLog()
        self.tau = 1.0
        self.q_cur: list[tuple[np.ndarray, float, float]] = []  # (row, s_i, rho)
        self.q_next: list[tuple[np.ndarray, float, float]] = []
        self._lam = default_lambda(eps, 1.0)
        self._factor = ridge_factor(np.zeros((0, d)), 1.0, self._lam)

    def _refresh_factor(self) -> None:
        # Broadcast already counted by the caller (tau doubling event).
        res = self.result()
        rows, _, w = decode_leverage_snapshot(res.table)
        self._lam = res.lam
        self._factor = ridge_factor(rows, w, res.lam)

    def step(self, rows, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly
        where the last batch left off (each row is scored against the
        factor live at its arrival, not the batch boundary)."""
        rows = np.asarray(rows)
        u = np.maximum(self.rng.uniform(size=rows.shape[0]), 1e-300)
        for i in range(rows.shape[0]):
            a = rows[i].astype(np.float64)
            score = float(a @ (self._factor @ a)) * self._lam
            rho = score / u[i]
            if rho >= self.tau:
                self.comm.item_msgs += 1
                # Copy: sampled rows outlive the caller's batch buffer.
                entry = (rows[i].astype(np.float32).copy(), score, rho)
                if rho >= 2.0 * self.tau:
                    self.q_next.append(entry)
                else:
                    self.q_cur.append(entry)
                if len(self.q_next) >= self.s:
                    self.tau *= 2.0
                    self.comm.broadcast_events += 1
                    self.q_cur = self.q_next
                    self.q_next = [t for t in self.q_cur if t[2] >= 2.0 * self.tau]
                    self.q_cur = [t for t in self.q_cur if t[2] < 2.0 * self.tau]
                    self._refresh_factor()

    def result(self) -> LeverageResult:
        """Threshold-sample estimator table (callable at any time)."""
        sample = self.q_cur + self.q_next
        if not sample:
            return LeverageResult(
                np.zeros((0, self.d + 2), np.float32), 0.0,
                default_lambda(self.eps, 1.0), self.comm, self.m, self.eps,
            )
        rows = np.stack([t[0] for t in sample]).astype(np.float64)
        scores = np.array([t[1] for t in sample], np.float64)
        # HT weight against the live threshold: pi_i = min(1, s_i / tau).
        # Deterministic given the keep — a one-row sample cannot blow up.
        w = np.maximum(scores, self.tau) / np.maximum(scores, 1e-300)
        f_hat = float(np.einsum("kd,kd,k->", rows, rows, w))
        table = np.concatenate(
            [rows, scores[:, None], w[:, None]], axis=1
        ).astype(np.float32)
        return LeverageResult(table, f_hat, default_lambda(self.eps, f_hat),
                              self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the sampler state (incl. PRNG)."""
        from repro_torch.core.protocols import _comm_state, _rng_state

        return {
            "s": self.s,
            "tau": self.tau,
            "q_cur": [[r.tolist(), sc, rho] for r, sc, rho in self.q_cur],
            "q_next": [[r.tolist(), sc, rho] for r, sc, rho in self.q_next],
            "lam": self._lam,
            "factor": np.asarray(self._factor).tolist(),
            "rng": _rng_state(self.rng),
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        from repro_torch.core.protocols import _comm_from_state, _rng_from_state

        self.s = int(state["s"])
        self.tau = float(state["tau"])
        self.q_cur = [(np.asarray(r, np.float32), float(sc), float(rho))
                      for r, sc, rho in state["q_cur"]]
        self.q_next = [(np.asarray(r, np.float32), float(sc), float(rho))
                       for r, sc, rho in state["q_next"]]
        self._lam = float(state["lam"])
        self._factor = np.asarray(state["factor"], np.float64)
        self.rng = _rng_from_state(state["rng"])
        self.comm = _comm_from_state(state["comm"])


# Resumable stream engines (init/step/result/state_dict) — the registry's
# event-engine leverage entries, mirroring QUANTILE_STREAMS.
LEVERAGE_STREAMS = {
    "P1": LeverageP1Stream,
    "P2": LeverageP2Stream,
}


def run_leverage_protocol(
    name: str,
    rows: np.ndarray,
    sites: np.ndarray,
    m: int,
    eps: float,
    seed: int = 0,
    **kw,
) -> LeverageResult:
    """One-shot wrapper: stream the whole feed through a leverage protocol."""
    rng = np.random.default_rng(seed)
    try:
        stream_cls = LEVERAGE_STREAMS[name]
    except KeyError:
        raise KeyError(
            f"unknown leverage protocol {name!r} "
            f"(have: {sorted(LEVERAGE_STREAMS)})"
        ) from None
    eng = stream_cls(m, eps, rows.shape[1], rng, **kw)
    eng.step(rows, sites)
    return eng.result()
