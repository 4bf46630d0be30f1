"""Batched query engine over the versioned sketch store.

Serves the paper's matrix query — ``||B x||^2`` as an eps-approximation of
``||A x||^2`` — for whole batches of directions against a pinned snapshot,
three ways:

  * ``kernel``  — the batched quadratic-form CUDA kernel
                  (``repro_torch.kernels.ops.quadform``): one pass over B
                  per batch.  The reference calls this path ``pallas``.
  * ``cached``  — factor once per (tenant, version) into the sketch's
                  singular spectrum, then every batch is a thin
                  ``(N, d) @ (d, l)`` matmul; ``top_directions`` and
                  ``stable_rank`` read the same cache entry for free.
  * ``naive``   — recompute the SVD per query: the strawman a serving
                  layer exists to beat.

All paths agree to fp tolerance; every result carries the snapshot's
additive error bound (``delta_sum`` when known, else ``eps ||A||_F^2``).

Snapshots whose ``meta["workload"]`` is ``"hh"`` hold weighted heavy-hitter
estimates (an ``(n, 2)`` [element, estimate] matrix, see
``core.hh.encode_hh_snapshot``) instead of a row sketch; queries against
them are frequency point-lookups — each "direction" is a single element id
— answered with the same ``QueryResult`` shape and the paper's ``eps W``
additive bound.  ``meta["workload"] == "quantile"`` snapshots hold a sorted
``(n, 2)`` [value, rank-estimate] table
(``core.quantiles.encode_quantile_snapshot``); each query is a ``(2,)``
``[mode, arg]`` row — rank-at-value or phi-quantile — answered by one
searchsorted pass on the host.  ``meta["workload"] == "leverage"``
snapshots hold an ``(n, d+2)`` [row | score | weight] importance-weighted
row sample (``core.leverage.encode_leverage_snapshot``); each query is a
``(d+1,)`` ``[mode, x]`` row — a subspace query ``sum_i w_i (a_i . x)^2``
served by the shared ``quadform`` kernel over the weighted sample, or a
ridge leverage score served by the ``levscore`` kernel.  All four kinds
share one admission path and one packed dispatch loop.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import f32_on, resolve_device
from repro_torch.obs import Observability, rehome_families
from repro_torch.query.store import SketchSnapshot, SketchStore

__all__ = ["PackedRequest", "QueryEngine", "QueryResult", "Spectrum"]

PATHS = ("kernel", "cached", "naive")


class PackedRequest(NamedTuple):
    """One tenant's slice of a cross-tenant packed batch."""

    tenant: str
    x: np.ndarray  # (n_i, d) directions for this tenant
    version: int | None = None


class Spectrum(NamedTuple):
    """Cached factorization of a snapshot: B = U diag(s) Vt (thin)."""

    s: np.ndarray  # (l,) singular values, descending
    vt: np.ndarray  # (l, d) right singular directions


class QueryResult(NamedTuple):
    """One tenant's served batch: estimates + the snapshot's certificate."""

    estimates: np.ndarray  # (n,) f32 — ||B x_j||^2 per query
    error_bound: float  # additive bound vs the true answer
    tenant: str
    version: int
    path: str


def _svd_spectrum(matrix: np.ndarray) -> Spectrum:
    _, s, vt = np.linalg.svd(matrix, full_matrices=False)
    return Spectrum(s=s, vt=vt)


def _workload(snap: SketchSnapshot) -> str:
    """A snapshot's workload kind (``"matrix"`` when untagged)."""
    return snap.meta.get("workload", "matrix")


class QueryEngine:
    """Serves batched queries against pinned ``SketchStore`` snapshots.

    Matrix snapshots ride the quadform paths (kernel / cached / naive) on
    ``device``; ``query_packed`` packs many tenants per kernel launch.
    HH and quantile snapshots are searchsorted lookups on the host;
    leverage snapshots ride their own weighted quadform / levscore sweeps.
    """

    _FAMILIES = (
        ("counter", "repro_engine_cache_ops_total",
         "Per-version cache lookups by cache (spectrum/factor) and op "
         "(hits/misses/evictions)."),
        ("counter", "repro_engine_packed_launches_total",
         "Kernel launches spent by query_packed."),
        ("counter", "repro_engine_packed_pad_slots_total",
         "Zero-filled query slots added while packing."),
    )

    def __init__(
        self,
        store: SketchStore,
        *,
        cache_size: int = 16,
        device=None,
        obs: Observability | None = None,
    ):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        self.store = store
        self.cache_size = cache_size
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Observability()
        self._cache: OrderedDict[tuple[str, int], Spectrum] = OrderedDict()
        # Leverage tenants' ridge factors, f32 on ``device`` (what the
        # levscore kernel reads), per (tenant, version).
        self._factor_cache: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self._bind_metrics()

    def _bind_metrics(self) -> None:
        kind, name, help = self._FAMILIES[0]
        self._m_cache = {
            (which, op): self.obs.handle(
                kind, name, help, labels={"cache": which, "op": op}
            )
            for which in ("spectrum", "factor")
            for op in ("hits", "misses", "evictions")
        }
        self._m_launches = self.obs.handle(*self._FAMILIES[1])
        self._m_pad = self.obs.handle(*self._FAMILIES[2])

    def bind_obs(self, obs: Observability) -> None:
        """Re-home this engine's telemetry into another bundle."""
        old, self.obs = self.obs, obs
        rehome_families(old, obs, self._FAMILIES)
        self._bind_metrics()

    @property
    def packed_launches(self) -> int:
        """Kernel launches spent by ``query_packed`` (registry view)."""
        return int(self._m_launches.value)

    @property
    def packed_pad_slots(self) -> int:
        """Zero-filled query slots added while packing (registry view)."""
        return int(self._m_pad.value)

    # -- spectrum cache ------------------------------------------------------

    def spectrum(self, tenant: str, version: int | None = None) -> Spectrum:
        """The snapshot's singular spectrum, LRU-cached by (tenant, version).

        Versions are immutable, so a hit can never be stale; publishing a
        new version changes the key, which *is* the invalidation.
        """
        return self._spectrum_for(self.store.get(tenant, version))

    def _lru_get(self, cache: OrderedDict, key, compute, which: str):
        """One LRU discipline for every per-version cache: keyed
        hit/miss/eviction counters (``which`` names the cache), move-to-end
        on hit, evict the oldest past ``cache_size``."""
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
            self._m_cache[(which, "hits")].inc()
            return hit
        self._m_cache[(which, "misses")].inc()
        value = compute()
        cache[key] = value
        while len(cache) > self.cache_size:
            cache.popitem(last=False)
            self._m_cache[(which, "evictions")].inc()
        return value

    def _spectrum_for(self, snap: SketchSnapshot) -> Spectrum:
        return self._lru_get(
            self._cache,
            (snap.tenant, snap.version),
            lambda: _svd_spectrum(snap.matrix),
            "spectrum",
        )

    def refresh_spectra(self, snaps: list) -> int:
        """Warm the spectrum cache for freshly published matrix snapshots.

        Groups the snapshots' sketches by (l, d) shape (wide sketches
        only, ``l <= d``) and factors each group with ONE stacked Gram
        eigendecomposition (``kernels.ops.fd_spectra``) instead of one
        SVD per tenant.  Per-row signs may differ from the SVD path; every
        consumer (cached quadforms, ``top_directions``, ``stable_rank``)
        is sign-invariant or inherits the same inherent ambiguity.
        Entries land in the LRU the query paths read; hits/misses are
        not counted (this is a prefill, not a lookup), evictions are.
        Non-matrix, tall, empty, or already-cached snapshots are
        skipped.  Returns the number of spectra warmed.
        """
        from repro_torch.kernels.ops import fd_spectra

        by_shape: dict[tuple[int, int], list[SketchSnapshot]] = {}
        for snap in snaps:
            mat = np.asarray(snap.matrix)
            if (
                _workload(snap) != "matrix"
                or (snap.tenant, snap.version) in self._cache
                or mat.ndim != 2
                or not 0 < mat.shape[0] <= mat.shape[1]
            ):
                continue
            by_shape.setdefault(mat.shape, []).append(snap)
        warmed = 0
        evictions = self._m_cache[("spectrum", "evictions")]
        for group in by_shape.values():
            b = f32_on(self.device, np.stack([np.asarray(s.matrix) for s in group]))
            s_all, vt_all = fd_spectra(b)
            s_all, vt_all = s_all.cpu().numpy(), vt_all.cpu().numpy()
            for t, snap in enumerate(group):
                self._cache[(snap.tenant, snap.version)] = Spectrum(
                    s=s_all[t], vt=vt_all[t]
                )
                warmed += 1
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
                    evictions.inc()
        return warmed

    def _cache_op(self, which: str, op: str) -> int:
        return int(self._m_cache[(which, op)].value)

    @property
    def cache_hits(self) -> int:
        """Total cache hits across both per-version caches."""
        return self._cache_op("spectrum", "hits") + self._cache_op("factor", "hits")

    @property
    def cache_misses(self) -> int:
        """Total cache misses across both per-version caches."""
        return self._cache_op("spectrum", "misses") + self._cache_op("factor", "misses")

    def cache_stats(self) -> dict:
        """Keyed counters for the per-version caches (a registry view).

        ``hits``/``misses``/``evictions`` aggregate both caches;
        ``spectrum`` and ``factor`` break the same counters out per cache;
        ``entries`` is the spectrum cache's resident count,
        ``factor_entries`` the leverage factor cache's; ``hit_rate`` is the
        aggregate fraction of lookups served from cache (0.0 on a cold
        cache, never NaN).  The dict is built fresh per call.
        """
        hits, misses = self.cache_hits, self.cache_misses
        return {
            "hits": hits,
            "misses": misses,
            "evictions": (self._cache_op("spectrum", "evictions")
                          + self._cache_op("factor", "evictions")),
            "entries": len(self._cache),
            "factor_entries": len(self._factor_cache),
            "spectrum": {op: self._cache_op("spectrum", op)
                         for op in ("hits", "misses", "evictions")},
            "factor": {op: self._cache_op("factor", op)
                       for op in ("hits", "misses", "evictions")},
            "hit_rate": hits / max(hits + misses, 1),
        }

    # -- batched quadratic forms --------------------------------------------

    def query_batch(
        self,
        x: np.ndarray,
        *,
        tenant: str = "default",
        version: int | None = None,
        path: str = "kernel",
    ) -> QueryResult:
        """Serve every row of ``x`` against the tenant's pinned snapshot.

        Matrix tenants: ``||B x_j||^2`` per (d,)-direction row, on the
        chosen ``path``.  HH tenants: one estimate per element id (``(n,)``
        or ``(n, 1)``); quantile tenants: one answer per ``(2,)`` ``[mode,
        arg]`` row; leverage tenants: one answer per ``(d+1,)`` ``[mode, x]``
        row (``path`` is ignored for these; each lookup has one
        implementation).
        """
        if path not in PATHS:
            raise ValueError(f"unknown query path {path!r}; choose from {PATHS}")
        with self.obs.trace("engine.query_batch", tenant=tenant, path=path):
            return self._query_batch(x, tenant=tenant, version=version, path=path)

    def _query_batch(
        self,
        x: np.ndarray,
        *,
        tenant: str,
        version: int | None,
        path: str,
    ) -> QueryResult:
        snap = self.store.get(tenant, version)
        x = np.asarray(x, np.float32)
        wl = _workload(snap)
        if wl in _LOOKUPS:
            return QueryResult(
                estimates=_LOOKUPS[wl](self, snap, x),
                error_bound=snap.error_bound,
                tenant=snap.tenant,
                version=snap.version,
                path=wl,
            )
        if x.ndim != 2 or x.shape[1] != snap.matrix.shape[1]:
            raise ValueError(
                f"directions must be (n, {snap.matrix.shape[1]}), got {x.shape}"
            )
        if path == "kernel":
            est = self._kernel_batch(snap, x)
        elif path == "cached":
            est = self._cached_batch(snap, x)
        else:
            est = self._naive_batch(snap, x)
        return QueryResult(
            estimates=est,
            error_bound=snap.error_bound,
            tenant=snap.tenant,
            version=snap.version,
            path=path,
        )

    def query(self, x: np.ndarray, **kw) -> float:
        """Single-direction convenience wrapper over ``query_batch``."""
        return float(self.query_batch(np.asarray(x)[None, :], **kw).estimates[0])

    def query_packed(self, requests: list[PackedRequest]) -> list[QueryResult]:
        """Serve many tenants' query batches, packing kernel launches.

        Matrix requests whose pinned sketches share an (l, d) shape are
        stacked — sketches into (T, l, d), directions zero-padded to a
        common N into (T, N, d) — and served by ONE ``quadform_packed``
        launch.  Shapes that appear only once go through the per-tenant
        kernel; leverage requests are served by their per-tenant weighted
        sweeps in the same call.  Results come back in request order, one
        ``QueryResult`` each, identical (to fp tolerance) to serial
        per-tenant ``query_batch``.
        """
        with self.obs.trace("engine.query_packed", requests=len(requests)):
            return self._query_packed(requests)

    def _query_packed(self, requests: list[PackedRequest]) -> list[QueryResult]:
        from repro_torch.kernels.ops import quadform_packed

        snaps: list[SketchSnapshot] = []
        xs: list[np.ndarray] = []
        lookups: dict[int, str] = {}  # request index -> lookup workload
        for i, req in enumerate(requests):
            snap = self.store.get(req.tenant, req.version)
            x = np.asarray(req.x, np.float32)
            if _workload(snap) in _LOOKUPS:
                lookups[i] = _workload(snap)
            elif x.ndim != 2 or x.shape[1] != snap.matrix.shape[1]:
                raise ValueError(
                    f"tenant {req.tenant!r}: directions must be "
                    f"(n, {snap.matrix.shape[1]}), got {x.shape}"
                )
            snaps.append(snap)
            xs.append(x)

        estimates: list[np.ndarray | None] = [None] * len(requests)
        by_shape: dict[tuple[int, int], list[int]] = {}
        for i, snap in enumerate(snaps):
            if i not in lookups:
                by_shape.setdefault(snap.matrix.shape, []).append(i)
        for i, wl in lookups.items():
            estimates[i] = _LOOKUPS[wl](self, snaps[i], xs[i])

        for shape, idxs in by_shape.items():
            self._m_launches.inc()
            if len(idxs) == 1:
                i = idxs[0]
                estimates[i] = self._kernel_batch(snaps[i], xs[i])
                continue
            n_max = max(xs[i].shape[0] for i in idxs)
            b_stack = np.stack([np.asarray(snaps[i].matrix) for i in idxs])
            x_stack = np.zeros((len(idxs), n_max, shape[1]), np.float32)
            for t, i in enumerate(idxs):
                x_stack[t, : xs[i].shape[0]] = xs[i]
                self._m_pad.inc(n_max - xs[i].shape[0])
            out = quadform_packed(f32_on(self.device, b_stack), f32_on(self.device, x_stack))
            out = out.cpu().numpy()
            for t, i in enumerate(idxs):
                estimates[i] = out[t, : xs[i].shape[0]]

        return [
            QueryResult(
                estimates=est,
                error_bound=snap.error_bound,
                tenant=snap.tenant,
                version=snap.version,
                path=lookups.get(i, "kernel"),
            )
            for i, (est, snap) in enumerate(zip(estimates, snaps))
        ]

    def _kernel_batch(self, snap: SketchSnapshot, x: np.ndarray) -> np.ndarray:
        from repro_torch.kernels.ops import quadform

        return quadform(f32_on(self.device, snap.matrix), f32_on(self.device, x)).cpu().numpy()

    def _hh_batch(self, snap: SketchSnapshot, x: np.ndarray) -> np.ndarray:
        """Vectorized HH point-lookup: estimated weight per queried element.

        ``x`` is an ``(n, 1)`` (or ``(n,)``) batch of element ids; unknown
        elements estimate 0 (the MG underestimate convention).  Ids compare
        exactly: both sides ride the f32 encoding of ints < 2**24.
        """
        q = np.asarray(x, np.float32)
        if q.ndim == 2 and q.shape[1] == 1:
            q = q[:, 0]
        if q.ndim != 1:
            raise ValueError(
                f"tenant {snap.tenant!r}: HH queries must be (n,) or (n, 1) "
                f"element ids, got {np.asarray(x).shape}"
            )
        mat = np.asarray(snap.matrix)
        if mat.shape[0] == 0:
            return np.zeros(q.shape[0], np.float32)
        # encode_hh_snapshot stores keys sorted and unique: binary search
        # instead of a dense (queries x keys) equality matrix.
        keys, counts = mat[:, 0], mat[:, 1]
        idx = np.clip(np.searchsorted(keys, q), 0, keys.shape[0] - 1)
        return np.where(keys[idx] == q, counts[idx], 0.0).astype(np.float32)

    def _quantile_batch(self, snap: SketchSnapshot, x: np.ndarray) -> np.ndarray:
        """Quantile lookups: each query row is ``(2,)`` ``[mode, arg]``.

        Mode ``QUERY_RANK`` (0) estimates the weighted rank of value
        ``arg``; mode ``QUERY_QUANTILE`` (1) returns the value whose rank
        is nearest ``arg * W`` — both one searchsorted pass over the
        published table, the same code path the live protocols answer
        from (``core.quantiles.table_rank`` / ``table_quantile``).
        """
        from repro_torch.core.quantiles import (
            QUERY_QUANTILE,
            QUERY_RANK,
            table_quantile,
            table_rank,
        )

        q = np.asarray(x, np.float32)
        if q.ndim != 2 or q.shape[1] != 2:
            raise ValueError(
                f"tenant {snap.tenant!r}: quantile queries must be (n, 2) "
                f"[mode, arg] rows, got {np.asarray(x).shape}"
            )
        modes, args = q[:, 0], q[:, 1]
        is_rank = modes == QUERY_RANK
        is_quant = modes == QUERY_QUANTILE
        if not np.all(is_rank | is_quant):
            raise ValueError(
                f"tenant {snap.tenant!r}: quantile query mode must be "
                f"{QUERY_RANK} (rank) or {QUERY_QUANTILE} (phi-quantile)"
            )
        mat = np.asarray(snap.matrix)
        out = np.empty(q.shape[0], np.float32)
        out[is_rank] = table_rank(mat, args[is_rank])
        out[is_quant] = table_quantile(mat, snap.frob, args[is_quant])
        return out

    def _leverage_batch(self, snap: SketchSnapshot, x: np.ndarray) -> np.ndarray:
        """Leverage lookups: each query row is ``(d+1,)`` ``[mode, x_1..x_d]``.

        Mode ``QUERY_SUBSPACE`` (0) serves the importance-weighted
        ``||A x||^2`` estimate ``sum_i w_i (a_i . x)^2`` — the weighted
        sample rows ride the same ``quadform`` kernel matrix snapshots
        use.  Mode ``QUERY_SCORE`` (1) serves the approximate ridge
        leverage score of ``x`` against the published sample's Gram via
        the ``levscore`` kernel (the snapshot's ``meta["lam"]`` pins the
        ridge the sample was published at).

        The batch's ``error_bound`` (``eps * F_hat``) certifies the
        SUBSPACE answers only; a ridge score lives on the ~[0, d_eff]
        scale and carries no additive certificate — score answers are
        diagnostics, not bounded estimates (see ``core.leverage.score_query``).
        """
        from repro_torch.core.leverage import QUERY_SCORE, QUERY_SUBSPACE, serve_subspace
        from repro_torch.kernels.ops import levscore

        mat = np.asarray(snap.matrix)
        d = mat.shape[1] - 2
        q = np.asarray(x, np.float32)
        if q.ndim != 2 or q.shape[1] != d + 1:
            raise ValueError(
                f"tenant {snap.tenant!r}: leverage queries must be (n, {d + 1}) "
                f"[mode, x] rows, got {np.asarray(x).shape}"
            )
        modes, dirs = q[:, 0], q[:, 1:]
        is_sub = modes == QUERY_SUBSPACE
        is_score = modes == QUERY_SCORE
        if not np.all(is_sub | is_score):
            raise ValueError(
                f"tenant {snap.tenant!r}: leverage query mode must be "
                f"{QUERY_SUBSPACE} (subspace) or {QUERY_SCORE} (score)"
            )
        out = np.empty(q.shape[0], np.float32)
        if np.any(is_sub):
            out[is_sub] = serve_subspace(mat, dirs[is_sub], device=self.device)
        if np.any(is_score):
            out[is_score] = levscore(
                self._factor_for(snap), f32_on(self.device, dirs[is_score])
            ).cpu().numpy()
        return out

    def _factor_for(self, snap: SketchSnapshot) -> torch.Tensor:
        """The leverage snapshot's ridge scoring factor, LRU-cached.

        Keyed ``(tenant, version)`` like ``_spectrum_for`` (same shared
        LRU discipline via ``_lru_get``; the version pins ``meta["lam"]``),
        which keeps repeated score sweeps against a pinned snapshot from
        redoing the O(d^3) pseudo-inverse (numpy f64, on the host) per
        batch.  Cached as the f32 tensor on ``device`` that the kernel reads.
        """
        from repro_torch.core.leverage import (
            decode_leverage_snapshot,
            default_lambda,
            ridge_factor,
        )

        def compute() -> torch.Tensor:
            rows, _, w = decode_leverage_snapshot(np.asarray(snap.matrix))
            lam = float(snap.meta.get("lam", default_lambda(snap.eps, snap.frob)))
            return f32_on(self.device, ridge_factor(rows, w, lam))

        return self._lru_get(
            self._factor_cache, (snap.tenant, snap.version), compute, "factor"
        )

    def _cached_batch(self, snap: SketchSnapshot, x: np.ndarray) -> np.ndarray:
        spec = self._spectrum_for(snap)
        proj = (x @ spec.vt.T) * spec.s[None, :]
        return np.sum(proj * proj, axis=1, dtype=np.float32).astype(np.float32)

    def _naive_batch(self, snap: SketchSnapshot, x: np.ndarray) -> np.ndarray:
        out = np.empty(x.shape[0], np.float32)
        for i, row in enumerate(x):
            spec = _svd_spectrum(snap.matrix)  # deliberately recomputed per query
            proj = spec.s * (spec.vt @ row)
            out[i] = np.float32(proj @ proj)
        return out

    # -- spectral summaries (served from the same cache) ---------------------

    def top_directions(
        self, k: int, *, tenant: str = "default", version: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Streaming-PCA answer: top-k right singular directions + values."""
        spec = self.spectrum(tenant, version)
        k = min(k, spec.s.shape[0])
        return spec.vt[:k], spec.s[:k]

    def stable_rank(self, *, tenant: str = "default", version: int | None = None) -> float:
        """``||B||_F^2 / sigma_1^2`` of the pinned sketch."""
        spec = self.spectrum(tenant, version)
        if spec.s.size == 0:
            return 0.0
        return float(np.sum(spec.s**2) / max(float(spec.s[0] ** 2), 1e-30))


# Non-matrix workloads: snapshot kinds served by their own per-tenant path
# (searchsorted for hh/quantile, weighted quadform / levscore sweeps for
# leverage) instead of joining the cross-tenant quadform pack.  One
# dispatch point for query_batch and query_packed, so adding a kind cannot
# desynchronize the two paths.
_LOOKUPS = {
    "hh": QueryEngine._hh_batch,
    "quantile": QueryEngine._quantile_batch,
    "leverage": QueryEngine._leverage_batch,
}
