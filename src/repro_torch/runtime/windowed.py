"""Windowed + decayed protocol specs for all four kinds.

Adapts ``core.windows`` (bucketed sliding window, exponential decay) to
the registry's four protocol ABCs and registers them as first-class
``(kind, engine, name)`` specs:

=========  =============  ==============================================
kind       names          serve state
=========  =============  ==============================================
matrix     P2win/P2decay  FD sketch folded across live buckets
hh         P1win/P1decay  Misra-Gries summary folded across live buckets
quantile   P1win/P1decay  GK summary folded across live buckets
leverage   P1win/P1decay  norm-scored reservoir + FD spill residual
=========  =============  ==============================================

``step`` grows a keyword-only ``ts`` (event time).  Without it the
wrapper synthesizes monotone step-count time (one unit per batch), which
makes windowed specs drop-in under every existing driver — the registry
harnesses, pipeline packed-ingest fallbacks, benchmarks — while real
deployments pass event time through ``StreamingPipeline.ingest``.

Communication model (paper units): sites push one scalar digest per
applied batch; the coordinator pulls the live per-bucket/per-site sketch
states (``ops.state_rows`` rows each) whenever it has to serve a fresher
answer than its cache.  Both counters ride the checkpoint payload so a
restored protocol reports bit-identical accounting.

The checkpoint contract matches every other spec: ``state_payload``
flattens the per-bucket tensor states (in the reference's leaf order) plus
parked (pending) batches into named numpy leaves, and ``restore_payload``
rejects geometry mismatches before touching any state — so each package
loads the other's windowed checkpoints.

Sketch states live on the protocol's ``device`` (``None``: the CUDA card);
the shard flavour takes the pipeline's ``m`` where the reference takes a
mesh, and runs its m software sites as separate states on that device.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fd
from repro_torch.core import hh as hhc
from repro_torch.core import leverage as lev
from repro_torch.core import quantiles as q
from repro_torch.core import windows
from repro_torch.core.comm import CommReport, build_report
from repro_torch.runtime.registry import (
    HHProtocol,
    LeverageProtocol,
    ProtocolSpec,
    QuantileProtocol,
    SketchProtocol,
    _leaves,
    _rebuild,
    register_protocol,
)

__all__ = [
    "DEFAULT_WINDOW",
    "DEFAULT_GAMMA",
    "WindowedMatrixProtocol",
    "WindowedHHProtocol",
    "WindowedQuantileProtocol",
    "WindowedLeverageProtocol",
]

# Synthetic time advances one unit per batch, so the defaults mean
# "effectively unwindowed" until a caller opts into real event time:
# the full harness/benchmark streams stay inside one live window and the
# default decay forgets ~0.1% per batch.
DEFAULT_WINDOW = float(2**20)
DEFAULT_GAMMA = 0.999


class _TimeWrapped:
    """Shared machinery: synthetic time, serve cache, comm, checkpoints."""

    def _init_time(
        self,
        ops: windows.WindowOps,
        mode: str,
        *,
        sites: int = 1,
        window: float | None = None,
        buckets: int = 8,
        lateness: float = 0.0,
        gamma: float | None = None,
        half_life: float | None = None,
    ) -> None:
        if mode == "win":
            self._tracked: windows._TimedSketch = windows.SlidingWindow(
                ops,
                window=DEFAULT_WINDOW if window is None else float(window),
                buckets=buckets,
                sites=sites,
                lateness=lateness,
            )
        elif mode == "decay":
            if gamma is None and half_life is None:
                gamma = DEFAULT_GAMMA
            self._tracked = windows.ExponentialDecay(
                ops, gamma=gamma, half_life=half_life, sites=sites, lateness=lateness
            )
        else:
            raise ValueError(f"mode must be 'win' or 'decay', got {mode!r}")
        self._mode = mode
        self._ops = ops
        self._last_ts = 0.0
        self._ship_rows = 0
        self._serve_cache: Any = None
        self._serve_epoch = -1

    # -- ingest ----------------------------------------------------------

    def _step_timed(self, arr: np.ndarray, ts: float | None) -> None:
        if arr.shape[0] == 0:
            return
        if ts is None:
            ts = self._last_ts + 1.0
        ts = float(ts)
        self._tracked.insert(arr, ts)  # raises LateRowError on shed
        if ts > self._last_ts:
            self._last_ts = ts
        self.rows_seen += int(arr.shape[0])
        self._invalidate()

    def _invalidate(self) -> None:
        pass

    def advance(self, ts: float) -> None:
        """Watermark heartbeat: close buckets without ingesting rows."""
        self._tracked.advance(ts)
        if float(ts) > self._last_ts:
            self._last_ts = float(ts)

    # -- time introspection (pipeline gauges / OnWindowClose) ------------

    def windows_closed(self) -> int:
        return self._tracked.windows_closed()

    def window_lag(self) -> float:
        return self._tracked.lag

    def watermark(self) -> float:
        return self._tracked.wm.watermark

    @property
    def late_rows(self) -> int:
        return self._tracked.late_rows

    @property
    def late_batches(self) -> int:
        return self._tracked.late_batches

    # -- serving ---------------------------------------------------------

    def _serve(self) -> Any:
        tr = self._tracked
        if self._serve_cache is None or self._serve_epoch != tr.epoch:
            self._serve_cache = tr.serve()
            self._serve_epoch = tr.epoch
            # coordinator pulls every live state to refresh its answer
            self._ship_rows += tr.live_states() * self._ops.state_rows
        return self._serve_cache

    def comm_report(self) -> CommReport:
        return build_report(
            scalar_msgs=self._tracked.applied_batches,
            row_msgs=self._ship_rows,
            broadcast_events=0,
            m=self.m,
        )

    # -- checkpoint contract ---------------------------------------------

    def state_payload(self) -> tuple[dict[str, np.ndarray], dict]:
        tr = self._tracked
        pending = sorted(tr._pending, key=lambda p: p[1])
        arrays: dict[str, np.ndarray] = {
            f"pend{j:04d}": np.asarray(batch) for j, (_, _, batch) in enumerate(pending)
        }
        meta: dict = {
            "protocol": self.name,
            "engine": self.engine,
            "kind": self.kind,
            "mode": self._mode,
            "m": int(self.m),
            "eps": float(self.eps),
            "sites": int(tr.sites),
            "lateness": float(tr.wm.lateness),
            "max_ts": None if tr.wm.max_ts == -math.inf else float(tr.wm.max_ts),
            "last_ts": float(self._last_ts),
            "late_batches": int(tr.late_batches),
            "late_rows": int(tr.late_rows),
            "applied_batches": int(tr.applied_batches),
            "applied_rows": int(tr.applied_rows),
            "epoch": int(tr.epoch),
            "rows_seen": int(self.rows_seen),
            "ship_rows": int(self._ship_rows),
            "pending_ts": [float(ts) for ts, _, _ in pending],
        }
        if self._mode == "win":
            meta["window"] = float(tr.window)
            meta["buckets"] = int(tr.buckets)
            meta["closed"] = int(tr._closed)
            meta["last_marker"] = tr._last_marker
            meta["bucket_ids"] = sorted(int(b) for b in tr._states)
            groups = [(f"st{bi:04d}", tr._states[b]) for bi, b in enumerate(meta["bucket_ids"])]
        else:
            meta["gamma"] = float(tr.gamma)
            meta["ref_ts"] = tr.ref_ts
            groups = [("st0000", tr._states)]
        for prefix, states in groups:
            for si, st in enumerate(states):
                for li, leaf in enumerate(_leaves(st)):
                    arrays[f"{prefix}_s{si:02d}_l{li:02d}"] = leaf.cpu().numpy()
        return arrays, meta

    def restore_payload(self, arrays: dict[str, np.ndarray], meta: dict) -> None:
        tr = self._tracked
        want = {
            "protocol": self.name,
            "engine": self.engine,
            "kind": self.kind,
            "mode": self._mode,
            "m": int(self.m),
            "eps": float(self.eps),
            "sites": int(tr.sites),
        }
        got = {k: meta.get(k) for k in want}
        if got != want:
            raise ValueError(
                f"protocol/config mismatch: expected {want}, payload carries {got}"
            )
        if self._mode == "win" and (
            float(meta["window"]) != tr.window or int(meta["buckets"]) != tr.buckets
        ):
            raise ValueError(
                "protocol/config mismatch: window geometry differs "
                f"(have window={tr.window} buckets={tr.buckets}, payload has "
                f"window={meta['window']} buckets={meta['buckets']})"
            )
        template = self._ops.init()
        template_leaves = _leaves(template)

        def unflatten(prefix: str):
            leaves = []
            for li, tmpl in enumerate(template_leaves):
                arr = np.asarray(arrays[f"{prefix}_l{li:02d}"])
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(
                        f"protocol/config mismatch: state leaf {prefix}_l{li:02d} "
                        f"has shape {arr.shape}, expected {tuple(tmpl.shape)}"
                    )
                leaves.append(torch.tensor(arr, device=tmpl.device).to(tmpl.dtype))
            return _rebuild(template, iter(leaves))

        if self._mode == "win":
            tr._states = {
                int(b): [
                    unflatten(f"st{bi:04d}_s{si:02d}") for si in range(tr.sites)
                ]
                for bi, b in enumerate(meta["bucket_ids"])
            }
            tr._closed = int(meta["closed"])
            marker = meta["last_marker"]
            tr._last_marker = None if marker is None else int(marker)
        else:
            tr._states = [unflatten(f"st0000_s{si:02d}") for si in range(tr.sites)]
            ref = meta["ref_ts"]
            tr.ref_ts = None if ref is None else float(ref)
        tr.wm.max_ts = -math.inf if meta["max_ts"] is None else float(meta["max_ts"])
        tr._pending = [
            (float(ts), j, np.asarray(arrays[f"pend{j:04d}"]))
            for j, ts in enumerate(meta["pending_ts"])
        ]
        tr._seq = len(tr._pending)
        tr.late_batches = int(meta["late_batches"])
        tr.late_rows = int(meta["late_rows"])
        tr.applied_batches = int(meta["applied_batches"])
        tr.applied_rows = int(meta["applied_rows"])
        tr.epoch = int(meta["epoch"])
        self._last_ts = float(meta["last_ts"])
        self.rows_seen = int(meta["rows_seen"])
        self._ship_rows = int(meta["ship_rows"])
        self._serve_cache = None
        self._serve_epoch = -1
        self._invalidate()


class WindowedMatrixProtocol(_TimeWrapped, SketchProtocol):
    """Sliding-window / decayed FD matrix tracking (``P2win`` / ``P2decay``)."""

    def __init__(
        self,
        name: str,
        engine: str,
        mode: str,
        *,
        m: int,
        eps: float,
        d: int,
        l: int | None = None,
        sites: int = 1,
        window: float | None = None,
        buckets: int = 8,
        lateness: float = 0.0,
        gamma: float | None = None,
        half_life: float | None = None,
        device=None,
    ):
        super().__init__(name, engine, m, eps, d, device)
        self._l = int(l) if l else max(8, math.ceil(2.0 / eps))
        self._init_time(
            windows.fd_window_ops(self._l, d, self.device),
            mode,
            sites=sites,
            window=window,
            buckets=buckets,
            lateness=lateness,
            gamma=gamma,
            half_life=half_life,
        )

    def step(self, rows, sites=None, *, ts: float | None = None) -> None:
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu()
        arr = np.asarray(rows, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.d:
            raise ValueError(
                f"matrix ingest batch must be (n, {self.d}) rows, got shape "
                f"{np.asarray(rows).shape}"
            )
        self._step_timed(arr, ts)

    def matrix(self) -> np.ndarray:
        return fd.fd_matrix(self._serve()).cpu().numpy()

    def frob_estimate(self) -> float:
        return float(self._serve().frob)

    def total_weight(self) -> float:
        """Matrix alias for the uniform adapter face: stream mass."""
        return self.frob_estimate()

    def snapshot_matrix(self) -> np.ndarray:
        """Publishable (l, d) sketch — matrix snapshots encode as themselves."""
        return self.matrix()


class WindowedHHProtocol(_TimeWrapped, HHProtocol):
    """Sliding-window / decayed Misra-Gries HH (``P1win`` / ``P1decay``)."""

    def __init__(
        self,
        name: str,
        engine: str,
        mode: str,
        *,
        m: int,
        eps: float,
        k: int | None = None,
        sites: int = 1,
        window: float | None = None,
        buckets: int = 8,
        lateness: float = 0.0,
        gamma: float | None = None,
        half_life: float | None = None,
        device=None,
    ):
        super().__init__(name, engine, m, eps)
        self.device = resolve_device(device)
        self._k = int(k) if k else max(8, math.ceil(2.0 / eps))
        self._init_time(
            windows.mg_window_ops(self._k, self.device),
            mode,
            sites=sites,
            window=window,
            buckets=buckets,
            lateness=lateness,
            gamma=gamma,
            half_life=half_life,
        )

    def step(self, pairs, sites=None, *, ts: float | None = None) -> None:
        keys, weights = self.split_pairs(pairs)
        # ids < 2**24 are exact in f64, so one array keeps pending batches
        # checkpointable as a single leaf
        self._step_timed(np.stack([keys.astype(np.float64), weights], axis=1), ts)

    def estimates(self) -> dict[int, float]:
        return hhc.mg_items(self._serve())

    def total_weight(self) -> float:
        return float(self._serve().weight)


class WindowedQuantileProtocol(_TimeWrapped, QuantileProtocol):
    """Sliding-window / decayed GK quantiles (``P1win`` / ``P1decay``).

    Internal summaries run at ``eps/4`` so the certified band stays under
    ``eps/2 * W`` even after the per-bucket serve folds — the same budget
    split the shard coordinator honors.
    """

    def __init__(
        self,
        name: str,
        engine: str,
        mode: str,
        *,
        m: int,
        eps: float,
        cap: int | None = None,
        sites: int = 1,
        window: float | None = None,
        buckets: int = 8,
        lateness: float = 0.0,
        gamma: float | None = None,
        half_life: float | None = None,
        device=None,
    ):
        super().__init__(name, engine, m, eps)
        self.device = resolve_device(device)
        self._op_eps = eps / 4.0
        self._cap = int(cap) if cap else math.ceil(2.0 / self._op_eps) + 8
        self._init_time(
            windows.quant_window_ops(self._op_eps, self._cap, self.device),
            mode,
            sites=sites,
            window=window,
            buckets=buckets,
            lateness=lateness,
            gamma=gamma,
            half_life=half_life,
        )

    def step(self, pairs, sites=None, *, ts: float | None = None) -> None:
        values, weights = self.split_pairs(pairs)
        self._step_timed(np.stack([values.astype(np.float64), weights], axis=1), ts)

    def table(self) -> np.ndarray:
        return q.quant_table(self._serve())

    def total_weight(self) -> float:
        return float(self._serve().weight)

    @property
    def state(self):
        """Shard-style state view: ``coord_q`` is the serve-folded summary
        (its band certificate honors the coordinator eps/2 budget)."""
        return SimpleNamespace(coord_q=self._serve())


class WindowedLeverageProtocol(_TimeWrapped, LeverageProtocol):
    """Sliding-window / decayed ridge-leverage sample (``P1win``/``P1decay``).

    Served table = kept reservoir rows (exact, at their live weights) +
    the FD spill residual's rows at weight 1 — so reservoir overflow
    never loses mass and the subspace envelope inherits the FD bound.
    """

    def __init__(
        self,
        name: str,
        engine: str,
        mode: str,
        *,
        m: int,
        eps: float,
        d: int,
        cap: int | None = None,
        l_resid: int | None = None,
        sites: int = 1,
        window: float | None = None,
        buckets: int = 8,
        lateness: float = 0.0,
        gamma: float | None = None,
        half_life: float | None = None,
        device=None,
    ):
        super().__init__(name, engine, m, eps, d, device)
        self._cap = int(cap) if cap else lev.default_cap(eps)
        self._l_resid = int(l_resid) if l_resid else max(8, math.ceil(2.0 / eps))
        self._init_time(
            windows.lev_window_ops(self._cap, d, self._l_resid, self.device),
            mode,
            sites=sites,
            window=window,
            buckets=buckets,
            lateness=lateness,
            gamma=gamma,
            half_life=half_life,
        )

    def _invalidate(self) -> None:
        self._live_factor = None

    def step(self, rows, sites=None, *, ts: float | None = None) -> None:
        self._step_timed(self.check_rows(rows), ts)

    def sampled_rows(self) -> np.ndarray:
        st = self._serve()
        rows = st.lev.rows.cpu().numpy().astype(np.float64)
        scores = st.lev.scores.cpu().numpy().astype(np.float64)
        weights = st.lev.weights.cpu().numpy().astype(np.float64)
        live = weights > 0.0
        parts = []
        if live.any():
            parts.append(
                np.concatenate(
                    [rows[live], scores[live][:, None], weights[live][:, None]],
                    axis=1,
                )
            )
        res = fd.fd_matrix(st.resid).cpu().numpy().astype(np.float64)
        res = res[np.einsum("rd,rd->r", res, res) > 0]
        if res.shape[0]:
            factor = lev.ridge_factor(res, 1.0, self.lam())
            parts.append(
                np.concatenate(
                    [res, lev.ridge_scores(factor, res)[:, None],
                     np.ones((res.shape[0], 1))],
                    axis=1,
                )
            )
        if not parts:
            return np.zeros((0, self.d + 2), np.float32)
        return np.concatenate(parts, axis=0).astype(np.float32)

    def total_weight(self) -> float:
        return float(self._serve().mass)

    def lam(self) -> float:
        return lev.default_lambda(self.eps, max(self.total_weight(), 1e-12))


# ---------------------------------------------------------------------------
# Registration: (kind, engine, name) x {win, decay} for both engines.
# ---------------------------------------------------------------------------

_KIND_CLS = {
    "matrix": WindowedMatrixProtocol,
    "hh": WindowedHHProtocol,
    "quantile": WindowedQuantileProtocol,
    "leverage": WindowedLeverageProtocol,
}


def _windowed_factory(kind: str, name: str, engine: str, mode: str):
    cls = _KIND_CLS[kind]

    def make(**kw: Any):
        kw.pop("seed", None)  # host-side wrappers are deterministic
        m = int(kw.pop("m"))
        if engine == "shard":
            # shard flavor: rows partition round-robin over m software
            # sites, each with its own per-bucket state (merge at serve)
            kw.setdefault("sites", m)
        return cls(name, engine, mode, m=m, **kw)

    return make


_WINDOWED_ERR = {
    # (kind, mode) -> err_factor: window folds keep the deterministic
    # bounds; decay adds the (1 - gamma^age) drift vs an unweighted oracle
    ("matrix", "win"): 1.0,
    ("matrix", "decay"): 1.5,
    ("hh", "win"): 1.0,
    ("hh", "decay"): 2.0,
    ("quantile", "win"): 2.0,
    ("quantile", "decay"): 2.0,
    ("leverage", "win"): 1.5,
    ("leverage", "decay"): 2.0,
}

_MODE_DESC = {
    "win": "bucketed sliding-window",
    "decay": "exponential-decay",
}

for _kind, _base in (("matrix", "P2"), ("hh", "P1"), ("quantile", "P1"), ("leverage", "P1")):
    for _mode, _suffix in (("win", "win"), ("decay", "decay")):
        for _engine in ("event", "shard"):
            register_protocol(ProtocolSpec(
                name=f"{_base}{_suffix}",
                kind=_kind,
                engine=_engine,
                factory=_windowed_factory(_kind, f"{_base}{_suffix}", _engine, _mode),
                err_factor=_WINDOWED_ERR[(_kind, _mode)],
                description=(
                    f"{_MODE_DESC[_mode]} {_kind} tracking over {_base} "
                    f"merge identities (core/windows.py)"
                ),
            ))
