"""Time as a first-class dimension: sliding windows + exponential decay.

The paper tracks ``||Ax||^2`` over the whole stream; serving traffic asks
"what does A look like over the last hour".  Both time restrictions reduce
to the SAME mergeable-summary algebra the four protocol kinds already
ship:

* **Sliding window** — event time is cut into ``buckets`` equal-width
  buckets per window.  Each bucket holds an independent sketch state
  (FD / MG / GK / leverage reservoir), fed only the rows whose timestamp
  lands in it.  Serving folds the live buckets with the existing merge
  identities (``fd_merge`` / ``mg_merge`` / ``quant_merge`` /
  ``lev_merge``); advancing the watermark past a bucket's trailing edge
  drops it wholesale.  The served answer covers at most one bucket width
  more than the exact window — the standard bucketed-window slack — while
  per-bucket error bounds add across disjoint row sets, so the merged
  answer keeps the certified eps envelope over the in-window rows.

* **Exponential decay** — a single state per site, aged with
  *scale-then-insert*: before absorbing a batch at time ``t`` the state is
  scaled so every resident row's contribution is worth
  ``gamma**(t - t_i)``.  Scaling is exact on all four states because each
  is (piecewise) linear in its mass: FD buffers scale by ``sqrt(g)``
  (quadratic forms scale by ``g``), MG counts, GK rank bounds and
  reservoir scores scale by ``g`` directly.

Both wrappers sit behind one watermark/ordering layer (``_TimedSketch``):
rows arrive as ``(batch, ts)``, are parked until the watermark
(``max_ts - lateness``) passes them, and are applied in ``(ts, seq)``
order — so any arrival order within the allowed lateness produces a
bit-identical state sequence.  Rows later than the watermark raise
``LateRowError`` (counted, never silently dropped); the runtime routes
them through its shed/report path.

Everything here is host-side orchestration over the kinds' tensor states;
no new kernels.  The four ``WindowOps`` builders run the port's kinds on
the tenant's device: FD inserts and merges shrink through the
``fd_gram``/``fd_project`` kernels, MG inserts are one ``mg_scan`` launch,
quantile inserts and merges ``quant_merge_pack`` launches, and the
leverage reservoir spills into an FD residual.  ``runtime/windowed.py``
adapts these wrappers to the registry's four protocol ABCs.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np

__all__ = [
    "TimedRows",
    "LateRowError",
    "WatermarkTracker",
    "WindowOps",
    "fd_window_ops",
    "mg_window_ops",
    "quant_window_ops",
    "lev_window_ops",
    "LevWindowState",
    "SlidingWindow",
    "ExponentialDecay",
]


class TimedRows(NamedTuple):
    """A rows payload stamped with one event time.

    Rides any existing ``rows`` seam unchanged (``Ingest.rows`` envelopes,
    ``StreamingPipeline.ingest``): consumers unwrap it at the adapter
    boundary, so cluster cells, replication, and checkpoint plumbing never
    need to know about time.
    """

    rows: Any
    ts: float


class LateRowError(ValueError):
    """A batch arrived later than the watermark allows.

    Carries enough to account for the shed: the runtime increments its
    late-row counters from these fields before re-raising/reporting.
    """

    def __init__(self, ts: float, watermark: float, n_rows: int):
        self.ts = float(ts)
        self.watermark = float(watermark)
        self.n_rows = int(n_rows)
        super().__init__(
            f"late batch: ts={self.ts} behind watermark={self.watermark} "
            f"({self.n_rows} rows shed)"
        )


class WatermarkTracker:
    """Bounded out-of-order tolerance: ``watermark = max_ts - lateness``.

    Rows at or ahead of the watermark are parked and applied in event-time
    order once the watermark passes them; rows strictly behind it are late.
    """

    def __init__(self, lateness: float = 0.0):
        lateness = float(lateness)
        if not (math.isfinite(lateness) and lateness >= 0.0):
            raise ValueError(f"lateness must be finite and >= 0, got {lateness}")
        self.lateness = lateness
        self.max_ts = -math.inf

    @property
    def watermark(self) -> float:
        return self.max_ts - self.lateness

    def observe(self, ts: float) -> None:
        ts = float(ts)
        if ts > self.max_ts:
            self.max_ts = ts

    def is_late(self, ts: float) -> bool:
        return float(ts) < self.watermark


class WindowOps(NamedTuple):
    """The per-kind algebra a time wrapper needs, nothing more.

    ``init`` builds the merge identity, ``insert`` folds an (already
    validated) numpy batch, ``merge`` is the kind's mergeable-summary
    fold, ``scale`` multiplies every resident row's mass contribution by
    ``g`` (exact on all four states).  ``state_rows`` is the sketch-rows
    size of one state — the unit the comm accounting charges when a
    state ships to the coordinator.
    """

    init: Callable[[], Any]
    insert: Callable[[Any, np.ndarray], Any]
    merge: Callable[[Any, Any], Any]
    scale: Callable[[Any, float], Any]
    state_rows: int


def fd_window_ops(l: int, d: int, device=None) -> WindowOps:
    """FD algebra: quadratic in the buffer, so mass scales via sqrt(g)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import fd

    device = resolve_device(device)

    def insert(st, arr):
        return fd.fd_update_stream(st, torch.as_tensor(arr, dtype=torch.float32).to(device))

    def scale(st, g):
        g = torch.tensor(g, dtype=torch.float32)
        return st._replace(
            buf=st.buf * torch.sqrt(g).to(device), frob=st.frob * g.to(device),
            delta_sum=st.delta_sum * g.to(device),
        )

    return WindowOps(lambda: fd.fd_init(l, d, device=device), insert, fd.fd_merge, scale, l)


def mg_window_ops(k: int, device=None) -> WindowOps:
    """Misra-Gries algebra: counts, total weight and the shrink error
    certificate are all linear in mass."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import hh

    device = resolve_device(device)

    def insert(st, arr):
        keys = torch.as_tensor(arr[:, 0].astype(np.int32)).to(device)
        weights = torch.as_tensor(arr[:, 1].astype(np.float32)).to(device)
        return hh.mg_update_stream(st, keys, weights)

    def scale(st, g):
        g = torch.tensor(g, dtype=torch.float32).to(device)
        return st._replace(
            counts=st.counts * g, weight=st.weight * g, shrink=st.shrink * g
        )

    return WindowOps(lambda: hh.mg_init(k, device), insert, hh.mg_merge, scale, k)


def quant_window_ops(eps: float, cap: int, device=None) -> WindowOps:
    """GK-summary algebra at an internal ``eps`` budget: rank lower
    bounds, gap certificates and item weights are all linear in mass."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import quantiles as q

    device = resolve_device(device)

    def insert(st, arr):
        return q.quant_insert(
            st,
            torch.as_tensor(arr[:, 0].astype(np.float32)).to(device),
            torch.as_tensor(arr[:, 1].astype(np.float32)).to(device),
            eps,
        )

    def merge(a, b):
        return q.quant_merge(a, b, eps, cap)

    def scale(st, g):
        g = torch.tensor(g, dtype=torch.float32).to(device)
        return st._replace(
            g=st.g * g, delta=st.delta * g, wv=st.wv * g, weight=st.weight * g
        )

    return WindowOps(lambda: q.quant_init(cap, device), insert, merge, scale, cap)


class LevWindowState(NamedTuple):
    """Leverage reservoir + FD residual + exact mass counter.

    The reservoir alone cannot serve a time-restricted eps envelope: rows
    spilled on overflow would lose their mass.  Exactly like the event P1
    stream, every spilled row folds into an FD residual sketch, and the
    served table is kept rows (exact) + residual FD rows — inheriting the
    FD envelope on whatever the reservoir dropped.
    """

    lev: Any
    resid: Any
    mass: Any


def lev_window_ops(cap: int, d: int, l_resid: int, device=None) -> WindowOps:
    """Leverage algebra: norm-scored reservoir with an FD spill residual.

    Window mode keeps every row at weight 1; decay bakes the age factor
    into the row payload itself (``rows *= sqrt(g)``), so spilled rows are
    always correctly scaled for the residual FD fold and the served
    ``sum_i w_i (a_i . x)^2`` ages exactly.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import fd
    from repro_torch.core import leverage as lev

    device = resolve_device(device)

    def init():
        return LevWindowState(
            lev=lev.lev_init(cap, d, device=device),
            resid=fd.fd_init(l_resid, d, device=device),
            mass=torch.zeros((), dtype=torch.float32, device=device),
        )

    def insert(st, arr):
        rows = torch.as_tensor(arr, dtype=torch.float32).to(device)
        scores = rows.square().sum(1)
        weights = torch.where(scores > 0.0, 1.0, 0.0).to(torch.float32)
        new_lev, spilled = lev.lev_merge_spill(st.lev, rows, scores, weights)
        return LevWindowState(
            lev=new_lev,
            resid=fd.fd_update_stream(st.resid, spilled),
            mass=st.mass + scores.sum(),
        )

    def merge(a, b):
        new_lev, spilled = lev.lev_merge_spill(
            a.lev, b.lev.rows, b.lev.scores, b.lev.weights
        )
        resid = fd.fd_merge(a.resid, b.resid)
        return LevWindowState(
            lev=new_lev,
            resid=fd.fd_update_stream(resid, spilled),
            mass=a.mass + b.mass,
        )

    def scale(st, g):
        g = torch.tensor(g, dtype=torch.float32)
        root = torch.sqrt(g).to(device)
        g = g.to(device)
        return LevWindowState(
            lev=st.lev._replace(rows=st.lev.rows * root, scores=st.lev.scores * g),
            resid=st.resid._replace(
                buf=st.resid.buf * root,
                frob=st.resid.frob * g,
                delta_sum=st.resid.delta_sum * g,
            ),
            mass=st.mass * g,
        )

    return WindowOps(init, insert, merge, scale, cap + l_resid)


def _batch_rows(batch: Any) -> int:
    if isinstance(batch, tuple):
        batch = batch[0]
    return int(np.asarray(batch).shape[0])


def _site_slice(batch: np.ndarray, site: int, sites: int) -> np.ndarray:
    return batch[site::sites]


class _TimedSketch:
    """Watermark/ordering layer shared by both time wrappers.

    Batches are parked until the watermark passes their timestamp, then
    applied in ``(ts, arrival_seq)`` order — the property the
    out-of-order byte-identity tests pin.  ``epoch`` bumps whenever the
    applied state changes; callers key serve caches on it.
    """

    def __init__(self, ops: WindowOps, *, sites: int = 1, lateness: float = 0.0):
        self.ops = ops
        self.sites = max(1, int(sites))
        self.wm = WatermarkTracker(lateness)
        self._pending: list[tuple[float, int, np.ndarray]] = []
        self._seq = 0
        self.late_batches = 0
        self.late_rows = 0
        self.applied_batches = 0
        self.applied_rows = 0
        self.epoch = 0

    # -- kind-agnostic entry points -------------------------------------

    def insert(self, batch: np.ndarray, ts: float) -> None:
        ts = float(ts)
        if not math.isfinite(ts):
            raise ValueError(f"event time must be finite, got {ts}")
        if self.wm.is_late(ts):
            n = _batch_rows(batch)
            self.late_batches += 1
            self.late_rows += n
            raise LateRowError(ts, self.wm.watermark, n)
        self.wm.observe(ts)
        self._pending.append((ts, self._seq, batch))
        self._seq += 1
        self._drain()

    def advance(self, ts: float) -> None:
        """Heartbeat: move the watermark without new rows (closes buckets
        whose boundary it passes)."""
        self.wm.observe(float(ts))
        self._drain()

    @property
    def lag(self) -> float:
        """How far the oldest parked batch trails event time (0 if none)."""
        if not self._pending:
            return 0.0
        return self.wm.max_ts - min(p[0] for p in self._pending)

    # -- machinery -------------------------------------------------------

    def _drain(self) -> None:
        wm = self.wm.watermark
        if wm == -math.inf:
            return
        due = [p for p in self._pending if p[0] <= wm]
        if due:
            due.sort(key=lambda p: (p[0], p[1]))
            self._pending = [p for p in self._pending if p[0] > wm]
            for ts, _, batch in due:
                self._apply(batch, ts)
                self.applied_batches += 1
                self.applied_rows += _batch_rows(batch)
            self.epoch += 1
        self._on_advance(wm)

    def _apply(self, batch: np.ndarray, ts: float) -> None:
        raise NotImplementedError

    def _on_advance(self, wm: float) -> None:
        pass

    def windows_closed(self) -> int:
        return 0

    def serve(self) -> Any:
        raise NotImplementedError


class SlidingWindow(_TimedSketch):
    """Bucketed sliding window over one ``WindowOps`` algebra.

    Event time is cut into buckets of width ``window / buckets``; bucket
    ``b`` covers ``[b*width, (b+1)*width)``.  Serving folds every live
    bucket (times ``sites`` software partitions) with ``ops.merge``;
    advancing the watermark drops buckets that fell entirely behind
    ``watermark - window`` and counts each bucket boundary the watermark
    crosses as a closed window (the ``OnWindowClose`` publish signal).
    """

    def __init__(
        self,
        ops: WindowOps,
        *,
        window: float,
        buckets: int = 8,
        sites: int = 1,
        lateness: float = 0.0,
    ):
        super().__init__(ops, sites=sites, lateness=lateness)
        window = float(window)
        buckets = int(buckets)
        if not (math.isfinite(window) and window > 0.0):
            raise ValueError(f"window must be finite and > 0, got {window}")
        if buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        self.window = window
        self.buckets = buckets
        self.width = window / buckets
        self._states: dict[int, list] = {}
        self._closed = 0
        self._last_marker: int | None = None

    def _apply(self, batch: np.ndarray, ts: float) -> None:
        b = math.floor(ts / self.width)
        states = self._states.get(b)
        if states is None:
            states = [self.ops.init() for _ in range(self.sites)]
            self._states[b] = states
        if self.sites == 1:
            states[0] = self.ops.insert(states[0], batch)
            return
        for s in range(self.sites):
            part = _site_slice(batch, s, self.sites)
            if part.shape[0]:
                states[s] = self.ops.insert(states[s], part)

    def _on_advance(self, wm: float) -> None:
        cutoff = wm - self.window
        dead = [b for b in self._states if (b + 1) * self.width <= cutoff]
        for b in dead:
            del self._states[b]
        if dead:
            self.epoch += 1
        marker = math.floor(wm / self.width)
        if self._last_marker is None:
            self._last_marker = marker
        elif marker > self._last_marker:
            self._closed += marker - self._last_marker
            self._last_marker = marker

    def windows_closed(self) -> int:
        return self._closed

    def live_states(self) -> int:
        return len(self._states) * self.sites

    def serve(self) -> Any:
        acc = None
        for b in sorted(self._states):
            for st in self._states[b]:
                acc = st if acc is None else self.ops.merge(acc, st)
        return self.ops.init() if acc is None else acc


class ExponentialDecay(_TimedSketch):
    """Scale-then-insert exponential decay over one ``WindowOps`` algebra.

    One state per site; absorbing a batch at time ``t`` first scales the
    states by ``gamma ** (t - ref_ts)`` so every resident row is worth
    ``gamma ** age``.  The watermark layer guarantees applies happen in
    event-time order, so ``ref_ts`` only moves forward.
    """

    def __init__(
        self,
        ops: WindowOps,
        *,
        gamma: float | None = None,
        half_life: float | None = None,
        sites: int = 1,
        lateness: float = 0.0,
    ):
        super().__init__(ops, sites=sites, lateness=lateness)
        if (gamma is None) == (half_life is None):
            raise ValueError("pass exactly one of gamma / half_life")
        if half_life is not None:
            half_life = float(half_life)
            if not (math.isfinite(half_life) and half_life > 0.0):
                raise ValueError(f"half_life must be > 0, got {half_life}")
            gamma = 0.5 ** (1.0 / half_life)
        gamma = float(gamma)
        if not (0.0 < gamma < 1.0):
            raise ValueError(f"gamma must be in (0, 1), got {gamma}")
        self.gamma = gamma
        self._states = [ops.init() for _ in range(self.sites)]
        self.ref_ts: float | None = None

    def _apply(self, batch: np.ndarray, ts: float) -> None:
        if self.ref_ts is None:
            self.ref_ts = ts
        elif ts > self.ref_ts:
            g = self.gamma ** (ts - self.ref_ts)
            self._states = [self.ops.scale(st, g) for st in self._states]
            self.ref_ts = ts
        if self.sites == 1:
            self._states[0] = self.ops.insert(self._states[0], batch)
            return
        for s in range(self.sites):
            part = _site_slice(batch, s, self.sites)
            if part.shape[0]:
                self._states[s] = self.ops.insert(self._states[s], part)

    def live_states(self) -> int:
        return self.sites

    def serve(self) -> Any:
        acc = self._states[0]
        for st in self._states[1:]:
            acc = self.ops.merge(acc, st)
        return acc
