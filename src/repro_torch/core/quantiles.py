"""Distributed quantile tracking: mergeable eps-approximate summaries.

The paper's model (m sites, one coordinator, continuous queries under small
communication) extends beyond matrix norms: Yi & Zhang's "Optimal Tracking
of Distributed Heavy Hitters and Quantiles" gives the canonical quantile
counterpart.  A copy of the reference's ``core/quantiles.py`` with its
fixed-shape summary on tensors:

  * ``QuantileSummary`` — a GK-style (Greenwald--Khanna) weighted quantile
    summary over python lists (numpy, copied): insert, compress, merge,
    rank/quantile query, serialized size.  Every tuple ``(v, g, delta,
    wv)`` certifies the weighted rank interval ``R(v) in [rmin, rmin +
    delta]`` where ``rmin = sum g`` up to the tuple and ``wv`` lower-bounds
    the mass sitting exactly at ``v``.
  * ``QuantState`` + ``quant_*`` — the same summary as fixed-shape tensors
    with any leading axes (one summary per site on the super-step engine's
    ``m`` axis), padded with ``+inf`` values.  Every merge and insert ends
    in one launch of the ``quant_pack`` kernel (``kernels.ops.quant_pack``)
    for all rows at once.
  * ``QuantileP1Stream`` / ``QuantileP3Stream`` — event-driven site ->
    coordinator protocols in the paper's style (numpy, copied).
  * snapshot codec — published quantile state is a sorted ``(n, 2)``
    [value, rank-estimate] f32 table; ``table_rank`` / ``table_quantile``
    are the single searchsorted implementation every query surface
    (live protocols, registry interface, packed serving) shares.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = [
    "QUERY_RANK",
    "QUERY_QUANTILE",
    "QuantileSummary",
    "QuantState",
    "quant_init",
    "quant_insert",
    "quant_merge",
    "quant_table",
    "quant_band",
    "QuantileResult",
    "QuantileP1Stream",
    "QuantileP3Stream",
    "QUANTILE_STREAMS",
    "run_quantile_protocol",
    "encode_quantile_snapshot",
    "decode_quantile_snapshot",
    "table_rank",
    "table_quantile",
    "rank_query",
    "quantile_query",
    "exact_ranks",
]

#: Query-row mode tags for quantile tenants: a packed-service query is a
#: ``(2,)`` row ``[mode, arg]`` — ``QUERY_RANK`` asks for the estimated
#: weighted rank of value ``arg``; ``QUERY_QUANTILE`` for the value whose
#: rank is nearest ``arg * W``.
QUERY_RANK = 0.0
QUERY_QUANTILE = 1.0


def rank_query(value: float) -> np.ndarray:
    """Build the ``(2,)`` query row asking for the rank of ``value``."""
    return np.array([QUERY_RANK, value], np.float32)


def quantile_query(phi: float) -> np.ndarray:
    """Build the ``(2,)`` query row asking for the phi-quantile value."""
    return np.array([QUERY_QUANTILE, phi], np.float32)


# ---------------------------------------------------------------------------
# Python oracle: GK-style weighted summary with explicit rank intervals.
# ---------------------------------------------------------------------------


class QuantileSummary:
    """Mergeable GK-style eps-approximate weighted quantile summary.

    Tuples are ``[v, g, delta, wv]`` sorted by value: ``rmin(i) = sum of g
    up to i`` lower-bounds the weighted rank ``R(v_i)`` (total weight of
    items ``<= v_i``), ``rmin + delta`` upper-bounds it, and ``wv`` is a
    certified lower bound on the mass sitting exactly at ``v_i``.  All
    three operations (insert, compress, merge) preserve interval
    soundness, and compression maintains the invariant ``g_i + delta_i -
    wv_i <= 2 eps W`` — the width of the *uncertain* rank interval
    between consecutive kept values (mass certified to sit exactly at a
    value is not uncertainty, which is what keeps duplicate-heavy
    streams exact).  Consequently every rank answer and every
    phi-quantile answer is within ``eps W`` of the truth, where quantile
    error is measured against the achievable ranks: the answer ``v``
    satisfies ``R(v) >= phi W - eps W`` and ``R(v) - mass(v) <= phi W +
    eps W``.  Merging is interval arithmetic (uncertainties add while
    total weights add), so eps is preserved — the mergeable-summaries
    property the coordinator folding relies on.
    """

    def __init__(self, eps: float):
        if not 0.0 < eps < 1.0:
            raise ValueError(f"eps must be in (0, 1), got {eps}")
        self.eps = eps
        self.tuples: list[list[float]] = []  # [v, g, delta, wv], sorted by v
        self._vals: list[float] = []  # parallel value index for bisect
        self.weight = 0.0
        self._since_compress = 0
        self._compress_every = max(16, math.ceil(1.0 / (2.0 * eps)))

    def insert(self, value: float, w: float = 1.0) -> None:
        """Absorb one weighted item, keeping rank intervals sound."""
        v, w = float(value), float(w)
        if not math.isfinite(v):
            raise ValueError(f"quantile values must be finite, got {v}")
        if w < 0.0:
            raise ValueError(f"weights must be >= 0, got {w}")
        if w == 0.0:
            return
        self.weight += w
        t = self.tuples
        i = bisect.bisect_left(self._vals, v)
        if i < len(t) and self._vals[i] == v:
            # Exact value hit: fold into the tuple (g and wv both certify
            # mass at this exact value; the interval stays sound).
            t[i][1] += w
            t[i][3] += w
        else:
            if i == len(t):
                delta = 0.0  # new maximum: rank exactly W
            else:
                # Classic GK insert band, weighted: the successor's band
                # minus its certified own-value mass (>= 0 by soundness).
                succ = t[i]
                delta = max(0.0, succ[1] + succ[2] - succ[3])
            t.insert(i, [v, w, delta, w])
            self._vals.insert(i, v)
        self._since_compress += 1
        if self._since_compress >= self._compress_every:
            self.compress()

    def extend(self, values, weights=None) -> None:
        """Absorb a batch (uniform weight 1 when ``weights`` is None)."""
        if weights is None:
            for v in np.asarray(values).ravel().tolist():
                self.insert(v, 1.0)
        else:
            for v, w in zip(np.asarray(values).ravel().tolist(),
                            np.asarray(weights).ravel().tolist()):
                self.insert(v, w)

    def compress(self) -> None:
        """Greedy GK compress: fold tuple i into i+1 while the merged
        uncertainty ``g_i + g_{i+1} + delta_{i+1} - wv_{i+1}`` stays
        within ``2 eps W``.  The first and last tuples are kept, so
        min/max stay exact."""
        self._since_compress = 0
        t = self.tuples
        if len(t) < 3:
            return
        thresh = 2.0 * self.eps * self.weight
        i = len(t) - 2
        while i >= 1:
            nxt = t[i + 1]
            if t[i][1] + nxt[1] + nxt[2] - nxt[3] <= thresh:
                nxt[1] += t[i][1]
                del t[i]
                del self._vals[i]
            i -= 1

    def merge(self, other: "QuantileSummary") -> None:
        """Fold ``other`` into this summary (interval arithmetic merge).

        Each output tuple's rank interval is the sum of its own interval
        and the other summary's certified interval at that value, so
        bands add — merging summaries of disjoint substreams at the same
        eps yields an eps-summary of the union (the mergeable-summaries
        property).  ``other`` is not modified.
        """
        a, b = self.tuples, other.tuples
        if not b:
            return
        if not a:
            self.tuples = [list(tp) for tp in b]
            self._vals = list(other._vals)
            self.weight += other.weight
            self.compress()
            return
        wa, wb = self.weight, other.weight

        def cums(ts):
            out, c = [], 0.0
            for tp in ts:
                c += tp[1]
                out.append(c)
            return out

        cum_a, cum_b = cums(a), cums(b)
        merged: list[tuple[float, float, float, float]] = []  # v, rmin, rmax, wv
        i = j = 0

        def upper(ts, cum, k, total, v):
            # Certified upper bound on the other stream's rank at v, read
            # from its next tuple at value >= v (W_other when none).
            if k >= len(ts):
                return total
            tp = ts[k]
            up = cum[k] + tp[2]
            if tp[0] > v:
                up -= tp[3]
            return up

        while i < len(a) or j < len(b):
            va = a[i][0] if i < len(a) else math.inf
            vb = b[j][0] if j < len(b) else math.inf
            if va == vb:  # one combined tuple, both sides inclusive
                rmin = cum_a[i] + cum_b[j]
                rmax = cum_a[i] + a[i][2] + cum_b[j] + b[j][2]
                merged.append((va, rmin, rmax, a[i][3] + b[j][3]))
                i += 1
                j += 1
            elif va < vb:
                rmin = cum_a[i] + (cum_b[j - 1] if j > 0 else 0.0)
                rmax = cum_a[i] + a[i][2] + upper(b, cum_b, j, wb, va)
                merged.append((va, rmin, rmax, a[i][3]))
                i += 1
            else:
                rmin = cum_b[j] + (cum_a[i - 1] if i > 0 else 0.0)
                rmax = cum_b[j] + b[j][2] + upper(a, cum_a, i, wa, vb)
                merged.append((vb, rmin, rmax, b[j][3]))
                j += 1

        tuples, vals = [], []
        prev_rmin = 0.0
        for v, rmin, rmax, wv in merged:
            rmin = max(rmin, prev_rmin)  # enforce monotone lower bounds
            tuples.append([v, rmin - prev_rmin, max(0.0, rmax - rmin), wv])
            vals.append(v)
            prev_rmin = rmin
        self.tuples = tuples
        self._vals = vals
        self.weight = wa + wb
        self.compress()

    # -- queries -------------------------------------------------------------

    def rank(self, x: float) -> float:
        """Estimated weighted rank of ``x`` (error <= ``error_bound()``)."""
        x = float(x)
        i = bisect.bisect_right(self._vals, x) - 1
        if i < 0:
            return 0.0
        t = self.tuples
        lo = sum(tp[1] for tp in t[: i + 1])
        if i + 1 < len(t):
            nxt = t[i + 1]
            hi = lo + nxt[1] + nxt[2] - nxt[3]
        else:
            hi = self.weight
        return 0.5 * (lo + max(lo, hi))

    def quantile(self, phi: float) -> float:
        """An eps-approximate phi-quantile value."""
        return float(table_quantile(self.table(), self.weight,
                                    np.array([phi]))[0])

    def table(self) -> np.ndarray:
        """Publishable sorted ``(n, 2)`` [value, rank-estimate] f32 table.

        Row i holds ``(v_i, c_i)`` where ``c_i`` is the midpoint of the
        certified rank interval for query values in ``[v_i, v_{i+1})`` —
        ``[rmin_i, rmax_{i+1} - wv_{i+1}]`` (upper end ``W`` after the
        last value).  ``table_rank`` answers rank queries by reading
        ``c`` directly and ``table_quantile`` inverts it; both inherit
        the summary's ``eps W`` guarantee.
        """
        t = self.tuples
        if not t:
            return np.zeros((0, 2), np.float32)
        arr = np.asarray(t, np.float64)
        rmin = np.cumsum(arr[:, 1])
        upper_next = np.empty(len(t))
        upper_next[:-1] = rmin[1:] + arr[1:, 2] - arr[1:, 3]
        upper_next[-1] = self.weight
        c = 0.5 * (rmin + np.maximum(rmin, upper_next))
        c = np.maximum.accumulate(c)
        return _dedup_f32_table(arr[:, 0], c)

    def error_bound(self) -> float:
        """Certified rank-error bound (half the widest uncertain interval)."""
        t = self.tuples
        if not t:
            return 0.0
        widest = self.weight - sum(tp[1] for tp in t)  # 0 up to fp noise
        rmin = 0.0
        for i, tp in enumerate(t):
            prev_rmin = rmin
            rmin += tp[1]
            widest = max(widest, rmin + tp[2] - tp[3] - prev_rmin)
        widest = max(widest, self.weight - rmin)
        return 0.5 * widest

    def size(self) -> int:
        """Number of stored tuples."""
        return len(self.tuples)

    def serialized_bytes(self) -> int:
        """Bytes a checkpoint of this summary occupies (4 f64 per tuple)."""
        return 32 * len(self.tuples)

    # -- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-able snapshot of the summary (exact float round-trip)."""
        return {
            "eps": self.eps,
            "tuples": [list(tp) for tp in self.tuples],
            "weight": self.weight,
            # Compress cadence is part of the state: without it a restored
            # summary compresses on a shifted schedule and the continued
            # stream is no longer bit-identical to the uninterrupted one.
            "since_compress": self._since_compress,
        }

    @classmethod
    def from_state(cls, state: dict) -> "QuantileSummary":
        """Rebuild a summary from ``state_dict`` output (state identity)."""
        qs = cls(float(state["eps"]))
        qs.tuples = [[float(x) for x in tp] for tp in state["tuples"]]
        qs._vals = [tp[0] for tp in qs.tuples]
        qs.weight = float(state["weight"])
        qs._since_compress = int(state.get("since_compress", 0))
        return qs


# ---------------------------------------------------------------------------
# Shared searchsorted query path over the published (n, 2) table.
# ---------------------------------------------------------------------------


def _dedup_f32_table(values, ranks) -> np.ndarray:
    """Build the f32 ``(n, 2)`` table, collapsing values that collide in f32.

    Distinct f64 values can round to the same float32; keeping only the
    last entry of each equal run (whose rank column already covers the
    gap *after* the value) keeps the published values strictly
    increasing — the snapshot-codec contract — without changing any
    searchsorted answer.
    """
    v = np.asarray(values, np.float32)
    c = np.asarray(ranks, np.float32)
    keep = np.concatenate([v[1:] != v[:-1], [True]]) if v.shape[0] else np.ones(0, bool)
    return np.stack([v[keep], np.maximum.accumulate(c)[keep]], axis=1)


def encode_quantile_snapshot(table: np.ndarray) -> np.ndarray:
    """Validate + freeze a quantile table into the store's ``(n, 2)`` form.

    Column 0 holds values (strictly increasing), column 1 the rank
    estimate at each value (non-decreasing).  This is the matrix a
    ``SketchStore`` snapshot carries for a quantile tenant.
    """
    t = np.asarray(table, np.float32)
    if t.ndim != 2 or (t.size and t.shape[1] != 2):
        raise ValueError(f"quantile snapshot table must be (n, 2), got {t.shape}")
    if t.shape[0]:
        if np.any(np.diff(t[:, 0]) <= 0):
            raise ValueError("quantile snapshot values must be strictly increasing")
        if np.any(np.diff(t[:, 1]) < 0):
            raise ValueError("quantile snapshot ranks must be non-decreasing")
    return t


def decode_quantile_snapshot(matrix: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Invert ``encode_quantile_snapshot``: ``(values, ranks)`` columns."""
    m = np.asarray(matrix)
    if m.ndim != 2 or (m.size and m.shape[1] != 2):
        raise ValueError(f"quantile snapshot matrix must be (n, 2), got {m.shape}")
    if not m.size:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    return m[:, 0], m[:, 1]


def table_rank(table: np.ndarray, xs) -> np.ndarray:
    """Rank estimates for each query value via one searchsorted pass.

    The single implementation every surface uses — live protocols, the
    registry interface, and published-snapshot serving — so answers
    cannot diverge between them.  ``table[:, 1]`` is the rank estimate
    for query values in the gap at and after each stored value (see
    ``QuantileSummary.table``), so a rank query is one lookup.
    """
    xs = np.atleast_1d(np.asarray(xs, np.float64)).ravel()
    t = np.asarray(table)
    if t.shape[0] == 0:
        return np.zeros(xs.shape[0], np.float32)
    idx = np.searchsorted(t[:, 0], xs, side="right") - 1
    out = np.where(idx >= 0, t[np.clip(idx, 0, None), 1], 0.0)
    return out.astype(np.float32)


def table_quantile(table: np.ndarray, w_total: float, phis) -> np.ndarray:
    """Phi-quantile values: the first stored value whose gap rank estimate
    reaches ``phi * w_total`` (clipped to the maximum)."""
    phis = np.atleast_1d(np.asarray(phis, np.float64)).ravel()
    t = np.asarray(table)
    if t.shape[0] == 0:
        return np.zeros(phis.shape[0], np.float32)
    targets = np.clip(phis, 0.0, 1.0) * float(w_total)
    n = t.shape[0]
    j = np.clip(np.searchsorted(t[:, 1], targets, side="left"), 0, n - 1)
    return t[j, 0].astype(np.float32)


def exact_ranks(values: np.ndarray, weights: np.ndarray, xs) -> np.ndarray:
    """Ground-truth weighted ranks of a finished stream (test oracle)."""
    order = np.argsort(values, kind="stable")
    v = np.asarray(values, np.float64)[order]
    c = np.cumsum(np.asarray(weights, np.float64)[order])
    xs = np.atleast_1d(np.asarray(xs, np.float64)).ravel()
    idx = np.searchsorted(v, xs, side="right") - 1
    return np.where(idx >= 0, c[np.clip(idx, 0, None)], 0.0)


# ---------------------------------------------------------------------------
# Fixed-shape summary on tensors (the super-step engine's state).
# ---------------------------------------------------------------------------


class QuantState(NamedTuple):
    """GK-style summaries as fixed-shape tensors (pad value ``+inf``), leading axes ``...``.

    An all-pad state (every value ``+inf``, weights zero) is what a
    non-shipping site contributes to the coordinator fold, exactly like the
    empty ``MGState`` for HH.
    """

    values: torch.Tensor  # (..., cap) f32, +inf = empty slot
    g: torch.Tensor  # (..., cap) f32 — rank increments
    delta: torch.Tensor  # (..., cap) f32 — band widths
    wv: torch.Tensor  # (..., cap) f32 — certified own-value mass
    weight: torch.Tensor  # (...) f32 — total weight summarized


def quant_init(cap: int, device=None) -> QuantState:
    """The empty summary at capacity ``cap``."""
    device = resolve_device(device)
    zeros = torch.zeros(cap, dtype=torch.float32, device=device)
    return QuantState(
        values=torch.full((cap,), float("inf"), dtype=torch.float32, device=device),
        g=zeros, delta=zeros.clone(), wv=zeros.clone(),
        weight=torch.zeros((), dtype=torch.float32, device=device),
    )


def _quant_pack(v, rmin, rmax, wv, thresh, cap, weight) -> QuantState:
    """Greedy GK compress of sorted interval tuples (..., n) into ``cap`` slots.

    Folds tuple i forward into i+1 while the merged band stays within
    ``thresh``; the first and last live tuples always emit.  Tuples with
    EQUAL values are always folded together (their certified own-value
    masses ``wv`` add), so the output values are strictly increasing — the
    snapshot-codec contract.  If more distinct tuples survive than ``cap``,
    the overflow keeps folding into the last slot — still interval-sound,
    just wider bands near the maximum.  One ``quant_pack`` launch for every
    row on the leading axes (the reference's ``lax.fori_loop``).
    """
    from repro_torch.kernels.ops import quant_pack

    lead, n = v.shape[:-1], v.shape[-1]
    rows = [a.reshape(-1, n).contiguous() for a in (v, rmin, rmax, wv)]
    out = quant_pack(*rows, thresh.expand(lead).reshape(-1).contiguous(), cap)
    return QuantState(*(a.reshape(*lead, cap) for a in out), weight=weight)


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def quant_merge(a: QuantState, b: QuantState, eps: float, cap: int) -> QuantState:
    """Merge two summaries (same leading axes) and compress to ``cap`` (band <= eps*W).

    The vectorized twin of ``QuantileSummary.merge``: sort the union,
    rebuild every tuple's rank interval as its own interval plus the other
    summary's certified interval at that value, then greedy-pack.  The sort
    is stable (equal values: ``a``'s first), as the reference's.  The
    cumulative sums run in torch's order, not XLA's: answers agree with the
    reference to f32 rounding of W.
    """
    v = torch.cat([a.values, b.values], -1)
    g = torch.cat([a.g, b.g], -1)
    d = torch.cat([a.delta, b.delta], -1)
    wv = torch.cat([a.wv, b.wv], -1)
    la, n = a.values.shape[-1], v.shape[-1]
    idx = torch.arange(n, device=v.device)
    order = torch.argsort(v, dim=-1, stable=True)  # ties: A entries first
    v, g, d, wv = (torch.gather(t, -1, order) for t in (v, g, d, wv))
    is_a = order < la
    live = torch.isfinite(v)

    cum_a = torch.cumsum(torch.where(is_a, g, 0.0), -1)
    cum_b = torch.cumsum(torch.where(is_a, 0.0, g), -1)
    rmin = cum_a + cum_b  # own inclusive rank + other mass sorted before
    own_cum = torch.where(is_a, cum_a, cum_b)

    pos_a = torch.where(is_a & live, idx, n)
    pos_b = torch.where(~is_a & live, idx, n)
    tail = torch.full(v.shape[:-1] + (1,), n, dtype=idx.dtype, device=v.device)
    next_a = torch.cat([_suffix_min(pos_a)[..., 1:], tail], -1)
    next_b = torch.cat([_suffix_min(pos_b)[..., 1:], tail], -1)
    n_other = torch.where(is_a, next_b, next_a)
    w_other = torch.where(is_a, b.weight[..., None], a.weight[..., None])
    safe = n_other.clamp(0, n - 1)
    v_s, wv_s = torch.gather(v, -1, safe), torch.gather(wv, -1, safe)
    up = (torch.gather(own_cum, -1, safe) + torch.gather(d, -1, safe)
          - wv_s * (v_s > v).to(torch.float32))
    upper_other = torch.where(n_other < n, up, w_other)
    rmax = own_cum + d + upper_other

    rmin = torch.cummax(rmin, dim=-1).values
    rmax = torch.maximum(rmax, rmin)
    weight = a.weight + b.weight
    thresh = torch.tensor(2.0 * eps, dtype=torch.float32) * weight
    return _quant_pack(v, rmin, rmax, wv, thresh, cap, weight)


def _segment_sum(vs: torch.Tensor, ws: torch.Tensor):
    """Sums of ``ws`` over runs of equal sorted ``vs`` (..., n), and each
    element's run index.  Each run is summed left to right, one place of
    the run a pass: no pass adds two non-zero terms into one sum, so the
    order is fixed on any device (a one-pass ``scatter_add`` on the card
    adds a run's terms in whatever order its atomics land)."""
    n = vs.shape[-1]
    idx = torch.arange(n, device=vs.device)
    start = torch.ones(vs.shape[:-1] + (1,), dtype=torch.bool, device=vs.device)
    is_start = torch.cat([start, vs[..., 1:] != vs[..., :-1]], -1)
    seg = torch.cumsum(is_start.to(torch.int64), -1) - 1
    pos = idx - torch.cummax(torch.where(is_start, idx, 0), dim=-1).values  # place in its run
    g = torch.zeros_like(ws)
    for r in range(int(pos.max()) + 1):
        g = g.scatter_add(-1, seg, torch.where(pos == r, ws, 0.0))
    return g, seg


def quant_insert(state: QuantState, values, weights, eps: float) -> QuantState:
    """Absorb a weighted batch (..., n): dedup exact values, merge as an exact summary."""
    cap = state.values.shape[-1]
    lead = state.values.shape[:-1]
    dev = state.values.device
    values = torch.as_tensor(values, dtype=torch.float32, device=dev).reshape(*lead, -1)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev).reshape(*lead, -1)
    n = values.shape[-1]
    if n == 0:  # nothing to absorb
        return state
    order = torch.argsort(values, dim=-1, stable=True)
    vs, ws = torch.gather(values, -1, order), torch.gather(weights, -1, order)
    g, seg = _segment_sum(vs, ws)
    v = torch.full_like(vs, float("inf")).scatter_reduce(-1, seg, vs, "amin")
    v = torch.where(g > 0, v, float("inf"))  # drop zero-weight slots and pad tails
    batch = QuantState(values=v, g=g, delta=torch.zeros_like(g), wv=g, weight=ws.sum(-1))
    return quant_merge(state, batch, eps, cap)


def quant_table(state: QuantState) -> np.ndarray:
    """Host-side ``(n, 2)`` [value, rank-estimate] table of one summary.

    Same gap-midpoint semantics as ``QuantileSummary.table`` — column 1
    estimates the rank of query values in the gap at and after each
    stored value.
    """
    v = state.values.cpu().numpy()
    live = np.isfinite(v)
    if not live.any():
        return np.zeros((0, 2), np.float32)
    g = state.g.cpu().numpy().astype(np.float64)[live]
    d = state.delta.cpu().numpy().astype(np.float64)[live]
    wv = state.wv.cpu().numpy().astype(np.float64)[live]
    rmin = np.cumsum(g)
    upper_next = np.empty(rmin.shape[0])
    upper_next[:-1] = rmin[1:] + d[1:] - wv[1:]
    upper_next[-1] = float(state.weight)
    c = 0.5 * (rmin + np.maximum(rmin, upper_next))
    c = np.maximum.accumulate(c)
    return _dedup_f32_table(v[live], c)


def quant_band(state: QuantState) -> float:
    """Certified rank-error bound of one summary (see ``error_bound``)."""
    v = state.values.cpu().numpy()
    live = np.isfinite(v)
    if not live.any():
        return 0.0
    g = state.g.cpu().numpy().astype(np.float64)[live]
    d = state.delta.cpu().numpy().astype(np.float64)[live]
    wv = state.wv.cpu().numpy().astype(np.float64)[live]
    rmin = np.cumsum(g)
    prev = np.concatenate([[0.0], rmin[:-1]])
    widest = float(np.max(rmin + d - wv - prev))
    widest = max(widest, float(state.weight) - float(rmin[-1]), 0.0)
    return 0.5 * widest


# ---------------------------------------------------------------------------
# Event-driven site -> coordinator protocols (paper-style accounting).
# ---------------------------------------------------------------------------


@dataclass
class QuantileResult:
    """The coordinator's current quantile state, queryable at any time."""

    table: np.ndarray  # (k, 2) [value, rank-estimate], sorted
    w_hat: float  # coordinator estimate of the total stream weight
    comm: "object"  # CommLog in the paper's units
    m: int
    eps: float

    def rank(self, xs) -> np.ndarray:
        """Estimated weighted rank per queried value."""
        return table_rank(self.table, xs)

    def quantile(self, phis) -> np.ndarray:
        """Value whose estimated rank is nearest ``phi * w_hat``, per phi."""
        return table_quantile(self.table, self.w_hat, phis)


class QuantileP1Stream:
    """Quantile P1: per-site GK summaries, deterministic change propagation.

    Each site runs a ``QuantileSummary(eps/4)`` over its local substream
    and pushes it to the coordinator when its cumulative weight has grown
    by a ``1 + eps/4`` factor since the last push (with an ``eps/(4m)``
    fraction-of-total floor so early items batch up); the coordinator
    merges pushed summaries at ``eps/2``.  Site summaries reset on push,
    so merged substreams are disjoint and bands add to at most
    ``(eps/2) W``; unpushed site mass accounts for the other ``eps/2``,
    keeping end-to-end quantile rank error within ``eps W``.
    """

    def __init__(self, m, eps, rng=None):
        from repro_torch.core.protocols import CommLog

        self.m, self.eps = m, eps
        self.comm = CommLog()
        self.site_sum = [QuantileSummary(eps / 4.0) for _ in range(m)]
        self.site_w = [0.0] * m
        self.site_pushed = [0.0] * m
        self.coord = QuantileSummary(eps / 2.0)
        self.w_hat = 1.0

    def step(self, values, weights, sites) -> None:
        """Absorb a batch of weighted values, one event at a time."""
        m, eps = self.m, self.eps
        for v, w, j in zip(values.tolist(), weights.tolist(), sites.tolist()):
            self.site_sum[j].insert(v, w)
            self.site_w[j] += w
            unpushed = self.site_w[j] - self.site_pushed[j]
            if (
                self.site_w[j] >= (1.0 + eps / 4.0) * self.site_pushed[j]
                and unpushed >= (eps / (4.0 * m)) * self.w_hat
            ):
                self.comm.sketch_rows += self.site_sum[j].size()
                self.comm.scalar_msgs += 1
                self.coord.merge(self.site_sum[j])
                self.site_sum[j] = QuantileSummary(eps / 4.0)
                self.site_pushed[j] = self.site_w[j]
                if self.coord.weight / self.w_hat > 1.0 + eps / 2.0:
                    self.w_hat = self.coord.weight
                    self.comm.broadcast_events += 1

    def result(self) -> QuantileResult:
        """The coordinator's current table (callable at any time)."""
        return QuantileResult(
            self.coord.table(), self.coord.weight, self.comm, self.m, self.eps
        )

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        from repro_torch.core.protocols import _comm_state

        return {
            "site_sum": [s.state_dict() for s in self.site_sum],
            "site_w": list(self.site_w),
            "site_pushed": list(self.site_pushed),
            "coord": self.coord.state_dict(),
            "w_hat": self.w_hat,
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        from repro_torch.core.protocols import _comm_from_state

        self.site_sum = [QuantileSummary.from_state(s) for s in state["site_sum"]]
        self.site_w = [float(w) for w in state["site_w"]]
        self.site_pushed = [float(w) for w in state["site_pushed"]]
        self.coord = QuantileSummary.from_state(state["coord"])
        self.w_hat = float(state["w_hat"])
        self.comm = _comm_from_state(state["comm"])


class QuantileP3Stream:
    """Quantile P3: the cheaper sampling variant (distributed priority
    sampling without replacement, as in HH P3, carrying values).

    A size-s priority sample supports subset-sum rank estimates: the rank
    of ``x`` is the estimated weight of items with value ``<= x``.  With
    ``s = O(1/eps^2)`` the error is ``O(eps W)`` with high probability —
    cheaper than P1's summary shipping but randomized (err_factor 2 in
    the registry, like the HH sampling protocols).
    """

    def __init__(self, m, eps, rng, s=None):
        from repro_torch.core.protocols import CommLog

        if s is None:
            s = max(8, math.ceil((1.0 / eps**2) * math.log(max(math.e, 1.0 / eps))))
        self.m, self.eps, self.s = m, eps, s
        self.rng = rng
        self.comm = CommLog()
        self.tau = 1.0
        self.q_cur: list[tuple[float, float, float]] = []  # (value, w, rho)
        self.q_next: list[tuple[float, float, float]] = []

    def step(self, values, weights, sites) -> None:
        """Absorb a batch of weighted values, one event at a time."""
        n = len(values)
        rho_all = weights / np.maximum(self.rng.uniform(size=n), 1e-300)
        for v, w, rho in zip(values.tolist(), weights.tolist(), rho_all.tolist()):
            if rho >= self.tau:
                self.comm.item_msgs += 1
                if rho >= 2.0 * self.tau:
                    self.q_next.append((v, w, rho))
                else:
                    self.q_cur.append((v, w, rho))
                if len(self.q_next) >= self.s:
                    self.tau *= 2.0
                    self.comm.broadcast_events += 1
                    self.q_cur = self.q_next
                    self.q_next = [t for t in self.q_cur if t[2] >= 2.0 * self.tau]
                    self.q_cur = [t for t in self.q_cur if t[2] < 2.0 * self.tau]

    def result(self) -> QuantileResult:
        """Priority-sample estimator table (callable at any time)."""
        sample = self.q_cur + self.q_next
        if not sample:
            return QuantileResult(
                np.zeros((0, 2), np.float32), 0.0, self.comm, self.m, self.eps
            )
        sample = sorted(sample, key=lambda t: t[2])
        rho_hat = sample[0][2]
        kept = sample[1:] if len(sample) > 1 else sample
        vals = np.array([t[0] for t in kept], np.float64)
        wbar = np.maximum(np.array([t[1] for t in kept], np.float64), rho_hat)
        order = np.argsort(vals, kind="stable")
        vals, wbar = vals[order], wbar[order]
        # _dedup_f32_table collapses duplicates *after* the f32 cast, so
        # f64-distinct values that collide in f32 cannot violate the
        # codec's strictly-increasing contract.
        table = _dedup_f32_table(vals, np.cumsum(wbar))
        return QuantileResult(table, float(wbar.sum()), self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the sampler state (incl. PRNG)."""
        from repro_torch.core.protocols import _comm_state, _rng_state

        return {
            "s": self.s,
            "tau": self.tau,
            "q_cur": [list(t) for t in self.q_cur],
            "q_next": [list(t) for t in self.q_next],
            "rng": _rng_state(self.rng),
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        from repro_torch.core.protocols import _comm_from_state, _rng_from_state

        self.s = int(state["s"])
        self.tau = float(state["tau"])
        self.q_cur = [(float(v), float(w), float(r)) for v, w, r in state["q_cur"]]
        self.q_next = [(float(v), float(w), float(r)) for v, w, r in state["q_next"]]
        self.rng = _rng_from_state(state["rng"])
        self.comm = _comm_from_state(state["comm"])


# Resumable stream engines (init/step/result/state_dict) — the registry's
# event-engine quantile entries, mirroring HH_STREAMS / MATRIX_STREAMS.
QUANTILE_STREAMS = {
    "P1": QuantileP1Stream,
    "P3": QuantileP3Stream,
}


def run_quantile_protocol(
    name: str,
    values: np.ndarray,
    weights: np.ndarray,
    sites: np.ndarray,
    m: int,
    eps: float,
    seed: int = 0,
    **kw,
) -> QuantileResult:
    """One-shot wrapper: stream the whole feed through a quantile protocol."""
    rng = np.random.default_rng(seed)
    try:
        stream_cls = QUANTILE_STREAMS[name]
    except KeyError:
        raise KeyError(
            f"unknown quantile protocol {name!r} "
            f"(have: {sorted(QUANTILE_STREAMS)})"
        ) from None
    eng = stream_cls(m, eps, rng, **kw)
    eng.step(values, weights, sites)
    return eng.result()
