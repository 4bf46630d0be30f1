"""Weighted frequency sketches: Misra--Gries and SpaceSaving.

The paper's weighted-heavy-hitter protocols (Section 4) are built from a
*weighted* Misra--Gries (MG) summary: the weighted generalisation decrements
all counters by ``delta = min(min_counter, w)`` instead of by 1.  Guarantee
for ``k`` counters over total weight ``W``::

    0 <= f_e - hat{f}_e <= W / (k + 1)        (underestimates)

SpaceSaving is the overestimate twin (``0 <= hat{f}_e - f_e <= W / k``) the
paper cites [31] for bounding per-site space in protocols P2/P4.

Both come in two flavours:
  * ``MGState`` + ``mg_*`` — fixed-shape tensors, any leading axes (the
    super-step engine keeps one summary per site on a leading ``m`` axis);
    ``mg_update_stream`` is one launch of the ``mg_scan`` kernel
    (``kernels.ops.mg_scan``) for all of them;
  * ``MGSketch`` / ``SpaceSaving`` — plain-python dict oracles used by the
    event-driven protocol engine and the tests, copied from the reference.

The tensor functions reproduce the reference's, tie for tie: the first
empty slot and the first minimum take a new key, and ``mg_merge`` keeps the
top k of a *stable* descending sort.  Like the reference, ``mg_update`` puts
a zero-weight key into an empty slot and ``mg_merge`` then drops it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = [
    "MGState",
    "mg_init",
    "mg_update",
    "mg_update_stream",
    "mg_merge",
    "mg_estimate",
    "mg_items",
    "MGSketch",
    "SpaceSaving",
    "encode_hh_snapshot",
    "decode_hh_snapshot",
    "exact_heavy_hitters",
    "threshold_heavy_hitters",
]

EMPTY = -1


class MGState(NamedTuple):
    """Weighted Misra--Gries summaries as fixed-shape tensors, leading axes ``...``."""
    keys: torch.Tensor  # (..., k) int32, -1 = empty
    counts: torch.Tensor  # (..., k) f32
    weight: torch.Tensor  # (...) f32 — total weight consumed
    shrink: torch.Tensor  # (...) f32 — total decrement mass (error witness)


def mg_init(k: int, device=None) -> MGState:
    """The empty k-counter MG summary (what ``mg_merge`` folds shipped summaries into)."""
    device = resolve_device(device)
    return MGState(
        keys=torch.full((k,), EMPTY, dtype=torch.int32, device=device),
        counts=torch.zeros(k, dtype=torch.float32, device=device),
        weight=torch.zeros((), dtype=torch.float32, device=device),
        shrink=torch.zeros((), dtype=torch.float32, device=device),
    )


def mg_update_stream(state: MGState, keys: torch.Tensor, weights: torch.Tensor) -> MGState:
    """Absorb a (..., b) batch of (element, weight) pairs, in order, into each summary.

    One ``mg_scan`` launch for every summary on the leading axes (the
    reference's ``lax.scan`` of ``mg_update``).
    """
    from repro_torch.kernels.ops import mg_scan

    lead, k = state.keys.shape[:-1], state.keys.shape[-1]
    b = keys.shape[-1]
    out = mg_scan(
        state.keys.reshape(-1, k).contiguous(),
        state.counts.reshape(-1, k).contiguous(),
        state.weight.reshape(-1).contiguous(),
        state.shrink.reshape(-1).contiguous(),
        keys.to(torch.int32).reshape(-1, b).contiguous(),
        weights.to(torch.float32).reshape(-1, b).contiguous(),
    )
    return MGState(out[0].reshape(*lead, k), out[1].reshape(*lead, k),
                   out[2].reshape(lead), out[3].reshape(lead))


def mg_update(state: MGState, key: torch.Tensor, w: torch.Tensor) -> MGState:
    """Absorb one (element, weight) pair into each summary (a stream of one)."""
    dev = state.keys.device
    return mg_update_stream(state, torch.as_tensor(key, device=dev)[..., None],
                            torch.as_tensor(w, device=dev)[..., None])


def mg_estimate(state: MGState, key: torch.Tensor) -> torch.Tensor:
    """Estimated weight of ``key`` in each summary (0 when untracked; underestimates)."""
    key = torch.as_tensor(key, dtype=torch.int32, device=state.keys.device)
    hit = state.keys == key[..., None]
    return torch.where(hit, state.counts, 0.0).sum(-1)


def mg_items(state: MGState) -> dict[int, float]:
    """Materialize one summary (no leading axes) as a plain ``{element: count}`` dict."""
    keys = state.keys.cpu().numpy()
    counts = state.counts.cpu().numpy()
    return {int(e): float(c) for e, c in zip(keys.tolist(), counts.tolist()) if e != EMPTY}


def mg_merge(a: MGState, b: MGState) -> MGState:
    """Mergeable-summaries MG merge (Agarwal et al.): combine counts for equal
    keys, keep the k largest after subtracting the (k+1)-th largest.

    Leading axes broadcast.  Among equal counts the earlier slot (``a``'s
    before ``b``'s) is kept: the descending sort is stable, as
    ``jnp.argsort`` is.
    """
    k = a.keys.shape[-1]
    keys = torch.cat([a.keys, b.keys], dim=-1)
    counts = torch.cat([a.counts, b.counts], dim=-1)
    valid = keys != EMPTY
    counts = torch.where(valid, counts, 0.0)
    # Deduplicate: O((2k)^2), k is small (O(1/eps)).  Each key sits at most
    # once in each summary, so a sum has at most two non-zero terms and is
    # exact in any order.
    same = (keys[..., :, None] == keys[..., None, :]) & valid[..., :, None] & valid[..., None, :]
    summed = torch.where(same, counts[..., None, :], 0.0).sum(-1)
    first = torch.arange(2 * k, device=keys.device) == same.to(torch.int32).argmax(-1)
    dedup = torch.where(first & valid, summed, 0.0)
    # Keep top-k, subtract the (k+1)-th largest.
    order = torch.argsort(-dedup, dim=-1, stable=True)
    sorted_counts = torch.gather(dedup, -1, order)
    thresh = sorted_counts[..., k]
    kept = (sorted_counts[..., :k] - thresh[..., None]).clamp_min(0.0)
    kept_keys = torch.where(kept > 0.0, torch.gather(keys, -1, order[..., :k]), EMPTY)
    return MGState(
        keys=kept_keys.to(torch.int32),
        counts=kept,
        weight=a.weight + b.weight,
        shrink=a.shrink + b.shrink + thresh,
    )


# ---------------------------------------------------------------------------
# Python oracles (dict-based, exact event-driven semantics).
# ---------------------------------------------------------------------------


class MGSketch:
    """Weighted Misra--Gries over a python dict; error <= W/(k+1)."""

    def __init__(self, k: int):
        self.k = k
        self.counters: dict[int, float] = {}
        self.weight = 0.0
        self.shrink = 0.0

    def update(self, key: int, w: float) -> None:
        """Absorb one (element, weight) pair."""
        self.weight += w
        c = self.counters
        if key in c:
            c[key] += w
            return
        if len(c) < self.k:
            c[key] = w
            return
        delta = min(min(c.values()), w)
        self.shrink += delta
        dead = []
        for e in c:
            c[e] -= delta
            if c[e] <= 1e-12:
                dead.append(e)
        for e in dead:
            del c[e]
        if w - delta > 1e-12:
            c[key] = w - delta

    def extend(self, keys, weights) -> None:
        """Absorb a batch of (element, weight) pairs."""
        for key, w in zip(keys, weights):
            self.update(int(key), float(w))

    def estimate(self, key: int) -> float:
        """Estimated weight of ``key`` (0 when untracked; underestimates)."""
        return self.counters.get(key, 0.0)

    def merge(self, other: "MGSketch") -> None:
        """Fold another MG sketch in (mergeable-summaries merge)."""
        for e, w in other.counters.items():
            self.counters[e] = self.counters.get(e, 0.0) + w
        self.weight += other.weight
        self.shrink += other.shrink
        if len(self.counters) > self.k:
            vals = sorted(self.counters.values(), reverse=True)
            thresh = vals[self.k]
            self.shrink += thresh
            self.counters = {
                e: w - thresh for e, w in self.counters.items() if w - thresh > 1e-12
            }

    def items(self):
        """The live ``{element: count}`` counters (a copy)."""
        return dict(self.counters)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the sketch (counter keys become strings)."""
        return {
            "k": self.k,
            "counters": {str(e): w for e, w in self.counters.items()},
            "weight": self.weight,
            "shrink": self.shrink,
        }

    @classmethod
    def from_state(cls, state: dict) -> "MGSketch":
        """Rebuild a sketch from ``state_dict`` output (exact state identity)."""
        mg = cls(int(state["k"]))
        mg.counters = {int(e): float(w) for e, w in state["counters"].items()}
        mg.weight = float(state["weight"])
        mg.shrink = float(state["shrink"])
        return mg


class SpaceSaving:
    """Weighted SpaceSaving; overestimates, error <= W/k."""

    def __init__(self, k: int):
        self.k = k
        self.counters: dict[int, float] = {}
        self.weight = 0.0

    def update(self, key: int, w: float) -> None:
        """Absorb one (element, weight) pair."""
        self.weight += w
        c = self.counters
        if key in c:
            c[key] += w
        elif len(c) < self.k:
            c[key] = w
        else:
            e_min = min(c, key=c.get)
            v_min = c.pop(e_min)
            c[key] = v_min + w

    def estimate(self, key: int) -> float:
        """Estimated weight of ``key`` (0 when untracked; overestimates)."""
        return self.counters.get(key, 0.0)

    def items(self):
        """The live ``{element: count}`` counters (a copy)."""
        return dict(self.counters)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the sketch (counter keys become strings)."""
        return {
            "k": self.k,
            "counters": {str(e): w for e, w in self.counters.items()},
            "weight": self.weight,
        }

    @classmethod
    def from_state(cls, state: dict) -> "SpaceSaving":
        """Rebuild a sketch from ``state_dict`` output (exact state identity)."""
        ss = cls(int(state["k"]))
        ss.counters = {int(e): float(w) for e, w in state["counters"].items()}
        ss.weight = float(state["weight"])
        return ss


# ---------------------------------------------------------------------------
# Published-snapshot codec: HH estimates as a SketchStore matrix.
# ---------------------------------------------------------------------------


def encode_hh_snapshot(estimates: dict[int, float]) -> np.ndarray:
    """Pack coordinator HH estimates into a publishable ``(n, 2)`` f32 matrix.

    Column 0 holds element ids, column 1 their weight estimates, sorted by
    id so equal estimate sets encode bit-identically.  This is the matrix a
    ``SketchStore`` snapshot carries for an HH tenant (the store's contract
    is "one immutable 2-D array per version"); element ids must stay below
    2**24 so they survive the f32 round-trip exactly.
    """
    if not estimates:
        return np.zeros((0, 2), np.float32)
    if max(estimates) >= 1 << 24 or min(estimates) < 0:
        raise ValueError("HH element ids must be in [0, 2**24) to encode exactly as f32")
    pairs = sorted(estimates.items())
    return np.array(pairs, np.float32).reshape(len(pairs), 2)


def decode_hh_snapshot(matrix: np.ndarray) -> dict[int, float]:
    """Invert ``encode_hh_snapshot``: ``(n, 2)`` matrix back to an estimate dict."""
    m = np.asarray(matrix)
    if m.ndim != 2 or (m.size and m.shape[1] != 2):
        raise ValueError(f"HH snapshot matrix must be (n, 2), got {m.shape}")
    return {int(e): float(w) for e, w in m.tolist()}


def threshold_heavy_hitters(
    estimates: dict[int, float], w_hat: float, eps: float, phi: float
) -> list[int]:
    """The paper's Section 4 answer rule, shared by every query surface.

    Returns (sorted) every element whose estimate crosses
    ``(phi - eps/2) * w_hat`` — the threshold that guarantees no true
    phi-heavy-hitter is missed when estimates carry eps/2 error.  Live
    protocols, the registry interface, and published-snapshot queries must
    all apply this one implementation so their answers cannot diverge.
    """
    thr = (phi - eps / 2.0) * w_hat
    return sorted(e for e, v in estimates.items() if v >= thr)


def exact_heavy_hitters(keys: np.ndarray, weights: np.ndarray, phi: float):
    """Ground-truth phi-weighted heavy hitters of a finished stream."""
    totals: dict[int, float] = {}
    for k, w in zip(keys.tolist(), weights.tolist()):
        totals[k] = totals.get(k, 0.0) + w
    w_total = float(np.sum(weights))
    return {e: v for e, v in totals.items() if v >= phi * w_total}, totals, w_total
