"""Priority sampling (Duffield--Lund--Thorup) primitives for protocol P3.

Each item with weight ``w`` draws ``u ~ Unif(0, 1]`` and gets priority
``rho = w / u``.  A size-``s`` *without replacement* sample keeps the ``s``
largest priorities; with ``tau`` the (s+1)-th largest priority, the
subset-sum estimator assigns each kept item the adjusted weight
``bar{w} = max(w, tau)``, which is unbiased: ``E[sum bar{w}] = W``.

The draws come from an explicit ``torch.Generator`` (the reference takes a
``jax.random`` key); the shard engine's own counter-based draws live in
``distributed.py``.  The streaming/distributed round structure (threshold
doubling, queues Q_j/Q_{j+1}) lives in ``protocols.py``; this module
provides the math.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "priorities",
    "priority_sample",
    "PrioritySample",
    "PrioritySampler",
    "subset_sum_weights",
]

_TINY = torch.finfo(torch.float32).tiny


def priorities(weights: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """rho_i = w_i / u_i with u ~ Unif(tiny, 1], drawn from ``generator``."""
    u = torch.rand(weights.shape, generator=generator, device=weights.device,
                   dtype=torch.float32)
    # torch.rand draws [0, 1); 1 - u lies in (0, 1], clamped above tiny.
    return weights / (1.0 - u).clamp_min(_TINY)


class PrioritySample(NamedTuple):
    """A size-s priority sample: kept indices, adjusted weights, threshold tau."""
    indices: torch.Tensor  # (s,) indices into the source tensor
    weights: torch.Tensor  # (s,) adjusted weights bar{w}
    tau: torch.Tensor  # () the (s+1)-th priority (estimator threshold)


def priority_sample(weights: torch.Tensor, generator: torch.Generator | None,
                    s: int) -> PrioritySample:
    """One-shot size-s priority sample of a weight vector."""
    n = weights.shape[0]
    if n <= s:
        raise ValueError(f"need n > s for a proper sample, got n={n}, s={s}")
    rho = priorities(weights.float(), generator)
    top_rho, top_idx = torch.topk(rho, s + 1)
    tau = top_rho[s]
    idx = top_idx[:s]
    adj = torch.maximum(weights[idx].float(), tau)
    return PrioritySample(indices=idx, weights=adj, tau=tau)


def subset_sum_weights(kept_w: np.ndarray, tau: float) -> np.ndarray:
    """Adjusted weights for a priority sample with threshold tau (numpy)."""
    return np.maximum(kept_w, tau)


class PrioritySampler:
    """Streaming without-replacement priority sampler (numpy oracle).

    Maintains the top-``s`` priorities over everything seen; ``sample()``
    returns (items, adjusted weights).  This is the *centralized* oracle; the
    distributed round protocol in protocols.py reproduces it with low
    communication (paper Lemma 6 / Theorem 5).
    """

    def __init__(self, s: int, rng: np.random.Generator):
        self.s = s
        self.rng = rng
        self._items: list = []
        self._weights: list[float] = []
        self._rhos: list[float] = []

    def update(self, item, w: float) -> None:
        """Offer one (item, weight) pair to the sampler."""
        rho = w / max(self.rng.uniform(), 1e-300)
        self._items.append(item)
        self._weights.append(w)
        self._rhos.append(rho)
        if len(self._items) > 4 * self.s:
            self._compact()

    def _compact(self) -> None:
        order = np.argsort(self._rhos)[::-1][: self.s + 1]
        self._items = [self._items[i] for i in order]
        self._weights = [self._weights[i] for i in order]
        self._rhos = [self._rhos[i] for i in order]

    def sample(self):
        """The current sample as ``(items, adjusted subset-sum weights)``."""
        self._compact()
        if len(self._items) <= self.s:
            return list(self._items), np.asarray(self._weights, np.float64)
        tau = self._rhos[self.s]
        items = self._items[: self.s]
        w = subset_sum_weights(np.asarray(self._weights[: self.s], np.float64), tau)
        return items, w
