"""Synthetic data generators for streams, matrices, and token batches.

The paper's UCI datasets (PAMAP, YearPredictionMSD) cannot ship in this
offline container; ``pamap_like`` / ``msd_like`` generate matrices matched to
their published characteristics (size, dimensionality, effective rank) so the
offline SVD/FD baselines land near the paper's reported err values
(PAMAP: SVD_30 err ~ 2e-6 => effectively low-rank; MSD: SVD_50 err ~ 6e-3 =>
heavy-tailed full rank).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "zipfian_stream",
    "pamap_like",
    "msd_like",
    "lowrank_stream",
    "lm_token_batch",
    "site_assignment",
]


def zipfian_stream(n: int, *, skew: float = 2.0, universe: int = 10_000, beta: float = 1000.0, seed: int = 0):
    """Weighted element stream: zipf(skew) keys, Unif[1, beta] weights."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(skew, size=n) % universe).astype(np.int64)
    weights = rng.uniform(1.0, beta, size=n)
    return keys, weights


def _scaled_rows(a: np.ndarray, rng, beta: float) -> np.ndarray:
    """Rescale rows to squared norms in [1, beta] (paper's weight model)."""
    norms = np.sqrt(np.maximum(np.einsum("nd,nd->n", a, a), 1e-12))
    target = np.sqrt(rng.uniform(1.0, beta, size=a.shape[0]))
    return a * (target / norms)[:, None]


def pamap_like(n: int = 100_000, d: int = 44, *, beta: float = 100.0, seed: int = 0) -> np.ndarray:
    """Low-rank-plus-noise matrix (PAMAP is ~rank-25 in 44 dims)."""
    rng = np.random.default_rng(seed)
    rank = 25
    spectrum = np.exp(-0.35 * np.arange(rank))  # fast decay -> low effective rank
    u = rng.normal(size=(n, rank)) * spectrum[None, :]
    v = rng.normal(size=(rank, d)) / np.sqrt(d)
    a = u @ v + 1e-4 * rng.normal(size=(n, d))
    return _scaled_rows(a, rng, beta)


def msd_like(n: int = 100_000, d: int = 90, *, beta: float = 100.0, seed: int = 0) -> np.ndarray:
    """High-rank heavy-tailed matrix (MSD keeps err even at rank 50)."""
    rng = np.random.default_rng(seed)
    spectrum = (1.0 + np.arange(d)) ** -0.35  # slow decay -> high rank
    u = rng.normal(size=(n, d)) * spectrum[None, :]
    v, _ = np.linalg.qr(rng.normal(size=(d, d)))
    a = u @ v.T
    return _scaled_rows(a, rng, beta)


def lowrank_stream(
    n: int, d: int, *, rank: int = 5, noise: float = 0.05, seed: int = 0
) -> np.ndarray:
    """Small low-rank-plus-noise tenant stream with a steep spectrum.

    The runtime demos, benchmarks, and tests all want the same thing: a
    stream whose sketch is meaningful at tiny `l` (so eps-envelope checks
    bite) with per-tenant variation via ``seed``/``rank``.
    """
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, rank)) * (np.arange(rank, 0, -1) ** 2)
    a = u @ rng.normal(size=(rank, d)) + noise * rng.normal(size=(n, d))
    return a.astype(np.float32)


def site_assignment(n: int, m: int, *, seed: int = 0) -> np.ndarray:
    """Uniform-random site for each stream element (the paper's model lets
    any site receive any element)."""
    return np.random.default_rng(seed + 7).integers(0, m, size=n)


def lm_token_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int) -> np.ndarray:
    """Markov-ish synthetic token stream: learnable (not uniform) so tiny
    training runs show a falling loss."""
    # Low-entropy transition structure: next token ~ (prev * a + b) mod V
    # with occasional uniform resets.
    a = 31
    b_const = 17
    toks = np.empty((batch, seq), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    resets = rng.uniform(size=(batch, seq)) < 0.1
    rand = rng.integers(0, vocab, size=(batch, seq))
    for t in range(1, seq):
        nxt = (toks[:, t - 1] * a + b_const) % vocab
        toks[:, t] = np.where(resets[:, t], rand[:, t], nxt)
    return toks
