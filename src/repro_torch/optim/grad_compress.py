"""FD-sketched data-parallel gradient aggregation with error feedback.

The paper's distributed matrix protocol, applied as a *gradient compression*
distributed-optimization trick.  In data-parallel training each shard j holds
a local gradient G_j for every 2D parameter (d_in rows of dimension d_out):
exactly the paper's "distributed matrix whose rows arrive at m sites".
Instead of all-reducing d_in x d_out floats:

  1. each shard FD-sketches  (G_j + residual_j)  ->  B_j (l, d_out)
  2. all_gather + FD-merge the sketches          ->  B   (l, d_out)
     (this is the paper's P1 merge; comm = m * l * d_out, replicated result)
  3. the top-k rows of B, normalized, form a shared basis V (k, d_out) —
     the FD guarantee says V captures every direction with squared mass
     >= ||G||_F^2 / l of the *global* gradient;
  4. project-and-reduce: P = mean_j(G_j' @ V.T)  (comm = d_in * k)
  5. decompress ghat = P @ V; error feedback residual_j = G_j' - (G_j'V^T)V.

Compression ratio per layer: (d_in*d_out) / (m*l*d_out/m + d_in*k)
~ d_out / k for the usual d_in >> m*l regime.  Error feedback makes the
scheme convergent despite the lossy step (PowerSGD-style); the FD guarantee
bounds the per-step bias by ||G||_F^2 / l along every direction.

The reference runs this inside ``shard_map``, one device a shard.  Here the
m shards sit on a leading axis of every gradient and residual leaf:
``lax.all_gather`` is that axis itself and ``lax.pmean`` a mean over it.
The m local sketches are one FD state stacked over the shard axis, so each
16-row chunk is one ``fd_gram`` and one ``fd_project`` launch for all m
shards (``core/fd.py``); the merge is one unstacked sketch.  Leaves are
walked in the reference's order, so the byte counts, f32 sums as the
reference's, come out the same.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import fd as fdlib
from repro_torch.tree import flatten, leaves, tree_map, unflatten

__all__ = ["CompressionStats", "FDCompressConfig", "compress_and_aggregate", "init_residuals"]


class FDCompressConfig(NamedTuple):
    """``rank`` k (the basis sent densely), ``sketch_rows`` l (FD's parameter,
    l >= k), ``axis`` (the reference's shard_map axis name, kept for its
    configs) and ``min_size`` (smaller leaves take a plain mean)."""

    rank: int = 8
    sketch_rows: int = 16
    axis: str = "data"
    min_size: int = 4096


def _is_matrix(leaf) -> bool:
    return leaf.ndim >= 2


def init_residuals(params, m: int | tuple[int, ...] = 1) -> dict:
    """Error-feedback buffers, one per shard: f32 zeros of shape
    ``(*m, *leaf.shape)`` for matrices, ``(*m,)`` placeholders otherwise."""
    lead = (m,) if isinstance(m, int) else tuple(m)
    return tree_map(lambda p: torch.zeros(lead + (tuple(p.shape) if _is_matrix(p) else ()),
                                          dtype=torch.float32, device=p.device), params)


class CompressionStats(NamedTuple):
    """Bytes a dense all-reduce would have moved, and bytes this scheme moved
    (f32 host scalars)."""

    full_bytes: torch.Tensor
    compressed_bytes: torch.Tensor


def _stacked_fd_init(m: int, l: int, d: int, device) -> fdlib.FDState:
    return fdlib.FDState(
        buf=torch.zeros((m, 2 * l, d), dtype=torch.float32, device=device),
        frob=torch.zeros((m,), dtype=torch.float32, device=device),
        delta_sum=torch.zeros((m,), dtype=torch.float32, device=device),
        n_seen=torch.zeros((m,), dtype=torch.int32, device=device),
    )


def compress_and_aggregate(grads, residuals, cfg: FDCompressConfig):
    """Per-shard gradients -> (aggregated gradients, new residuals, stats).

    ``grads``: a tree whose leaves carry the m shards on a leading axis,
    ``(m, *leaf.shape)``; ``residuals``: ``init_residuals``'s tree, one
    buffer per shard.  The aggregated gradients have the leaves' own shapes
    and dtypes (every shard of the reference holds the same ones); the
    residuals keep their shard axis.  Non-matrix (or small) leaves take a
    plain mean and keep their residuals.
    """
    l, k = cfg.sketch_rows, cfg.rank
    full_bytes = np.float32(0.0)
    comp_bytes = np.float32(0.0)
    out_g, out_r = [], []
    for (_, g), r in zip(flatten(grads), leaves(residuals)):
        m, shape = g.shape[0], tuple(g.shape[1:])
        size = int(np.prod(shape))
        if len(shape) < 2 or size < cfg.min_size or shape[-1] < 2 * k:
            out_g.append(g.mean(0))
            out_r.append(r)
            full_bytes += np.float32(4.0 * size)
            comp_bytes += np.float32(4.0 * size)
            continue
        d_out = shape[-1]
        rows = size // d_out
        acc = g.reshape(m, rows, d_out).float() + r.reshape(m, rows, d_out)

        # 1. each shard's sketch: one stacked FD state
        st = fdlib.fd_update_stream(_stacked_fd_init(m, l, d_out, g.device), acc)
        b_local = fdlib.fd_matrix(st)  # (m, l, d_out)
        # 2. gather + merge (paper P1 merge: stack and re-sketch)
        st_m = fdlib.fd_update_stream(fdlib.fd_init(l, d_out, device=g.device),
                                      b_local.reshape(m * l, d_out))
        b = fdlib.fd_matrix(st_m)
        # 3. orthonormal basis from the top-k sketch rows (rows are sigma_i v_i)
        norms = torch.sqrt((b * b).sum(1, keepdim=True))
        v = (b / norms.clamp_min(1e-12))[:k]  # (k, d_out)
        # 4. project and reduce
        p_local = acc @ v.T  # (m, rows, k)
        p = p_local.mean(0)
        # 5. decompress + error feedback
        ghat = p @ v
        new_r = acc - p_local @ v
        out_g.append(ghat.reshape(shape).to(g.dtype))
        out_r.append(new_r.reshape(r.shape))
        full_bytes += np.float32(4.0 * size)
        comp_bytes += np.float32(4.0 * (l * d_out + rows * k))

    stats = CompressionStats(full_bytes=torch.tensor(full_bytes),
                             compressed_bytes=torch.tensor(comp_bytes))
    return unflatten(grads, out_g), unflatten(residuals, out_r), stats
