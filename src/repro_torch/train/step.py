"""Train-step factories: the plain step and the FD-compressed data-parallel
step.

The compressed step is the paper's protocol working as gradient compression
(``optim/grad_compress.py``), selected by ``TrainConfig.grad_compression``.
The reference runs it under ``shard_map`` over a mesh of data-parallel
devices; here the shards are a leading axis: the batch is cut into ``m``
micro-batches in mesh order, each takes one forward and backward, and the
per-shard gradients are stacked for ``compress_and_aggregate``.  Each shard
keeps its own error-feedback residuals, as each of the reference's devices
does (its step returns them unreplicated), so ``TrainState.residuals``
carries the shard axes in front of every leaf.

The parameters, their moments and the residuals are trees in the
reference's layout (``models/weights.py``: each scan group's blocks stacked
over a repeat axis), on which the weight decay and the compression decide;
``LM.loss`` takes per-layer views of them.  A step returns new trees and
leaves the state it was given untouched.  ``train_state_shardings`` and
``make_jitted_train_step`` (meshes) wait for ROADMAP item 13c.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models.weights import reference_params
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (
    FDCompressConfig,
    compress_and_aggregate,
    init_residuals,
)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = [
    "TrainConfig",
    "TrainState",
    "aggregate_shards",
    "init_train_state",
    "make_compressed_train_step",
    "make_train_step",
]


class TrainConfig(NamedTuple):
    """Schedule, AdamW and (optionally) gradient-compression settings."""

    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    grad_compression: FDCompressConfig | None = None


class TrainState(NamedTuple):
    """Parameters and AdamW state in the reference's layout; the per-shard
    error-feedback residuals (compressed path only)."""

    params: dict
    opt: AdamWState
    residuals: dict | None = None


def _mesh(m, axis: str) -> dict[str, int]:
    """Data-parallel axis sizes in mesh order: ``m`` shards on one axis, or a
    dict of named axes."""
    mesh = {axis: m} if isinstance(m, int) else dict(m)
    if not mesh or min(mesh.values()) < 1:
        raise ValueError(f"need one or more shards on every axis, got {mesh}")
    return mesh


def init_train_state(lm, tcfg: TrainConfig, m: int | dict[str, int] = 1) -> TrainState:
    """The model's weights (copies, stacked into the reference's layout), zero
    AdamW moments and, with gradient compression, zero residuals for each of
    the ``m`` shards (an int, or a dict of mesh axis sizes)."""
    params = reference_params(lm.cfg, lm.state_dict())
    res = None
    if tcfg.grad_compression:
        res = init_residuals(params, tuple(_mesh(m, tcfg.grad_compression.axis).values()))
    return TrainState(params=params, opt=adamw_init(params), residuals=res)


def _lr(tcfg: TrainConfig, count: torch.Tensor) -> torch.Tensor:
    # count is the pre-increment step; +1 so the very first update is not lr=0
    return warmup_cosine(count + 1, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps)


def _update(tcfg: TrainConfig, grads, state: TrainState):
    return adamw_update(grads, state.opt, state.params, lr=_lr(tcfg, state.opt.count),
                        b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
                        grad_clip=tcfg.grad_clip)


def _tokens(lm, batch: dict) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=lm.device).long()


def _loss_and_grads(lm, params, tokens: torch.Tensor):
    """The loss of ``tokens`` and its gradients with respect to ``params``'
    leaves, in a tree of ``params``' structure."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = lm.loss({"tokens": tokens}, params=live)
    grads = torch.autograd.grad(loss, leaves(live))
    return loss.detach(), unflatten(params, grads)


def make_train_step(lm, tcfg: TrainConfig):
    """The plain step: the global batch's loss and gradients, one AdamW update.
    ``step(state, {"tokens": (B, T)}) -> (new state, {"loss", "step"})``."""

    def train_step(state: TrainState, batch: dict):
        loss, grads = _loss_and_grads(lm, state.params, _tokens(lm, batch))
        new_params, new_opt = _update(tcfg, grads, state)
        return TrainState(new_params, new_opt, state.residuals), {"loss": loss,
                                                                  "step": new_opt.count}

    return train_step


def aggregate_shards(grads, residuals, ccfg: FDCompressConfig, mesh: dict[str, int],
                     compress_axis: str | None = None):
    """The compressed step's gradient exchange: ``grads`` and ``residuals``
    carry the mesh's shard axes (``mesh``: sizes in mesh order) in front of
    every leaf.  Without ``compress_axis`` every shard is a site of one
    ``compress_and_aggregate``.  With it, the gradients are averaged densely
    over the other axes first, and then each shard of those axes compresses
    the pooled gradients across ``compress_axis`` with its own residuals, as
    each of the reference's devices does.  -> (ghat, the new residuals with
    the shard axes in front, ``CompressionStats``); in the hierarchical mode
    ghat is the first pooled shard's, as the reference's step returns
    device 0's."""
    shape = tuple(mesh.values())
    n = math.prod(shape)
    if compress_axis is None:
        flat = lambda t: t.reshape((n,) + tuple(t.shape[len(shape):]))  # noqa: E731
        ghat, new_res, stats = compress_and_aggregate(tree_map(flat, grads),
                                                      tree_map(flat, residuals), ccfg)
        return ghat, tree_map(lambda r: r.reshape(shape + tuple(r.shape[1:])), new_res), stats
    c = list(mesh).index(compress_axis)
    other = shape[:c] + shape[c + 1:]

    def by_shard(t: torch.Tensor) -> torch.Tensor:
        """(*shape, ...) -> (shape[c], the other shards, ...)."""
        return t.movedim(c, 0).reshape((shape[c], n // shape[c]) + tuple(t.shape[len(shape):]))

    pooled = tree_map(lambda g: by_shard(g).mean(1), grads)
    res = tree_map(by_shard, residuals)
    outs = [compress_and_aggregate(pooled, tree_map(lambda r, j=j: r[:, j], res), ccfg)
            for j in range(n // shape[c])]
    new_res = tree_map(lambda *rs: torch.stack(rs, 1).reshape(
        (shape[c],) + other + tuple(rs[0].shape[1:])).movedim(0, c), *[o[1] for o in outs])
    return outs[0][0], new_res, outs[0][2]


def make_compressed_train_step(lm, tcfg: TrainConfig, m: int | dict[str, int],
                               compress_axis: str | None = None):
    """Data-parallel step with FD gradient compression and error feedback.

    ``m``: the shards (the reference's data-parallel devices), an int or a
    dict of mesh axis sizes in mesh order; the batch's rows are cut into
    that many micro-batches in mesh order.  ``compress_axis``: hierarchical
    mode, as the reference's: gradients are averaged densely over the
    *other* axes (the fast link) and FD-compressed only across
    ``compress_axis`` (the slow one: the paper's own topology, pods as
    sites); see ``aggregate_shards``.  ``step(state, batch) -> (new state,
    metrics)``, the metrics holding the shards' mean loss, the step and the
    byte counts.
    """
    ccfg = tcfg.grad_compression or FDCompressConfig()
    mesh = _mesh(m, ccfg.axis)
    shape = tuple(mesh.values())
    n = math.prod(shape)
    if compress_axis is not None and compress_axis not in mesh:
        raise ValueError(f"compress_axis {compress_axis!r} is not one of the mesh axes {list(mesh)}")

    def train_step(state: TrainState, batch: dict):
        tokens = _tokens(lm, batch)
        if tokens.shape[0] % n:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not split over {n} shards")
        losses, shard_grads = [], []
        for micro in tokens.reshape(n, tokens.shape[0] // n, tokens.shape[1]):
            loss, grads = _loss_and_grads(lm, state.params, micro)
            losses.append(loss)
            shard_grads.append(leaves(grads))
        loss = torch.stack(losses).mean()
        grads = unflatten(state.params, [torch.stack(gs).reshape(shape + tuple(gs[0].shape))
                                         for gs in zip(*shard_grads)])
        del shard_grads
        ghat, new_res, stats = aggregate_shards(grads, state.residuals, ccfg, mesh, compress_axis)
        del grads
        new_params, new_opt = _update(tcfg, ghat, state)
        metrics = {
            "loss": loss,
            "step": new_opt.count,
            "comm_full_bytes": stats.full_bytes,
            "comm_compressed_bytes": stats.compressed_bytes,
        }
        return TrainState(new_params, new_opt, new_res), metrics

    return train_step
