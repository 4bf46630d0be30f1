"""The reference's parameter layout, and the port's per-layer one.

``repro.models.transformer.LM.init`` returns a pytree
``{"embed": {...}, "groups": [{"pos{i}": block}, ...], "final_norm": ...}``
in which each scan group of ``(kinds, repeats)`` stacks its blocks' leaves
over a leading repeat axis (absent when ``repeats == 1``).  Layer
``rep * len(kinds) + i`` of a group is ``pos{i}``'s slice ``rep``.  The
port's ``LM`` keeps one block per layer, in pattern order, with the same
leaf names and layouts, so the conversion only unstacks and renames.

Training keeps the reference's layout (``train/step.py``): the optimiser's
weight decay and the gradient compression decide on the stacked leaves (a
stack of 1-D norm scales is a matrix there), so ``unstack_groups`` gives the
forward per-layer views of them, through which gradients flow back to the
stacked leaves, and ``reference_params`` stacks a model's weights into them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig, group_pattern
from repro_torch.tree import tree_map

__all__ = [
    "params_from_reference",
    "reference_params",
    "train_state_from_reference",
    "unstack_groups",
]


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _nest(flat: dict) -> dict:
    """``{"attn.wq": a}`` -> ``{"attn": {"wq": a}}``."""
    tree: dict = {}
    for name, value in flat.items():
        *inner, last = name.split(".")
        node = tree
        for key in inner:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def _groups(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    if cfg.scan_unroll:
        return [((kind,), 1) for kind in cfg.pattern()]
    return group_pattern(cfg.pattern())


def _unbind(tree, n: int) -> list:
    """``n`` trees of the slices of ``tree``'s leaves along their first axis:
    one ``unbind`` a leaf, whose backward stacks the slices' gradients once."""
    if isinstance(tree, dict):
        parts = {key: _unbind(value, n) for key, value in tree.items()}
        return [{key: part[r] for key, part in parts.items()} for r in range(n)]
    return list(tree.unbind(0))


def unstack_groups(cfg: ModelConfig, tree: dict) -> list[dict]:
    """Each layer's block parameters, in pattern order, from the reference's
    layout: views of the stacked leaves, no copies."""
    groups = _groups(cfg)
    if len(groups) != len(tree["groups"]):
        raise ValueError(f"{cfg.name} has {len(groups)} layer groups, the tree {len(tree['groups'])}")
    blocks = []
    for (kinds, repeats), gparams in zip(groups, tree["groups"]):
        pos = [gparams[f"pos{i}"] for i in range(len(kinds))]
        if repeats > 1:
            per_pos = [_unbind(p, repeats) for p in pos]
            blocks.extend(per_pos[i][rep] for rep in range(repeats) for i in range(len(kinds)))
        else:
            blocks.extend(pos)
    return blocks


def params_from_reference(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """State dict for ``LM(cfg).load_state_dict`` from the reference's ``LM(cfg).init``
    pytree (leaves as numpy arrays, tensors, or anything ``np.asarray`` reads)."""
    tree = tree_map(lambda a: a if isinstance(a, torch.Tensor) else _tensor(a), tree)
    state = {f"embed.{name}": a for name, a in _leaves(tree["embed"])}
    state["final_norm"] = tree["final_norm"]
    for layer, block in enumerate(unstack_groups(cfg, tree)):
        for name, a in _leaves(block):
            state[f"blocks.{layer}.{name}"] = a
    return state


def reference_params(cfg: ModelConfig, state: dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_reference``: the reference's pytree from the
    port's state dict (``LM.state_dict()``), each group's blocks stacked over
    its repeat axis; every leaf a copy."""
    flat = {name: t.detach() for name, t in state.items()}
    tree = {"embed": _nest({n[len("embed."):]: t.clone() for n, t in flat.items()
                            if n.startswith("embed.")}),
            "groups": [], "final_norm": flat["final_norm"].clone()}
    first = 0
    for kinds, repeats in _groups(cfg):
        group = {}
        for i in range(len(kinds)):
            layers = [first + rep * len(kinds) + i for rep in range(repeats)]
            prefix = f"blocks.{layers[0]}."
            names = [n[len(prefix):] for n in flat if n.startswith(prefix)]
            group[f"pos{i}"] = _nest({
                n: torch.stack([flat[f"blocks.{j}.{n}"] for j in layers]) if repeats > 1
                else flat[prefix + n].clone() for n in names})
        tree["groups"].append(group)
        first += repeats * len(kinds)
    return tree


def train_state_from_reference(state, *, residuals: list | None = None, device=None):
    """The port's ``TrainState`` from the reference's ``repro.train.TrainState``
    (leaves as numpy arrays or anything ``np.asarray`` reads).

    Params, ``mu`` and ``nu`` carry over leaf for leaf: the port trains in the
    reference's layout (bf16 leaves keep their bits).  ``count`` likewise.
    The reference keeps one residual buffer per device (its compressed step
    returns them unreplicated), which ``np.asarray`` of a leaf does not show:
    pass each device's residual tree, in mesh order, as ``residuals``.
    Without it, ``state.residuals`` is taken as one shard's.
    """
    from repro_torch import resolve_device
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    device = resolve_device(device)

    def load(tree):
        return tree_map(lambda a: _tensor(a).to(device), tree)

    if residuals is None and state.residuals is not None:
        residuals = [state.residuals]
    res = None
    if residuals is not None:
        res = tree_map(lambda *shards: torch.stack([_tensor(a) for a in shards]).to(device),
                       *residuals)
    opt = state.opt
    return TrainState(
        params=load(state.params),
        opt=AdamWState(mu=load(opt.mu), nu=load(opt.nu),
                       count=_tensor(np.asarray(opt.count, np.int32)).to(device)),
        residuals=res,
    )
