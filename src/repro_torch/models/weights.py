"""The reference's parameters as the port's state dict.

``repro.models.transformer.LM.init`` returns a pytree
``{"embed": {...}, "groups": [{"pos{i}": block}, ...], "final_norm": ...}``
in which each scan group of ``(kinds, repeats)`` stacks its blocks' leaves
over a leading repeat axis (absent when ``repeats == 1``).  Layer
``rep * len(kinds) + i`` of a group is ``pos{i}``'s slice ``rep``.  The
port's ``LM`` keeps one block per layer, in pattern order, with the same
leaf names and layouts, so the conversion only unstacks and renames.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig, group_pattern

__all__ = ["params_from_reference"]


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


def params_from_reference(cfg: ModelConfig, tree: dict) -> dict[str, torch.Tensor]:
    """State dict for ``LM(cfg).load_state_dict`` from the reference's ``LM(cfg).init``
    pytree (leaves as numpy arrays or anything ``np.asarray`` reads)."""
    if cfg.scan_unroll:
        groups = [((kind,), 1) for kind in cfg.pattern()]
    else:
        groups = group_pattern(cfg.pattern())
    if len(groups) != len(tree["groups"]):
        raise ValueError(f"{cfg.name} has {len(groups)} layer groups, the tree {len(tree['groups'])}")
    state = {f"embed.{name}": _tensor(a) for name, a in _leaves(tree["embed"])}
    state["final_norm"] = _tensor(tree["final_norm"])
    layer = 0
    for (kinds, repeats), gparams in zip(groups, tree["groups"]):
        for rep in range(repeats):
            for i in range(len(kinds)):
                for name, a in _leaves(gparams[f"pos{i}"]):
                    state[f"blocks.{layer}.{name}"] = _tensor(a[rep] if repeats > 1 else a)
                layer += 1
    return state
