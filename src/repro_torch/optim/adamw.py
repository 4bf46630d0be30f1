"""AdamW over a pytree of parameters (functional, as the reference's).

The update walks the leaves of the trees it is given, in the reference's
order.  Training keeps the parameters in the reference's layout
(``models/weights.py``): each scan group's blocks stacked over a repeat
axis.  The decoupled weight decay applies to leaves of two or more axes,
so a stacked group's norm scales, (repeats, d), are decayed, as in the
reference, and a lone block's (d,) are not.  ``adamw_state_shardings``
(ZeRO-1 over a mesh) waits for the port's meshes (ROADMAP item 13c).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "adamw_init", "adamw_update"]


class AdamWState(NamedTuple):
    """First and second moments (f32 trees shaped as the parameters) and the
    int32 step count."""

    mu: dict
    nu: dict
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    """Zero moments and count, on the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = leaves(params)[0].device
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns ``(new_params, new_state)``.  Global-norm clip, decoupled weight
    decay; the parameters keep their dtype, the moments are f32."""
    gf = [g.float() for g in leaves(grads)]
    if grad_clip > 0:
        gnorm = torch.sqrt(sum((g * g).sum() for g in gf) + 1e-12)
        scale = torch.clamp(grad_clip / gnorm, max=1.0)
        gf = [g * scale for g in gf]
    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    mu = [b1 * m + (1 - b1) * g for m, g in zip(leaves(state.mu), gf)]
    nu = [b2 * v + (1 - b2) * g * g for v, g in zip(leaves(state.nu), gf)]

    def step(p, m, v):
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay > 0 and p.ndim >= 2:  # no decay on norms and biases of one layer
            update = update + weight_decay * p.float()
        return (p.float() - lr * update).to(p.dtype)

    new_params = [step(p, m, v) for p, m, v in zip(leaves(params), mu, nu)]
    return unflatten(params, new_params), AdamWState(
        mu=unflatten(params, mu), nu=unflatten(params, nu), count=count)
