"""Shared neural layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

The functions take their weights as tensors in the reference's layouts
(``(d_in, d_out)`` projections, ``(vocab, d)`` tables), so a parameter of
``repro.models.layers`` carries over as it is.  The ``*_init`` functions draw
from an explicit ``torch.Generator``: the same scales as the reference, other
numbers (``jax.random`` cannot be reproduced; ``models/weights.py`` loads the
reference's own draws).
"""
from __future__ import annotations

import torch

__all__ = [
    "dtype_of",
    "embed_apply",
    "embed_init",
    "linear_init",
    "mlp_apply",
    "mlp_init",
    "norm_init",
    "rms_norm",
    "rope",
    "unembed_apply",
]


def dtype_of(cfg) -> torch.dtype:
    """The config's parameter and activation dtype."""
    return getattr(torch, cfg.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 with the ``(1 + scale)`` parameterisation, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def norm_init(d: int, device=None) -> torch.Tensor:
    """A norm's scale: zeros, i.e. the identity under ``(1 + scale)``."""
    return torch.zeros(d, dtype=torch.float32, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on split halves.  x: (..., T, heads, head_dim); positions: (..., T)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., T, half)
    cos = torch.cos(angles)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, dtype, scale: float | None = None,
                device=None) -> torch.Tensor:
    """A ``(d_in, d_out)`` projection, normal with std ``d_in ** -0.5`` unless given."""
    if scale is None:
        scale = d_in**-0.5
    w = torch.randn(d_in, d_out, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def mlp_init(gen: torch.Generator, cfg, device=None) -> dict[str, torch.Tensor]:
    """SwiGLU weights ``w_gate``, ``w_up`` (d, ff) and ``w_down`` (ff, d)."""
    d, ff, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)
    return {
        "w_gate": linear_init(gen, d, ff, dt, device=device),
        "w_up": linear_init(gen, d, ff, dt, device=device),
        "w_down": linear_init(gen, ff, d, dt, scale=ff**-0.5, device=device),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``w_down(silu(x w_gate) * (x w_up))``."""
    gate = torch.nn.functional.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]


def embed_init(gen: torch.Generator, cfg, device=None) -> dict[str, torch.Tensor]:
    """The ``(padded_vocab, d)`` token table (and an untied unembedding), std 0.02."""
    dt, shape = dtype_of(cfg), (cfg.padded_vocab, cfg.d_model)
    p = {"table": (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)
    return p


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings: (B, T) -> (B, T, d)."""
    return params["table"][tokens]


def unembed_apply(params, x: torch.Tensor, softcap: float = 0.0,
                  true_vocab: int = 0) -> torch.Tensor:
    """f32 logits over the padded vocabulary; rows past ``true_vocab`` are -1e30."""
    table = params["unembed"] if "unembed" in params else params["table"]
    logits = (x @ table.T).float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    if true_vocab and true_vocab < table.shape[0]:
        logits[..., true_vocab:] = -1e30
    return logits
