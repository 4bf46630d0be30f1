"""Model assembly: attention blocks, prefill and decode.

``LM`` is an ``nn.Module`` over the ``global`` and ``local`` layer kinds:
    x += attn(norm(x));  x += mlp(norm(x))
The reference folds the layer pattern into scan groups whose parameters carry
a leading repeat axis; the port runs its blocks one by one from an
``nn.ModuleList`` in pattern order (``models/weights.py`` unstacks the
reference's groups).  The reference's ``sharding.constrain_residual`` is the
identity on one device and has no counterpart here.

The parameters are held with ``requires_grad=False``: this is the serving
path.  MoE feed-forward layers, the ``rglru`` and ``ssd`` kinds, frontend
embeddings (``vision_embeds``) and ``loss`` belong to the training stack
and raise ``NotImplementedError`` (ROADMAP item 12).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    mlp_apply,
    mlp_init,
    norm_init,
    rms_norm,
    unembed_apply,
)

__all__ = ["ATTN_KINDS", "Block", "LM"]

ATTN_KINDS = ("global", "local")
_LATER = "is not ported yet (ROADMAP item 12, the training stack)"


def _frozen(params: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})


class Block(nn.Module):
    """One attention block: ``x += attn(norm1(x)); x += mlp(norm2(x))``."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator, device=None):
        super().__init__()
        self.window = cfg.window if kind == "local" else 0
        self.norm1 = nn.Parameter(norm_init(cfg.d_model, device), requires_grad=False)
        self.attn = _frozen(attention.attn_init(gen, cfg, device))
        self.norm2 = nn.Parameter(norm_init(cfg.d_model, device), requires_grad=False)
        self.ffn = _frozen(mlp_init(gen, cfg, device))

    def forward(self, cfg: ModelConfig, x, positions, cache):
        """(x, cache) -> (x after the block, the updated cache or None)."""
        h, new_cache = attention.attn_apply(cfg, self.attn, rms_norm(x, self.norm1, cfg.norm_eps),
                                            window=self.window, positions=positions, cache=cache)
        x = x + h
        return x + mlp_apply(self.ffn, rms_norm(x, self.norm2, cfg.norm_eps)), new_cache


class LM(nn.Module):
    """Decoder LM over the configured layer pattern, on one device.

    Weights are drawn from ``generator`` (a ``torch.Generator`` on ``device``;
    seed 0 if none is given) at the reference's scales; load the reference's
    own weights with ``load_state_dict(models.weights.params_from_reference(
    cfg, tree))``.  ``device=None`` means the CUDA card.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError(f"MoE feed-forward ({cfg.name}) {_LATER}")
        other = sorted(set(cfg.pattern()) - set(ATTN_KINDS))
        if other:
            raise NotImplementedError(f"layer kinds {other} ({cfg.name}) {_LATER}")
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device).manual_seed(0)
        self.cfg = cfg
        self.embed = _frozen(embed_init(gen, cfg, device))
        self.blocks = nn.ModuleList(Block(cfg, kind, gen, device) for kind in cfg.pattern())
        self.final_norm = nn.Parameter(norm_init(cfg.d_model, device), requires_grad=False)

    @property
    def device(self) -> torch.device:
        """The device the weights live on."""
        return self.final_norm.device

    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """One empty KV cache per layer (ring buffers for local layers)."""
        return [attention.init_cache(self.cfg, batch, max_len, blk.window, self.device)
                for blk in self.blocks]

    def hidden(self, tokens: torch.Tensor, *, vision_embeds=None, cache: list | None = None,
               index: int | None = None):
        """Final-norm hidden states (B, T, D) and the updated caches.

        * train/prefill: ``index=None``, positions ``0 .. T-1``; ``cache=None``
          (train) or ``init_cache``'s output (prefill).
        * decode: T == 1 and ``index`` the current position.
        """
        if vision_embeds is not None:
            raise NotImplementedError(f"frontend embeddings {_LATER}")
        b, t = tokens.shape
        x = embed_apply(self.embed, tokens)
        if index is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        else:
            positions = torch.full((b, t), index, device=x.device)
        new_caches = []
        for i, blk in enumerate(self.blocks):
            x, nc = blk(self.cfg, x, positions, cache[i] if cache is not None else None)
            new_caches.append(nc)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return x, (new_caches if cache is not None else None)

    def forward(self, tokens: torch.Tensor, *, vision_embeds=None, cache: list | None = None,
                index: int | None = None):
        """Full f32 logits (B, T, padded_vocab) and the updated caches."""
        x, new_cache = self.hidden(tokens, vision_embeds=vision_embeds, cache=cache, index=index)
        return self.logits_at(x), new_cache

    def logits_at(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of hidden states ``x`` (..., D), padded vocabulary masked."""
        return unembed_apply(self.embed, x, true_vocab=self.cfg.vocab_size)

    def loss(self, *args, **kwargs):
        """Next-token loss: part of the training stack."""
        raise NotImplementedError(f"LM.loss {_LATER}")

    def decode_step(self, cache: list, tokens: torch.Tensor, index: int):
        """One serving step: tokens (B, 1) at position ``index`` -> (logits (B, 1, V), caches)."""
        return self.forward(tokens, cache=cache, index=index)

    def prefill(self, tokens: torch.Tensor, max_len: int, vision_embeds=None):
        """Last-position logits (B, V) and the filled caches; the full-prompt
        logits are never formed."""
        cache = self.init_cache(tokens.shape[0], max_len)
        x, cache = self.hidden(tokens, cache=cache, vision_embeds=vision_embeds)
        return self.logits_at(x[:, -1]), cache
