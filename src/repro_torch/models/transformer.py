"""Model assembly: attention blocks, prefill and decode.

``LM`` is an ``nn.Module`` over the ``global`` and ``local`` layer kinds:
    x += attn(norm(x));  x += mlp(norm(x))
The reference folds the layer pattern into scan groups whose parameters carry
a leading repeat axis; the port runs its blocks one by one from an
``nn.ModuleList`` in pattern order (``models/weights.py`` unstacks the
reference's groups).  The reference's ``sharding.constrain_residual`` is the
identity on one device and has no counterpart here.

The module's parameters are held with ``requires_grad=False``: serving
runs without autograd.  Training (``repro_torch.train``) passes ``params``,
the reference's layout of the weights (``models/weights.py``), to
``hidden`` and ``loss``, whose per-layer views the blocks use; gradients
flow back to those leaves.  With ``cfg.remat == "block"`` each
block is recomputed in backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` does.  MoE feed-forward layers, the
``rglru`` and ``ssd`` kinds and frontend embeddings (``vision_embeds``) are
other model families and raise ``NotImplementedError`` (ROADMAP item 12b).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import unstack_groups
from repro_torch.models.layers import (
    embed_apply,
    embed_init,
    mlp_apply,
    mlp_init,
    norm_init,
    rms_norm,
    unembed_apply,
)

__all__ = ["ATTN_KINDS", "Block", "LM", "block_apply"]

ATTN_KINDS = ("global", "local")
_LATER = "is not ported yet (ROADMAP item 12b, the other model families)"


def _frozen(params: dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in params.items()})


def block_apply(cfg: ModelConfig, params, window: int, x, positions, cache):
    """One attention block with weights ``params`` (``norm1``, ``attn``,
    ``norm2``, ``ffn``): ``x += attn(norm1(x)); x += mlp(norm2(x))``.
    (x, cache) -> (x after the block, the updated cache or None)."""
    h, new_cache = attention.attn_apply(cfg, params["attn"],
                                        rms_norm(x, params["norm1"], cfg.norm_eps),
                                        window=window, positions=positions, cache=cache)
    x = x + h
    return x + mlp_apply(params["ffn"], rms_norm(x, params["norm2"], cfg.norm_eps)), new_cache


def _chunk_loss(x, table, targets, true_vocab: int):
    """Summed cross-entropy of one chunk of positions: hidden states x (B, C,
    D), the unembedding table (V, D), targets (B, C) with -1 for none."""
    logits = unembed_apply({"table": table}, x, true_vocab=true_vocab)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - tgt) * (targets >= 0).float()).sum()


class Block(nn.Module):
    """One attention block: ``x += attn(norm1(x)); x += mlp(norm2(x))``."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator, device=None):
        super().__init__()
        self.window = cfg.window if kind == "local" else 0
        self.norm1 = nn.Parameter(norm_init(cfg.d_model, device), requires_grad=False)
        self.attn = _frozen(attention.attn_init(gen, cfg, device))
        self.norm2 = nn.Parameter(norm_init(cfg.d_model, device), requires_grad=False)
        self.ffn = _frozen(mlp_init(gen, cfg, device))

    def weights(self) -> dict:
        """The block's own parameters, as ``block_apply`` takes them."""
        return {"norm1": self.norm1, "attn": self.attn, "norm2": self.norm2, "ffn": self.ffn}

    def forward(self, cfg: ModelConfig, x, positions, cache, params=None):
        """(x, cache) -> (x after the block, the updated cache or None), with
        ``params`` (``block_apply``'s) in place of the block's own if given."""
        weights = self.weights() if params is None else params
        if cfg.remat == "block" and cache is None and torch.is_grad_enabled():
            return checkpoint(block_apply, cfg, weights, self.window, x, positions, None,
                              use_reentrant=False)
        return block_apply(cfg, weights, self.window, x, positions, cache)


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

    def _weights(self, params: dict | None):
        """(embed, per-layer block weights, final norm): the module's own, or
        views of ``params`` in the reference's layout."""
        if params is None:
            return self.embed, [blk.weights() for blk in self.blocks], self.final_norm
        return params["embed"], unstack_groups(self.cfg, params), params["final_norm"]

    def hidden(self, tokens: torch.Tensor, *, vision_embeds=None, cache: list | None = None,
               index: int | None = None, params: dict | None = None):
        """Final-norm hidden states (B, T, D) and the updated caches.

        * train/prefill: ``index=None``, positions ``0 .. T-1``; ``cache=None``
          (train) or ``init_cache``'s output (prefill).
        * decode: T == 1 and ``index`` the current position.

        ``params``: weights in the reference's layout in place of the module's.
        """
        if vision_embeds is not None:
            raise NotImplementedError(f"frontend embeddings {_LATER}")
        embed, blocks, final_norm = self._weights(params)
        b, t = tokens.shape
        x = embed_apply(embed, tokens)
        if index is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        else:
            positions = torch.full((b, t), index, device=x.device)
        new_caches = []
        for i, (blk, weights) in enumerate(zip(self.blocks, blocks)):
            x, nc = blk(self.cfg, x, positions, cache[i] if cache is not None else None, weights)
            new_caches.append(nc)
        x = rms_norm(x, final_norm, self.cfg.norm_eps)
        return x, (new_caches if cache is not None else None)

    def forward(self, tokens: torch.Tensor, *, vision_embeds=None, cache: list | None = None,
                index: int | None = None):
        """Full f32 logits (B, T, padded_vocab) and the updated caches."""
        x, new_cache = self.hidden(tokens, vision_embeds=vision_embeds, cache=cache, index=index)
        return self.logits_at(x), new_cache

    def logits_at(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of hidden states ``x`` (..., D), padded vocabulary masked."""
        return unembed_apply(self.embed, x, true_vocab=self.cfg.vocab_size)

    def loss(self, batch: dict, *, params: dict | None = None,
             loss_chunk: int = 1024) -> torch.Tensor:
        """Next-token cross-entropy (f32 scalar) of ``batch["tokens"]`` (B, T).

        The unembedding runs ``loss_chunk`` positions at a time: the (B,
        chunk, V) f32 logits are the only vocabulary-sized activation, and
        each chunk's are recomputed in backward (``torch.utils.checkpoint``),
        as the reference's ``jax.checkpoint`` around its chunk body does.
        The last position has no target; the sum is over B (T - 1) targets.
        """
        tokens = batch["tokens"]
        x, _ = self.hidden(tokens, vision_embeds=batch.get("vision_embeds"), params=params)
        targets = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
        b, t, _ = x.shape
        chunk = min(loss_chunk, t)
        embed = self.embed if params is None else params["embed"]
        table = embed["unembed"] if "unembed" in embed else embed["table"]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = torch.is_grad_enabled()
        for start in range(0, t, chunk):
            args = (x[:, start:start + chunk], table, targets[:, start:start + chunk],
                    self.cfg.vocab_size)
            total = total + (checkpoint(_chunk_loss, *args, use_reentrant=False) if remat
                             else _chunk_loss(*args))
        return total / (b * (tokens.shape[1] - 1))

    def decode_step(self, cache: list, tokens: torch.Tensor, index: int):
        """One serving step: tokens (B, 1) at position ``index`` -> (logits (B, 1, V), caches)."""
        return self.forward(tokens, cache=cache, index=index)

    def prefill(self, tokens: torch.Tensor, max_len: int, vision_embeds=None):
        """Last-position logits (B, V) and the filled caches; the full-prompt
        logits are never formed."""
        cache = self.init_cache(tokens.shape[0], max_len)
        x, cache = self.hidden(tokens, cache=cache, vision_embeds=vision_embeds)
        return self.logits_at(x[:, -1]), cache
