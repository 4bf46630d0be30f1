"""Model configuration and layer-pattern utilities.

A model is a stack of *blocks*; each block is described by a layer kind:

    "global" — full causal attention + MLP/MoE
    "local"  — sliding-window attention + MLP/MoE
    "rglru"  — RG-LRU recurrent mixer + MLP (RecurrentGemma/Griffin)
    "ssd"    — Mamba-2 SSD mixer (self-contained block, no MLP)

``layer_pattern`` cycles over ``n_layers``; ``group_pattern`` folds maximal
repeats into the groups the reference stacks and scans.  The port runs the
layers one by one (``models/transformer.py``) and uses the grouping only to
read the reference's parameters (``models/weights.py``).

A copy of ``repro.models.config`` (the port imports nothing of ``repro``),
so a reference config carries over one to one.  ``attn_impl`` keeps the
reference's values: ``xla`` and ``xla_chunked`` are the plain PyTorch
attention of ``models/attention.py``, ``pallas`` is the hand-written CUDA
kernel (``kernels.ops.flash_attention``; its plain version on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, layer pattern, attention and numerics."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    rope_theta: float = 10000.0
    qk_norm: bool = False
    logit_softcap: float = 0.0
    window: int = 0  # sliding window for "local" layers (0 = full)
    layer_pattern: tuple[str, ...] = ("global",)  # cycled over n_layers
    attn_impl: str = "xla_chunked"  # xla | xla_chunked | pallas (the CUDA flash kernel)
    attn_block_q: int = 512  # q-block for chunked/pallas attention
    # moe
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # EP when n_experts < the model-axis width: split each expert's ff into
    # `moe_virtual_split` independent virtual experts (SwiGLU is elementwise
    # over ff; the down-proj halves simply add in the combine).  Same params,
    # no giant TP activation all-reduce.
    moe_virtual_split: int = 1
    # rg-lru
    rnn_width: int = 0  # 0 -> d_model
    conv_width: int = 4
    # ssd (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # frontends (stubs: inputs arrive as precomputed embeddings)
    frontend: str = "none"  # none | patch (vlm) | frames (audio)
    n_frontend_tokens: int = 0  # patch/frame positions prepended
    # misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    subquadratic: bool = False  # eligible for long_500k
    remat: str = "block"  # none | block — activation checkpointing policy
    vocab_pad_multiple: int = 128  # pad embedding rows for clean TP sharding
    scan_unroll: bool = False  # unroll layer scans (cost-accounting lowers)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows: the vocabulary rounded up to ``vocab_pad_multiple``."""
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m if m else self.vocab_size

    @property
    def resolved_head_dim(self) -> int:
        """``head_dim``, or ``d_model // n_heads`` when it is 0."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_rnn_width(self) -> int:
        """``rnn_width``, or ``d_model`` when it is 0."""
        return self.rnn_width or self.d_model

    @property
    def is_moe(self) -> bool:
        """Whether the feed-forward layers are mixtures of experts."""
        return self.n_experts > 0

    def pattern(self) -> tuple[str, ...]:
        """The layer kind of each of the ``n_layers`` layers."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for kind in self.pattern():
            if kind in ("global", "local"):
                total += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
                total += 2 * d  # norms
                if self.qk_norm:
                    total += 2 * hd
                if self.is_moe:
                    total += d * self.n_experts  # router
                    total += self.n_experts * 3 * d * self.d_ff
                else:
                    total += 3 * d * self.d_ff
            elif kind == "rglru":
                w = self.resolved_rnn_width
                total += 2 * d * w + w * d  # in (x2 branches) + out proj
                total += self.conv_width * w  # temporal conv
                total += 2 * w + w  # gates a, input scale Lambda
                total += 2 * d
                total += 3 * d * self.d_ff  # MLP half of the block
            elif kind == "ssd":
                di = self.ssm_expand * self.d_model
                nh = di // self.ssm_head_dim
                g = 1
                proj_in = d * (2 * di + 2 * g * self.ssm_state + nh)
                total += proj_in + di * d
                total += self.conv_width * (di + 2 * g * self.ssm_state)
                total += 2 * nh + d  # A, D, norm
            else:
                raise ValueError(f"unknown layer kind {kind}")
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return dense + self.n_layers * self.experts_per_token * 3 * d * self.d_ff


def group_pattern(pattern: tuple[str, ...]) -> list[tuple[tuple[str, ...], int]]:
    """Fold a layer pattern into [(block, repeats)] scan groups.

    Finds the smallest period p such that a prefix of the pattern is p
    repeated >= 2 times, emits that as one group, recurses on the rest.
    A 94-layer uniform stack becomes [((kind,), 94)]; gemma3's 26-layer
    (L L L L L G) x 4 + (L L) becomes [((L,L,L,L,L,G), 4), ((L,L), 1)].
    """
    pattern = tuple(pattern)
    if not pattern:
        return []
    n = len(pattern)
    best: tuple[int, int] | None = None  # (period, repeats)
    for p in range(1, n // 2 + 1):
        k = 1
        while (k + 1) * p <= n and pattern[k * p : (k + 1) * p] == pattern[:p]:
            k += 1
        if k >= 2:
            best = (p, k)
            break  # smallest period wins
    if best is None:
        return [(pattern, 1)]
    p, k = best
    return [(pattern[:p], k)] + group_pattern(pattern[k * p :])
