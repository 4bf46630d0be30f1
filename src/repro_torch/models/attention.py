"""GQA attention: plain PyTorch and flash-kernel paths, KV caches with ring-buffer SWA.

Modes (driven by ``cache`` and sequence length), as in ``repro.models.attention``:
  * train:   full sequence, no cache.
  * prefill: full sequence, fills the cache.
  * decode:  T == 1 against a cache.  Local (windowed) layers keep a
    *ring-buffer* cache of only ``window`` slots, so their KV memory is
    O(window), not O(context).  Global layers keep the full ``max_len`` cache.

Caches are dicts ``{"k": (B, KVH, S, Dh), "v": ..., "index": int}`` where S is
the window (ring) or ``max_len`` (global).  Unlike the reference, whose
arrays are immutable, prefill and decode write the new keys and values into
the cache's tensors in place (a decode step would otherwise copy every
layer's whole cache) and return the same tensors under a new index.

Prefill runs ``cfg.attn_impl``: ``xla`` (one masked softmax over the whole
(T, T) logits) and ``xla_chunked`` (a loop over query blocks; windowed
layers see only a ``window + block`` slice of keys) are plain PyTorch, as the
reference's XLA paths; ``pallas`` runs the hand-written CUDA flash kernel
``kernels.ops.flash_attention`` (its plain version on the CPU).  Decode is
plain PyTorch on every path, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import dtype_of, linear_init, norm_init, rms_norm, rope

__all__ = ["NEG_INF", "attn_apply", "attn_init", "init_cache"]

NEG_INF = -1e30
ATTN_IMPLS = ("xla", "xla_chunked", "pallas")


def attn_init(gen: torch.Generator, cfg, device=None) -> dict[str, torch.Tensor]:
    """Projections ``wq`` (d, H hd), ``wk``, ``wv`` (d, KVH hd), ``wo`` (H hd, d), and the
    qk-norm scales when the config has them."""
    d, hd, dt = cfg.d_model, cfg.resolved_head_dim, dtype_of(cfg)
    p = {
        "wq": linear_init(gen, d, cfg.n_heads * hd, dt, device=device),
        "wk": linear_init(gen, d, cfg.n_kv_heads * hd, dt, device=device),
        "wv": linear_init(gen, d, cfg.n_kv_heads * hd, dt, device=device),
        "wo": linear_init(gen, cfg.n_heads * hd, d, dt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, device)
        p["k_norm"] = norm_init(hd, device)
    return p


def init_cache(cfg, batch: int, max_len: int, window: int, device=None) -> dict:
    """Cache for one attention layer.  Ring-buffer sized for local layers."""
    hd = cfg.resolved_head_dim
    s = min(max_len, window) if window > 0 else max_len
    shape = (batch, cfg.n_kv_heads, s, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
        "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
        "index": 0,
    }


def _qkv(cfg, params, x, positions):
    b, t, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, t, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _softcap(cfg, logits):
    if cfg.logit_softcap > 0.0:
        return cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _self_attention_xla(cfg, q, k, v, window: int):
    """Causal attention; q: (B, T, H, Dh), k/v: (B, KVH, S, Dh), f32 softmax."""
    b, t, h, hd = q.shape
    kvh = k.shape[1]
    qh = q.reshape(b, t, kvh, h // kvh, hd)
    logits = _softcap(cfg, torch.einsum("btkgd,bksd->bkgts", qh, k).float() * hd**-0.5)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bksd->btkgd", probs, v).reshape(b, t, h, hd)


def _self_attention_chunked(cfg, q, k, v, window: int):
    """Attention one query block at a time: peak memory is one (B, H, BQ,
    KV-span) logits block instead of (T, T).  For windowed layers the span
    per block is a fixed-length slice of ``window + BQ`` keys, a real saving
    of work, not only masking."""
    b, t, h, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    bq = min(cfg.attn_block_q, t)
    while t % bq:
        bq -= 1
    span = min(s, window + bq) if window > 0 else s
    qb = q.reshape(b, t // bq, bq, kvh, h // kvh, hd).permute(1, 0, 3, 4, 2, 5)
    outs = []
    for qi, qblk in enumerate(qb):  # qblk: (B, KVH, G, BQ, Dh)
        qs = qi * bq
        start = min(max(qs + bq - span, 0), s - span) if window > 0 and span < s else 0
        kblk, vblk = k[:, :, start:start + span], v[:, :, start:start + span]
        kpos = start + torch.arange(kblk.shape[2], device=q.device)
        logits = _softcap(cfg, torch.einsum("bkgqd,bksd->bkgqs", qblk, kblk).float() * hd**-0.5)
        qpos = qs + torch.arange(bq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgqs,bksd->bkgqd", probs, vblk))
    # (nq, B, KVH, G, BQ, Dh) -> (B, T, H, Dh)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, t, h, hd)


def _self_attention_pallas(cfg, q, k, v, window: int):
    out = ops.flash_attention(q.transpose(1, 2), k, v, window=window,
                              logit_softcap=cfg.logit_softcap)
    return out.transpose(1, 2)


def _decode_attention(cfg, q, cache, window: int):
    """One-token attention against a (possibly ring-buffer) cache.

    q: (B, 1, H, Dh); ``cache["index"]`` is the new token's position, whose
    keys are already in the cache.  Returns (B, 1, H, Dh).
    """
    b, _, h, hd = q.shape
    k, v, index = cache["k"], cache["v"], cache["index"]
    kvh, s = k.shape[1], k.shape[2]
    qh = q.reshape(b, kvh, h // kvh, hd)
    logits = _softcap(cfg, torch.einsum("bkgd,bksd->bkgs", qh, k).float() * hd**-0.5)
    slots = torch.arange(s, device=q.device)
    if window > 0 and s == window:
        # Ring buffer: slot r holds absolute position
        #   index - ((write_pos - r) mod window), write_pos = index mod window.
        abs_pos = index - ((index % window - slots) % window)
        valid = (abs_pos >= 0) & (abs_pos <= index) & (abs_pos > index - window)
    else:
        valid = slots <= index
        if window > 0:
            valid &= slots > index - window
    probs = torch.softmax(logits.masked_fill(~valid, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bkgs,bksd->bkgd", probs, v).reshape(b, 1, h, hd)


def attn_apply(cfg, params, x: torch.Tensor, *, window: int, positions: torch.Tensor,
               cache: dict | None = None) -> tuple[torch.Tensor, dict | None]:
    """x: (B, T, D) -> (y (B, T, D), the updated cache or None).  See the module docstring."""
    b, t, _ = x.shape
    q, k, v = _qkv(cfg, params, x, positions)
    if cache is not None and t == 1:  # decode
        index = cache["index"]
        slot = index % cache["k"].shape[2]  # ring for local, linear for global (index < S)
        cache["k"][:, :, slot] = k[:, 0]
        cache["v"][:, :, slot] = v[:, 0]
        out = _decode_attention(cfg, q, cache, window)
        new_cache = {"k": cache["k"], "v": cache["v"], "index": index + 1}
    else:  # train / prefill
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (B, KVH, T, Dh)
        if cfg.attn_impl == "pallas":
            out = _self_attention_pallas(cfg, q, kt, vt, window)
        elif cfg.attn_impl == "xla_chunked":
            out = _self_attention_chunked(cfg, q, kt, vt, window)
        elif cfg.attn_impl == "xla":
            out = _self_attention_xla(cfg, q, kt, vt, window)
        else:
            raise ValueError(f"attn_impl {cfg.attn_impl!r} is not one of {ATTN_IMPLS}")
        new_cache = None
        if cache is not None:
            s = cache["k"].shape[2]
            if s >= t:
                cache["k"][:, :, :t] = kt
                cache["v"][:, :, :t] = vt
            else:  # ring cache smaller than the prompt: keep the tail, ring-aligned
                # Position p must land in slot p % s so decode's ring indexing
                # stays consistent: roll the tail by (t - s) % s.
                cache["k"].copy_(torch.roll(kt[:, :, t - s:], (t - s) % s, dims=2))
                cache["v"].copy_(torch.roll(vt[:, :, t - s:], (t - s) % s, dims=2))
            new_cache = {"k": cache["k"], "v": cache["v"], "index": t}
    y = out.reshape(b, t, -1) @ params["wo"]
    return y, new_cache
