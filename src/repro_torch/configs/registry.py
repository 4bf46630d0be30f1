"""Architecture registry: ``--arch <id>`` resolution + input shapes.

The four assigned input-shape cells:
    train_4k     seq_len=4096   global_batch=256   (train_step)
    prefill_32k  seq_len=32768  global_batch=32    (prefill_step)
    decode_32k   seq_len=32768  global_batch=128   (serve_step, 1 new token)
    long_500k    seq_len=524288 global_batch=1     (serve_step; sub-quadratic
                                                    archs only — see DESIGN.md)
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma3-1b": "gemma3_1b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "qwen3-0.6b": "qwen3_0_6b",
    "smollm-135m": "smollm_135m",
    "internvl2-2b": "internvl2_2b",
    "mamba2-370m": "mamba2_370m",
    "musicgen-medium": "musicgen_medium",
}

ARCH_NAMES = tuple(_MODULES)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

SHAPE_NAMES = tuple(SHAPES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {', '.join(ARCH_NAMES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) a live dry-run cell?  (paper-mandated skips only)"""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §5)"
    return True, ""


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same-family shrink for CPU smoke tests (deliverable f)."""
    changes: dict = {
        "n_layers": min(cfg.n_layers, 2 * len(cfg.layer_pattern)),
        "d_model": 64 if cfg.resolved_head_dim <= 64 else 128,
        "d_ff": 128 if cfg.d_ff else 0,
        "vocab_size": 256,
        "head_dim": min(cfg.resolved_head_dim, 32),
        "n_heads": min(cfg.n_heads, 4) if cfg.n_heads > 1 else 1,
        "window": min(cfg.window, 16) if cfg.window else 0,
        "rnn_width": 64 if cfg.rnn_width else 0,
        "dtype": "float32",
        "remat": "none",
        "n_frontend_tokens": 8 if cfg.n_frontend_tokens else 0,
    }
    if cfg.is_moe:
        changes["n_experts"] = 4
        changes["experts_per_token"] = 2
    if cfg.family == "ssm":
        changes["ssm_state"] = 16
        changes["ssm_head_dim"] = 16
        changes["n_heads"] = 1
    # keep kv divisibility: n_kv_heads <= n_heads and divides it
    nh = changes["n_heads"]
    kv = min(cfg.n_kv_heads, nh)
    while nh % kv:
        kv -= 1
    changes["n_kv_heads"] = kv
    return dataclasses.replace(cfg, **changes)
