"""Batched serving from the command line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \\
        --batch 4 --prompt-len 24 --gen 16 --device cpu

Random-inits weights from ``--seed``, prefills a batch of random prompts,
decodes with the KV cache (ring buffers for SWA layers), and reports tok/s
and greedy consistency against the teacher-forced forward, as
``repro.launch.serve`` does.  It runs on the CUDA card unless ``--device``
names another device, and runs the config as given (its ``attn_impl``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_NAMES, get_config, reduced_config
from repro_torch.models.transformer import LM
from repro_torch.serve import ServeConfig, ServeEngine, greedy_consistency


def main(argv: list[str] | None = None, clock: Callable[[], float] = time.time) -> None:
    """Parse ``argv`` (the command line if None), serve one batch, print the report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None, help="restore weights from a training run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        # The reference restores a training run's state; its template comes
        # with the training stack.
        raise NotImplementedError("--ckpt-dir restores a training run's state, which waits "
                                  "for the training stack (ROADMAP item 12)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(args.seed))
    engine = ServeEngine(
        lm, ServeConfig(max_len=args.max_len, temperature=args.temperature, seed=args.seed)
    )
    rng = np.random.default_rng(args.seed)
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
                           device=device)
    t0 = clock()
    out = engine.generate(prompts, args.gen)
    dt = clock() - t0
    print(
        f"[serve] {cfg.name}: {args.batch}x{args.gen} tokens in {dt:.2f}s "
        f"({args.batch * args.gen / dt:.1f} tok/s batched)"
    )
    if args.temperature == 0.0:
        match = greedy_consistency(lm, out, args.prompt_len)
        print(f"[serve] greedy consistency vs teacher-forced forward: {match:.1%}")
    for row in out[:4, args.prompt_len:].tolist():
        print("  ", row)


if __name__ == "__main__":
    main()
