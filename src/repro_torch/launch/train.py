"""Production training entry point: restartable, checkpointed, compressible.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --reduced \\
        --steps 20 --global-batch 8 --seq-len 64 --device cpu --ckpt-dir /tmp/run1

As ``repro.launch.train``: random-init weights from ``--seed``, batches from
the deterministic ``TokenStream``, the plain step or, with
``--compress-grads``, the FD-compressed data-parallel step over ``--shards``
shards (the reference's device count).  It runs on the CUDA card unless
``--device`` names another device, and runs the config as given (its
``attn_impl`` and ``remat``; ``--reduced`` turns remat off, as the
reference does).

Fault tolerance in this entry point:
  * deterministic data: batch(step) is a pure function — restart-safe;
  * AsyncCheckpointer every --ckpt-every steps + atomic dirs + hash checks;
  * --restore resumes from the latest checkpoint;
  * per-step retry-once on transient failure, then checkpoint-and-abort.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.registry import ARCH_NAMES, get_config, reduced_config
from repro_torch.data import Prefetcher, TokenStream
from repro_torch.models.transformer import LM
from repro_torch.optim import FDCompressConfig
from repro_torch.train.step import (
    TrainConfig,
    init_train_state,
    make_compressed_train_step,
    make_train_step,
)


def main(argv: list[str] | None = None, clock: Callable[[], float] = time.time) -> None:
    """Parse ``argv`` (the command line if None) and train."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--compress-grads", action="store_true", help="FD gradient compression (pure-DP)")
    ap.add_argument("--shards", type=int, default=1,
                    help="data-parallel shards of the compressed step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    cfg = dataclasses.replace(cfg, remat="none") if args.reduced else cfg
    lm = LM(cfg, device=device, generator=torch.Generator(device).manual_seed(args.seed))
    tcfg = TrainConfig(
        peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 2),
        total_steps=args.steps,
        grad_compression=FDCompressConfig() if args.compress_grads else None,
    )

    state = init_train_state(lm, tcfg, args.shards)
    start = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.restore and args.ckpt_dir and (last := latest_step(args.ckpt_dir)) is not None:
        state, _ = restore(args.ckpt_dir, last, state, device=device)
        start = last
        print(f"[train] restored step {last}")

    if args.compress_grads:
        step = make_compressed_train_step(lm, tcfg, args.shards)
    else:
        step = make_train_step(lm, tcfg)

    ds = TokenStream(
        global_batch=args.global_batch, seq_len=args.seq_len, vocab=cfg.vocab_size, seed=args.seed
    )
    pf = Prefetcher(ds, start_step=start)
    try:
        t_last = clock()
        for i in range(start, args.steps):
            got_step, batch = pf.next()
            if got_step != i:
                raise RuntimeError(f"the prefetcher gave step {got_step}, wanted {i}")
            tbatch = {"tokens": torch.as_tensor(batch["tokens"], device=device)}
            for attempt in (0, 1):  # retry-once on transient failure
                try:
                    state, metrics = step(state, tbatch)
                    break
                except Exception:
                    if attempt == 1:
                        if ckpt:
                            ckpt.save(i, state)
                            ckpt.wait()
                        raise
            if (i + 1) % 10 == 0 or i == start:
                dt = clock() - t_last
                t_last = clock()
                extra = ""
                if "comm_compressed_bytes" in metrics:
                    ratio = float(metrics["comm_full_bytes"]) / max(
                        float(metrics["comm_compressed_bytes"]), 1.0
                    )
                    extra = f" comm_saving={ratio:.1f}x"
                print(
                    f"[train] step {i+1}/{args.steps} loss={float(metrics['loss']):.4f}"
                    f" ({dt:.2f}s/10steps){extra}",
                    flush=True,
                )
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save(i + 1, state)
        if ckpt:
            ckpt.save(args.steps, state)
            ckpt.wait()
    finally:
        pf.close()
    print("[train] done")


if __name__ == "__main__":
    main()
