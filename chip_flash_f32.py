#!/usr/bin/env python3
"""Time the f32 flash-attention kernel of a checkout on one GPU.

    python3 chip_flash_f32.py [--tree DIR] [--shapes path,windowed,prefill4096]
                              [--chunks 1,2,4] [--prefill] [--seed 0] [--out report.json]

Imports ``repro_torch`` from ``DIR/src`` (by default this script's own
checkout), so that two checkouts can be timed in turns on one card by
running it once for each.  For each shape it calls
``ops.flash_attention`` on random f32 inputs from ``--seed`` and prints the
kernel's device time (``chip_smoke.time_ms``: CUDA events around 20 calls
queued behind a device sleep, after 3 warm-ups), the bound, the largest
difference from the plain version and, where the mask is plain causal,
SDPA's time in f32 (TF32 off) and the kernels it ran.  Shapes:

* ``path``: the f32 serving check's prefill and last full forward (b = 1,
  hq = 16, hkv = 8, s = 512 and 520, dh = 128, causal);
* ``windowed``: b = 1, hq = 8, hkv = 2, s = 1000, dh = 64, window 256,
  soft-cap 30;
* ``prefill4096``: Qwen3-0.6B's 4,096-token prefill in f32 (b = 4, hq = 16,
  hkv = 8, dh = 128, causal).

``--chunks`` also times ``ops.flash_attention_f32`` with each fixed split
(key tiles a piece at most; checkouts that have it).  ``--prefill`` times
one Qwen3-0.6B prefill of 512 tokens in f32 under ``torch.profiler``
(``chip_smoke.device_profile``): wall time, device busy time and the flash
kernels' share of it.  It prints the card's name and power limit, and one
JSON object last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHAPES = {
    "path": [(1, 16, 8, 512, 128, 0, 0.0), (1, 16, 8, 520, 128, 0, 0.0)],
    "windowed": [(1, 8, 2, 1000, 64, 256, 30.0)],
    "prefill4096": [(4, 16, 8, 4096, 128, 0, 0.0)],
}


def sdpa_kernels(torch, fn) -> list[str]:
    """The device kernels one call of ``fn`` runs, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(HERE), help="checkout whose repro_torch is timed")
    ap.add_argument("--shapes", default="path,windowed", help=f"of {', '.join(SHAPES)}")
    ap.add_argument("--chunks", default="", help="fixed splits to time as well, e.g. 1,2,4")
    ap.add_argument("--prefill", action="store_true", help="profile one f32 prefill")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="write the report here as JSON")
    args = ap.parse_args()

    tree = Path(args.tree).resolve()
    if not (tree / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_flash_f32: no repro_torch under {tree}/src", file=sys.stderr)
        return 1
    sys.path[:0] = [str(tree / "src"), str(HERE)]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("chip_flash_f32: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    chunks = [int(c) for c in args.chunks.split(",") if c]
    rows = []
    for name in args.shapes.split(","):
        for b, hq, hkv, s, dh, window, cap in SHAPES[name]:
            q, k, v = (torch.randn(b, h, s, dh, device="cuda", generator=gen)
                       for h in (hq, hkv, hkv))
            kw = dict(window=window, logit_softcap=cap)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.ref_attention(q, k, v, **kw)
            err = float((got - want).abs().max()) / float(want.abs().max())
            del got, want
            flops = 4.0 * b * hq * dh * cs.attention_pairs(s, window)
            bound, by = cs.bound_ms(flops, 4.0 * (2 * b * hq * s * dh + 2 * b * hkv * s * dh))
            row = dict(shape=name, b=b, hq=hq, hkv=hkv, s=s, dh=dh, window=window, softcap=cap,
                       ms=cs.time_ms(torch, lambda: ops.flash_attention(q, k, v, **kw)),
                       bound_ms=bound, bound_by=by, rel_err=err)
            if hasattr(ops, "flash_chunk"):
                row["chunk"] = ops.flash_chunk(b * hq, s, dh, window, q.device)
                row["chunk_ms"] = {
                    c: cs.time_ms(torch, lambda c=c: ops.flash_attention_f32(
                        q, k, v, window, dh**-0.5, cap, c)) for c in chunks}
            if window == 0 and cap == 0.0:
                call = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
                row["sdpa_ms"] = cs.time_ms(torch, call)
                row["sdpa_kernels"] = sdpa_kernels(torch, call)
                # cuBLAS gemms and a softmax are its math backend; a fused
                # attention kernel (fmha, flash) one of the others.
                fused = [k for k in row["sdpa_kernels"] if "fmha" in k or "flash" in k]
                row["sdpa_backend"] = "fused: " + fused[0][:80] if fused else "math"
            rows.append(row)
            del q, k, v
            torch.cuda.empty_cache()
    report = dict(tree=str(tree), card=card, torch=torch.__version__, shapes=rows)
    if args.prefill:
        from repro_torch.models import LM

        lm = LM(cs.serving_config(attn_impl="pallas", dtype="float32"), device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(args.seed))
        toks = torch.randint(0, lm.cfg.vocab_size, (1, cs.CHECK_PROMPT), device="cuda",
                             generator=gen)
        with torch.no_grad():
            lm.prefill(toks, cs.CHECK_PROMPT)  # warm-up
            prof = cs.device_profile(torch, lambda: lm.prefill(toks, cs.CHECK_PROMPT))
        flash = {k: v for k, v in prof["device_ms"].items() if "flash_attention" in k}
        report["prefill"] = dict(
            tokens=cs.CHECK_PROMPT, wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
            flash_ms=sum(flash.values()), flash_share=sum(flash.values()) / prof["device_busy_ms"],
            flash_kernels={k: [v, prof["device_count"][k]] for k, v in flash.items()},
            top_device_ms=prof["top_device_ms"])
    for r in rows:
        extra = "".join(f" chunk {c}: {t * 1e3:.2f} us;" for c, t in r.get("chunk_ms", {}).items())
        sd = f"; SDPA {r['sdpa_ms'] * 1e3:.2f} us ({r['sdpa_backend']})" if "sdpa_ms" in r else ""
        print(f"{r['shape']} b={r['b']} hq={r['hq']} hkv={r['hkv']} s={r['s']} dh={r['dh']} "
              f"window={r['window']} cap={r['softcap']}: {r['ms'] * 1e3:.2f} us (split "
              f"{r.get('chunk', '-')}), bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}), "
              f"rel err {r['rel_err']:.2e};{extra}{sd}")
    if args.prefill:
        p = report["prefill"]
        print(f"f32 prefill of {p['tokens']} tokens: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, flash {p['flash_ms']:.3f} ms "
              f"({p['flash_share']:.1%}): {json.dumps(p['flash_kernels'])}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({k: v for k, v in report.items() if k != "shapes"}
                     | {"shapes": [{k: v for k, v in r.items() if k != "sdpa_kernels"}
                                   for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
