#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py [--seed 0] [--steps 64] [--lev-steps 16] [--serve-prompt 4096]
                          [--out report.json]

From the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

1. builds the hand-written kernels' six sources from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per source,
   all at once), prints each kernel's ptxas registers, spills and static
   shared memory, and counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instructions in the SASS of ``flash_attention_wgmma.cu``: both must
   be there.  In the SASS of the five f32 sources it counts ``FFMA``,
   shared loads (``LDS``, ``LDS.128``), ``cp.async`` copies (``LDGSTS``)
   and tensor-core instructions (``HMMA``, ``HGMMA``): the f32 kernels are
   IEEE f32 FMAs on the CUDA cores, so any of the last two fails the run;
2. calls each kernel's wrapper at the shapes the main path gives it and
   holds the result against its plain PyTorch version on the same inputs
   (max |kernel - plain| <= KERNEL_RTOL * max |plain|) and against a second
   run of itself (bit for bit), timing the kernel, the plain version and
   one PyTorch library call; ``quadform`` also on a ragged shape on offset
   views (T = 3, L = 37, N = 45, d = 131: its 4-byte staging path), on
   L = 1 and on L = 600 (15 tiles of L, more than one cluster holds);
   ``fd_gram`` and ``fd_project`` also on the same ragged shape on offset
   views, on L = 1, on L = 600 and on d < 32 (d = 20, and d = 7 off 16
   bytes), with G required to be exactly symmetric;
3. drives protocol P2 through ``DistributedMatrixTracker`` — m = 8 sites,
   d = 1024 (the ``d_model`` of Qwen3-0.6B), eps = 0.02, 64 super-steps of
   8 x 512 rows made on the card from ``--seed`` as a low-rank stream plus
   noise — publishing 8 snapshots into a ``SketchStore``, then
   ``refresh_spectra`` over them, one ``query_batch`` of 1024 directions on
   the kernel path and one ``query_packed`` of 8 tenants x 1024 directions;
4. holds the sketch to the reference's error checks against dense truth
   (``A^T A`` accumulated on the card in f64): ``||A^T A - B^T B||_2 <
   2 eps ||A||_F^2`` and ``||B x||^2 <= (1 + 1e-3) ||A x||^2`` on 256 unit
   directions, and requires every kernel to have been launched by the main
   path;
5. times the served queries over repeated calls (median and spread), and
   profiles one ``query_batch`` and one ``query_packed`` with
   ``torch.profiler``: the ``quadform`` kernel's device time against the
   call's host time;
6. drives ``StreamingPipeline(m=8, eps=0.02)`` on the card with one matrix
   tenant (super-step P2) and one leverage tenant (super-step leverage P1,
   d = 1024): both ingest the first 16 super-steps of the same stream and
   publish; then 1024 subspace and 1024 score queries to the leverage
   tenant and 1024 directions to the matrix tenant are submitted and
   served by one ``flush``.  Subspace answers must lie within
   ``err_factor * eps * ||A||_F^2`` of dense truth (err_factor 1.5, the
   registry's), score answers within rtol 1e-3, atol 1e-5 of the f64
   oracle ``table_scores`` on the published table (tests/test_leverage.py),
   and the flush must have launched ``levscore`` and ``quadform``;
7. holds ``levscore`` against its plain version at the path's shape (the
   served ridge factor, N = 1024, d = 1024), a ragged one (N = 300,
   d = 1000), one score query, a ragged shape on offset views (N = 37,
   d = 131: its 4-byte staging path), d = 20, d = 7 off 16 bytes, and the
   path's shape with a factor that is not symmetric; times the leverage
   ingest (share of ``eigh``), the host ``pinv``s and the served subspace
   and score rates; and profiles leverage score ``query_batch`` calls with
   ``torch.profiler``: the ``levscore`` kernel's device time against a
   call's host time;
8. holds ``flash_attention`` against its plain version at the serving
   path's shape (b = 4, hq = 16, hkv = 8, s = 4096, dh = 128, bf16, causal:
   each element within one bf16 rounding of itself, ``BF16_ROUNDING``, of
   the plain version in f32 on the same bf16 inputs) and at a ragged,
   windowed, soft-capped one in bf16 (the same check) and in f32
   (``KERNEL_RTOL``), timing SDPA beside the serving shape;
9. serves Qwen3-0.6B (``configs/qwen3_0_6b.py``, all 28 layers, random bf16
   weights from ``--seed``, ``attn_impl="pallas"``) through
   ``ServeEngine.generate``: 4 random prompts of 4096 tokens, 32 new tokens
   each, a 4224-slot KV cache.  The prefill must launch ``flash_attention``
   once per layer and nothing else; it reports prefill and decode tokens/s,
   greedy consistency against the teacher-forced forward (as
   ``launch/serve.py`` does) and, from ``torch.profiler`` over one more
   prefill, the device-busy share and the kernel's share of device time;
10. checks serving in f32 (the same model, batch 1, a 512-token prompt, 8
   decode steps): each step's logits within 2e-3 of the full forward at that
   position (``tests/test_serve.py``'s bound), and the kernel's prefill
   within 2e-3 of the plain ``xla`` prefill.

Launch counts are set to 0 just before each path (the P2 path, the
pipeline, the serving run) and read just after; comparisons of a kernel with its plain
version are made outside those windows.  It prints the card's name and
power limit, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": {...}}``.  Any failed check exits non-zero; so does a machine
without CUDA, or a directory without the package.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data sheet, dense rates: f32 on the CUDA cores (TF32 is off), bf16
# on the tensor cores, and HBM3 bandwidth.  bound_ms = max(bytes / BYTES_PER_S,
# flops / the peak rate of the inputs' type).
FLOPS_F32 = 67e12
FLOPS_BF16 = 989e12
BYTES_PER_S = 3.35e12

# Clock cycles a second for torch.cuda._sleep: above the H100's 1.98 GHz
# boost clock, so a sleep lasts at least as long as asked.
SLEEP_CYCLES_PER_S = 2.0e9

# Kernel vs plain version on the same inputs: both accumulate in IEEE f32
# over up to 1024 terms in different orders, so they differ by rounding only.
KERNEL_RTOL = 1e-5

# bf16 kernel output against the plain version in f32 on the same bf16
# inputs: each element within one rounding to bf16 of itself (at most 2^-8 of
# its magnitude), plus the f32 slack KERNEL_RTOL * max |plain|.
BF16_ROUNDING = 2.0**-8

# Served logits in f32: decode against the full forward, the kernel's prefill
# against the plain one (tests/test_serve.py's bound).
LOGIT_ATOL = 2e-3

# The leverage tenant's answers against the f64 oracle: the reference's own
# tolerances (tests/test_leverage.py) and its registry err_factor.
SCORE_RTOL, SCORE_ATOL, LEV_ERR_FACTOR = 1e-3, 1e-5, 1.5

DEV = "cuda"
M, D, EPS, ROWS_PER_SITE = 8, 1024, 0.02, 512
N_DIRS, N_CHECK_DIRS, RANK = 1024, 256, 32
PALLAS = {
    "fd_gram": ("src/repro/kernels/fd_gram.py:52", "src/repro/kernels/fd_shrink_fused.py:60"),
    "fd_project": ("src/repro/kernels/fd_project.py:49", "src/repro/kernels/fd_shrink_fused.py:99"),
    "quadform": ("src/repro/kernels/quadform.py:127", "src/repro/kernels/quadform.py:92"),
    "levscore": ("src/repro/kernels/levscore.py:71",),
    "flash_attention": ("src/repro/kernels/flash_attention.py:166",),
}
P2_KERNELS = ("fd_gram", "fd_project", "quadform")
# Opcodes counted in the SASS of the f32 sources; the last two (tensor-core
# products: mma.sync and wmma, and wgmma) must not be there.
SASS_F32 = ("FFMA", "LDS", "LDS.128", "LDGSTS", "HMMA", "HGMMA")
PIPELINE_KERNELS = ("fd_gram", "fd_project", "quadform", "levscore")
SERVE_ARCH, SERVE_BATCH, SERVE_GEN, SERVE_MAX_LEN = "qwen3-0.6b", 4, 32, 4224
CHECK_PROMPT, CHECK_STEPS = 512, 8


def fail(msg: str) -> None:
    """Report a failed phase on stderr and exit non-zero."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    """Fail with ``msg`` unless ``cond`` holds."""
    if not cond:
        fail(msg)


def bound_ms(flops: float, nbytes: float, rate: float = FLOPS_F32) -> tuple[float, str]:
    """Least time the card could take at ``rate`` FLOP/s, and which of the two
    rates bounds it."""
    t_ops, t_bytes = flops / rate, nbytes / BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around ``reps`` calls after warm-up.

    The calls are queued behind a device-side sleep that outlasts their host
    time, so the events time the device's work back to back, not the host's
    launch overhead (which exceeds the work of a short kernel)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * reps * host_s, 1.0) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_name(mangled: str) -> str:
    """``flash_attention_kernel_wgmma<128>`` (or ``quadform_kernel<1, 4>``:
    its integer and bool template arguments) from its mangled name."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if m:
            n, start = int(m.group()), i + len(m.group())
            name = mangled[start:start + n]
            if "kernel" in name:
                args = re.findall(r"IL[bi](\d+)E", mangled[start + n:])
                return f"{name}<{', '.join(args)}>" if args else name
            i = start + n
        else:
            i += 1
    return mangled


def ptxas_summary(reports: dict) -> list[dict]:
    """Registers, spills and static shared memory of every kernel in the
    ptxas reports of ``_build.build`` (dynamic shared memory is set at launch)."""
    rows = []
    for source, text in sorted(reports.items()):
        name, spills = "?", (0, 0)
        for line in text.splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                name = kernel_name(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                rows.append(dict(source=source, kernel=name, registers=int(m.group(1)),
                                 spill_stores=spills[0], spill_loads=spills[1],
                                 static_smem=int(smem.group(1)) if smem else 0))
    return rows


def sass_counts(library: Path, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """How many instructions of each of ``opcodes`` (by default wgmma,
    ``HGMMA``, and TMA loads, ``UTMALDG``) the SASS of a built library holds,
    by ``cuobjdump --dump-sass``.  ``LDS`` counts every width of shared
    load, ``LDS.128`` the 16-byte ones."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or str(Path(CUDA_HOME or "/usr/local/cuda") / "bin"
                                            / "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True,
                         timeout=120)
    check(out.returncode == 0, f"cuobjdump failed on {library}: {out.stderr}")
    lines = out.stdout.splitlines()
    return {op: sum(1 for line in lines if re.search(rf"\b{re.escape(op)}\b", line))
            for op in opcodes}


def make_stream(torch, seed: int, steps: int):
    """``steps`` super-steps of (M * ROWS_PER_SITE, D) rows on the card and
    the dense truth ``A^T A`` in f64: a rank-RANK signal with decaying
    scales plus isotropic noise, like hidden-state rows of a model."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    basis = torch.linalg.qr(torch.randn(D, RANK, device=DEV, generator=gen))[0].T
    scales = 4.0 / torch.arange(1, RANK + 1, device=DEV, dtype=torch.float32).sqrt()
    batches, ata = [], torch.zeros(D, D, dtype=torch.float64, device=DEV)
    for _ in range(steps):
        coef = torch.randn(M * ROWS_PER_SITE, RANK, device=DEV, generator=gen) * scales
        rows = coef @ basis + 0.1 * torch.randn(M * ROWS_PER_SITE, D, device=DEV, generator=gen)
        batches.append(rows)
        r64 = rows.double()
        ata.addmm_(r64.T, r64)
    return batches, ata


def unit_dirs(torch, gen, n: int):
    """``n`` random unit directions of length D on the card."""
    x = torch.randn(n, D, device=DEV, generator=gen)
    return (x / x.norm(dim=1, keepdim=True)).contiguous()


def kernel_cases(torch, batches, l_site: int, l_coord: int):
    """Each kernel's wrapper, plain version and library call at the shapes
    the main path gives it, on inputs cut from the stream."""
    from repro_torch.kernels import fd_ops, ops, ref

    gen = torch.Generator(device=DEV).manual_seed(1)
    rows = batches[0].reshape(M, ROWS_PER_SITE, D)
    site_buf = rows[:, : 2 * l_site].contiguous()  # (8, 400, 1024): site shrink
    coord_buf = batches[0][: 2 * l_coord][None].contiguous()  # (1, 400, 1024): coordinator shrink
    sketches = rows[:, :l_coord].contiguous()  # (8, 200, 1024): published sketches
    x_one = unit_dirs(torch, gen, N_DIRS)
    x_pack = torch.stack([unit_dirs(torch, gen, N_DIRS) for _ in range(M)])

    def project_inputs(b, path):
        """U from the shrink's eigh; w the shrink's on the path, random elsewhere
        (at L = 1 the shrink weighs every row 0)."""
        lam, u = ref.eigh_descending(ref.ref_fd_gram_batched(b))
        w, _ = ref.shrink_weights(lam, b.shape[1] // 2)
        if not path:
            w = 0.5 + torch.rand(w.shape, device=DEV, generator=gen_fd)
        return w.contiguous(), u.contiguous(), b

    cases = []
    # The FD kernels at the path's three shapes, then at their edges: a ragged
    # shape on offset views (b[1:] starts 19,388 bytes in, so both kernels
    # stage with 4-byte copies), one row, L = 600 (36 upper tiles of G, more
    # than one cluster holds), and d < 32 on the TMA path and, off 16 bytes,
    # the 4-byte path.
    gen_fd = torch.Generator(device=DEV).manual_seed(5)
    for label, b in (("site shrink", site_buf), ("coordinator shrink", coord_buf),
                     ("refresh_spectra", sketches),
                     ("ragged, offset views", torch.randn(4, 37, 131, device=DEV,
                                                          generator=gen_fd)[1:]),
                     ("L = 1", coord_buf[:, :1]), ("L = 600", batches[0][:600][None]),
                     ("d = 20", site_buf[:3, :64, :20].contiguous()),
                     ("d = 7, offset views", torch.randn(3, 50, 7, device=DEV,
                                                         generator=gen_fd)[1:])):
        t, l, d = b.shape
        path = label in ("site shrink", "coordinator shrink", "refresh_spectra")
        cases.append(dict(
            kernel="fd_gram", shape=f"{label}: (T={t}, L={l}, d={d})",
            pallas=PALLAS["fd_gram"][0 if t == 1 else 1],
            run=lambda b=b: fd_ops.fd_gram(b),
            plain=lambda b=b: ref.ref_fd_gram_batched(b),
            library=lambda b=b: torch.bmm(b, b.mT),
            symmetric=True,
            # G is symmetric: the function needs l (l + 1) / 2 dot products
            # per sketch.
            flops=2.0 * t * l * (l + 1) / 2 * d, nbytes=4.0 * (t * l * d + t * l * l),
        ))
        w, u, _ = project_inputs(b, path)
        cases.append(dict(
            kernel="fd_project", shape=f"{label}: (T={t}, L={l}, d={d})",
            pallas=PALLAS["fd_project"][0 if t == 1 else 1],
            run=lambda w=w, u=u, b=b: fd_ops.fd_project(w, u, b),
            plain=lambda w=w, u=u, b=b: ref.ref_fd_project_batched(w, u, b),
            library=lambda u=u, b=b: torch.bmm(u.mT, b),  # U^T B; the w rescale is not in it
            flops=2.0 * t * l * l * d + t * l * d,
            nbytes=4.0 * (t * l + t * l * l + 2 * t * l * d),
        ))
    # quadform at the two query paths' shapes, then at its edges: a ragged
    # shape on offset views (b[1:] starts 19,388 bytes in, so the kernel
    # stages with 4-byte copies), one row of B, and L = 600 (15 L tiles of
    # 40 rows, more than one cluster of 8 blocks holds).
    ragged_b = torch.randn(4, 37, 131, device=DEV, generator=gen)[1:]
    ragged_x = torch.randn(4, 45, 131, device=DEV, generator=gen)[1:]
    for label, b, x in (("query_batch", sketches[:1], x_one[None]),
                        ("query_packed", sketches, x_pack),
                        ("ragged, offset views", ragged_b, ragged_x),
                        ("L = 1", sketches[:1, :1], x_one[None]),
                        ("L = 600", batches[0][:600][None], x_one[None])):
        t, l, d = b.shape
        n = x.shape[1]
        single = label == "query_batch"
        cases.append(dict(
            kernel="quadform", shape=f"{label}: (T={t}, L={l}, N={n}, d={d})",
            pallas=PALLAS["quadform"][0 if t == 1 else 1],
            run=(lambda b=b, x=x: ops.quadform(b[0], x[0])) if single
            else (lambda b=b, x=x: ops.quadform_packed(b, x)),
            plain=(lambda b=b, x=x: ref.ref_quadform(b[0], x[0])) if single
            else (lambda b=b, x=x: ref.ref_quadform_packed(b, x)),
            # One sketch: one 2-D product, as a caller with one sketch writes it.
            library=(lambda b=b, x=x: (b[0] @ x[0].T).square().sum(0)) if t == 1
            else (lambda b=b, x=x: (b @ x.mT).square().sum(-2)),
            flops=2.0 * t * l * n * d + 2.0 * t * l * n,
            nbytes=4.0 * (t * l * d + t * n * d + t * n),
        ))
    return cases


def run_kernel_cases(torch, cases) -> list[dict]:
    """Check every case against its plain version, then time all three calls."""
    from repro_torch.kernels import ops

    results = []
    for c in cases:
        # A case may hold the kernel to the plain version in f32 (``want``).
        got, again, want = c["run"](), c["run"](), c.get("want", c["plain"])()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{c['kernel']} {c['shape']}: two runs differ")
        if c.get("symmetric"):
            check(torch.equal(got, got.mT), f"{c['kernel']} {c['shape']}: G is not symmetric")
        got = got.reshape(want.shape).float()
        check(bool(torch.isfinite(got).all()), f"{c['kernel']} {c['shape']}: non-finite output")
        diff = (got - want).abs()
        err, scale = float(diff.max()), float(want.abs().max())
        # |kernel - plain| <= elem_rtol * |plain| + KERNEL_RTOL * max |plain|, per element.
        elem_rtol = c.get("elem_rtol", 0.0)
        ratio = diff / (elem_rtol * want.abs() + KERNEL_RTOL * scale).clamp_min(1e-30)
        worst = int(ratio.argmax())
        err_over_tol = float(ratio.flatten()[worst])
        check(err_over_tol <= 1.0,
              f"{c['kernel']} {c['shape']}: |kernel - plain| = "
              f"{float(diff.flatten()[worst]):.3e} at plain = {float(want.flatten()[worst]):.3e} "
              f"> {elem_rtol:.3e} * |plain| + {KERNEL_RTOL} * {scale:.3e}")
        del diff, ratio
        del got, again, want
        rate = c.get("rate", FLOPS_F32)
        b_ms, b_by = bound_ms(c["flops"], c["nbytes"], rate)
        extra = {}
        if rate != FLOPS_F32:  # also the table's convention: f32 on the CUDA cores
            extra["bound_f32_ms"] = bound_ms(c["flops"], c["nbytes"])[0]
        results.append(dict(
            kernel=c["kernel"], shape=c["shape"], replaces=c["pallas"],
            source=c.get("source", ops.KERNELS[c["kernel"]][0].source),
            max_abs_err=err, max_rel_err=err / max(scale, 1e-30), err_over_tol=err_over_tol,
            ms=time_ms(torch, c["run"]), plain_ms=time_ms(torch, c["plain"]),
            library_ms=time_ms(torch, c["library"]) if c["library"] else None,
            bound_ms=b_ms, bound_by=b_by, gflop=c["flops"] / 1e9, mbytes=c["nbytes"] / 1e6,
            **extra,
        ))
    return results


def drive_main_path(torch, batches, steps: int):
    """P2 ingest and publish through ``DistributedMatrixTracker``, then
    ``refresh_spectra`` and both query paths of the ``QueryEngine``."""
    from repro_torch.core.tracker import DistributedMatrixTracker
    from repro_torch.kernels import ops
    from repro_torch.query import PackedRequest, QueryEngine, SketchStore

    tracker = DistributedMatrixTracker(M, D, eps=EPS, protocol="P2", device=DEV)
    store = SketchStore()
    publish_every = max(1, steps // M)
    phase_launches, timings = {}, {}

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    ingest_s, snaps = 0.0, []
    for s, rows in enumerate(batches):
        t0 = time.perf_counter()
        tracker.update(rows)
        torch.cuda.synchronize()
        ingest_s += time.perf_counter() - t0
        if (s + 1) % publish_every == 0 and len(snaps) < M:
            snaps.append(tracker.publish(store, f"t{len(snaps)}"))
    phase_launches["ingest"] = ops.launch_counts()
    timings["ingest_s"] = ingest_s

    engine = QueryEngine(store, device=DEV)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    warmed = engine.refresh_spectra(snaps)
    torch.cuda.synchronize()
    timings["refresh_s"] = time.perf_counter() - t0
    check(warmed == len(snaps), f"refresh_spectra warmed {warmed} of {len(snaps)}")
    phase_launches["refresh_spectra"] = _delta(ops.launch_counts(), before)

    gen = torch.Generator(device=DEV).manual_seed(2)
    x = unit_dirs(torch, gen, N_DIRS).cpu().numpy()
    before = ops.launch_counts()
    served = engine.query_batch(x, tenant=snaps[-1].tenant, path="kernel")
    phase_launches["query_batch"] = _delta(ops.launch_counts(), before)

    xs = [unit_dirs(torch, gen, N_DIRS).cpu().numpy() for _ in snaps]
    requests = [PackedRequest(s.tenant, xi) for s, xi in zip(snaps, xs)]
    before = ops.launch_counts()
    packed = engine.query_packed(requests)
    phase_launches["query_packed"] = _delta(ops.launch_counts(), before)
    launches = ops.launch_counts()
    return dict(tracker=tracker, store=store, engine=engine, snaps=snaps, x=x, served=served,
                xs=xs, requests=requests, packed=packed, launches=launches,
                phase_launches=phase_launches, timings=timings)


def time_calls(calls: dict, reps: int = 21) -> dict:
    """Served directions per second of each ``{name: (directions, call)}``,
    each over ``reps`` calls on the host clock, host<->device copies
    included: median, fastest and slowest call."""
    out = {}
    for name, (n, fn) in calls.items():
        fn()  # warm-up
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            secs.append(time.perf_counter() - t0)
        secs.sort()
        out[name] = dict(calls=reps, directions=n, qps_median=n / secs[reps // 2],
                         qps_fastest=n / secs[0], qps_slowest=n / secs[-1])
    return out


def time_serving(run) -> dict:
    """``query_batch`` (1024 directions) and ``query_packed`` (8 x 1024)."""
    engine, tenant = run["engine"], run["snaps"][-1].tenant
    return time_calls({
        "query_batch": (N_DIRS, lambda: engine.query_batch(run["x"], tenant=tenant, path="kernel")),
        "query_packed": (len(run["requests"]) * N_DIRS,
                         lambda: engine.query_packed(run["requests"])),
    })


def profile_queries(torch, run) -> dict:
    """``torch.profiler`` over one ``query_batch`` (1024 directions) and one
    ``query_packed`` (8 x 1024), each after one unprofiled call: the call's
    host time against the ``quadform`` kernel's device time and all device
    time, and the torch ops with the most host time."""
    engine, tenant = run["engine"], run["snaps"][-1].tenant
    out = {}
    for name, fn in (
        ("query_batch", lambda: engine.query_batch(run["x"], tenant=tenant, path="kernel")),
        ("query_packed", lambda: engine.query_packed(run["requests"])),
    ):
        fn()
        prof = device_profile(torch, fn)
        prof.pop("device_count")
        kernel_ms = sum(v for k, v in prof.pop("device_ms").items() if "quadform_kernel" in k)
        check(kernel_ms > 0, f"the profiler saw no quadform kernel in {name}")
        prof.update(quadform_ms=kernel_ms, quadform_share_of_call=kernel_ms / prof["wall_ms"])
        out[name] = prof
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def check_main_path(torch, run, ata, steps: int) -> dict:
    """The reference's own checks (tests/test_distributed.py) and the
    served answers' consistency, all against dense f64 truth."""
    from repro_torch.kernels import ref

    tracker, engine, snaps = run["tracker"], run["engine"], run["snaps"]
    frob = float(torch.diagonal(ata).sum())
    b = torch.tensor(tracker.sketch_matrix(), device=DEV, dtype=torch.float64)
    check(bool(torch.isfinite(b).all()) and b.shape == (tracker.cfg.l_coord, D),
          f"sketch is not a finite ({tracker.cfg.l_coord}, {D}) matrix")
    cov_err = float(torch.linalg.eigvalsh(ata - b.T @ b).abs().max()) / frob
    check(cov_err < 2 * EPS, f"||A^T A - B^T B||_2 / ||A||_F^2 = {cov_err} >= 2 eps")

    gen = torch.Generator(device=DEV).manual_seed(3)
    xc = unit_dirs(torch, gen, N_CHECK_DIRS).double()
    ax = ((xc @ ata) * xc).sum(1)
    bx = (xc @ b.T).square().sum(1)
    viol = int((bx > ax * (1 + 1e-3)).sum())
    check(viol == 0, f"{viol} of {N_CHECK_DIRS} directions have ||Bx||^2 > (1+1e-3)||Ax||^2")

    f_hat = tracker.frob_estimate()
    # P2's scalar sends keep every site's unsent mass below (eps/m) f_hat.
    check(f_hat <= frob * (1 + 1e-4) + 1.0 and frob - f_hat <= EPS * f_hat * (1 + 1e-3),
          f"frob estimate {f_hat} vs stream mass {frob}")

    est = run["served"].estimates
    x = torch.tensor(run["x"], device=DEV, dtype=torch.float64)
    truth = ((x @ ata) * x).sum(1).cpu().numpy()
    check(est.shape == (N_DIRS,) and bool(torch.isfinite(torch.tensor(est)).all()),
          "query_batch answers are not finite (1024,)")
    served_gap = float(abs(truth - est).max()) / frob
    check(served_gap <= 2 * EPS, f"served |Ax|^2 - |Bx|^2 gap {served_gap} > 2 eps ||A||_F^2")

    # Cached path (spectra from fd_spectra) against the kernel path: the Gram
    # trick leaves each sigma_i^2 within ~1e-7 sigma_max^2 over l = 200 rows.
    cached = engine.query_batch(run["x"], tenant=snaps[-1].tenant, path="cached").estimates
    s_max2 = float(engine.spectrum(snaps[-1].tenant).s[0]) ** 2
    cache_gap = float(abs(cached - est).max()) / s_max2
    check(cache_gap <= 1e-4, f"cached vs kernel path differ by {cache_gap} sigma_max^2")

    pack_err = 0.0
    for snap, xi, res in zip(snaps, run["xs"], run["packed"]):
        want = ref.ref_quadform(torch.tensor(snap.matrix, device=DEV),
                                torch.tensor(xi, device=DEV)).cpu().numpy()
        check(res.estimates.shape == want.shape, "query_packed answer shape")
        err = float(abs(res.estimates - want).max()) / max(float(abs(want).max()), 1e-30)
        pack_err = max(pack_err, err)
    check(pack_err <= KERNEL_RTOL, f"query_packed vs plain quadform: {pack_err}")

    chunks_site = math.ceil(ROWS_PER_SITE / tracker.cfg.l_site)
    chunks_coord = math.ceil(M * tracker.cfg.l_site / tracker.cfg.l_coord)
    want = {"fd_gram": steps * (chunks_site + chunks_coord) + 1, "fd_project": 0, "quadform": 2,
            "levscore": 0, "flash_attention": 0}
    want["fd_project"] = want["fd_gram"]
    for name in P2_KERNELS:
        check(run["launches"][name] > 0, f"kernel {name} was not launched on the main path")
    check(run["launches"] == want, f"launches {run['launches']} != expected {want}")
    return dict(cov_err=cov_err, one_sided_violations=viol, frob=frob, frob_estimate=f_hat,
                served_gap=served_gap, cached_vs_kernel=cache_gap, packed_vs_plain=pack_err,
                comm=tracker.comm_report().as_dict())


def profile_steps(torch, step, batches) -> dict:
    """Profile ``step(rows)`` over ``batches[1:]`` after one unprofiled step:
    device busy share, the share of host time inside ``eigh`` (by input
    shape), the device time of the two shrink kernels beside it, and device
    time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for rows in batches[1:]:
            step(rows)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()

    def self_dev(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))

    # Device-side events only (kernels, copies): a host op's device time
    # repeats its kernels' time.
    dev = {e.key: self_dev(e) for e in events
           if e.device_type == DeviceType.CUDA and self_dev(e) > 0}
    eigh = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::linalg_eigh"]
    eigh_us = sum(e.cpu_time_total for e in eigh)
    busy_us = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    # The shrink kernels' device time beside eigh's host time.
    shrink_ms = {name: sum(v for k, v in dev.items() if f"{name}_kernel" in k) / 1e3
                 for name in ("fd_gram", "fd_project")}
    return dict(steps=len(batches) - 1, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / wall_us, eigh_host_ms=eigh_us / 1e3,
                eigh_host_share=eigh_us / wall_us, shrink_kernel_device_ms=shrink_ms,
                shrink_kernel_share_of_device_busy={
                    k: v * 1e3 / max(busy_us, 1e-30) for k, v in shrink_ms.items()},
                eigh_calls=sum(e.count for e in eigh),
                eigh_by_shape={str(e.input_shapes): dict(calls=e.count,
                                                         host_share=e.cpu_time_total / wall_us)
                               for e in eigh},
                top_device_ms={k: v / 1e3 for k, v in top})


def profile_ingest(torch, batches, steps: int) -> dict:
    """A short profiled P2 ingest on a fresh tracker."""
    from repro_torch.core.tracker import DistributedMatrixTracker

    tracker = DistributedMatrixTracker(M, D, eps=EPS, protocol="P2", device=DEV)
    return profile_steps(torch, tracker.update, batches[: 1 + steps])


def profile_leverage_ingest(torch, batches, steps: int) -> dict:
    """A short profiled leverage P1 ingest on a fresh super-step protocol."""
    from repro_torch.runtime import create_protocol

    proto = create_protocol("P1", engine="shard", kind="leverage", m=M, d=D, eps=EPS,
                            device=DEV)
    return profile_steps(torch, proto.step, batches[: 1 + steps])


def drive_pipeline(torch, batches) -> dict:
    """The pipeline path: ``StreamingPipeline(m=8, eps=0.02)`` on the card, a
    matrix tenant (P2) and a leverage tenant (super-step leverage P1) both
    ingesting ``batches`` and publishing; then 1024 subspace and 1024 score
    queries to the leverage tenant and 1024 directions to the matrix tenant
    submitted and served by one ``flush``."""
    from repro_torch.core.leverage import score_query, subspace_query
    from repro_torch.kernels import ops
    from repro_torch.runtime import OnDemand, StreamingPipeline

    pipe = StreamingPipeline(M, eps=EPS, policy=OnDemand(), max_batch=4 * N_DIRS,
                             default_deadline_s=3600.0, device=DEV)
    pipe.add_tenant("matrix", D, protocol="P2")
    pipe.add_leverage_tenant("leverage", D, engine="shard")
    tenants = ("matrix", "leverage")
    gen = torch.Generator(device=DEV).manual_seed(4)
    x = {k: unit_dirs(torch, gen, N_DIRS).cpu().numpy() for k in ("subspace", "score", "matrix")}
    ingest_s = dict.fromkeys(tenants, 0.0)
    publish_s, snaps = {}, {}

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    for rows in batches:
        for tenant in tenants:
            t0 = time.perf_counter()
            pipe.ingest(tenant, rows)
            torch.cuda.synchronize()
            ingest_s[tenant] += time.perf_counter() - t0
    for tenant in tenants:
        t0 = time.perf_counter()
        snaps[tenant] = pipe.publish(tenant)
        publish_s[tenant] = time.perf_counter() - t0
    tickets = {"subspace": [], "score": []}
    for a, b in zip(x["subspace"], x["score"]):
        tickets["subspace"].append(pipe.submit("leverage", subspace_query(a)))
        tickets["score"].append(pipe.submit("leverage", score_query(b)))
    tickets["matrix"] = [pipe.submit("matrix", v) for v in x["matrix"]]
    before = ops.launch_counts()
    t0 = time.perf_counter()
    served = pipe.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    flush_launches = _delta(ops.launch_counts(), before)
    launches = ops.launch_counts()
    results = {k: [t.result() for t in v] for k, v in tickets.items()}
    return dict(pipe=pipe, snaps=snaps, x=x, results=results, served=served,
                launches=launches, flush_launches=flush_launches,
                timings=dict(ingest_s=ingest_s, publish_s=publish_s, flush_s=flush_s))


def check_pipeline(torch, prun, batches) -> dict:
    """The leverage tenant's answers against dense truth and the f64 oracle,
    the matrix tenant's against dense truth, and the path's launches."""
    import numpy as np

    from repro_torch.core.leverage import table_scores
    from repro_torch.kernels import ops

    pipe, snaps, x, res = prun["pipe"], prun["snaps"], prun["x"], prun["results"]
    check(prun["served"] == 3 * N_DIRS, f"flush served {prun['served']} of {3 * N_DIRS}")
    ata = torch.zeros(D, D, dtype=torch.float64, device=DEV)
    for rows in batches:
        r64 = rows.double()
        ata.addmm_(r64.T, r64)
    frob = float(torch.diagonal(ata).sum())

    def truth(v):
        v = torch.tensor(v, device=DEV, dtype=torch.float64)
        return ((v @ ata) * v).sum(1).cpu().numpy()

    for kind, tenant in (("subspace", "leverage"), ("score", "leverage"), ("matrix", "matrix")):
        est = np.array([r[0] for r in res[kind]])
        check(est.shape == (N_DIRS,) and bool(np.isfinite(est).all()),
              f"{kind} answers are not finite ({N_DIRS},)")
        check({r[2] for r in res[kind]} == {snaps[tenant].version},
              f"{kind} answers not served from the published version")
    sub = np.array([r[0] for r in res["subspace"]])
    sub_gap = float(np.abs(sub - truth(x["subspace"])).max()) / frob
    check(sub_gap <= LEV_ERR_FACTOR * EPS * (1 + 1e-5),
          f"leverage subspace gap {sub_gap} > {LEV_ERR_FACTOR} eps ||A||_F^2")
    mat = np.array([r[0] for r in res["matrix"]])
    mat_gap = float(np.abs(mat - truth(x["matrix"])).max()) / frob
    check(mat_gap <= 2 * EPS, f"matrix tenant gap {mat_gap} > 2 eps ||A||_F^2")

    lam = float(snaps["leverage"].meta["lam"])
    t0 = time.perf_counter()
    oracle = table_scores(snaps["leverage"].matrix, x["score"], lam).astype(np.float64)
    oracle_s = time.perf_counter() - t0
    got = np.array([r[0] for r in res["score"]], np.float64)
    bad = int((np.abs(got - oracle) > SCORE_ATOL + SCORE_RTOL * np.abs(oracle)).sum())
    check(bad == 0, f"{bad} of {N_DIRS} score answers off the f64 oracle "
                    f"(rtol {SCORE_RTOL}, atol {SCORE_ATOL})")
    score_rel = float((np.abs(got - oracle) / np.maximum(np.abs(oracle), 1e-30)).max())

    for name in PIPELINE_KERNELS:
        check(prun["launches"][name] > 0, f"kernel {name} was not launched on the pipeline path")
    check(prun["launches"]["flash_attention"] == 0, "the pipeline path launched flash_attention")
    for name in ("quadform", "levscore"):
        check(prun["flush_launches"][name] > 0, f"the pipeline's flush did not launch {name}")
    return dict(frob=frob, subspace_gap=sub_gap, matrix_gap=mat_gap, score_max_rel=score_rel,
                score_oracle_s=oracle_s, table_rows=int(snaps["leverage"].matrix.shape[0]),
                lam=lam, comm={t: pipe.tracker(t).comm_report().as_dict()
                               for t in ("matrix", "leverage")})


def levscore_cases(torch, prun) -> tuple[list[dict], float]:
    """``levscore`` at the path's shape — the ridge factor of the published
    leverage table, rebuilt on the host as the engine builds it (timed:
    one f64 ``pinv`` of d x d) — and at its edges: a ragged shape, one score
    query, a ragged shape on offset views (the 4-byte ``cp.async`` path),
    d = 20, d = 7 off 16 bytes, and the path's shape with a factor that is
    not symmetric (the path's factor is symmetric to rounding, so it cannot
    catch a kernel that reads only one triangle of M)."""
    from repro_torch.core.leverage import decode_leverage_snapshot, ridge_factor
    from repro_torch.kernels import ops, ref

    snap = prun["snaps"]["leverage"]
    rows, _, w = decode_leverage_snapshot(snap.matrix)
    t0 = time.perf_counter()
    factor = ridge_factor(rows, w, float(snap.meta["lam"]))
    pinv_s = time.perf_counter() - t0
    m_path = torch.tensor(factor, dtype=torch.float32, device=DEV)
    x_path = torch.tensor(prun["x"]["score"], device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(9)
    m_skew = m_path + m_path.abs().mean() * torch.randn(D, D, device=DEV, generator=gen)

    def offset(*shape):
        """The second of two stacked random tensors: its base is off 16 bytes."""
        return torch.randn(2, *shape, device=DEV, generator=gen)[1]

    cases = []
    for label, m, x in (("score queries", m_path, x_path),
                        ("ragged", m_path[:1000, :1000].contiguous(),
                         x_path[:300, :1000].contiguous()),
                        ("one score query", m_path, x_path[:1]),
                        ("ragged, offset views", offset(131, 131), offset(37, 131)),
                        ("d = 20", m_path[:20, :20].contiguous(), x_path[:64, :20].contiguous()),
                        ("d = 7, offset views", offset(7, 7), offset(50, 7)),
                        ("score queries, factor not symmetric", m_skew, x_path)):
        n, d = x.shape
        cases.append(dict(
            kernel="levscore", shape=f"{label}: (N={n}, d={d})", pallas=PALLAS["levscore"][0],
            run=lambda m=m, x=x: ops.levscore(m, x),
            plain=lambda m=m, x=x: ref.ref_levscore(m, x),
            library=lambda m=m, x=x: (x @ m * x).sum(1),
            flops=2.0 * n * d * d + 2.0 * n * d, nbytes=4.0 * (d * d + n * d + n),
        ))
    return cases, pinv_s


def time_leverage_serving(prun) -> dict:
    """Leverage subspace and score queries (1024 each) through
    ``QueryEngine.query_batch`` against the published table."""
    import numpy as np

    engine = prun["pipe"].engine

    def rows(mode, v):
        return np.concatenate([np.full((v.shape[0], 1), mode, np.float32), v], axis=1)

    q_sub, q_score = rows(0.0, prun["x"]["subspace"]), rows(1.0, prun["x"]["score"])
    return time_calls({
        "leverage_subspace": (N_DIRS, lambda: engine.query_batch(q_sub, tenant="leverage")),
        "leverage_score": (N_DIRS, lambda: engine.query_batch(q_score, tenant="leverage")),
    })


def profile_leverage_scores(torch, prun, calls: int = 5) -> dict:
    """``torch.profiler`` over ``calls`` leverage score ``query_batch`` calls
    (1024 scores each), after one unprofiled call: the ``levscore`` kernel's
    device time per launch against the host time per call.  The second pass
    (``levscore_sum_kernel``) is reported apart: it is launched early as a
    programmatic dependent, so its device time includes its wait for the
    first kernel.  Fails unless the profiler recorded one ``levscore`` kernel
    a call.  Runs before the long ingest profiles: after them the profiler
    has dropped the first kernels of a short window."""
    import numpy as np

    q = np.concatenate([np.ones((N_DIRS, 1), np.float32), prun["x"]["score"]], axis=1)
    engine = prun["pipe"].engine

    def fn():
        for _ in range(calls):
            engine.query_batch(q, tenant="leverage")

    engine.query_batch(q, tenant="leverage")
    prof = device_profile(torch, fn)
    dev, count = prof.pop("device_ms"), prof.pop("device_count")

    def per_launch(name):
        n = sum(c for k, c in count.items() if name in k)
        return sum(v for k, v in dev.items() if name in k) / n if n else 0.0, n

    kernel_ms, launches = per_launch("levscore_kernel")
    check(launches == calls, f"the profiler recorded {launches} levscore kernels in {calls} "
          f"leverage score query_batch calls")
    call_ms = prof["wall_ms"] / calls
    prof.update(calls=calls, call_ms=call_ms, levscore_ms=kernel_ms,
                levscore_share_of_call=kernel_ms / call_ms,
                levscore_sum_ms=per_launch("levscore_sum_kernel")[0])
    return prof


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention over s positions needs, with a window."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_cases(torch, seed: int, prompt_len: int) -> list[dict]:
    """``flash_attention`` at the serving path's shape (bf16, Qwen3-0.6B's
    heads, ``SERVE_BATCH`` prompts of ``prompt_len``) and at a ragged,
    windowed, soft-capped one in bf16 and in f32, on random inputs from
    ``seed``."""
    from repro_torch.kernels import ops, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    cases = []
    for label, (b, hq, hkv, s, dh, window, cap, dtype) in (
        ("serving prefill", (SERVE_BATCH, 16, 8, prompt_len, 128, 0, 0.0, torch.bfloat16)),
        ("ragged, windowed, soft-capped", (1, 8, 2, 1000, 64, 256, 30.0, torch.bfloat16)),
        ("ragged, windowed, soft-capped", (1, 8, 2, 1000, 64, 256, 30.0, torch.float32)),
    ):
        q, k, v = (torch.randn(b, h, s, dh, device=DEV, generator=gen).to(dtype)
                   for h in (hq, hkv, hkv))
        kw = dict(window=window, logit_softcap=cap)
        size = torch.finfo(dtype).bits // 8
        bf16 = dtype == torch.bfloat16
        cases.append(dict(
            kernel="flash_attention",
            shape=f"{label}: (b={b}, hq={hq}, hkv={hkv}, s={s}, dh={dh}, window={window}, "
                  f"softcap={cap}, {str(dtype).split('.')[-1]})",
            pallas=PALLAS["flash_attention"][0],
            source=(ops.FLASH_ATTENTION_BF16 if bf16 else ops.FLASH_ATTENTION).source,
            run=lambda q=q, k=k, v=v, kw=kw: ops.flash_attention(q, k, v, **kw),
            plain=lambda q=q, k=k, v=v, kw=kw: ref.ref_attention(q, k, v, **kw),
            want=lambda q=q, k=k, v=v, kw=kw: ref.ref_attention(q.float(), k.float(), v.float(),
                                                                **kw),
            elem_rtol=BF16_ROUNDING if bf16 else 0.0,
            # SDPA has no window or soft-cap: it computes this function only
            # on the plain causal shape.
            library=(lambda q=q, k=k, v=v: sdpa(q, k, v, is_causal=True, enable_gqa=True))
            if window == 0 and cap == 0.0 else None,
            rate=FLOPS_BF16 if bf16 else FLOPS_F32,
            flops=4.0 * b * hq * dh * attention_pairs(s, window),
            nbytes=float(size * (2 * b * hq * s * dh + 2 * b * hkv * s * dh)),
        ))
    return cases


def serving_config(**changes):
    """Qwen3-0.6B at full width with ``changes`` (``attn_impl``, ``dtype``)."""
    import dataclasses

    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(SERVE_ARCH), **changes)


def drive_serving(torch, seed: int, prompt_len: int, n_gen: int) -> dict:
    """The serving path: ``ServeEngine.generate`` over Qwen3-0.6B with the
    flash kernel, on random bf16 weights and random prompts from ``seed``;
    then the greedy consistency of its tokens and a second, timed run."""
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig, ServeEngine, greedy_consistency

    cfg = serving_config(attn_impl="pallas")
    t0 = time.perf_counter()
    lm = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt_len), device=DEV,
                            generator=gen)
    engine = ServeEngine(lm, ServeConfig(max_len=max(SERVE_MAX_LEN, prompt_len + n_gen)))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    out = engine.generate(prompts, n_gen)
    launches = ops.launch_counts()
    timings = [dict(engine.timings)]
    check(tuple(out.shape) == (SERVE_BATCH, prompt_len + n_gen), f"generated {tuple(out.shape)}")
    check(torch.equal(out[:, :prompt_len], prompts), "generate did not keep the prompts")
    new = out[:, prompt_len:]
    check(bool(((new >= 0) & (new < cfg.vocab_size)).all()), "generated tokens outside the vocab")
    want = dict.fromkeys(ops.KERNELS, 0)
    want["flash_attention"] = cfg.n_layers
    check(launches == want, f"serving launches {launches} != expected {want} (one "
                            f"flash_attention per layer in the prefill, none in decode)")
    consistency = greedy_consistency(lm, out, prompt_len)
    again = engine.generate(prompts, n_gen)
    timings.append(dict(engine.timings))
    check(torch.equal(again, out), "two greedy generations differ")
    return dict(lm=lm, prompts=prompts, out=out, launches=launches, init_s=init_s,
                timings=timings, greedy_consistency=consistency, cfg=cfg)


def device_profile(torch, fn) -> dict:
    """``torch.profiler`` over ``fn()``: wall time, device busy share, and the
    device time and launches of each kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def self_dev(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))

    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA and self_dev(e) > 0]
    busy_us = sum(self_dev(e) for e in events)
    check(busy_us > 0, "the profiler saw no device time")
    top = sorted(events, key=lambda e: -self_dev(e))[:12]
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / wall_us, device_launches=sum(e.count for e in events),
                device_ms={e.key: self_dev(e) / 1e3 for e in events},
                device_count={e.key: e.count for e in events},
                top_device_ms={e.key: self_dev(e) / 1e3 for e in top},
                top_host_self_ms={e.key: e.self_cpu_time_total / 1e3 for e in host})


def profile_serving(torch, srun, steps: int = 4) -> dict:
    """One more prefill, and ``steps`` greedy decode steps after one unprofiled
    step, each under ``torch.profiler``: device busy shares, the flash
    kernel's share of prefill device time, device launches per decode step."""
    from repro_torch.serve import make_serve_step

    lm, prompts = srun["lm"], srun["prompts"]
    t0 = prompts.shape[1]
    with torch.no_grad():
        prefill = device_profile(torch, lambda: lm.prefill(prompts, SERVE_MAX_LEN))
        logits, cache = lm.prefill(prompts, SERVE_MAX_LEN)
        step = make_serve_step(lm)
        state = dict(cur=torch.argmax(logits, dim=-1)[:, None], cache=cache)

        def decode(first: int, n: int):
            for i in range(first, first + n):
                state["cur"], _, state["cache"] = step(state["cache"], state["cur"], t0 + i,
                                                       None, 0.0)

        decode(0, 1)
        dec = device_profile(torch, lambda: decode(1, steps))
    flash_ms = sum(v for k, v in prefill.pop("device_ms").items() if "flash_attention_kernel" in k)
    for p in (prefill, dec):
        p.pop("device_count")
    dec.pop("device_ms")
    prefill.update(flash_attention_ms=flash_ms,
                   flash_attention_share=flash_ms / prefill["device_busy_ms"])
    dec.update(steps=steps, ms_per_step=dec["wall_ms"] / steps,
               launches_per_step=dec["device_launches"] / steps)
    return dict(prefill=prefill, decode=dec)


def check_serving_f32(torch, seed: int) -> dict:
    """Qwen3-0.6B in f32 (batch 1, a ``CHECK_PROMPT``-token prompt): each of
    ``CHECK_STEPS`` decode steps against the full forward at its position
    (through the kernel, ragged lengths), and the kernel's prefill against
    the plain ``xla`` prefill on the same weights."""
    from repro_torch.models import LM

    cfg = serving_config(attn_impl="pallas", dtype="float32")
    lm = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed))
    plain = LM(serving_config(attn_impl="xla", dtype="float32"), device=DEV)
    plain.load_state_dict(lm.state_dict())
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    toks = torch.randint(0, cfg.vocab_size, (1, CHECK_PROMPT + CHECK_STEPS), device=DEV,
                         generator=gen)
    with torch.no_grad():
        logits, cache = lm.prefill(toks[:, :CHECK_PROMPT], CHECK_PROMPT + CHECK_STEPS)
        x, _ = plain.hidden(toks[:, :CHECK_PROMPT])
        prefill_err = float((logits - plain.logits_at(x[:, -1])).abs().max())
        check(bool(torch.isfinite(logits).all()), "f32 prefill logits are not finite")
        check(prefill_err < LOGIT_ATOL,
              f"f32 prefill: kernel vs plain max |logit diff| {prefill_err} >= {LOGIT_ATOL}")
        decode_err = []
        for i in range(CHECK_PROMPT, CHECK_PROMPT + CHECK_STEPS):
            dec, cache = lm.decode_step(cache, toks[:, i:i + 1], i)
            x, _ = lm.hidden(toks[:, :i + 1])
            decode_err.append(float((dec[:, 0] - lm.logits_at(x[:, -1])).abs().max()))
            check(decode_err[-1] < LOGIT_ATOL,
                  f"f32 decode at {i}: max |logit diff| vs the full forward {decode_err[-1]} "
                  f">= {LOGIT_ATOL}")
        logit_scale = float(logits.abs().max())
    return dict(prompt=CHECK_PROMPT, steps=CHECK_STEPS, prefill_kernel_vs_plain=prefill_err,
                decode_vs_forward=decode_err, logit_scale=logit_scale)


def main() -> int:
    """Build, check the kernels, drive and check both paths, report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64, help="P2 super-steps of 8 x 512 rows")
    ap.add_argument("--lev-steps", type=int, default=16,
                    help="pipeline super-steps (the first of the same stream)")
    ap.add_argument("--serve-prompt", type=int, default=4096, help="serving prompt length")
    ap.add_argument("--out", type=str, default="", help="write the full report here as JSON")
    args = ap.parse_args()

    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no repro_torch package under {src}: run from a checkout of the repository")
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    check(2 <= args.lev_steps <= args.steps, "need 2 <= --lev-steps <= --steps")
    check(args.serve_prompt >= 1, "need --serve-prompt >= 1")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]

    from repro_torch.core.distributed import ProtocolConfig
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    sources = sorted({k.source for ks in ops.KERNELS.values() for k in ks})
    ptxas = _build.build(sources)
    build_s = time.perf_counter() - t0
    sass = sass_counts(_build.library_path(ops.FLASH_ATTENTION_BF16.source))
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"{ops.FLASH_ATTENTION_BF16.source} has no wgmma or no TMA load in its SASS: {sass}")
    f32_sources = [k.source for ks in ops.KERNELS.values() for k in ks
                   if k is not ops.FLASH_ATTENTION_BF16]
    sass_f32 = {src: sass_counts(_build.library_path(src), SASS_F32) for src in f32_sources}
    for src, counts in sass_f32.items():
        check(counts["HMMA"] == 0 and counts["HGMMA"] == 0,
              f"{src} holds tensor-core instructions in its SASS: {counts}")

    batches, ata = make_stream(torch, args.seed, args.steps)
    torch.cuda.synchronize()
    cfg = ProtocolConfig(eps=EPS, m=M, d=D).resolved()

    cases = run_kernel_cases(torch, kernel_cases(torch, batches, cfg.l_site, cfg.l_coord))

    # Path 1: P2 through DistributedMatrixTracker and the QueryEngine.
    run = drive_main_path(torch, batches, args.steps)
    checks = check_main_path(torch, run, ata, args.steps)
    serving = time_serving(run)
    query_prof = profile_queries(torch, run)

    # Path 2: StreamingPipeline with a matrix and a leverage tenant.
    lev_batches = batches[: args.lev_steps]
    prun = drive_pipeline(torch, lev_batches)
    pipe_checks = check_pipeline(torch, prun, lev_batches)
    lev_cases, pinv_s = levscore_cases(torch, prun)
    cases += run_kernel_cases(torch, lev_cases)
    lev_serving = time_leverage_serving(prun)
    score_prof = profile_leverage_scores(torch, prun)
    # The long ingest profiles come after the short ones (profile_leverage_scores).
    prof = profile_ingest(torch, batches, min(8, args.steps - 1)) if args.steps > 1 else {}
    lev_prof = profile_leverage_ingest(torch, lev_batches, min(8, args.lev_steps - 1))
    del batches, ata, lev_batches
    torch.cuda.empty_cache()

    # Path 3: serving Qwen3-0.6B through ServeEngine with the flash kernel.
    t_serve = time.perf_counter()
    cases += run_kernel_cases(torch, flash_cases(torch, args.seed, args.serve_prompt))
    srun = drive_serving(torch, args.seed, args.serve_prompt, SERVE_GEN)
    serve_prof = profile_serving(torch, srun)
    del srun["lm"]
    torch.cuda.empty_cache()
    f32_checks = check_serving_f32(torch, args.seed)
    serve_phase_s = time.perf_counter() - t_serve

    n_rows = args.steps * M * ROWS_PER_SITE
    t, pt = run["timings"], prun["timings"]
    lev_rows = args.lev_steps * M * ROWS_PER_SITE
    lev_host_s = pt["ingest_s"]["leverage"] + pt["publish_s"]["leverage"]
    pipeline = dict(
        steps=args.lev_steps, rows=lev_rows,
        ingest_rows_per_s={k: lev_rows / v for k, v in pt["ingest_s"].items()},
        publish_s=pt["publish_s"], flush_s=pt["flush_s"], host_pinv_s=pinv_s,
        leverage_pinv_share=pinv_s / lev_host_s, leverage_eigh_host_share=lev_prof["eigh_host_share"],
        leverage_device_busy_share=lev_prof["device_busy_share"], serving=lev_serving,
        score_profile=score_prof,
        checks=pipe_checks, launches=prun["launches"], flush_launches=prun["flush_launches"],
    )
    summary = dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        seed=args.seed, steps=args.steps, m=M, d=D, eps=EPS, l_site=cfg.l_site,
        l_coord=cfg.l_coord, rows=n_rows, ingest_s=t["ingest_s"],
        ingest_rows_per_s=n_rows / t["ingest_s"], serving=serving,
        refresh_spectra_s=t["refresh_s"], eigh_host_share=prof.get("eigh_host_share"),
        device_busy_share=prof.get("device_busy_share"), checks=checks,
        query_profile=query_prof,
        phase_launches=run["phase_launches"], pipeline=pipeline,
    )
    n_prompt, n_new = SERVE_BATCH * args.serve_prompt, SERVE_BATCH * (SERVE_GEN - 1)
    summary["serving_path"] = dict(
        arch=SERVE_ARCH, layers=srun["cfg"].n_layers, dtype=srun["cfg"].dtype,
        attn_impl=srun["cfg"].attn_impl, batch=SERVE_BATCH, prompt=args.serve_prompt,
        generated=SERVE_GEN, weights_init_s=srun["init_s"], timings=srun["timings"],
        prefill_tokens_per_s=[n_prompt / t["prefill_s"] for t in srun["timings"]],
        decode_tokens_per_s=[n_new / t["decode_s"] for t in srun["timings"]],
        greedy_consistency=srun["greedy_consistency"], launches=srun["launches"],
        profile=serve_prof, f32_checks=f32_checks, phase_s=serve_phase_s,
    )
    kernels = []
    for name in ops.KERNELS:
        mine = [c for c in cases if c["kernel"] == name]
        main = max(mine, key=lambda c: c["gflop"])  # the heaviest shape stands for the kernel
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{main['source']}",
            replaces="; ".join(PALLAS[name]),
            launches=run["launches"][name] + prun["launches"][name] + srun["launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in mine), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"], shapes=mine,
        ))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(summary=summary, kernels=kernels, profile=prof, leverage_profile=lev_prof,
                 ptxas=ptxas, sass={**sass_f32, ops.FLASH_ATTENTION_BF16.source: sass}),
            indent=1))
    print(f"build: {build_s:.1f} s for {', '.join(sources)}")
    for row in ptxas_summary(ptxas):
        print(f"ptxas {row['source']} {row['kernel']}: {row['registers']} registers, spills "
              f"{row['spill_stores']} B stored / {row['spill_loads']} B loaded, static smem "
              f"{row['static_smem']} B")
    print(f"SASS of {ops.FLASH_ATTENTION_BF16.source}: {sass['HGMMA']} HGMMA (wgmma), "
          f"{sass['UTMALDG']} UTMALDG (TMA loads)")
    for src, n in sass_f32.items():
        print(f"SASS of {src}: {n['FFMA']} FFMA, {n['LDS']} LDS ({n['LDS.128']} LDS.128), "
              f"{n['FFMA'] / max(n['LDS'], 1):.2f} FFMA per shared load, {n['LDGSTS']} LDGSTS "
              f"(cp.async), {n['HMMA']} HMMA, {n['HGMMA']} HGMMA")
    for c in cases:
        lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
        print(f"{c['kernel']:<10} {c['shape']:<52} ms {c['ms']:.4f}  plain {c['plain_ms']:.4f}  "
              f"library {lib}  bound {c['bound_ms']:.4f} ({c['bound_by']})  "
              f"rel err {c['max_rel_err']:.2e}  err/tol {c['err_over_tol']:.3f}")
    for name, p in query_prof.items():
        print(f"profile of one {name}: call {p['wall_ms']:.3f} ms on the host clock, device busy "
              f"{p['device_busy_ms']:.3f} ms, quadform kernel {p['quadform_ms']:.4f} ms "
              f"({p['quadform_share_of_call']:.1%} of the call)")
    print(f"profile of {score_prof['calls']} leverage score query_batch calls: "
          f"{score_prof['call_ms']:.3f} ms a call on the host clock, device busy "
          f"{score_prof['device_busy_ms'] / score_prof['calls']:.3f} ms a call, levscore kernel "
          f"{score_prof['levscore_ms']:.4f} ms a launch ({score_prof['levscore_share_of_call']:.1%} "
          f"of a call; its second pass {score_prof['levscore_sum_ms']:.4f} ms, waiting "
          f"included)")
    for name, p in (("P2 ingest", prof), ("leverage ingest", lev_prof)):
        if p:
            k, share = p["shrink_kernel_device_ms"], p["shrink_kernel_share_of_device_busy"]
            print(f"profile of {name} ({p['steps']} steps): wall {p['wall_ms']:.1f} ms, eigh "
                  f"{p['eigh_host_ms']:.1f} ms of host time ({p['eigh_host_share']:.1%}), device "
                  f"busy {p['device_busy_ms']:.1f} ms, fd_gram {k['fd_gram']:.3f} ms "
                  f"({share['fd_gram']:.2%}) and fd_project {k['fd_project']:.3f} ms "
                  f"({share['fd_project']:.2%}) of device time")
    for tenant, comm in pipe_checks["comm"].items():
        print(f"pipeline {tenant} CommReport: {json.dumps(comm)}")
    sp = summary["serving_path"]
    print(f"serving {SERVE_ARCH}: {SERVE_BATCH} x {args.serve_prompt} prompt tokens, "
          f"{SERVE_GEN} new each: prefill tokens/s {sp['prefill_tokens_per_s']}, "
          f"decode tokens/s {sp['decode_tokens_per_s']}, greedy consistency vs teacher-forced "
          f"forward {sp['greedy_consistency']:.1%}; prefill device busy "
          f"{serve_prof['prefill']['device_busy_share']:.1%}, flash_attention "
          f"{serve_prof['prefill']['flash_attention_share']:.1%} of prefill device time; decode "
          f"device busy {serve_prof['decode']['device_busy_share']:.1%}, "
          f"{serve_prof['decode']['launches_per_step']:.0f} device launches a step; "
          f"phase {serve_phase_s:.1f} s")
    print(f"serving f32 check: prefill kernel vs plain {f32_checks['prefill_kernel_vs_plain']:.3e}, "
          f"decode vs full forward max {max(f32_checks['decode_vs_forward']):.3e} "
          f"(limit {LOGIT_ATOL})")
    print("summary: " + json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
