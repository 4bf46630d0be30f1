#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py [--seed 0] [--steps 64] [--lev-steps 16] [--serve-prompt 4096]
                          [--out report.json]

From the root of a checkout, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

1. builds the hand-written kernels' eight sources from
   ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per source,
   all at once), prints each kernel's ptxas registers, spills and static
   shared memory, and counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instructions in the SASS of ``flash_attention_wgmma.cu``: both must
   be there.  In the SASS of the seven f32 sources it counts ``FFMA``,
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
   within 2e-3 of the plain ``xla`` prefill;
11. before the serving phases, packed multi-tenant ingest: two
   ``StreamingPipeline``s (m = 8, d = 1024, eps = 0.02, publishing every 3
   steps), each with 8 P2 matrix tenants (3 x 4096, 3 x 2048, 2 x 1024
   rows a wave, one 2048-row tenant cold for the first wave) and 2
   leverage P1 tenants (2048 rows each), ingest 8 waves cut from the same
   stream, one through ``ingest_many(packed=False)`` and one through
   ``ingest_many(packed=True)`` (the pack's site shrinks are 64 buffers of
   400 x 1024, whose ``fd_gram`` and ``fd_project`` join the kernel cases
   of 2).  It prints rows/s, the packed counters of ``stats()``, ``eigh``'s
   share of host time and calls over the last two waves (``torch.profiler``)
   and the cuSOLVER routine of one ``eigh`` of the (64, 400, 400) batch;
   holds packed against serial (rows and ``n_seen`` exactly, live mass to
   1e-6 relative, matrix and subspace answers on 1024 unit directions within
   1e-5 ``||A_t||_F^2``, score answers within rtol 1e-3, atol 1e-5, the
   ``CommReport`` totals printed side by side); saves the packed pipeline
   while its tenants' states still sit in the pack, loads it on the card
   (state leaves and served answers bit-identical), and after one more
   packed wave into both holds their answers within 1e-5 ``||A_t||_F^2``;
12. after 11, heavy-hitter and quantile tenants (path 5): one
   ``StreamingPipeline`` of m = 50 sites, eps = 0.01 (k = 200 counters,
   q_cap = 808), with an HH super-step P1 tenant on the reference
   benchmark's 1,000,000-item stream (Zipf skew 2 keys over 50,000 ids,
   weights U[1, 1000]), a quantile super-step P1 tenant on 200,000
   lognormal(3, 1.5) values (weights U[1, 100]), HH event P1 and P2 and
   quantile event P1 tenants on the first 20,000 items of those streams, and
   a matrix P2 tenant (d = 1024) taking 4 waves of 4,000 rows; 16 waves (the
   last two profiled), then one publish each; 1,024 HH lookups (the true
   0.05-heavy keys and random ids), 1,024 quantile rank and phi-quantile
   queries and 1,024 matrix directions through ``query_batch`` and one mixed
   ``query_packed``, then ``heavy_hitters`` and ``quantiles``.  Every key's
   HH estimate lies within ``err_factor * eps * W`` of its weight counted in
   f64 on the host, recall of the heavy set is 1, the worst rank error of the
   quantile probes is within ``err_factor * eps * W``; the pipeline is saved,
   loaded on the card (leaves and answers bit-identical) and one more wave
   gives the uninterrupted pipeline's answers.  ``mg_scan`` (one wave's site
   scan) and ``quant_pack`` (the 50 site inserts, one coordinator merge) are
   held bit for bit to their plain versions on the inputs the first wave
   gave them, and timed beside a chain bound (their dependent steps).

Launch counts are set to 0 just before each path (the P2 path, the
pipeline, the packed pipeline, path 5, the serving run) and read just
after; the serial pipeline of 11 runs before its window.  Comparisons of a kernel with its plain
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
# The Pallas kernel each of the port's kernels stands for (``ops.KERNELS``:
# one buffer or sketch counts as the single kernel, a stack as the batched
# or packed one).
PALLAS = {
    "fd_gram": "src/repro/kernels/fd_gram.py:52",
    "fd_gram_batched": "src/repro/kernels/fd_shrink_fused.py:60",
    "fd_project": "src/repro/kernels/fd_project.py:49",
    "fd_project_batched": "src/repro/kernels/fd_shrink_fused.py:99",
    "quadform": "src/repro/kernels/quadform.py:127",
    "quadform_packed": "src/repro/kernels/quadform.py:92",
    "levscore": "src/repro/kernels/levscore.py:71",
    "flash_attention": "src/repro/kernels/flash_attention.py:166",
}
SHRINK_KERNELS = ("fd_gram", "fd_gram_batched", "fd_project", "fd_project_batched")
P2_KERNELS = SHRINK_KERNELS + ("quadform", "quadform_packed")
# Opcodes counted in the SASS of the f32 sources; the last two (tensor-core
# products: mma.sync and wmma, and wgmma) must not be there.
SASS_F32 = ("FFMA", "LDS", "LDS.128", "LDGSTS", "HMMA", "HGMMA")
PIPELINE_KERNELS = SHRINK_KERNELS + ("quadform", "levscore")
SERVE_ARCH, SERVE_BATCH, SERVE_GEN, SERVE_MAX_LEN = "qwen3-0.6b", 4, 32, 4224
CHECK_PROMPT, CHECK_STEPS = 512, 8
# Path 4, packed ingest: each of two pipelines holds 8 P2 matrix tenants and
# 2 leverage P1 tenants, fed these rows a wave (one 2048-row matrix tenant
# cold for the first wave), PACK_WAVES waves of which the last
# PACK_PROFILED_WAVES run under torch.profiler, then one tail wave after the
# checkpoint.  Answers agree within PACK_TOL * ||A_t||_F^2, the reference's
# bound (tests/test_ingest_packed.py::test_mid_pack_save_load_round_trip).
PACK_MATRIX_ROWS = (4096, 4096, 4096, 2048, 2048, 2048, 1024, 1024)
PACK_LEV_ROWS = (2048, 2048)
PACK_COLD, PACK_WAVES, PACK_PROFILED_WAVES, PACK_PUBLISH_EVERY = "m3", 8, 2, 3
PACK_TOL, PACK_FROB_RTOL = 1e-5, 1e-6
PACK_KERNELS = ("fd_gram_batched", "fd_project_batched", "quadform", "levscore")
# Path 5, heavy-hitter and quantile tenants: one pipeline of HQ_M sites at
# HQ_EPS (k = 200 MG counters, q_cap = 808), the reference benchmarks' m
# (benchmarks/hh_protocols.py:41) and streams: HH_ITEMS weighted items, Zipf
# skew 2 keys over HH_KEYS ids, weights U[1, 1000] (:41-43); Q_ITEMS
# lognormal(3, 1.5) values with weights U[1, 100] (benchmarks/quantile_protocols.py:36-40,
# :54).  The event engines (host simulators) take the first EVENT_ITEMS of
# each stream (BENCH_hh_pipeline.json's size); the matrix tenant takes
# HQ_MATRIX_WAVES waves of HQ_MATRIX_ROWS rows of path 1's stream (a
# super-step's 8 x 512 rows cut to a multiple of m).  HQ_WAVES waves, the
# last HQ_PROFILED_WAVES under torch.profiler, then one more wave (the first
# wave's items again) after the checkpoint.  Phi of the heavy-hitter set:
# benchmarks/hh_protocols.py:27.
HQ_M, HQ_EPS, HQ_WAVES, HQ_PROFILED_WAVES, HQ_PHI = 50, 0.01, 16, 2, 0.05
HH_ITEMS, HH_KEYS, Q_ITEMS, EVENT_ITEMS = 1_000_000, 50_000, 200_000, 20_000
HQ_MATRIX_WAVES, HQ_MATRIX_ROWS = 4, 4000
HQ_KERNELS = ("mg_scan", "quant_pack", "quadform", "fd_gram", "fd_project")
# The two kernels no Pallas kernel stands behind: the reference's sequential
# loops, run as XLA code.
NO_PALLAS = {
    "mg_scan": "none (src/repro/core/hh.py:98 mg_update_stream, a lax.scan)",
    "quant_pack": "none (src/repro/core/quantiles.py:468 _quant_pack, a lax.fori_loop)",
}
# A sequential kernel's chain bound: its dependent steps at about 30 cycles
# each (a shared-memory round trip, or four dependent f32 additions, a
# compare and a select) at the H100's 1.98 GHz boost clock.  A reckoning,
# not a measurement.
CHAIN_STEP_S = 30 / 1.98e9


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
    # (64, 400, 1024): a packed ingest's site shrink, PACK_MATRIX tenants x M sites.
    n_pack = len(PACK_MATRIX_ROWS) * M * 2 * l_site
    pack_buf = torch.cat([batches[i % len(batches)]
                          for i in range(-(-n_pack // batches[0].shape[0]))])[:n_pack]
    pack_buf = pack_buf.reshape(len(PACK_MATRIX_ROWS) * M, 2 * l_site, D)
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
                     ("refresh_spectra", sketches), ("packed site shrink", pack_buf),
                     ("ragged, offset views", torch.randn(4, 37, 131, device=DEV,
                                                          generator=gen_fd)[1:]),
                     ("L = 1", coord_buf[:, :1]), ("L = 600", batches[0][:600][None]),
                     ("d = 20", site_buf[:3, :64, :20].contiguous()),
                     ("d = 7, offset views", torch.randn(3, 50, 7, device=DEV,
                                                         generator=gen_fd)[1:])):
        t, l, d = b.shape
        path = label in ("site shrink", "coordinator shrink", "refresh_spectra",
                         "packed site shrink")
        stack = "" if t == 1 else "_batched"
        cases.append(dict(
            kernel=f"fd_gram{stack}", shape=f"{label}: (T={t}, L={l}, d={d})",
            pallas=PALLAS[f"fd_gram{stack}"],
            run=lambda b=b: fd_ops.fd_gram(b),
            plain=lambda b=b: ref.ref_fd_gram_batched(b),
            library=lambda b=b: torch.bmm(b, b.mT),
            symmetric=True, on_path=path,
            # G is symmetric: the function needs l (l + 1) / 2 dot products
            # per sketch.
            flops=2.0 * t * l * (l + 1) / 2 * d, nbytes=4.0 * (t * l * d + t * l * l),
        ))
        w, u, _ = project_inputs(b, path)
        cases.append(dict(
            kernel=f"fd_project{stack}", shape=f"{label}: (T={t}, L={l}, d={d})",
            pallas=PALLAS[f"fd_project{stack}"],
            run=lambda w=w, u=u, b=b: fd_ops.fd_project(w, u, b),
            plain=lambda w=w, u=u, b=b: ref.ref_fd_project_batched(w, u, b),
            library=lambda u=u, b=b: torch.bmm(u.mT, b),  # U^T B; the w rescale is not in it
            on_path=path,
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
            kernel="quadform" if t == 1 else "quadform_packed",
            shape=f"{label}: (T={t}, L={l}, N={n}, d={d})",
            pallas=PALLAS["quadform" if t == 1 else "quadform_packed"],
            run=(lambda b=b, x=x: ops.quadform(b[0], x[0])) if single
            else (lambda b=b, x=x: ops.quadform_packed(b, x)),
            plain=(lambda b=b, x=x: ref.ref_quadform(b[0], x[0])) if single
            else (lambda b=b, x=x: ref.ref_quadform_packed(b, x)),
            # One sketch: one 2-D product, as a caller with one sketch writes it.
            library=(lambda b=b, x=x: (b[0] @ x[0].T).square().sum(0)) if t == 1
            else (lambda b=b, x=x: (b @ x.mT).square().sum(-2)),
            on_path=label in ("query_batch", "query_packed"),
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
        if c.get("exact"):
            # The sequential kernels make the plain version's f32 additions
            # and comparisons in its order: bit for bit, +inf pads included.
            check(torch.equal(got, want),
                  f"{c['kernel']} {c['shape']}: kernel and plain version differ in "
                  f"{int((got != want).sum())} of {got.numel()} values")
            err = scale = err_over_tol = 0.0
        else:
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
                  f"{float(diff.flatten()[worst]):.3e} at plain = "
                  f"{float(want.flatten()[worst]):.3e} > {elem_rtol:.3e} * |plain| + "
                  f"{KERNEL_RTOL} * {scale:.3e}")
            del diff, ratio
        del got, again, want
        rate = c.get("rate", FLOPS_F32)
        b_ms, b_by = bound_ms(c["flops"], c["nbytes"], rate)
        extra = {}
        if rate != FLOPS_F32:  # also the table's convention: f32 on the CUDA cores
            extra["bound_f32_ms"] = bound_ms(c["flops"], c["nbytes"])[0]
        if "chain_steps" in c:  # a sequential loop: its chain of dependent steps
            extra.update(chain_steps=c["chain_steps"],
                         chain_bound_ms=c["chain_steps"] * CHAIN_STEP_S * 1e3)
        results.append(dict(
            kernel=c["kernel"], shape=c["shape"], replaces=c["pallas"],
            source=c.get("source", ops.KERNELS[c["kernel"]][0].source),
            max_abs_err=err, max_rel_err=err / max(scale, 1e-30), err_over_tol=err_over_tol,
            ms=time_ms(torch, c["run"]), plain_ms=time_ms(torch, c["plain"], c.get("plain_reps", 20)),
            library_ms=time_ms(torch, c["library"]) if c["library"] else None,
            bound_ms=b_ms, bound_by=b_by, gflop=c["flops"] / 1e9, mbytes=c["nbytes"] / 1e6,
            on_path=c.get("on_path", False),
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
    # The site buffers shrink as a stack of m and refresh_spectra takes the
    # stack of published sketches; the coordinator shrinks alone, and
    # query_batch serves one sketch.
    want = dict.fromkeys(run["launches"], 0)
    for form, n in (("", steps * chunks_coord), ("_batched", steps * chunks_site + 1)):
        want[f"fd_gram{form}"] = want[f"fd_project{form}"] = n
    want.update(quadform=1, quadform_packed=1)
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
    step(batches[0])
    torch.cuda.synchronize()
    return profile_ingest(torch, lambda: [step(rows) for rows in batches[1:]],
                          len(batches) - 1)


def raw_profile(prof) -> tuple[dict, dict, dict]:
    """Device time (µs) and launches by kernel name, and ``aten::linalg_eigh``'s
    ``(calls, host µs)`` by input shapes, summed over the profiler's raw
    events.  A window of ingest holds up to millions of kernel launches
    (cuSOLVER's Jacobi ``eigh`` launches about a thousand a matrix), and
    ``key_averages()`` builds a Python object for each.  Only device-side
    events (kernels, copies) count as device time: a host op's device time
    repeats its kernels' time."""
    from torch.autograd import DeviceType

    dev: dict = {}
    count: dict = {}
    eigh: dict = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.is_hidden_event() or name in ("[memory]", "[OutOfMemory]"):
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                dev[name] = dev.get(name, 0.0) + e.duration_ns() / 1e3
                count[name] = count.get(name, 0) + 1
        elif name == "aten::linalg_eigh":
            calls, us = eigh.get(str(e.shapes()), (0, 0.0))
            eigh[str(e.shapes())] = (calls + 1, us + e.duration_ns() / 1e3)
    return dev, count, eigh


def profile_ingest(torch, fn, steps: int) -> dict:
    """``torch.profiler`` over ``fn()``, ``steps`` ingest steps or waves:
    device busy share, ``eigh``'s share of host time and calls by input
    shape, and the shrink kernels' device time beside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_call = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, _, eigh = raw_profile(prof)
    eigh_us = sum(us for _, us in eigh.values())
    busy_us = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    # The shrink kernels' device time beside eigh's host time.
    shrink_ms = {name: sum(v for k, v in dev.items() if f"{name}_kernel" in k) / 1e3
                 for name in ("fd_gram", "fd_project")}
    return dict(steps=steps, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / wall_us, eigh_host_ms=eigh_us / 1e3,
                eigh_host_share=eigh_us / wall_us, shrink_kernel_device_ms=shrink_ms,
                shrink_kernel_share_of_device_busy={
                    k: v * 1e3 / max(busy_us, 1e-30) for k, v in shrink_ms.items()},
                eigh_calls=sum(calls for calls, _ in eigh.values()),
                eigh_by_shape={k: dict(calls=calls, host_share=us / wall_us)
                               for k, (calls, us) in eigh.items()},
                top_device_ms={k: v / 1e3 for k, v in top},
                profiler_s=time.perf_counter() - t_call - wall_us / 1e6)


def profile_p2_ingest(torch, batches, steps: int) -> dict:
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
            kernel="levscore", shape=f"{label}: (N={n}, d={d})", pallas=PALLAS["levscore"],
            run=lambda m=m, x=x: ops.levscore(m, x),
            plain=lambda m=m, x=x: ref.ref_levscore(m, x),
            library=lambda m=m, x=x: (x @ m * x).sum(1), on_path=label == "score queries",
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


def stream_cutter(batches):
    """``take(n)``: the next n rows of the stream, a view of one of its
    batches (a batch's tail that cannot hold n is skipped); after the last
    batch it starts again from the first."""
    pos = [0, 0]

    def take(n: int):
        i, off = pos
        if off + n > batches[i].shape[0]:
            i, off = (i + 1) % len(batches), 0
        pos[:] = [i, off + n]
        return batches[i][off:off + n]

    return take


def pack_fleet():
    """The packed phase's tenants and their rows a wave."""
    sizes = {f"m{i}": n for i, n in enumerate(PACK_MATRIX_ROWS)}
    sizes.update({f"lev{i}": n for i, n in enumerate(PACK_LEV_ROWS)})
    return sizes


def pack_pipeline():
    """One pipeline of the packed phase: ``pack_fleet``'s tenants, m = 8,
    d = 1024, eps = 0.02, publishing every PACK_PUBLISH_EVERY steps."""
    from repro_torch.runtime import EveryKSteps, StreamingPipeline

    pipe = StreamingPipeline(M, eps=EPS, policy=EveryKSteps(PACK_PUBLISH_EVERY),
                             max_batch=4 * N_DIRS, default_deadline_s=3600.0, device=DEV)
    for name in pack_fleet():
        if name.startswith("lev"):
            pipe.add_leverage_tenant(name, D, engine="shard")
        else:
            pipe.add_tenant(name, D, protocol="P2")
    return pipe


def pack_answers(pipe, x, q) -> dict:
    """Every tenant's served answers on its latest version: ``||B x||^2`` on
    the kernel path for matrix tenants, subspace and score answers for
    leverage tenants."""
    out = {}
    for name in pipe.tenants():
        if pipe.workload(name) == "matrix":
            out[name] = {"matrix": pipe.engine.query_batch(x, tenant=name).estimates}
        else:
            out[name] = {k: pipe.engine.query_batch(q[k], tenant=name).estimates
                         for k in ("subspace", "score")}
    return out


def pack_state(pipe) -> dict:
    """Every tenant's rows, live mass, FD ``n_seen`` and ``CommReport``."""
    out = {}
    for name in pipe.tenants():
        target = pipe.tracker(name)
        st = getattr(target, "_proto", target).state
        out[name] = dict(rows=pipe.stats(name).rows, live_frob=pipe.stats(name).live_frob,
                         n_seen=[st.site_fd.n_seen.cpu().numpy(), st.coord_fd.n_seen.cpu().numpy()],
                         comm=target.comm_report().as_dict())
    return out


def compare_answers(got: dict, want: dict, mass: dict) -> dict:
    """Worst gap of each kind of answer: matrix and subspace answers in
    units of ``||A_t||_F^2``, score answers over ``SCORE_ATOL + SCORE_RTOL
    |want|`` (at most 1 passes)."""
    import numpy as np

    worst = {"matrix": 0.0, "subspace": 0.0, "score": 0.0}
    for name, kinds in want.items():
        for kind, w in kinds.items():
            g = got[name][kind]
            check(g.shape == w.shape and bool(np.isfinite(g).all()),
                  f"{name} {kind} answers are not finite {w.shape}")
            if kind == "score":
                gap = float((np.abs(g - w) / (SCORE_ATOL + SCORE_RTOL * np.abs(w))).max())
            else:
                gap = float(np.abs(g.astype(np.float64) - w).max()) / mass[name]
            worst[kind] = max(worst[kind], gap)
    return worst


def identical(a: dict, b: dict) -> bool:
    """Bit equality of two ``pack_answers`` results."""
    import numpy as np

    return all(np.array_equal(a[n][k], b[n][k]) for n in b for k in b[n])


def run_fleet(torch, waves, packed: bool) -> dict:
    """A fresh ``pack_pipeline`` through ``waves``: all but the last
    PACK_PROFILED_WAVES timed on the synchronised host clock, those under
    ``torch.profiler``."""
    pipe = pack_pipeline()
    timed = waves[: len(waves) - PACK_PROFILED_WAVES]
    torch.cuda.synchronize()
    secs = 0.0
    for wave in timed:
        t0 = time.perf_counter()
        pipe.ingest_many(wave, packed=packed)
        torch.cuda.synchronize()
        secs += time.perf_counter() - t0
    rows = sum(r.shape[0] for wave in timed for _, r in wave)
    prof = profile_ingest(
        torch, lambda: [pipe.ingest_many(w, packed=packed) for w in waves[len(timed):]],
        PACK_PROFILED_WAVES)
    return dict(pipe=pipe, ingest_s=secs, rows=rows, rows_per_s=rows / secs,
                stats=pipe.stats(), profile=prof)


def eigh_routine(torch, g) -> dict:
    """The device kernels of one ``torch.linalg.eigh`` of the batch ``g``,
    and the cuSOLVER routine they belong to (the library picks it by size
    and batch)."""
    from torch.profiler import ProfilerActivity, profile

    torch.linalg.eigh(g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        torch.linalg.eigh(g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, count, _ = raw_profile(prof)
    check(sum(dev.values()) > 0, "the profiler saw no device time in eigh")
    kernels = sorted(dev.items(), key=lambda kv: -kv[1])
    names = " ".join(k.lower() for k, _ in kernels)
    routine = ("syevjBatched (Jacobi, batched)" if "batch" in names and "syevj" in names
               else "syevj (Jacobi)" if "syevj" in names
               else "syevd (tridiagonal reduction + divide and conquer)"
               if any(w in names for w in ("sytrd", "stedc", "ormtr", "syevd", "latrd"))
               else "not recognised from its kernel names")
    return dict(batch=list(g.shape), routine=routine, wall_ms=wall_ms,
                device_busy_ms=sum(dev.values()) / 1e3, launches=sum(count.values()),
                top_kernels_ms={k: v / 1e3 for k, v in kernels[:6]},
                top_kernels_count={k: count[k] for k, _ in kernels[:6]})


def drive_packed(torch, batches, l_site: int) -> dict:
    """Path 4: two ``pack_pipeline``s fed the same waves, one through
    ``ingest_many(packed=False)``, then — launch counts set to 0 — one
    through ``ingest_many(packed=True)``, saved while its tenants' states
    still sit in the pack, loaded back on the card, and one more packed wave
    into both; the served answers of each stage."""
    import tempfile

    import numpy as np

    from repro_torch.kernels import fd_ops, ops
    from repro_torch.runtime import StreamingPipeline

    t_phase = time.perf_counter()
    stages: dict = {}

    def lap(stage: str) -> None:
        """Seconds since the last lap, under ``stage``."""
        now = time.perf_counter()
        stages[stage] = now - sum(stages.values()) - t_phase

    take = stream_cutter(batches)
    fleet = pack_fleet()
    waves = [[(name, take(n)) for name, n in fleet.items() if not (w == 0 and name == PACK_COLD)]
             for w in range(PACK_WAVES + 1)]
    tail = waves.pop()
    mass = {name: 0.0 for name in fleet}
    for wave in waves:
        for name, rows in wave:
            mass[name] += float(rows.double().square().sum())
    tail_mass = {name: mass[name] + float(rows.double().square().sum()) for name, rows in tail}
    gen = torch.Generator(device=DEV).manual_seed(10)
    x = unit_dirs(torch, gen, N_DIRS).cpu().numpy()
    q = {k: np.concatenate([np.full((N_DIRS, 1), mode, np.float32),
                            unit_dirs(torch, gen, N_DIRS).cpu().numpy()], axis=1)
         for k, mode in (("subspace", 0.0), ("score", 1.0))}
    n_sites = len(PACK_MATRIX_ROWS) * M
    per = batches[0].shape[0]
    buf = torch.cat([take(per) for _ in range(-(-n_sites * 2 * l_site // per))])
    routine = eigh_routine(torch, fd_ops.fd_gram(
        buf[: n_sites * 2 * l_site].reshape(n_sites, 2 * l_site, D).contiguous()))
    del buf
    lap("set-up and eigh routine")

    serial = run_fleet(torch, waves, packed=False)
    lap("serial waves")
    for name in fleet:
        serial["pipe"].publish(name)
    serial.update(answers=pack_answers(serial["pipe"], x, q), state=pack_state(serial["pipe"]))
    lap("serial publish and answers")

    ops.reset_launch_counts()
    packed = run_fleet(torch, waves, packed=True)
    lap("packed waves")
    pipe = packed["pipe"]
    in_pack = sum(getattr(pipe.tracker(n), "_proto", pipe.tracker(n))._pack_slot is not None
                  for n in fleet)
    check(in_pack == len(fleet), f"{in_pack} of {len(fleet)} tenants' states in the pack at save")
    before = pack_answers(pipe, x, q)  # the versions published during the waves
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pipe.save(tmp)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        loaded = StreamingPipeline.load(tmp, M, device=DEV, max_batch=4 * N_DIRS,
                                        default_deadline_s=3600.0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    lap("save and load")
    leaves_equal = all(
        all(np.array_equal(a[k], b[k]) for k in b)
        for a, b in ((loaded._tenant(n).adapter.state_payload()[0],
                      pipe._tenant(n).adapter.state_payload()[0]) for n in fleet))
    after_load = pack_answers(loaded, x, q)
    for name in fleet:
        pipe.publish(name)
    packed.update(answers=pack_answers(pipe, x, q), state=pack_state(pipe))
    loaded_bitwise = identical(after_load, before)
    for p_ in (pipe, loaded):
        p_.ingest_many(tail, packed=True)
        for name in fleet:
            p_.publish(name)
    tail_answers = {"packed": pack_answers(pipe, x, q), "loaded": pack_answers(loaded, x, q)}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    lap("checks and the tail wave")
    return dict(serial=serial, packed=packed, loaded=loaded, mass=mass, tail_mass=tail_mass,
                eigh_routine=routine, save_s=save_s, load_s=load_s, bytes=nbytes,
                leaves_equal=leaves_equal, loaded_bitwise=loaded_bitwise,
                tail_answers=tail_answers, launches=launches, stages_s=stages,
                phase_s=time.perf_counter() - t_phase)


def check_packed(prun) -> dict:
    """Packed against serial for every tenant, and the checkpoint."""
    import numpy as np

    serial, packed = prun["serial"], prun["packed"]
    for name, want in serial["state"].items():
        got = packed["state"][name]
        check(got["rows"] == want["rows"], f"{name}: {got['rows']} rows packed, {want['rows']} serial")
        check(all(np.array_equal(a, b) for a, b in zip(got["n_seen"], want["n_seen"])),
              f"{name}: n_seen differs between packed and serial ingest")
        rel = abs(got["live_frob"] - want["live_frob"]) / max(abs(want["live_frob"]), 1e-30)
        check(rel <= PACK_FROB_RTOL, f"{name}: live frob packed vs serial {rel:.2e} relative")
    gaps = compare_answers(packed["answers"], serial["answers"], prun["mass"])
    check(gaps["matrix"] <= PACK_TOL and gaps["subspace"] <= PACK_TOL and gaps["score"] <= 1.0,
          f"packed vs serial answers: {gaps} (limits {PACK_TOL} ||A_t||_F^2, score 1)")
    check(prun["leaves_equal"], "a state leaf differs right after the load")
    check(prun["loaded_bitwise"], "served answers differ right after the load")
    tail_gaps = compare_answers(prun["tail_answers"]["loaded"], prun["tail_answers"]["packed"],
                                prun["tail_mass"])
    check(tail_gaps["matrix"] <= PACK_TOL and tail_gaps["subspace"] <= PACK_TOL
          and tail_gaps["score"] <= 1.0,
          f"loaded vs packed after one more wave: {tail_gaps} (limits {PACK_TOL} ||A_t||_F^2)")
    s = packed["stats"]
    check(s["packed_launches"] > 0 and prun["serial"]["stats"]["packed_launches"] == 0,
          "the packed pipeline made no packed launch, or the serial one did")
    for name in PACK_KERNELS:
        check(prun["launches"][name] > 0, f"kernel {name} was not launched on the packed path")
    check(prun["launches"]["flash_attention"] == 0, "the packed path launched flash_attention")
    comm = {n: (packed["state"][n]["comm"]["total"], serial["state"][n]["comm"]["total"])
            for n in serial["state"]}
    return dict(packed_vs_serial=gaps, loaded_vs_packed_after_tail=tail_gaps, comm_totals=comm,
                comm_equal=all(a == b for a, b in comm.values()))


def zipfian_stream(n: int, *, skew: float = 2.0, universe: int = 10_000, beta: float = 1000.0,
                   seed: int = 0):
    """A numpy copy of the reference's ``data.synthetic.zipfian_stream``
    (src/repro/data/synthetic.py:24-29): zipf(skew) keys, U[1, beta] weights."""
    import numpy as np

    rng = np.random.default_rng(seed)
    keys = (rng.zipf(skew, size=n) % universe).astype(np.int64)
    weights = rng.uniform(1.0, beta, size=n)
    return keys, weights


def hq_streams(seed: int) -> dict:
    """Path 5's two streams from ``seed`` (seed 0: the reference benchmarks'
    seeds 11 and 21): HH_ITEMS (key, weight) items and Q_ITEMS (value,
    weight) items, as (items, 2) host arrays."""
    import numpy as np

    keys, w = zipfian_stream(HH_ITEMS, beta=1000.0, universe=HH_KEYS, seed=seed + 11)
    values = np.random.default_rng(seed + 21).lognormal(3.0, 1.5, Q_ITEMS).astype(np.float32)
    _, qw = zipfian_stream(Q_ITEMS, beta=100.0, universe=50_000, seed=seed + 21)
    return {"hh": (keys, w), "q": (values.astype(np.float64), qw)}


def hq_waves(streams: dict, batches) -> list[list[tuple]]:
    """HQ_WAVES waves of ``(tenant, batch)``: each stream cut in HQ_WAVES
    equal slices (the event tenants' EVENT_ITEMS likewise), the matrix
    tenant's HQ_MATRIX_ROWS rows in the first HQ_MATRIX_WAVES."""
    def cut(pair, n, w):
        per = n // HQ_WAVES
        return tuple(a[w * per:(w + 1) * per] for a in pair)

    waves = []
    for w in range(HQ_WAVES):
        wave = [("hh", cut(streams["hh"], HH_ITEMS, w)), ("q", cut(streams["q"], Q_ITEMS, w))]
        wave += [(name, cut(streams[kind], EVENT_ITEMS, w))
                 for name, kind in (("hh-ev-p1", "hh"), ("hh-ev-p2", "hh"), ("q-ev-p1", "q"))]
        if w < HQ_MATRIX_WAVES:
            wave.append(("matrix", batches[w % len(batches)][:HQ_MATRIX_ROWS]))
        waves.append(wave)
    return waves


def hq_pipeline():
    """Path 5's pipeline: HH (super-step P1, event P1 and P2), quantile
    (super-step P1, event P1) and one matrix P2 tenant, m = HQ_M."""
    from repro_torch.runtime import OnDemand, StreamingPipeline

    pipe = StreamingPipeline(HQ_M, eps=HQ_EPS, policy=OnDemand(), max_batch=8 * N_DIRS,
                             default_deadline_s=3600.0, device=DEV)
    pipe.add_hh_tenant("hh", engine="shard")
    pipe.add_hh_tenant("hh-ev-p1", engine="event")
    pipe.add_hh_tenant("hh-ev-p2", protocol="P2", engine="event")
    pipe.add_quantile_tenant("q", engine="shard")
    pipe.add_quantile_tenant("q-ev-p1", engine="event")
    pipe.add_tenant("matrix", D, eps=EPS, protocol="P2")
    return pipe


def hq_queries(torch, streams: dict, seed: int) -> dict:
    """The served queries, N_DIRS of each kind.  HH: the true phi-heavy
    keys and random ids; quantile: half rank queries at stream values, half
    phi-quantile queries (phi in f32, as a query row carries it); matrix:
    unit directions."""
    import numpy as np

    from repro_torch.core.hh import exact_heavy_hitters

    rng = np.random.default_rng(seed + 31)
    heavy, _, _ = exact_heavy_hitters(*streams["hh"], HQ_PHI)
    ids = np.concatenate([np.array(sorted(heavy), np.int64),
                          rng.integers(0, HH_KEYS, N_DIRS - len(heavy))])
    values = rng.choice(streams["q"][0], N_DIRS // 2)
    phis = rng.uniform(0.01, 0.99, N_DIRS - N_DIRS // 2).astype(np.float32).astype(np.float64)
    q = np.concatenate([np.stack([np.zeros_like(values), values], 1),
                        np.stack([np.ones_like(phis), phis], 1)]).astype(np.float32)
    gen = torch.Generator(device=DEV).manual_seed(seed + 32)
    x = unit_dirs(torch, gen, N_DIRS).cpu().numpy()
    return {"ids": ids.astype(np.float32)[:, None], "q": q, "x": x, "phis": phis,
            "heavy": sorted(heavy)}


def hq_answers(pipe, queries) -> dict:
    """Every tenant's served answers: ``query_batch`` and one mixed
    ``query_packed``, the heavy-hitter sets and the phi-quantiles."""
    from repro_torch.query import PackedRequest

    eng = pipe.engine
    per = {"hh": queries["ids"], "hh-ev-p1": queries["ids"], "hh-ev-p2": queries["ids"],
           "q": queries["q"], "q-ev-p1": queries["q"], "matrix": queries["x"]}
    out = {name: eng.query_batch(x, tenant=name).estimates for name, x in per.items()}
    packed = eng.query_packed([PackedRequest(name, x) for name, x in per.items()])
    out.update({f"packed {r.tenant}": r.estimates for r in packed})
    for name in ("hh", "hh-ev-p1", "hh-ev-p2"):
        out[f"heavy_hitters {name}"] = pipe.heavy_hitters(name, HQ_PHI)
    for name in ("q", "q-ev-p1"):
        out[f"quantiles {name}"] = pipe.quantiles(name, queries["phis"])
    return out


def hq_identical(a: dict, b: dict, skip=()) -> bool:
    """Bit equality of two ``hq_answers`` results (keys in ``skip`` aside)."""
    import numpy as np

    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in b if k not in skip)


class _Recorder:
    """Records the first call of a kernel wrapper in ``ops`` whose inputs
    ``want(*args)`` accepts, passing every call through."""

    def __init__(self, ops, name, want):
        self.ops, self.name, self.want, self.args = ops, name, want, None
        self.real = getattr(ops, name)

    def __call__(self, *args):
        if self.args is None and self.want(*args):
            self.args = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
        return self.real(*args)

    def __enter__(self):
        setattr(self.ops, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.real)


def drive_hq(torch, batches, seed: int) -> dict:
    """Path 5: ``hq_pipeline`` ingests HQ_WAVES waves (launch counts set to 0
    first; each tenant's ingest timed on the synchronised host clock, the
    last HQ_PROFILED_WAVES under ``torch.profiler``), publishes and serves
    ``hq_queries`` through ``query_batch`` and ``query_packed``; then —
    outside the counted window — saves the pipeline, loads it on the card
    and feeds one more wave into both.  The first wave records the kernels'
    inputs at the path's shapes: the site scan of ``mg_scan``, the site
    inserts and one coordinator merge of ``quant_pack``."""
    import tempfile

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.query import PackedRequest
    from repro_torch.runtime import StreamingPipeline

    t_phase = time.perf_counter()
    streams = hq_streams(seed)
    waves = hq_waves(streams, batches)
    queries = hq_queries(torch, streams, seed)
    pipe = hq_pipeline()
    names = [name for name, _ in waves[0]]
    ingest_s = dict.fromkeys(names, 0.0)
    items = dict.fromkeys(names, 0)
    timed = HQ_WAVES - HQ_PROFILED_WAVES

    def feed(wave, clock: bool) -> None:
        for name, batch in wave:
            t0 = time.perf_counter()
            pipe.ingest(name, batch)
            torch.cuda.synchronize()
            if clock:
                ingest_s[name] += time.perf_counter() - t0
                items[name] += len(batch[0]) if isinstance(batch, tuple) else batch.shape[0]

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with _Recorder(ops, "mg_scan", lambda *a: a[0].shape[0] == HQ_M) as rec_mg, \
            _Recorder(ops, "quant_pack", lambda *a: a[0].shape[0] == HQ_M) as rec_site, \
            _Recorder(ops, "quant_pack", lambda *a: a[0].shape[0] == 1) as rec_coord:
        feed(waves[0], clock=True)
    for wave in waves[1:timed]:
        feed(wave, clock=True)
    prof = profile_hq(torch, lambda: [feed(w, clock=False) for w in waves[timed:]])
    t0 = time.perf_counter()
    snaps = {name: pipe.publish(name) for name in names}
    publish_s = time.perf_counter() - t0
    answers = hq_answers(pipe, queries)
    eng = pipe.engine
    latency = time_calls({
        "hh query_batch": (N_DIRS, lambda: eng.query_batch(queries["ids"], tenant="hh")),
        "quantile query_batch": (N_DIRS, lambda: eng.query_batch(queries["q"], tenant="q")),
        "matrix query_batch": (N_DIRS, lambda: eng.query_batch(queries["x"], tenant="matrix")),
        "mixed query_packed (hh, q, matrix)": (3 * N_DIRS, lambda: eng.query_packed([
            PackedRequest("hh", queries["ids"]), PackedRequest("q", queries["q"]),
            PackedRequest("matrix", queries["x"])])),
        "heavy_hitters": (1, lambda: pipe.heavy_hitters("hh", HQ_PHI)),
        "quantiles": (len(queries["phis"]), lambda: pipe.quantiles("q", queries["phis"])),
    })
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    hq_s = time.perf_counter() - t_phase

    # The checkpoint, outside the counted window.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pipe.save(tmp)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        loaded = StreamingPipeline.load(tmp, HQ_M, device=DEV, max_batch=8 * N_DIRS,
                                        default_deadline_s=3600.0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    leaves_equal = all(
        all(np.array_equal(a[k], b[k]) for k in b)
        for a, b in ((loaded._tenant(n).adapter.state_payload()[0],
                      pipe._tenant(n).adapter.state_payload()[0]) for n in names))
    loaded_bitwise = hq_identical(hq_answers(loaded, queries), answers)
    tail = [(name, waves[0][i][1]) for i, name in enumerate(names)]
    for p_ in (pipe, loaded):
        for name, batch in tail:
            p_.ingest(name, batch)
            p_.publish(name)
    tail_answers = {"uninterrupted": hq_answers(pipe, queries), "loaded": hq_answers(loaded, queries)}
    torch.cuda.synchronize()
    return dict(pipe=pipe, streams=streams, queries=queries, snaps=snaps, answers=answers,
                ingest_s=ingest_s, items=items, publish_s=publish_s, latency=latency,
                profile=prof, launches=launches, save_s=save_s, load_s=load_s, bytes=nbytes,
                leaves_equal=leaves_equal, loaded_bitwise=loaded_bitwise,
                tail_answers=tail_answers, tail=tail, batches=batches, hq_s=hq_s,
                recorded={"mg_scan": rec_mg.args, "quant_pack site": rec_site.args,
                          "quant_pack coord": rec_coord.args},
                phase_s=time.perf_counter() - t_phase)


def profile_hq(torch, fn) -> dict:
    """``torch.profiler`` over ``fn()`` (path 5's last waves): device busy
    share, and the device time and launches of the two sequential kernels
    (summed from the raw events, as ``raw_profile`` does)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, count, _ = raw_profile(prof)
    busy_us = sum(dev.values())
    check(busy_us > 0, "the profiler saw no device time in path 5's waves")
    kernels = {}
    for name in ("mg_scan", "quant_pack"):
        us = sum(v for k, v in dev.items() if f"{name}_kernel" in k)
        n = sum(c for k, c in count.items() if f"{name}_kernel" in k)
        kernels[name] = dict(device_ms=us / 1e3, launches=n, us_a_launch=us / max(n, 1))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return dict(waves=HQ_PROFILED_WAVES, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / wall_us, device_launches=sum(count.values()),
                kernels=kernels, top_device_ms={k: v / 1e3 for k, v in top})


def check_hq(torch, hq) -> dict:
    """Path 5's answers against the truth counted in f64 on the host, and its
    launches: HH estimates of every key within ``err_factor * eps * W`` and
    recall 1 of the phi-heavy set; the worst rank error of the 1024 quantile
    probes within ``err_factor * eps * W``; matrix answers within 2 eps
    ``||A||_F^2`` of dense truth; ``query_packed`` answers equal to
    ``query_batch``'s; the checkpoint bit-identical."""
    import numpy as np

    from repro_torch.core.hh import decode_hh_snapshot
    from repro_torch.core.quantiles import exact_ranks
    from repro_torch.runtime import get_spec

    ans, q, streams = hq["answers"], hq["queries"], hq["streams"]
    out = {"hh": {}, "quantile": {}}
    for name, proto, engine, n in (("hh", "P1", "shard", HH_ITEMS),
                                   ("hh-ev-p1", "P1", "event", EVENT_ITEMS),
                                   ("hh-ev-p2", "P2", "event", EVENT_ITEMS)):
        keys, w = (a[:n] for a in streams["hh"])
        truth = np.bincount(keys, weights=w, minlength=HH_KEYS)
        w_total = float(w.sum())
        est = np.zeros(HH_KEYS)
        for e, v in decode_hh_snapshot(hq["snaps"][name].matrix).items():
            est[e] = v
        factor = get_spec(proto, engine, "hh").err_factor
        err = float(np.abs(est - truth).max()) / w_total
        check(err <= factor * HQ_EPS,
              f"{name}: max |estimate - weight| = {err:.3e} W > {factor} eps W")
        heavy = {int(e) for e in np.nonzero(truth >= HQ_PHI * w_total)[0]}
        found = set(ans[f"heavy_hitters {name}"])
        recall = len(heavy & found) / max(len(heavy), 1)
        check(recall == 1.0, f"{name}: recall {recall} of the {HQ_PHI}-heavy set {sorted(heavy)}")
        served = ans[name]
        check(np.array_equal(served, est[q["ids"][:, 0].astype(np.int64)].astype(np.float32)),
              f"{name}: served lookups differ from the published estimates")
        out["hh"][name] = dict(max_err_over_w=err, limit=factor * HQ_EPS, heavy=sorted(heavy),
                               found=sorted(found), recall=recall,
                               precision=len(heavy & found) / max(len(found), 1))
    for name, proto, engine, n in (("q", "P1", "shard", Q_ITEMS),
                                   ("q-ev-p1", "P1", "event", EVENT_ITEMS)):
        values, w = (a[:n] for a in streams["q"])
        w_total = float(w.sum())
        served = ans[name].astype(np.float64)
        is_rank = q["q"][:, 0] == 0.0
        rank_err = np.abs(served[is_rank] - exact_ranks(values, w, q["q"][is_rank, 1])) / w_total
        quant_err = np.abs(exact_ranks(values, w, served[~is_rank])
                           - q["q"][~is_rank, 1].astype(np.float64) * w_total) / w_total
        worst = float(max(rank_err.max(), quant_err.max()))
        factor = get_spec(proto, engine, "quantile").err_factor
        check(worst <= factor * HQ_EPS, f"{name}: worst rank error {worst:.3e} W > {factor} eps W")
        check(np.array_equal(ans[f"quantiles {name}"].astype(np.float32),
                             ans[name][~is_rank]),
              f"{name}: quantiles() differs from the served phi-quantile queries")
        out["quantile"][name] = dict(worst_rank_err_over_w=worst, limit=factor * HQ_EPS,
                                     rank_probes=int(is_rank.sum()),
                                     quantile_probes=int((~is_rank).sum()))
    rows = torch.cat([hq["batches"][w % len(hq["batches"])][:HQ_MATRIX_ROWS]
                      for w in range(HQ_MATRIX_WAVES)]).double()
    ata = rows.T @ rows
    frob = float(torch.diagonal(ata).sum())
    x = torch.tensor(q["x"], device=DEV, dtype=torch.float64)
    truth = ((x @ ata) * x).sum(1).cpu().numpy()
    mat_gap = float(np.abs(ans["matrix"] - truth).max()) / frob
    check(mat_gap <= 2 * EPS, f"path 5 matrix tenant gap {mat_gap} > 2 eps ||A||_F^2")
    for name in ("hh", "hh-ev-p1", "hh-ev-p2", "q", "q-ev-p1", "matrix"):
        check(np.array_equal(ans[f"packed {name}"], ans[name]),
              f"{name}: query_packed answers differ from query_batch's")
    for name in HQ_KERNELS:
        check(hq["launches"][name] > 0, f"kernel {name} was not launched on path 5")
    check(hq["launches"]["levscore"] == 0 and hq["launches"]["flash_attention"] == 0,
          f"path 5 launched a kernel it does not run: {hq['launches']}")
    check(hq["leaves_equal"], "path 5: a state leaf differs right after the load")
    check(hq["loaded_bitwise"], "path 5: served answers differ right after the load")
    after = hq["tail_answers"]
    check(hq_identical(after["loaded"], after["uninterrupted"], skip=("matrix", "packed matrix")),
          "path 5: after one more wave the loaded pipeline answers differently")
    mass = frob + float(hq["batches"][0][:HQ_MATRIX_ROWS].double().square().sum())
    tail_gap = max(float(np.abs(after["loaded"][k].astype(np.float64)
                                - after["uninterrupted"][k]).max()) / mass
                   for k in ("matrix", "packed matrix"))
    check(tail_gap <= PACK_TOL, f"path 5 matrix after one more wave: {tail_gap} ||A||_F^2")
    return dict(out, matrix_gap=mat_gap, tail_matrix_gap=tail_gap,
                comm={n: hq["pipe"].tracker(n).comm_report().as_dict()
                      for n in hq["pipe"].tenants()})


def hq_cases(torch, hq) -> list[dict]:
    """``mg_scan`` and ``quant_pack`` at path 5's shapes, on the inputs the
    first wave gave them: the site scan (50 summaries x one wave's items),
    the 50 site inserts and one coordinator merge.  Bit for bit against the
    plain step-by-step loops, whose device time is taken over 2 calls (each
    is tens of thousands of launches)."""
    from repro_torch.kernels import ops, ref

    def flat(out):
        return torch.cat([t.double().flatten() for t in out])

    cases = []
    args = hq["recorded"]["mg_scan"]
    check(args is not None, "path 5's first wave recorded no mg_scan call")
    s, k = args[0].shape
    b = args[4].shape[1]
    cases.append(dict(
        kernel="mg_scan", shape=f"site scan: (S={s}, k={k}, b={b})", pallas=NO_PALLAS["mg_scan"],
        run=lambda a=args: flat(ops.mg_scan(*a)), plain=lambda a=args: flat(ref.ref_mg_scan(*a)),
        library=None, exact=True, plain_reps=2, chain_steps=b, on_path=True,
        # Each item compares every slot, at least: S b k operations.
        flops=float(s * b * k), nbytes=8.0 * (2 * s * k + 2 * s + s * b),
    ))
    for label, key in (("site inserts", "quant_pack site"), ("coordinator merge", "quant_pack coord")):
        args = hq["recorded"][key]
        check(args is not None, f"path 5's first wave recorded no quant_pack call ({label})")
        t, n = args[0].shape
        cap = args[5]
        cases.append(dict(
            kernel="quant_pack", shape=f"{label}: (T={t}, n={n}, cap={cap})",
            pallas=NO_PALLAS["quant_pack"],
            run=lambda a=args: flat(ops.quant_pack(*a)),
            plain=lambda a=args: flat(ref.ref_quant_pack(*a)),
            library=None, exact=True, plain_reps=2, chain_steps=n, on_path=True,
            # About eight f32 additions and comparisons a tuple.
            flops=8.0 * t * n, nbytes=4.0 * (4 * t * n + t + 4 * t * cap),
        ))
    return cases

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
            pallas=PALLAS["flash_attention"],
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
            rate=FLOPS_BF16 if bf16 else FLOPS_F32, on_path=label == "serving prefill",
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
    prof = profile_p2_ingest(torch, batches, min(8, args.steps - 1)) if args.steps > 1 else {}
    lev_prof = profile_leverage_ingest(torch, lev_batches, min(8, args.lev_steps - 1))

    # Path 4: packed multi-tenant ingest against serial, and a checkpoint.
    pk = drive_packed(torch, batches, cfg.l_site)
    pack_checks = check_packed(pk)

    # Path 5: heavy-hitter and quantile tenants beside a matrix tenant, and a checkpoint.
    hq = drive_hq(torch, batches, args.seed)
    hq_checks = check_hq(torch, hq)
    cases += run_kernel_cases(torch, hq_cases(torch, hq))
    for key in ("pipe", "batches", "tail", "recorded"):
        del hq[key]
    del batches, ata, lev_batches
    for key in ("serial", "packed"):
        del pk[key]["pipe"]
    del pk["loaded"]
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
    pack_rows = sum(PACK_MATRIX_ROWS) + sum(PACK_LEV_ROWS)
    summary["packed_ingest"] = dict(
        tenants=dict(matrix_P2=len(PACK_MATRIX_ROWS), leverage_P1=len(PACK_LEV_ROWS)),
        rows_a_wave=pack_rows, cold=PACK_COLD, waves=PACK_WAVES,
        profiled_waves=PACK_PROFILED_WAVES, publish_every=PACK_PUBLISH_EVERY,
        rows=PACK_WAVES * pack_rows - PACK_MATRIX_ROWS[int(PACK_COLD[1:])],
        **{mode: dict(rows_timed=pk[mode]["rows"], ingest_s=pk[mode]["ingest_s"],
                      rows_per_s=pk[mode]["rows_per_s"], stats=pk[mode]["stats"],
                      profile=pk[mode]["profile"]) for mode in ("serial", "packed")},
        eigh_routine=pk["eigh_routine"], save_s=pk["save_s"], load_s=pk["load_s"],
        checkpoint_bytes=pk["bytes"], leaves_equal=pk["leaves_equal"],
        answers_bit_identical_after_load=pk["loaded_bitwise"], checks=pack_checks,
        launches=pk["launches"], phase_s=pk["phase_s"], stages_s=pk["stages_s"],
    )
    summary["hq_path"] = dict(
        m=HQ_M, eps=HQ_EPS, waves=HQ_WAVES, profiled_waves=HQ_PROFILED_WAVES,
        items=dict(hh=HH_ITEMS, quantile=Q_ITEMS, event=EVENT_ITEMS,
                   matrix_rows=HQ_MATRIX_WAVES * HQ_MATRIX_ROWS),
        items_per_s={n: hq["items"][n] / hq["ingest_s"][n] for n in hq["items"]},
        ingest_s=hq["ingest_s"], publish_s=hq["publish_s"], latency=hq["latency"],
        profile=hq["profile"], launches=hq["launches"], save_s=hq["save_s"],
        load_s=hq["load_s"], checkpoint_bytes=hq["bytes"], leaves_equal=hq["leaves_equal"],
        answers_bit_identical_after_load=hq["loaded_bitwise"], checks=hq_checks,
        window_s=hq["hq_s"], phase_s=hq["phase_s"],
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
        # The heaviest of the path's shapes stands for the kernel.
        main = max([c for c in mine if c["on_path"]] or mine, key=lambda c: c["gflop"])
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{main['source']}",
            replaces=PALLAS.get(name) or NO_PALLAS[name],
            launches=(run["launches"][name] + prun["launches"][name] + pk["launches"][name]
                      + hq["launches"][name] + srun["launches"][name]),
            max_abs_err=max(c["max_abs_err"] for c in mine), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"], shapes=mine,
            **({"chain_bound_ms": main["chain_bound_ms"]} if "chain_bound_ms" in main else {}),
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
    pi = summary["packed_ingest"]
    print(f"packed ingest: {len(PACK_MATRIX_ROWS)} P2 + {len(PACK_LEV_ROWS)} leverage P1 tenants "
          f"a pipeline, {pi['rows']} rows in {PACK_WAVES} waves ({PACK_PROFILED_WAVES} profiled); "
          f"phase {pi['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in pi["stages_s"].items()))
    for mode in ("serial", "packed"):
        r, st, p = pi[mode], pi[mode]["stats"], pi[mode]["profile"]
        print(f"packed ingest, {mode}: {r['rows_per_s']:.0f} rows/s over {r['rows_timed']} rows "
              f"(synchronised host clock); packed_launches {st['packed_launches']}, restacks "
              f"{st['restacks']}, pad_rows {st['pad_rows']}, pack_occupancy "
              f"{st['pack_occupancy']:.4f}, shrink_launches {st['shrink_launches']}; profile of "
              f"{p['steps']} waves: eigh {p['eigh_host_ms']:.1f} of {p['wall_ms']:.1f} ms host "
              f"({p['eigh_host_share']:.1%}), {p['eigh_calls']} eigh calls, device busy "
              f"{p['device_busy_share']:.1%}; the profiler's own {p['profiler_s']:.1f} s")
    er = pi["eigh_routine"]
    print(f"eigh of a {tuple(er['batch'])} batch: {er['routine']}; {er['device_busy_ms']:.2f} ms "
          f"device, {er['launches']} launches; kernels {json.dumps(er['top_kernels_count'])}")
    pc = pi["checks"]
    print(f"packed vs serial: worst gap matrix {pc['packed_vs_serial']['matrix']:.2e} and "
          f"subspace {pc['packed_vs_serial']['subspace']:.2e} ||A_t||_F^2 (limit {PACK_TOL}), "
          f"score {pc['packed_vs_serial']['score']:.3f} of its tolerance; CommReport totals "
          f"packed / serial {json.dumps(pc['comm_totals'])}")
    print(f"checkpoint of the packed pipeline: save {pi['save_s']:.2f} s, load {pi['load_s']:.2f} "
          f"s, {pi['checkpoint_bytes']} bytes; state leaves equal {pi['leaves_equal']}, answers "
          f"bit-identical after the load {pi['answers_bit_identical_after_load']}; after one more "
          f"wave matrix {pc['loaded_vs_packed_after_tail']['matrix']:.2e}, subspace "
          f"{pc['loaded_vs_packed_after_tail']['subspace']:.2e} ||A_t||_F^2, score "
          f"{pc['loaded_vs_packed_after_tail']['score']:.3f} of its tolerance")
    hp = summary["hq_path"]
    print(f"path 5, heavy hitters and quantiles (m = {HQ_M}, eps = {HQ_EPS}; {card}): items/s "
          + ", ".join(f"{n} {v:.0f}" for n, v in hp["items_per_s"].items())
          + f" over {HQ_WAVES - HQ_PROFILED_WAVES} waves (synchronised host clock); window "
          f"{hp['window_s']:.1f} s, phase {hp['phase_s']:.1f} s")
    hk = hp["profile"]["kernels"]
    print(f"path 5 profile of {HQ_PROFILED_WAVES} waves: device busy "
          f"{hp['profile']['device_busy_share']:.1%} of {hp['profile']['wall_ms']:.1f} ms; "
          + "; ".join(f"{n} {v['launches']} launches, {v['us_a_launch']:.1f} us a launch"
                      for n, v in hk.items())
          + f"; launches in the window {json.dumps({k: hp['launches'][k] for k in HQ_KERNELS})}")
    for n, v in hp["checks"]["hh"].items():
        print(f"path 5 {n}: max |estimate - weight| {v['max_err_over_w']:.3e} W (limit "
              f"{v['limit']}), recall {v['recall']}, precision {v['precision']:.3f}, "
              f"heavy {v['heavy']}")
    for n, v in hp["checks"]["quantile"].items():
        print(f"path 5 {n}: worst rank error {v['worst_rank_err_over_w']:.3e} W over "
              f"{v['rank_probes']} + {v['quantile_probes']} probes (limit {v['limit']})")
    print("path 5 latency: " + "; ".join(
        f"{k} {v['directions'] / v['qps_median'] * 1e3:.3f} ms median "
        f"({v['directions'] / v['qps_fastest'] * 1e3:.3f}-{v['directions'] / v['qps_slowest'] * 1e3:.3f})"
        for k, v in hp["latency"].items()))
    print(f"path 5 checkpoint: save {hp['save_s']:.2f} s, load {hp['load_s']:.2f} s, "
          f"{hp['checkpoint_bytes']} bytes; leaves equal {hp['leaves_equal']}, answers "
          f"bit-identical {hp['answers_bit_identical_after_load']}; after one more wave the "
          f"matrix tenant within {hp['checks']['tail_matrix_gap']:.2e} ||A||_F^2, the rest "
          f"bit-identical")
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
