#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths once on one GPU and check them.

    python3 chip_smoke.py [--seed 0] [--steps 64] [--lev-steps 16] [--serve-prompt 4096]
                          [--train-ckpt] [--out report.json]

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
   ``flash_attention.cu`` must also hold TMA loads (``UTMALDG``) and its
   kernels no spills;
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
   the plain version in f32 on the same bf16 inputs), at a ragged,
   windowed, soft-capped one in bf16 (the same check) and in f32
   (``KERNEL_RTOL``), and at the f32 serving check's shape (b = 1, hq = 16,
   hkv = 8, s = 512 and 520, dh = 128, f32, causal: ``KERNEL_RTOL``), timing
   SDPA beside the causal shapes;
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
   within 2e-3 of the plain ``xla`` prefill; the f32 kernel must run once a
   layer in the prefill and in each full forward (and its second pass as
   often where ``flash_split`` splits); one more prefill under
   ``torch.profiler`` gives its wall time and the kernel's share of its
   device time;
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
   gives the uninterrupted pipeline's answers.  The wave's quantile
   coordinator must fold its 50 shipped summaries in one ``quant_fold``
   launch, and ``mg_scan`` must take its route with the slots in registers.
   ``mg_scan`` (one wave's site scan), ``quant_merge_pack`` (the 50 site
   inserts) and ``quant_fold`` (the coordinator's fold of 50 summaries) are
   held bit for bit to their plain versions, run on CPU copies of the inputs
   the first wave gave them (a CUDA ``cumsum`` would round elsewhere), and
   timed beside a chain bound (their dependent steps over live tuples); the
   plain versions on the host clock, the fold's once.  Each tenant's
   items/s are reported over the timed waves and at the median wave, beside
   the garbage collector's pauses in those waves;
13. after 12, path 6: shard P3 through ``DistributedMatrixTracker`` (m = 8,
   d = 1024, eps = 0.02, so s = 9,781) on the 64 super-steps of 3, each
   timed; the reference's check ``||A^T A - B^T B||_2 < 2 eps ||A||_F^2``
   against the f64 truth, fewer messages than rows, 256 served directions
   within the spec's ``1.5 eps ||A||_F^2``, and two steps run twice from one
   state bit-equal; one ``query_batch`` of 1,024 directions must launch
   ``quadform`` at L = 9,782, which is held against its plain version there
   and on a tall ragged stack on offset views, beside the library call.
   Then one ``StreamingPipeline`` of windowed tenants (shard flavour, 8
   software sites, ``OnWindowClose`` each): ``P2win`` and ``P1win`` leverage
   on 2,048 rows of 3's stream a batch, ``P2decay`` (half-life 8) on the
   same rows, ``P1win`` HH and quantile on path 5's streams; 32 batches at
   ts = 0..31 (window 16 in 8 buckets, lateness 2), two arriving out of
   order within the lateness and one behind the watermark, which must raise
   ``LateRowError`` and count in ``late_rows``.  Answers against the truth
   over the rows the states cover (f64, on the host or the card): matrix
   directions within ``eps ||A_win||_F^2`` (decayed: ``1.5 eps`` of the
   decayed mass), HH estimates within ``eps W_win``, leverage subspace
   answers within ``1.5 eps ||A_win||_F^2`` and scores against
   ``table_scores``; the quantile probes within the band the served summary
   certifies (the fold of many states widens it past the spec's envelope,
   in the reference too: ROADMAP.md §3); windows closed = bucket boundaries
   crossed = publishes; a mid-stream save and load on the card,
   bit-identical, and one more batch into both.  ``fd_gram``,
   ``fd_project``, ``levscore``, ``mg_scan`` and ``quant_merge_pack`` are held
   against their plain versions at the path's shapes (the last two bit for
   bit on recorded site inserts), and each tenant's serve fold is timed;
14. after 13, path 7, the cluster (``repro_torch.cluster``): 4
   ``PipelineCell``s of m = 8 sites (eps = 0.02) behind a ``ClusterRouter``;
   8 P2 matrix tenants (4,096 to 1,024 rows a wave of 3's stream), 2
   leverage P1 tenants (2,048), HH super-step P1 tenants at eps 0.01 and
   0.001 (``mg_scan``'s two routes) on path 5's Zipf stream and quantile
   super-step P1 tenants at eps 0.02 and 0.01 (the second's ``quant_fold``
   above 48 KB of shared memory) on its lognormal stream, named so that the
   ring spreads them over all four cells (checked before anything runs).
   3 waves into a bare pipeline (packed), into the cluster with a thread a
   cell (``ingest_many(parallel=True)``) and into a cluster of the same cell
   names without threads: rows/s of each; parallel against sequential bit for
   bit (states and answers); the cluster against the bare pipeline with
   steps, rows, versions, ``n_seen``, ``CommReport`` totals, error bounds
   and HH and quantile answers exact, matrix and leverage subspace answers
   within 1e-5 ``||A_t||_F^2`` and score answers within rtol 1e-3, atol
   1e-5 (the kernels' splits follow the pack: ROADMAP.md §3);
   one ``router.query_batch`` fan-out (one ``query_packed`` a cell, whose
   ``quadform_packed`` launches are counted), timed over 21 calls and held
   to the truth as paths 3-5 are; ``scale_to`` 5 cells (the moved tenants'
   state bit for bit, versions kept), one more wave into the cluster (device
   busy over it, ``torch.profiler``) and the bare pipeline; a
   ``ServingReplica`` on the card (read-through,
   ``versions_behind``, ``max_versions_behind`` enforced); then two
   transported routers of 2 cells (no faults, and ``FaultPlan.seeded`` at
   the reference test's rates) fed 160 messages of 512 rows or 2,000 items,
   a windowed ``P2win`` tenant among them: the faults fire, every send is
   accounted for, states and answers are the same bytes; 48 more messages
   carry a checkpoint, a crash, parked batches, a degraded answer through
   the replica and ``recover_cell`` into a fresh cell, bit for bit against
   the uninterrupted router.  Its first route-2 ``mg_scan`` and its first
   ``quant_fold`` above 48 KB are recorded and held bit for bit against the
   plain loops;
15. after the serving phases, path 8, training (``repro_torch.train``):
   Qwen3-0.6B at full width (28 layers, bf16, its own ``xla_chunked``
   attention and per-block remat) takes 2 plain steps and 3 FD-compressed
   steps over m = 4 shards of 2 x 512 tokens (``make_compressed_train_step``)
   on one fixed random batch; the loss must fall over each run, the plain
   step must launch no kernel, and each compressed step must launch the FD
   kernels exactly as the leaves' shapes say (27,420 launches of each
   batched kernel for the shards' stacked sketches, 40 of each single one
   for the merges) and report the byte counts worked out on the host; the
   last runs under ``torch.profiler`` (wall time, device busy, ``eigh``'s
   host share).  ``fd_gram`` and ``fd_project`` are held against their
   plain versions at (4, 32, d) and the merges' (1, 32, d), d = 1,024 /
   2,048 / 3,072, on the inputs the first step gave them, beside
   ``torch.bmm``.  The first step's own
   ``compress_and_aggregate`` call, on the real gradients, must meet what
   does not depend on the basis: ``mean_j(acc_j - new_r_j)`` of rank <= k
   in every compressed leaf, ``ghat`` within one bf16 rounding of it; on
   synthetic gradients at the leaves' shapes (rank 8 with a gap, plus
   noise; a leaf of each shape but the embedding's) it is held card against CPU
   copies (1e-4 of the largest entries, bytes equal); a 2-layer f32 copy
   of the width holds the loss (1e-5) and
   every gradient leaf (1e-4 of its largest) card against CPU; last,
   ``launch.train.main`` at ``--reduced`` size with ``--compress-grads
   --shards 4`` runs 2 steps into a checkpoint directory and restores step
   2 for a third.  With ``--train-ckpt`` (off by default: it adds about a
   quarter of an hour, more than the run's budget), the full-width state
   after the compressed steps (bf16 parameters, f32 moments and the 4
   shards' residuals, about 15.5 GB) is also saved through
   ``ckpt.AsyncCheckpointer``, as ``launch.train`` saves it, and restored
   with ``ckpt.restore``: the caller's stall, the write, the restore and the
   bytes on disk are reported, and every restored leaf must equal its
   original bit for bit.

Launch counts are set to 0 just before each path (the P2 path, the
pipeline, the packed pipeline, path 5, path 6, path 7, the serving run, the
f32 serving check, path 8's steps) and read just after; the serial pipeline of 11 runs before its
window.  Comparisons of a kernel with its plain version are made outside
those windows.  It prints the card's name and
power limit, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": {...}}``.  Any failed check exits non-zero; so does a machine
without CUDA, or a directory without the package.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import shutil
import statistics
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
# Path 8, training: Qwen3-0.6B at full width, all its layers, bf16, its own
# attn_impl ("xla_chunked": no flash backward exists) and remat ("block"):
# TRAIN_PLAIN_STEPS plain and TRAIN_COMPRESSED_STEPS FD-compressed steps
# over TRAIN_SHARDS shards on one fixed batch of TRAIN_ROWS x TRAIN_SEQ
# random tokens (2 sequences a shard), AdamW at TRAIN_LR from the first step
# (warmup 1).  The loss and its gradients are held card against CPU on a
# TRAIN_CHECK_LAYERS-layer f32 copy of the width (LOSS_RTOL; each leaf
# within GRAD_RTOL of its largest entry: f32 sums over up to 151,936
# logits and 3,072 features in other orders), the compression on synthetic
# gradients at the path's leaf shapes (GRAD_RTOL); a sketched leaf of ghat
# must have sigma_(k+1) <= TRAIN_RANK_TOL sigma_1 (f32 products of rank k).
TRAIN_ARCH = SERVE_ARCH
TRAIN_SHARDS, TRAIN_ROWS, TRAIN_SEQ = 4, 8, 512
TRAIN_PLAIN_STEPS, TRAIN_COMPRESSED_STEPS, TRAIN_ENTRY_STEPS = 2, 3, 2
TRAIN_LR, TRAIN_CHECK_LAYERS = 1e-3, 2
LOSS_RTOL, GRAD_RTOL, TRAIN_RANK_TOL = 1e-5, 1e-4, 1e-4
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
HQ_KERNELS = ("mg_scan", "quant_merge_pack", "quant_fold", "quadform", "fd_gram", "fd_project")
# The kernels no Pallas kernel stands behind: the reference's sequential
# loops, run as XLA code.
NO_PALLAS = {
    "mg_scan": "none (src/repro/core/hh.py:98 mg_update_stream, a lax.scan)",
    "quant_merge_pack": "none (src/repro/core/quantiles.py:468 _quant_pack, a lax.fori_loop, "
                        "ending quant_merge at :523)",
    "quant_fold": "none (src/repro/core/distributed.py:521 the coordinator's loop of "
                  "quant_merge over m sites)",
}
# Path 6, after path 5: shard P3 through DistributedMatrixTracker on path 1's
# stream (m = 8, d = 1024, eps = 0.02: s = 9,781, so P3's served matrix is
# (9,782, 1,024)), its served answers held to the spec's err_factor on the
# first P3_CHECK_DIRS directions; then one pipeline of windowed tenants,
# shard flavour, each publishing on OnWindowClose: P2win and P1win leverage
# on WIN_ROWS rows of path 1's stream a batch, P2decay (half-life
# WIN_HALF_LIFE) on the same rows, P1win HH and quantile on path 5's
# streams, each cut into WIN_BATCHES batches at ts = 0, 1, ... (window
# WIN_WINDOW in WIN_BUCKETS buckets, lateness WIN_LATENESS).  The batches in
# each WIN_SWAPS pair arrive swapped (within the lateness); batch WIN_LATE
# arrives after WIN_LATE_AFTER, behind the watermark, and is shed.  The
# pipeline is saved and loaded after WIN_SAVE_AFTER arrivals.
P3_CHECK_DIRS = N_CHECK_DIRS
WIN_BATCHES, WIN_ROWS = 32, 2048
WIN_WINDOW, WIN_BUCKETS, WIN_LATENESS, WIN_HALF_LIFE = 16.0, 8, 2.0, 8.0
WIN_SWAPS, WIN_LATE, WIN_LATE_AFTER, WIN_SAVE_AFTER = ((10, 11), (20, 21)), 5, 23, 16
P6_KERNELS = ("fd_gram", "fd_project", "quadform", "levscore", "mg_scan", "quant_merge_pack")
P3_PROFILED_STEPS = 4
# Path 7, after path 6: the cluster.  CL_CELLS PipelineCells of M sites (eps
# = EPS) on a HashRing behind a ClusterRouter.  The fleet: 8 P2 matrix tenants
# (CL_MATRIX rows a wave, cut from path 3's stream), 2 leverage P1 tenants
# (CL_LEV), HH super-step P1 tenants at eps 0.01 (k = 200: mg_scan's route 1)
# and 0.001 (k = 2,000: route 2) on path 5's Zipf stream, quantile super-step
# P1 tenants at eps 0.02 (q_cap 408) and 0.01 (q_cap 808, whose quant_fold
# takes more than 48 KB of dynamic shared memory) on its lognormal stream,
# CL_HH_ITEMS and CL_Q_ITEMS items a wave.  The names are chosen so that the
# ring spreads the rows over all four cells, the HH pair and the quantile
# pair sit on different cells and every cell holds two matrix tenants
# (check_cluster_names).  CL_WAVES waves into each target, one more after
# the rebalance.  Answers whose pack composition differs agree within CL_TOL
# of the tenant's mass (PACK_TOL's bound).  The chaos routers (two cells)
# hold CL_CHAOS's tenants, fed CL_CHAOS_MESSAGES messages of CL_CHAOS_ROWS
# rows or CL_CHAOS_ITEMS items under FaultPlan.seeded(..., p_drop=0.15,
# p_duplicate=0.1, p_delay=0.1) (tests/test_chaos.py:373), publishing every
# CL_CHAOS_PUBLISH_EVERY steps, the windowed tenant on OnWindowClose over
# WIN_WINDOW in CL_WIN_BUCKETS buckets; the replica's bound CL_STALENESS.  The
# stream then goes on for CL_CHAOS_TAIL messages, across a crash-restart.
CL_CELLS, CL_WAVES, CL_TOL = 4, 3, PACK_TOL
CL_MATRIX = {"mat-2": 4096, "mat-6": 4096, "mat-0": 2048, "mat-5": 2048, "mat-8": 2048,
             "mat-15": 1024, "mat-20": 1024, "mat-1": 1024}
CL_LEV = {"lev-0": 2048, "lev-1": 2048}
CL_HH, CL_Q = {"hh-f": 0.01, "hh-d": 0.001}, {"q-e": 0.02, "q-a": 0.01}
CL_HH_ITEMS, CL_Q_ITEMS = 50_000, 12_000
CL_CHAOS = {"mat-0": "matrix", "mat-2": "matrix", "lev-0": "leverage", "hh-0": "hh",
            "q-0": "quantile", "win-0": "windowed"}
CL_CHAOS_MESSAGES, CL_CHAOS_ROWS, CL_CHAOS_ITEMS, CL_CHAOS_SEED = 160, 512, 2000, 1
CL_CHAOS_TAIL = 48
CL_CHAOS_PUBLISH_EVERY, CL_WIN_BUCKETS, CL_STALENESS = 9, 4, 64
P7_KERNELS = SHRINK_KERNELS + ("quadform", "quadform_packed", "levscore", "mg_scan",
                               "quant_merge_pack", "quant_fold")
# Dynamic shared memory a block may take before its kernel's limit is raised.
SMEM_DEFAULT = 48 * 1024
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
        # A case may hold the kernel to the plain version in f32 (``want``),
        # or run the plain version on CPU copies of its inputs, timed on the
        # host clock over ``plain_reps`` calls.
        got, again = c["run"](), c["run"]()
        if c.get("plain_on_cpu"):
            plain_s = []
            for _ in range(c.get("plain_reps", 1)):
                t0 = time.perf_counter()
                want = c["plain"]()
                plain_s.append(time.perf_counter() - t0)
            want = want.to(got.device)
        else:
            want = c.get("want", c["plain"])()
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
        if c.get("plain_on_cpu"):
            extra.update(plain_on="cpu (host clock)", plain_calls=len(plain_s))
        if "variant" in c:
            extra["variant"] = c["variant"]
        results.append(dict(
            kernel=c["kernel"], shape=c["shape"], replaces=c["pallas"],
            source=c.get("source", ops.KERNELS[c["kernel"]][0].source),
            max_abs_err=err, max_rel_err=err / max(scale, 1e-30), err_over_tol=err_over_tol,
            ms=time_ms(torch, c.get("time", c["run"])),
            plain_ms=(1e3 * sum(plain_s) / len(plain_s) if c.get("plain_on_cpu")
                      else time_ms(torch, c["plain"], c.get("plain_reps", 20))),
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


def profile_ingest(torch, fn, steps: int, shapes: bool = True) -> dict:
    """``torch.profiler`` over ``fn()``, ``steps`` ingest steps or waves:
    device busy share, ``eigh``'s share of host time and calls by input
    shape (``shapes``; without, under one key: the profiler's own time
    halves, which matters over millions of events), and the shrink kernels'
    device time beside it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_call = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
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


def _cloned(a):
    """A tensor's clone, a tuple's of tensors' clones, anything else as it is."""
    if isinstance(a, tuple):
        return tuple(_cloned(x) for x in a)
    return a.clone() if hasattr(a, "clone") else a


class _Recorder:
    """Records the first call of a kernel wrapper in ``ops`` whose inputs
    ``want(*args)`` accepts, passing every call through."""

    def __init__(self, ops, name, want):
        self.ops, self.name, self.want, self.args = ops, name, want, None
        self.real = getattr(ops, name)

    def __call__(self, *args):
        if self.args is None and self.want(*args):
            self.args = tuple(_cloned(a) for a in args)
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
    inserts of ``quant_merge_pack`` and the coordinator's ``quant_fold``."""
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
    wave_s = {name: [] for name in names}
    items = dict.fromkeys(names, 0)
    timed = HQ_WAVES - HQ_PROFILED_WAVES

    def feed(wave, clock: bool) -> None:
        for name, batch in wave:
            t0 = time.perf_counter()
            pipe.ingest(name, batch)
            torch.cuda.synchronize()
            if clock:
                wave_s[name].append(time.perf_counter() - t0)
                ingest_s[name] += wave_s[name][-1]
                items[name] += len(batch[0]) if isinstance(batch, tuple) else batch.shape[0]

    # Python's garbage collector pauses whatever tenant's ingest it lands in:
    # its pauses in the timed waves are kept beside the wave times.
    gc_pauses, gc_start = [], [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], time.perf_counter() - gc_start[0]))

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    gc.callbacks.append(gc_clock)
    with _Recorder(ops, "mg_scan", lambda *a: a[0].shape[0] == HQ_M) as rec_mg, \
            _Recorder(ops, "quant_merge_pack", lambda a, *_: a[0].shape[0] == HQ_M) as rec_site, \
            _Recorder(ops, "quant_fold", lambda *a: True) as rec_fold:
        feed(waves[0], clock=True)
    for wave in waves[1:timed]:
        feed(wave, clock=True)
    gc.callbacks.remove(gc_clock)
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
    mg_routes = {k.symbol: k.launches for k in ops.KERNELS["mg_scan"]}
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
                ingest_s=ingest_s, wave_s=wave_s, items=items, publish_s=publish_s,
                gc=dict(pauses=len(gc_pauses), seconds=sum(t for _, t in gc_pauses),
                        longest_s=max((t for _, t in gc_pauses), default=0.0),
                        gen2=sum(g == 2 for g, _ in gc_pauses)),
                latency=latency,
                profile=prof, launches=launches, save_s=save_s, load_s=load_s, bytes=nbytes,
                leaves_equal=leaves_equal, loaded_bitwise=loaded_bitwise,
                tail_answers=tail_answers, tail=tail, batches=batches, hq_s=hq_s,
                mg_routes=mg_routes,
                recorded={"mg_scan": rec_mg.args, "quant_merge_pack": rec_site.args,
                          "quant_fold": rec_fold.args},
                phase_s=time.perf_counter() - t_phase)


def profile_hq(torch, fn) -> dict:
    """``torch.profiler`` over ``fn()`` (path 5's last waves): device busy
    share, and the device time and launches of the sequential kernels
    (summed from the raw events, as ``raw_profile`` does; ``quant_fold_kernel``
    serves both ``quant_merge_pack`` and ``quant_fold``)."""
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
    for name, symbol in (("mg_scan", "mg_scan_"), ("quant_fold", "quant_fold_kernel")):
        us = sum(v for k, v in dev.items() if symbol in k)
        n = sum(c for k, c in count.items() if symbol in k)
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
    from repro_torch.kernels import ops
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
    # One site insert and one coordinator fold a wave; mg_scan's route by k.
    for name in ("quant_merge_pack", "quant_fold"):
        check(hq["launches"][name] == HQ_WAVES,
              f"path 5 launched {name} {hq['launches'][name]} times in {HQ_WAVES} waves")
    routes = hq["mg_routes"]
    check(routes[ops.MG_SCAN.symbol] > 0 and routes[ops.MG_SCAN_SHARED.symbol] == 0,
          f"path 5's mg_scan did not take its route with the slots in registers: {routes}")
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


def _flat(torch, out):
    """A kernel's output tuple as one f64 vector, for bit-for-bit comparison."""
    return torch.cat([t.double().flatten() for t in out])


def _cpu_args(args):
    """CPU copies of a recorded call's arguments (tuples of tensors kept as tuples)."""
    return tuple(_cpu_args(a) if isinstance(a, tuple) else a.cpu() if hasattr(a, "cpu") else a
                 for a in args)


def mg_scan_case(torch, args, label: str) -> dict:
    """``mg_scan`` on a recorded call's inputs, bit for bit against the plain
    step-by-step loop on CPU copies (host clock, 2 calls); its chain bound is
    the items of a row."""
    from repro_torch.kernels import ops, ref

    s, k = args[0].shape
    b = args[4].shape[1]
    route = 1 if k <= ops.MG_REGISTER_SLOTS else 2
    return dict(
        kernel="mg_scan", shape=f"{label}: (S={s}, k={k}, b={b}), route {route}",
        pallas=NO_PALLAS["mg_scan"], run=lambda a=args: _flat(torch, ops.mg_scan(*a)),
        time=lambda a=args: ops.mg_scan(*a),
        plain=lambda a=_cpu_args(args): _flat(torch, ref.ref_mg_scan(*a)), plain_on_cpu=True,
        plain_reps=2, library=None, exact=True, chain_steps=b, on_path=True,
        variant=f"route {route}: slots in {'registers' if route == 1 else 'shared memory'}",
        # Each item compares every slot, at least: S b k operations.
        flops=float(s * b * k), nbytes=8.0 * (2 * s * k + 2 * s + s * b),
    )


def quant_merge_case(torch, args, label: str) -> dict:
    """``quant_merge_pack`` on a recorded call's inputs, bit for bit against
    the plain loop on CPU copies (host clock, 2 calls); its chain bound is
    the live tuples of the longest row."""
    from repro_torch.kernels import ops, ref

    a, bb, two_eps, cap = args
    (t, la), lb = a[0].shape, bb[0].shape[1]
    live = torch.isfinite(a[0]).sum(-1) + torch.isfinite(bb[0]).sum(-1)
    return dict(
        kernel="quant_merge_pack",
        shape=f"{label}: (T={t}, la={la}, lb={lb}, cap={cap}; {int(live.max())} live tuples "
              "walked)",
        pallas=NO_PALLAS["quant_merge_pack"],
        run=lambda a=args: _flat(torch, ops.quant_merge_pack(*a)),
        time=lambda a=args: ops.quant_merge_pack(*a),
        plain=lambda a=_cpu_args(args): _flat(torch, ref.ref_quant_merge_pack(*a)),
        plain_on_cpu=True, plain_reps=2, library=None, exact=True,
        chain_steps=int(live.max()), on_path=True,
        # About eight f32 additions and comparisons a walked tuple.
        flops=8.0 * float(live.sum()), nbytes=4.0 * (4 * t * (la + lb + cap) + 3 * t),
    )


def hq_cases(torch, hq) -> list[dict]:
    """``mg_scan``, ``quant_merge_pack`` and ``quant_fold`` at path 5's shapes,
    on the inputs the first wave gave them: the site scan (50 summaries x one
    wave's items), the 50 site inserts and the coordinator's fold of the 50
    shipped summaries.  Bit for bit against the plain step-by-step loops run
    on CPU copies of those inputs (a CUDA ``cumsum`` rounds elsewhere than the
    merge's f64 prefix sums), whose time is taken on the host clock: over 2
    calls, the fold's over 1.  The kernel's time is its wrapper's call alone
    (``time``), without the copies that flatten its outputs for the check.  A
    chain bound counts the dependent steps of the longest row: items for
    ``mg_scan``; live tuples walked for the merges (in the fold, merge after
    merge, counted by stepping ``quant_merge_pack``)."""
    cases = []
    args = hq["recorded"]["mg_scan"]
    check(args is not None, "path 5's first wave recorded no mg_scan call")
    cases.append(mg_scan_case(torch, args, "site scan"))
    args = hq["recorded"]["quant_merge_pack"]
    check(args is not None, "path 5's first wave recorded no quant_merge_pack call (site inserts)")
    cases.append(quant_merge_case(torch, args, "site inserts"))
    args = hq["recorded"]["quant_fold"]
    check(args is not None, "path 5's first wave recorded no quant_fold call")
    cases.append(quant_fold_case(torch, args, "coordinator fold"))
    return cases


def quant_fold_case(torch, args, label: str) -> dict:
    """``quant_fold`` on a recorded call's inputs (one coordinator), bit for
    bit against the plain loop on CPU copies (host clock, 1 call) and
    against its merges taken one ``quant_merge_pack`` launch at a time; its
    chain bound is the live tuples walked, merge after merge."""
    from repro_torch.kernels import ops, ref

    def live(x):
        return torch.isfinite(x).sum(-1)

    a, bb, two_eps, cap = args
    t, m, lb = bb[0].shape
    check(t == 1, f"{label}: a fold of one coordinator, got {t}")
    # The fold's chain: each merge's live tuples, merge after merge.
    steps, state = 0, a
    for j in range(m):
        site = tuple(x[:, j] for x in bb)
        steps += int(live(state[0])[0] + live(site[0])[0])
        state = ops.quant_merge_pack(state, site, two_eps, cap)
    torch.cuda.synchronize()
    check(torch.equal(_flat(torch, state), _flat(torch, ops.quant_fold(*args))),
          f"{label}: the fold differs from its merges taken one launch at a time")
    return dict(
        kernel="quant_fold",
        shape=f"{label}: (m={m}, cap={cap}; {steps} live tuples walked of {m * (cap + lb)}; "
              f"{fold_smem(args) / 1024:.1f} KB of shared memory a block)",
        pallas=NO_PALLAS["quant_fold"], run=lambda a=args: _flat(torch, ops.quant_fold(*a)),
        time=lambda a=args: ops.quant_fold(*a),
        plain=lambda a=_cpu_args(args): _flat(torch, ref.ref_quant_fold(*a)), plain_on_cpu=True,
        plain_reps=1,
        library=None, exact=True, chain_steps=steps, on_path=True,
        flops=8.0 * steps, nbytes=4.0 * (8 * cap + 2 + m * (4 * lb + 1)),
    )


def fold_smem(args) -> int:
    """Bytes of dynamic shared memory a block of ``quant_fold`` takes on
    these inputs: 0 where its rows' arrays go to scratch in device memory."""
    from repro_torch.kernels import ops

    a, bb, _, cap = args
    dev, (t, la), lb = a[0].device, a[0].shape, bb[0].shape[-1]
    if ops.QUANT_FOLD.query(dev, *ops.QUANT_SCRATCH, t, la, lb, cap):
        return 0
    return ops.QUANT_FOLD.query(dev, *ops.QUANT_SMEM, la, lb, cap)


def drive_p3(torch, batches) -> dict:
    """Path 6's first half: shard P3 through ``DistributedMatrixTracker`` on
    path 1's stream (every super-step timed on the synchronised host clock),
    a publish and one ``query_batch`` of N_DIRS directions through the
    ``QueryEngine``, which must launch ``quadform`` at L = s + 1.  Two
    steps are then run twice from the same state, outside the tracker."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.tracker import DistributedMatrixTracker
    from repro_torch.kernels import ops
    from repro_torch.query import QueryEngine, SketchStore

    tracker = DistributedMatrixTracker(M, D, eps=EPS, protocol="P3", device=DEV)
    cfg = tracker.cfg
    step_s = []
    for rows in batches:
        t0 = time.perf_counter()
        tracker.update(rows)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    store = SketchStore()
    t0 = time.perf_counter()
    snap = tracker.publish(store, "p3")
    publish_s = time.perf_counter() - t0
    engine = QueryEngine(store, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(61)
    x = unit_dirs(torch, gen, N_DIRS).cpu().numpy()
    with _Recorder(ops, "quadform", lambda b, _: b.shape[0] == cfg.s + 1) as rec:
        t0 = time.perf_counter()
        served = engine.query_batch(x, tenant="p3", path="kernel").estimates
        query_s = time.perf_counter() - t0
    state = tracker.state
    flat = lambda st: [st.rng, st.tau, st.buf_rows, st.buf_w, st.buf_rho, *st.comm]  # noqa: E731
    runs = [dist.p3_step(cfg, dist.p3_step(cfg, state, batches[0]), batches[1])
            for _ in range(2)]
    repeat_equal = all(torch.equal(a, b) for a, b in zip(flat(runs[0]), flat(runs[1])))
    prof = profile_p3(torch, cfg, state, batches[2:2 + P3_PROFILED_STEPS])
    return dict(tracker=tracker, cfg=cfg, step_s=step_s, snap=snap, publish_s=publish_s,
                x=x, served=served, query_s=query_s, quadform_args=rec.args,
                repeat_equal=repeat_equal, profile=prof)


def profile_p3(torch, cfg, state, batches) -> dict:
    """``torch.profiler`` over P3 super-steps from the tracker's final state
    (not fed back to it): wall time, device busy share, and the torch ops
    with the most host time and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import distributed as dist

    dist.p3_step(cfg, state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = state
        for rows in batches:
            st = dist.p3_step(cfg, st, rows)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev, count, _ = raw_profile(prof)
    busy_us = sum(dev.values())
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:8]
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return dict(steps=len(batches), wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                device_busy_share=busy_us / wall_us, device_launches=sum(count.values()),
                top_device_ms={k: v / 1e3 for k, v in top},
                top_host_self_ms={k: v / 1e3 for k, v in host})


def check_p3(torch, p3, ata) -> dict:
    """The reference's check (tests/test_distributed.py:38-44) against dense
    f64 truth: ``||A^T A - B^T B||_2 < 2 eps ||A||_F^2`` and fewer messages
    than rows; the served answers of P3_CHECK_DIRS unit directions within
    the spec's ``err_factor * eps * ||A||_F^2``; two runs of two steps from
    one state bit-equal."""
    from repro_torch.runtime import get_spec

    tracker = p3["tracker"]
    frob = float(torch.diagonal(ata).sum())
    b = torch.tensor(p3["snap"].matrix, device=DEV, dtype=torch.float64)
    spectral = float(torch.linalg.eigvalsh(ata - b.T @ b).abs().max()) / frob
    check(spectral < 2 * EPS, f"P3: ||A^T A - B^T B||_2 = {spectral:.3e} ||A||_F^2 >= 2 eps")
    x = torch.tensor(p3["x"], device=DEV, dtype=torch.float64)
    truth = ((x @ ata) * x).sum(1).cpu().numpy()
    gap = (abs(p3["served"].astype("float64") - truth) / frob)
    factor = get_spec("P3", "shard", "matrix").err_factor
    check(float(gap[:P3_CHECK_DIRS].max()) <= factor * EPS,
          f"P3: a served direction is {float(gap[:P3_CHECK_DIRS].max()):.3e} ||A||_F^2 off "
          f"(limit {factor} eps)")
    comm = tracker.comm_report()
    n = tracker.rows_fed
    check(comm.row_msgs > 0 and comm.total < n, f"P3 messages {comm.total} not below n = {n}")
    check(p3["quadform_args"] is not None,
          f"P3's query_batch did not launch quadform at L = {p3['cfg'].s + 1}")
    check(p3["repeat_equal"], "P3: two runs of two steps from one state differ")
    check(bool(torch.isfinite(b).all()) and b.shape == (p3["cfg"].s + 1, D),
          f"P3's served matrix is {tuple(b.shape)} or not finite")
    return dict(spectral_err=spectral, max_dir_gap=float(gap[:P3_CHECK_DIRS].max()),
                max_dir_gap_all=float(gap.max()), limit=factor * EPS, comm=comm.as_dict(),
                rows=n, tau=float(tracker.state.tau),
                doublings=int(tracker.state.comm.broadcast_events),
                frob_estimate=tracker.frob_estimate(), frob=frob)


def win_arrivals() -> list[int]:
    """Path 6's arrival order of the WIN_BATCHES batches (batch i at ts = i):
    each pair in WIN_SWAPS arrives swapped, within the lateness, and batch
    WIN_LATE arrives after batch WIN_LATE_AFTER, behind the watermark."""
    order = list(range(WIN_BATCHES))
    for a, b in WIN_SWAPS:
        i, j = order.index(a), order.index(b)
        order[i], order[j] = b, a
    order.remove(WIN_LATE)
    order.insert(order.index(WIN_LATE_AFTER) + 1, WIN_LATE)
    return order


def win_streams(torch, batches, seed: int) -> dict:
    """Path 6's WIN_BATCHES batches for each tenant: WIN_ROWS rows of path 1's
    stream a batch for the matrix and leverage tenants (on the card), and
    path 5's HH and quantile streams cut at multiples of M (host pairs)."""
    import numpy as np

    stream = torch.cat(batches)[: WIN_BATCHES * WIN_ROWS]
    check(stream.shape[0] == WIN_BATCHES * WIN_ROWS, "path 6 needs more rows of path 1's stream")
    hq = hq_streams(seed)

    def cut(pair, n):
        bounds = [M * round(i * n / M / WIN_BATCHES) for i in range(WIN_BATCHES + 1)]
        return [tuple(np.ascontiguousarray(a[bounds[i]:bounds[i + 1]]) for a in pair)
                for i in range(WIN_BATCHES)]

    rows = [stream[i * WIN_ROWS:(i + 1) * WIN_ROWS] for i in range(WIN_BATCHES)]
    return {"mat-win": rows, "mat-decay": rows, "lev-win": rows,
            "hh-win": cut(hq["hh"], HH_ITEMS), "q-win": cut(hq["q"], Q_ITEMS)}


def win_pipeline():
    """Path 6's pipeline: the windowed tenants, shard flavour (M software
    sites), each with its own ``OnWindowClose``."""
    from repro_torch.runtime import OnWindowClose, StreamingPipeline

    pipe = StreamingPipeline(M, eps=EPS, max_batch=8 * N_DIRS, default_deadline_s=3600.0,
                             device=DEV)
    geometry = dict(window=WIN_WINDOW, buckets=WIN_BUCKETS, lateness=WIN_LATENESS)
    for name, kind, protocol in (("mat-win", "matrix", "P2win"), ("lev-win", "leverage", "P1win"),
                                 ("hh-win", "hh", "P1win"), ("q-win", "quantile", "P1win")):
        pipe.add_windowed_tenant(name, kind=kind, d=D if kind in ("matrix", "leverage") else None,
                                 protocol=protocol, engine="shard", policy=OnWindowClose(),
                                 **geometry)
    pipe.add_windowed_tenant("mat-decay", kind="matrix", d=D, protocol="P2decay", engine="shard",
                             policy=OnWindowClose(), half_life=WIN_HALF_LIFE,
                             lateness=WIN_LATENESS)
    return pipe


def win_live_answers(pipe, x) -> dict:
    """Each windowed tenant's live answers, read from its protocol: the
    matrix tenants' ``||B x||^2``, the HH estimates, the quantile table and
    the leverage table."""
    return {"mat-win": pipe.tracker("mat-win").query_batch(x),
            "mat-decay": pipe.tracker("mat-decay").query_batch(x),
            "lev-win": pipe.tracker("lev-win").sampled_rows(),
            "hh-win": pipe.tracker("hh-win").estimates(),
            "q-win": pipe.tracker("q-win").table()}


def win_served(pipe, queries) -> dict:
    """Every windowed tenant's published answers through ``query_batch``."""
    eng = pipe.engine
    return {"mat-win": eng.query_batch(queries["x"], tenant="mat-win").estimates,
            "mat-decay": eng.query_batch(queries["x"], tenant="mat-decay").estimates,
            "lev-subspace": eng.query_batch(queries["sub"], tenant="lev-win").estimates,
            "lev-score": eng.query_batch(queries["score"], tenant="lev-win").estimates,
            "hh-win": eng.query_batch(queries["ids"], tenant="hh-win").estimates,
            "q-win": eng.query_batch(queries["q"], tenant="q-win").estimates}


def drive_windows(torch, batches, seed: int) -> dict:
    """Path 6's second half: ``win_pipeline`` takes the WIN_BATCHES batches
    of ``win_streams`` in ``win_arrivals`` order (each tenant's ingest timed
    on the synchronised host clock; the late batch must raise
    ``LateRowError`` for every tenant).  After WIN_SAVE_AFTER arrivals the
    pipeline is saved and loaded on the card (outside the timed ingest),
    and the next arrival goes into both.  At the end every tenant is
    published and queried through the engine.  The first site inserts
    record ``mg_scan``'s and ``quant_merge_pack``'s inputs."""
    import tempfile

    import numpy as np

    from repro_torch.core.leverage import score_query, subspace_query
    from repro_torch.core.quantiles import quantile_query, rank_query
    from repro_torch.core.windows import LateRowError
    from repro_torch.kernels import ops
    from repro_torch.runtime import StreamingPipeline

    streams = win_streams(torch, batches, seed)
    names = list(streams)
    pipe = win_pipeline()
    order = win_arrivals()
    ingest_s = dict.fromkeys(names, 0.0)
    items = dict.fromkeys(names, 0)
    late = dict.fromkeys(names, 0)
    # Policy publishes (each a serve fold) happen inside ingest: their time
    # a tenant is kept apart too.
    publish_s = dict.fromkeys(names, 0.0)
    publish = pipe._publish

    def timed_publish(tenant, t):
        t0 = time.perf_counter()
        snap = publish(tenant, t)
        torch.cuda.synchronize()
        publish_s[tenant] += time.perf_counter() - t0
        return snap

    pipe._publish = timed_publish
    gen = torch.Generator(device=DEV).manual_seed(seed + 62)
    x_live = unit_dirs(torch, gen, N_CHECK_DIRS).cpu().numpy()
    ckpt = {}

    def feed(p, i, clock: bool) -> None:
        for name in names:
            batch = streams[name][i]
            t0 = time.perf_counter()
            try:
                p.ingest(name, batch, ts=float(i))
                shed = False
            except LateRowError:
                shed = True
            torch.cuda.synchronize()
            if clock:
                ingest_s[name] += time.perf_counter() - t0
                if shed:
                    late[name] += 1
                else:
                    items[name] += len(batch[0]) if isinstance(batch, tuple) else batch.shape[0]

    with _Recorder(ops, "mg_scan", lambda *a: a[0].shape[0] == 1) as rec_mg, \
            _Recorder(ops, "quant_merge_pack",
                      lambda a, b, two_eps, cap: a[0].shape[0] == 1 and b[0].shape[1] > 1
                      and cap == pipe.tracker("q-win")._cap) as rec_q:
        for n, i in enumerate(order):
            feed(pipe, i, clock=True)
            if n + 1 == WIN_SAVE_AFTER:
                with tempfile.TemporaryDirectory() as tmp:
                    t0 = time.perf_counter()
                    pipe.save(tmp)
                    ckpt["save_s"] = time.perf_counter() - t0
                    ckpt["bytes"] = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                                        if f.is_file())
                    t0 = time.perf_counter()
                    loaded = StreamingPipeline.load(tmp, M, device=DEV, max_batch=8 * N_DIRS,
                                                    default_deadline_s=3600.0)
                    torch.cuda.synchronize()
                    ckpt["load_s"] = time.perf_counter() - t0
                ckpt["leaves_equal"] = all(
                    sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
                    for a, b in ((loaded._tenant(t).adapter.state_payload()[0],
                                  pipe._tenant(t).adapter.state_payload()[0]) for t in names))
                ckpt["published_equal"] = all(
                    np.array_equal(loaded.store.get(t).matrix, pipe.store.get(t).matrix)
                    for t in names if t in pipe.store.tenants())
            if n == WIN_SAVE_AFTER:  # the next arrival, into the loaded copy too, profiled
                ckpt["profile"] = profile_ingest(torch, lambda: feed(loaded, i, clock=False), 1)
                ckpt["tail"] = {"loaded": win_live_answers(loaded, x_live),
                                "uninterrupted": win_live_answers(pipe, x_live)}
                del loaded
    torch.cuda.synchronize()
    pipe._publish = publish
    closes = {t: pipe.tracker(t).windows_closed() for t in names}
    publishes = {t: pipe.stats(t).publishes for t in names}
    late_rows = pipe.stats()["late_rows"]

    # The final publish of every tenant, and the served queries.
    t0 = time.perf_counter()
    snaps = {t: pipe.publish(t) for t in names}
    final_publish_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 63)
    x = unit_dirs(torch, gen, N_DIRS).cpu().numpy()
    hh_keys = np.concatenate([k for k, _ in streams["hh-win"]])
    q_values = np.concatenate([v for v, _ in streams["q-win"]])
    phis = rng.uniform(0.01, 0.99, N_DIRS // 2).astype(np.float32).astype(np.float64)
    queries = dict(
        x=x, ids=rng.choice(hh_keys, N_DIRS).astype(np.float32)[:, None],
        q=np.stack([rank_query(v) for v in rng.choice(q_values, N_DIRS // 2)]
                   + [quantile_query(p) for p in phis]).astype(np.float32),
        sub=np.stack([subspace_query(v) for v in x]).astype(np.float32),
        score=np.stack([score_query(v) for v in unit_dirs(torch, gen, N_DIRS).cpu().numpy()]
                       ).astype(np.float32))
    t0 = time.perf_counter()
    served = win_served(pipe, queries)
    serve_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dict(pipe=pipe, streams=streams, order=order, ingest_s=ingest_s, items=items,
                policy_publish_s=publish_s, late=late, late_rows=late_rows, closes=closes,
                publishes=publishes, snaps=snaps, publish_s=final_publish_s,
                queries=queries, served=served,
                serve_s=serve_s, ckpt=ckpt,
                recorded={"mg_scan": rec_mg.args, "quant_merge_pack": rec_q.args})


def win_folds(torch, win) -> dict:
    """Each windowed tenant's serve fold taken again on its final state
    (``serve()``, sorted buckets then sites, one merge at a time): seconds on
    the synchronised host clock, states folded and kernel launches."""
    from repro_torch.kernels import ops

    out = {}
    for name in win["streams"]:
        tr = win["pipe"].tracker(name)._tracked
        before = ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.serve()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in _delta(ops.launch_counts(), before).items() if v}
        out[name] = dict(seconds=secs, states=tr.live_states(), merges=tr.live_states() - 1,
                         launches=launches)
    return out


def win_truth(torch, win, name: str):
    """The rows a windowed tenant's state covers, and their weights: the
    batches applied by its watermark (late ones never), in its live buckets
    (window) or aged by ``gamma ** (ref_ts - ts)`` (decay)."""
    proto = win["pipe"].tracker(name)
    tr = proto._tracked
    wm = proto.watermark()
    applied = [i for i in range(WIN_BATCHES) if i != WIN_LATE and i <= wm]
    if hasattr(tr, "gamma"):
        return [(i, tr.gamma ** (tr.ref_ts - i)) for i in applied]
    live = set(tr._states)
    return [(i, 1.0) for i in applied if math.floor(i / tr.width) in live]


def check_windows(torch, win) -> dict:
    """Path 6's windowed answers against truth over the rows their states
    cover, counted in f64: matrix directions within ``err_factor * eps *
    ||A_win||_F^2`` (decayed: of the decayed mass, against the decayed
    truth), every HH key's estimate within ``err_factor * eps * W_win``, the
    quantile probes' worst rank error within ``err_factor * eps * W_win``,
    leverage subspace answers within ``err_factor * eps * ||A_win||_F^2`` and
    score answers within rtol 1e-3, atol 1e-5 of ``table_scores`` on the
    published table; window closes, publishes, the late batch and the
    checkpoint."""
    import numpy as np

    from repro_torch.core.hh import decode_hh_snapshot
    from repro_torch.core.leverage import table_scores
    from repro_torch.core.quantiles import exact_ranks, quant_band
    from repro_torch.runtime import get_spec

    served, q, streams, snaps = win["served"], win["queries"], win["streams"], win["snaps"]
    out = {}
    x = torch.tensor(q["x"], device=DEV, dtype=torch.float64)
    for name, answer, spec in (("mat-win", "mat-win", ("P2win", "matrix")),
                               ("mat-decay", "mat-decay", ("P2decay", "matrix")),
                               ("lev-win", "lev-subspace", ("P1win", "leverage"))):
        ata = torch.zeros(D, D, dtype=torch.float64, device=DEV)
        for i, g in win_truth(torch, win, name):
            r = streams[name][i].double()
            ata.addmm_(r.T, r, alpha=g)
        mass = float(torch.diagonal(ata).sum())
        truth = ((x @ ata) * x).sum(1).cpu().numpy()
        gap = float(np.abs(served[answer].astype(np.float64) - truth).max()) / mass
        factor = get_spec(spec[0], "shard", spec[1]).err_factor
        check(gap <= factor * EPS, f"path 6 {name}: a direction is {gap:.3e} of the in-window "
                                   f"mass off (limit {factor} eps)")
        out[name] = dict(max_gap_over_mass=gap, limit=factor * EPS, mass=mass,
                         frob_estimate=float(snaps[name].frob),
                         batches=len(win_truth(torch, win, name)))
    snap = snaps["lev-win"]
    want = table_scores(snap.matrix, q["score"][:, 1:], float(snap.meta["lam"]))
    got = served["lev-score"].astype(np.float64)
    ratio = float((np.abs(got - want) / (SCORE_ATOL + SCORE_RTOL * np.abs(want))).max())
    check(ratio <= 1.0, f"path 6 lev-win: score answers off the f64 oracle ({ratio:.3f} of tol)")
    out["lev-win"]["score_err_over_tol"] = ratio

    parts = [streams["hh-win"][i] for i, _ in win_truth(torch, win, "hh-win")]
    keys = np.concatenate([k for k, _ in parts])
    w = np.concatenate([v for _, v in parts])
    truth = np.bincount(keys, weights=w, minlength=HH_KEYS)
    w_win = float(w.sum())
    est = np.zeros(HH_KEYS)
    for e, v in decode_hh_snapshot(snaps["hh-win"].matrix).items():
        est[e] = v
    err = float(np.abs(est - truth).max()) / w_win
    factor = get_spec("P1win", "shard", "hh").err_factor
    check(err <= factor * EPS, f"path 6 hh-win: max |estimate - weight| = {err:.3e} W_win")
    check(np.array_equal(served["hh-win"],
                         est[q["ids"][:, 0].astype(np.int64)].astype(np.float32)),
          "path 6 hh-win: served lookups differ from the published estimates")
    out["hh-win"] = dict(max_err_over_w=err, limit=factor * EPS, w_win=w_win, items=len(keys))

    parts = [streams["q-win"][i] for i, _ in win_truth(torch, win, "q-win")]
    values = np.concatenate([v for v, _ in parts])
    w = np.concatenate([v for _, v in parts])
    w_win = float(w.sum())
    ans = served["q-win"].astype(np.float64)
    is_rank = q["q"][:, 0] == 0.0
    rank_err = np.abs(ans[is_rank] - exact_ranks(values, w, q["q"][is_rank, 1])) / w_win
    quant_err = np.abs(exact_ranks(values, w, ans[~is_rank])
                       - q["q"][~is_rank, 1].astype(np.float64) * w_win) / w_win
    worst = float(max(rank_err.max(), quant_err.max()))
    factor = get_spec("P1win", "shard", "quantile").err_factor
    # The fold of the live states (sorted buckets, then sites, one merge at
    # a time, as the reference folds them) widens the summary's certified
    # band with every merge, past the spec's envelope when many states fold
    # (ROADMAP.md §3; the reference gives the same table): the answers are
    # held to the band the served summary certifies, and the envelope is
    # reported beside it.
    band = quant_band(win["pipe"].tracker("q-win")._serve()) / w_win
    check(worst <= band * (1.0 + 1e-6),
          f"path 6 q-win: worst rank error {worst:.3e} W_win beyond the summary's certified "
          f"band {band:.3e} W_win")
    out["q-win"] = dict(worst_rank_err_over_w=worst, certified_band_over_w=band,
                        envelope=factor * EPS, within_envelope=worst <= factor * EPS,
                        w_win=w_win, items=len(values),
                        states=win["pipe"].tracker("q-win")._tracked.live_states())

    # Closes, publishes and the late batch.
    pipe = win["pipe"]
    for name in win["streams"]:
        proto = pipe.tracker(name)
        tr = proto._tracked
        if hasattr(tr, "width"):
            first = win["order"][0] - WIN_LATENESS
            want_closes = math.floor(proto.watermark() / tr.width) - math.floor(first / tr.width)
            check(win["closes"][name] == want_closes,
                  f"path 6 {name}: {win['closes'][name]} windows closed, {want_closes} bucket "
                  "boundaries crossed")
        check(win["publishes"][name] == win["closes"][name],
              f"path 6 {name}: {win['publishes'][name]} publishes for {win['closes'][name]} "
              "closes")
        check(win["late"][name] == 1 and proto.late_batches == 1,
              f"path 6 {name}: the late batch was not shed once")
    want_late = sum(len(b[0]) if isinstance(b, tuple) else b.shape[0]
                    for b in (win["streams"][n][WIN_LATE] for n in win["streams"]))
    check(win["late_rows"] == want_late,
          f"path 6 late_rows {win['late_rows']}, the late batch held {want_late}")

    ck = win["ckpt"]
    check(ck["leaves_equal"] and ck["published_equal"],
          "path 6: a leaf or a published snapshot differs right after the load")
    tail = ck["tail"]
    for name in ("hh-win", "q-win"):
        check(np.array_equal(np.asarray(tail["loaded"][name] if name == "q-win"
                                        else sorted(tail["loaded"][name].items())),
                             np.asarray(tail["uninterrupted"][name] if name == "q-win"
                                        else sorted(tail["uninterrupted"][name].items()))),
              f"path 6 {name}: after one more batch the loaded pipeline answers differently")
    tail_gap = {}
    for name in ("mat-win", "mat-decay", "lev-win"):
        a, b = (np.asarray(tail[k][name], np.float64) for k in ("loaded", "uninterrupted"))
        check(a.shape == b.shape, f"path 6 {name}: answers of another shape after the load")
        scale = max(float(np.abs(b).max()), 1e-30)
        tail_gap[name] = float(np.abs(a - b).max()) / scale
        check(tail_gap[name] <= PACK_TOL,
              f"path 6 {name}: after one more batch {tail_gap[name]:.3e} off the uninterrupted "
              "pipeline")
    return dict(out, closes=win["closes"], publishes=win["publishes"],
                late_rows=win["late_rows"], tail_gap=tail_gap,
                comm={n: pipe.tracker(n).comm_report().as_dict() for n in win["streams"]})


def path6_cases(torch, p3, win) -> list[dict]:
    """Path 6's kernels at its shapes: ``quadform`` at P3's (L = s + 1, N =
    N_DIRS, d = D) and a tall ragged stack on offset views; ``fd_gram`` and
    ``fd_project`` at a windowed insert's (2l, d) = (200, 1024) buffer;
    ``levscore`` at the windowed leverage tenant's published factor and
    score queries; ``mg_scan`` and ``quant_merge_pack`` on the windowed
    site inserts' recorded inputs, bit for bit."""
    import numpy as np

    from repro_torch.core.leverage import decode_leverage_snapshot, ridge_factor
    from repro_torch.kernels import fd_ops, ops, ref

    cases = []
    b, x = p3["quadform_args"]
    gen = torch.Generator(device=DEV).manual_seed(64)
    l_tall = b.shape[0]
    tall_b = torch.randn(2 * l_tall * 131 + 1, device=DEV, generator=gen)[1:].view(2, l_tall, 131)
    tall_x = torch.randn(2 * 300 * 131 + 1, device=DEV, generator=gen)[1:].view(2, 300, 131)
    for label, bb, xx, single in (("P3 query_batch", b[None], x[None], True),
                                  ("tall, ragged, offset views", tall_b, tall_x, False)):
        t, l, d = bb.shape
        n = xx.shape[1]
        cases.append(dict(
            kernel="quadform" if single else "quadform_packed",
            shape=f"{label}: (T={t}, L={l}, N={n}, d={d})",
            pallas=PALLAS["quadform" if single else "quadform_packed"],
            run=(lambda bb=bb, xx=xx: ops.quadform(bb[0], xx[0])) if single
            else (lambda bb=bb, xx=xx: ops.quadform_packed(bb, xx)),
            plain=(lambda bb=bb, xx=xx: ref.ref_quadform(bb[0], xx[0])) if single
            else (lambda bb=bb, xx=xx: ref.ref_quadform_packed(bb, xx)),
            library=(lambda bb=bb, xx=xx: (bb[0] @ xx[0].T).square().sum(0)) if single
            else (lambda bb=bb, xx=xx: (bb @ xx.mT).square().sum(-2)),
            on_path=single, flops=2.0 * t * l * n * d + 2.0 * t * l * n,
            nbytes=4.0 * (t * l * d + t * n * d + t * n),
        ))
    l2 = 2 * win["pipe"].tracker("mat-win")._l
    buf = win["streams"]["mat-win"][0][:l2][None].contiguous()
    lam, u = ref.eigh_descending(ref.ref_fd_gram_batched(buf))
    w, _ = ref.shrink_weights(lam, l2 // 2)
    w, u = w.contiguous(), u.contiguous()
    t, l, d = buf.shape
    cases.append(dict(
        kernel="fd_gram", shape=f"window insert shrink: (T={t}, L={l}, d={d})",
        pallas=PALLAS["fd_gram"], run=lambda: fd_ops.fd_gram(buf),
        plain=lambda: ref.ref_fd_gram_batched(buf), library=lambda: torch.bmm(buf, buf.mT),
        symmetric=True, on_path=False,
        flops=2.0 * t * l * (l + 1) / 2 * d, nbytes=4.0 * (t * l * d + t * l * l)))
    cases.append(dict(
        kernel="fd_project", shape=f"window insert shrink: (T={t}, L={l}, d={d})",
        pallas=PALLAS["fd_project"], run=lambda: fd_ops.fd_project(w, u, buf),
        plain=lambda: ref.ref_fd_project_batched(w, u, buf),
        library=lambda: torch.bmm(u.mT, buf), on_path=False,
        flops=2.0 * t * l * l * d + t * l * d, nbytes=4.0 * (t * l + t * l * l + 2 * t * l * d)))
    snap = win["snaps"]["lev-win"]
    rows, _, wts = decode_leverage_snapshot(snap.matrix)
    m_f = torch.tensor(ridge_factor(rows, wts, float(snap.meta["lam"])), dtype=torch.float32,
                       device=DEV)
    xs = torch.tensor(np.ascontiguousarray(win["queries"]["score"][:, 1:]), device=DEV)
    n, d = xs.shape
    cases.append(dict(
        kernel="levscore", shape=f"windowed score queries: (N={n}, d={d})",
        pallas=PALLAS["levscore"], run=lambda: ops.levscore(m_f, xs),
        plain=lambda: ref.ref_levscore(m_f, xs), library=lambda: (xs @ m_f * xs).sum(1),
        on_path=False, flops=2.0 * n * d * d + 2.0 * n * d, nbytes=4.0 * (d * d + n * d + n)))
    rec = win["recorded"]
    check(rec["mg_scan"] is not None, "path 6 recorded no windowed mg_scan site insert")
    check(rec["quant_merge_pack"] is not None,
          "path 6 recorded no windowed quant_merge_pack site insert")
    for case in (mg_scan_case(torch, rec["mg_scan"], "windowed site insert"),
                 quant_merge_case(torch, rec["quant_merge_pack"], "windowed site insert")):
        case["on_path"] = False
        cases.append(case)
    return cases


def cluster_fleet() -> dict:
    """Path 7's tenants: ``{name: (kind, rows or items a wave, eps)}``."""
    fleet = {n: ("matrix", r, EPS) for n, r in CL_MATRIX.items()}
    fleet.update({n: ("leverage", r, EPS) for n, r in CL_LEV.items()})
    fleet.update({n: ("hh", CL_HH_ITEMS, e) for n, e in CL_HH.items()})
    fleet.update({n: ("quantile", CL_Q_ITEMS, e) for n, e in CL_Q.items()})
    return fleet


def check_cluster_names() -> dict:
    """Path 7's placement on the ring, checked before anything runs (the
    ring is pure Python): the fleet spreads over at least three of the four
    cells, the two HH and the two quantile tenants sit on different cells,
    a cell holds two or more matrix tenants (its ``query_packed`` launches
    ``quadform_packed``), growing to five cells moves a tenant, and the
    chaos fleet's victim (the cell of its first matrix tenant) holds all
    five kinds while the other cell holds a tenant too."""
    from repro_torch.cluster import HashRing, rebalance_plan

    cells = [f"cell-{i}" for i in range(CL_CELLS)]
    ring = HashRing(cells)
    place = {n: ring.place(n) for n in cluster_fleet()}
    check(len(set(place.values())) >= 3, f"path 7's tenants land on fewer than 3 cells: {place}")
    for group in (CL_HH, CL_Q):
        check(len({place[n] for n in group}) == len(group), f"{list(group)} share a cell: {place}")
    per_cell = [sum(place[n] == c for n in CL_MATRIX) for c in cells]
    check(max(per_cell) >= 2, f"no cell holds two matrix tenants: {place}")
    moves = rebalance_plan(ring, ring.with_cells(cells + [f"cell-{CL_CELLS}"]), place).moves
    check(len(moves) >= 1, "growing path 7's ring to five cells moves no tenant")
    chaos = HashRing(["cell-0", "cell-1"])
    victim = chaos.place(next(iter(CL_CHAOS)))
    on_victim = {CL_CHAOS[n] for n in CL_CHAOS if chaos.place(n) == victim}
    elsewhere = [n for n in CL_CHAOS if chaos.place(n) != victim]
    check(on_victim == set(CL_CHAOS.values()) and elsewhere,
          f"the chaos victim {victim} does not hold all five kinds with a tenant elsewhere")
    return place


def cluster_cells(names):
    """Fresh ``PipelineCell``s of M sites on the card, publishing on demand."""
    from repro_torch.cluster import PipelineCell
    from repro_torch.runtime import OnDemand

    return [PipelineCell(n, M, device=DEV, eps=EPS, policy=OnDemand(), max_batch=8 * N_DIRS,
                         default_deadline_s=3600.0) for n in names]


def cluster_register(target) -> None:
    """``cluster_fleet``'s tenants on a pipeline or a router, shard engines."""
    for name, (kind, _, eps) in cluster_fleet().items():
        if kind == "matrix":
            target.add_tenant(name, D, protocol="P2")
        elif kind == "leverage":
            target.add_leverage_tenant(name, D, engine="shard")
        elif kind == "hh":
            target.add_hh_tenant(name, eps=eps, engine="shard")
        else:
            target.add_quantile_tenant(name, eps=eps, engine="shard")


def cluster_waves(take, streams: dict, n: int) -> list:
    """``n`` waves of ``[(tenant, batch), ...]``: matrix and leverage rows cut
    from path 3's stream, HH (key, weight) and quantile (value, weight)
    items cut in order from path 5's streams, as host pairs."""
    waves, pos = [], {"hh": 0, "q": 0}
    for _ in range(n):
        wave = []
        for name, (kind, size, _) in cluster_fleet().items():
            if kind in ("matrix", "leverage"):
                wave.append((name, take(size)))
            else:
                key = "hh" if kind == "hh" else "q"
                a, w = streams[key]
                i = pos[key]
                pos[key] = i + size
                wave.append((name, (a[i:i + size], w[i:i + size])))
        waves.append(wave)
    return waves


def cluster_queries(torch, fed: dict, seed: int) -> dict:
    """``router.query_batch``'s requests, one a tenant: N_DIRS unit
    directions to each matrix tenant; N_DIRS subspace and N_DIRS score rows
    to each leverage tenant; the true HQ_PHI-heavy keys of what an HH
    tenant was fed and random ids; N_DIRS // 2 rank probes at fed values
    and as many phi-quantile probes to each quantile tenant."""
    import numpy as np

    from repro_torch.core.hh import exact_heavy_hitters

    rng = np.random.default_rng(seed + 71)
    gen = torch.Generator(device=DEV).manual_seed(seed + 72)
    out = {}
    for name, (kind, _, _) in cluster_fleet().items():
        if kind == "matrix":
            out[name] = unit_dirs(torch, gen, N_DIRS).cpu().numpy()
        elif kind == "leverage":
            out[name] = np.concatenate(
                [np.concatenate([np.full((N_DIRS, 1), mode, np.float32),
                                 unit_dirs(torch, gen, N_DIRS).cpu().numpy()], axis=1)
                 for mode in (0.0, 1.0)])
        elif kind == "hh":
            heavy, _, _ = exact_heavy_hitters(*fed[name], HQ_PHI)
            ids = np.concatenate([np.array(sorted(heavy), np.int64),
                                  rng.integers(0, HH_KEYS, N_DIRS - len(heavy))])
            out[name] = ids.astype(np.float32)[:, None]
        else:
            values = rng.choice(fed[name][0], N_DIRS // 2)
            phis = rng.uniform(0.01, 0.99, N_DIRS - N_DIRS // 2).astype(np.float32)
            out[name] = np.concatenate([np.stack([np.zeros_like(values), values], 1),
                                        np.stack([np.ones_like(phis), phis], 1)]).astype(
                                            np.float32)
    return out


def cluster_state(pipes: dict) -> dict:
    """Every tenant's exported state leaves (host arrays), steps, rows,
    latest version and ``CommReport`` total; ``pipes`` maps each tenant to
    the pipeline that owns it."""
    out = {}
    for name, pipe in pipes.items():
        st = pipe.stats(name)
        out[name] = dict(arrays=pipe.export_tenant(name)["arrays"], steps=st.steps, rows=st.rows,
                         version=st.latest_version,
                         comm=pipe.tracker(name).comm_report().as_dict()["total"])
    return out


def cluster_results(results) -> dict:
    """``query_batch`` results as ``{tenant: (version, error_bound, estimates)}``."""
    import numpy as np

    return {r.tenant: (r.version, r.error_bound, np.asarray(r.estimates)) for r in results}


def cluster_gaps(got: dict, want: dict, mass: dict, scores: dict | None = None) -> dict:
    """Worst gap of each kind between two ``cluster_results``: matrix
    answers and leverage subspace answers over the tenant's
    ``||A_t||_F^2``; leverage score answers (the rows ``scores[name]``
    marks) over ``SCORE_ATOL + SCORE_RTOL * |want|``; HH and quantile
    answers and all versions as counts of differences; error bounds
    relative; ``bitwise`` when every answer is the same bytes."""
    import numpy as np

    out = dict(answer=0.0, score=0.0, error_bound=0.0, versions_differ=0, exact_differ=0,
               bitwise=True)
    for name, (v, eb, est) in want.items():
        gv, geb, gest = got[name]
        out["versions_differ"] += gv != v
        out["bitwise"] &= bool(np.array_equal(gest, est)) and geb == eb
        out["error_bound"] = max(out["error_bound"], abs(geb - eb) / max(abs(eb), 1e-30))
        if name in mass:
            diff = np.abs(gest.astype(np.float64) - est)
            score = (scores or {}).get(name, np.zeros(len(est), bool))
            if score.any():
                out["score"] = max(out["score"], float(
                    (diff[score] / (SCORE_ATOL + SCORE_RTOL * np.abs(est[score]))).max()))
            if not score.all():
                out["answer"] = max(out["answer"], float(diff[~score].max()) / mass[name])
        else:
            out["exact_differ"] += not (np.array_equal(gest, est) and geb == eb)
    return out


def cluster_same_state(a: dict, b: dict, leaves: str = "") -> bool:
    """Steps, rows, versions and ``CommReport`` totals equal for every
    tenant, and every state leaf whose name holds ``leaves`` bit for bit
    (``""``: all of them)."""
    import numpy as np

    for name, s in b.items():
        g = a[name]
        if (g["steps"], g["rows"], g["version"], g["comm"]) != (s["steps"], s["rows"],
                                                                s["version"], s["comm"]):
            return False
        if g["arrays"].keys() != s["arrays"].keys() or not all(
                np.array_equal(g["arrays"][k], v) for k, v in s["arrays"].items()
                if leaves in k):
            return False
    return True


def drive_cluster(torch, batches, seed: int) -> dict:
    """Path 7: the cluster on the card (launch counts set to 0 by the caller).

    1. CL_WAVES waves into a bare ``StreamingPipeline`` (``ingest_many``,
       packed), then into a ``ClusterRouter`` of CL_CELLS cells with
       ``parallel=True`` (a thread a cell) and into one of fresh cells of the
       same names with ``parallel=False``, on the synchronised host clock.
    2. Publish every tenant; one ``router.query_batch`` fan-out (each cell's
       one ``query_packed`` counted), timed over 21 calls.
    3. ``scale_to`` CL_CELLS + 1 cells, the moved tenants' state before and
       after, one more wave into the cluster (a thread a cell, under
       ``torch.profiler``) and the bare pipeline.
    4. A ``ServingReplica`` on the router: read-through, ``versions_behind``
       after one more publish, ``max_versions_behind`` enforced.
    5. Chaos and recovery (``drive_chaos``)."""
    import numpy as np

    from repro_torch.cluster import ClusterRouter, ServingReplica, StalenessExceededError
    from repro_torch.kernels import ops
    from repro_torch.query import PackedRequest
    from repro_torch.runtime import OnDemand, StreamingPipeline

    t_phase = time.perf_counter()
    fleet = cluster_fleet()
    names = [f"cell-{i}" for i in range(CL_CELLS)]
    streams = hq_streams(seed)
    take = stream_cutter(batches)
    waves = cluster_waves(take, streams, CL_WAVES + 1)
    tail = waves.pop()
    fed: dict = {n: [] for n in fleet}
    for wave in waves:
        for name, batch in wave:
            fed[name].append(batch)
    mass, ata = {}, {}
    for name, (kind, _, _) in fleet.items():
        if kind in ("matrix", "leverage"):
            rows = torch.cat(fed[name]).double()
            ata[name] = rows.T @ rows
            mass[name] = float(torch.diagonal(ata[name]).sum())
        else:
            fed[name] = tuple(np.concatenate(a) for a in zip(*fed[name]))
    queries = cluster_queries(torch, fed, seed)
    rows_a_wave = sum(s for k, s, _ in fleet.values() if k in ("matrix", "leverage"))
    items_a_wave = sum(s for k, s, _ in fleet.values() if k in ("hh", "quantile"))

    def run(ingest) -> dict:
        """Every wave on the synchronised host clock."""
        secs = []
        torch.cuda.synchronize()
        for wave in waves:
            t0 = time.perf_counter()
            ingest(wave)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return dict(wave_s=secs, rows_per_s=sorted(rows_a_wave / s for s in secs))

    bare = StreamingPipeline(M, eps=EPS, policy=OnDemand(), max_batch=8 * N_DIRS,
                             default_deadline_s=3600.0, device=DEV)
    cluster_register(bare)
    timing = {"bare": run(lambda w: bare.ingest_many(w, packed=True))}
    routers = {}
    for mode, parallel in (("parallel", True), ("sequential", False)):
        routers[mode] = ClusterRouter(cluster_cells(names))
        cluster_register(routers[mode])
        timing[mode] = run(lambda w, r=routers[mode], p=parallel: r.ingest_many(w, parallel=p))
    router = routers["parallel"]
    t_rest = time.perf_counter()
    for name in fleet:
        bare.publish(name)
        for r in routers.values():
            r.cell_for(name).pipeline.publish(name)
    heavy = {n: {int(k) for k in router.cell_for(n).pipeline.heavy_hitters(n, HQ_PHI)}
             for n in CL_HH}
    snaps = {n: router.cell_for(n).store.get(n) for n in fleet}  # what the fan-out serves
    states = {mode: cluster_state({n: r.cell_for(n).pipeline for n in fleet})
              for mode, r in routers.items()}
    states["bare"] = cluster_state({n: bare for n in fleet})
    requests = [(n, queries[n]) for n in fleet]

    # The fan-out: one query_packed a cell, counted on each cell's engine.
    calls = {n: 0 for n in names}
    for n in names:
        eng = router.cell(n).engine
        real = eng.query_packed

        def counted(reqs, n=n, real=real):
            calls[n] += 1
            return real(reqs)
        eng.query_packed = counted
    before = ops.launch_counts()
    fanout = cluster_results(router.query_batch(requests))
    fanout_launches = _delta(ops.launch_counts(), before)
    for n in names:
        del router.cell(n).engine.query_packed
    answers = {"parallel": fanout,
               "sequential": cluster_results(routers["sequential"].query_batch(requests)),
               "bare": cluster_results(bare.engine.query_packed(
                   [PackedRequest(n, q) for n, q in requests]))}
    latency = time_calls({"query_batch fan-out": (sum(len(q) for q in queries.values()),
                                                  lambda: router.query_batch(requests))})
    placement = router.placement()

    # Rebalance to one more cell, then one more wave into the cluster and the bare pipeline.
    plan_moves = router.plan_scale_to(names + [f"cell-{CL_CELLS}"]).moves
    moved_before = {m.tenant: states["parallel"][m.tenant] for m in plan_moves}
    grown = [router.cell(n) for n in names] + cluster_cells([f"cell-{CL_CELLS}"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = router.scale_to(grown)
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    moved_after = cluster_state({m.tenant: router.cell_for(m.tenant).pipeline
                                 for m in plan.moves})
    after_move = cluster_results(router.query_batch(requests))
    tail_profile = profile_ingest(torch, lambda: router.ingest_many(tail, parallel=True), 1)
    bare.ingest_many(tail, packed=True)
    for name in fleet:
        bare.publish(name)
        router.cell_for(name).pipeline.publish(name)
    tail_mass = dict(mass)
    for name, batch in tail:
        if name in tail_mass:
            tail_mass[name] += float(batch.double().square().sum())
    tail_answers = {"cluster": cluster_results(router.query_batch(requests)),
                    "bare": cluster_results(bare.engine.query_packed(
                        [PackedRequest(n, q) for n, q in requests]))}
    tail_states = {"cluster": cluster_state({n: router.cell_for(n).pipeline for n in fleet}),
                   "bare": cluster_state({n: bare for n in fleet})}

    # A serving replica on the router, on the same card.
    t = next(iter(CL_MATRIX))
    x = queries[t]
    replica = ServingReplica(router)
    first = replica.query_batch(x, tenant=t)
    owner = router.cell_for(t)
    owner.pipeline.publish(t)
    stale = replica.query_batch(x, tenant=t)
    bounded = ServingReplica(router, max_versions_behind=0)
    bounded.sync(t)
    owner.pipeline.publish(t)
    pinned = bounded.query_batch(x, tenant=t, version=bounded.synced_version(t))
    try:
        bounded.query_degraded(x, tenant=t)
        raised = None
    except StalenessExceededError as e:
        raised = (e.behind, e.bound)
    fresh = bounded.query_batch(x, tenant=t)
    own = owner.engine.query_batch(x, tenant=t)
    replica_out = dict(
        device=str(replica.engine.device), read_throughs=replica.read_throughs,
        first_behind=first.versions_behind, stale_behind=stale.versions_behind,
        stale_version=stale.result.version, first_version=first.result.version,
        stale_equal=bool(np.array_equal(stale.result.estimates, first.result.estimates)),
        pinned_behind=pinned.versions_behind, raised=raised,
        fresh_behind=fresh.versions_behind, fresh_version=fresh.result.version,
        owner_version=owner.latest_version(t),
        fresh_equal=bool(np.array_equal(fresh.result.estimates, own.estimates)))
    rest_s = time.perf_counter() - t_rest

    chaos = drive_chaos(torch, take, streams, seed)
    torch.cuda.synchronize()
    out = dict(timing=timing, tail_profile=tail_profile, states=states, answers=answers,
               fanout_calls=calls, fanout_launches=fanout_launches, latency=latency,
               placement=placement, moves=[tuple(m) for m in plan.moves],
               planned=[tuple(m) for m in plan_moves], scale_s=scale_s,
               moved_before=moved_before, moved_after=moved_after, after_move=after_move,
               tail_answers=tail_answers, tail_states=tail_states, tail_mass=tail_mass,
               replica=replica_out, chaos=chaos, mass=mass, ata=ata, heavy=heavy, fed=fed,
               queries=queries, rows_a_wave=rows_a_wave, items_a_wave=items_a_wave, snaps=snaps,
               route_launches={k.symbol: k.launches for k in ops.KERNELS["mg_scan"]},
               rest_s=rest_s, phase_s=time.perf_counter() - t_phase)
    for r in routers.values():
        r.close()
    bare.close()
    return out


def chaos_router(plan=None):
    """A transported router of two fresh cells holding ``CL_CHAOS``'s
    tenants; back-offs slept on an injected clock, so none costs wall time."""
    from repro_torch.cluster import ClusterRouter, Transport
    from repro_torch.runtime import EveryKSteps, OnWindowClose
    from repro_torch.runtime.policies import RetryPolicy

    clock = [0.0]

    def sleep(s):
        clock[0] += s

    transport = Transport(plan=plan)
    router = ClusterRouter(
        cluster_cells(["cell-0", "cell-1"]), transport=transport,
        retry=RetryPolicy(max_attempts=5, base_s=0.01, cap_s=0.04), breaker_threshold=2,
        breaker_cooldown_s=0.0, staleness_bound=CL_STALENESS, clock=lambda: clock[0],
        sleep=sleep)
    every = EveryKSteps(CL_CHAOS_PUBLISH_EVERY)
    for name, kind in CL_CHAOS.items():
        if kind == "matrix":
            router.add_tenant(name, D, protocol="P2", policy=every)
        elif kind == "leverage":
            router.add_leverage_tenant(name, D, engine="shard", policy=every)
        elif kind == "hh":
            router.add_hh_tenant(name, eps=HQ_EPS, engine="shard", policy=every)
        elif kind == "quantile":
            router.add_quantile_tenant(name, eps=HQ_EPS, engine="shard", policy=every)
        else:
            router.add_windowed_tenant(name, kind="matrix", d=D, protocol="P2win",
                                       engine="shard", window=WIN_WINDOW, buckets=CL_WIN_BUCKETS,
                                       policy=OnWindowClose())
    return router, transport


def chaos_settle(router, transport, past: int = 0) -> None:
    """Heartbeat until every cell is healthy, the replay queues are drained
    and the transport has used ``past`` message indices."""
    for _ in range(200):
        hb = router.heartbeat_all()
        pending = sum(v["replay_pending"] for k, v in router.stats().items() if k != "_resilience")
        if all(s == "ok" for s in hb.values()) and pending == 0 and transport.sends >= past:
            return
    fail(f"path 7: the chaos cluster did not settle: {hb}, {pending} batches pending")


def drive_chaos(torch, take, streams: dict, seed: int) -> dict:
    """Path 7's transported routers: CL_CHAOS_MESSAGES messages (CL_CHAOS_ROWS
    rows or CL_CHAOS_ITEMS items, the windowed tenant's with its event time)
    into a fault-free router and one under ``FaultPlan.seeded``, compared once
    both have settled.  The stream then goes on for CL_CHAOS_TAIL messages
    into both: the chaos router checkpoints the victim cell, takes half of
    them, loses the cell, parks the rest for replay, serves a degraded query
    through its replica and recovers the cell into a fresh one from the
    checkpoint; the fault-free router is the uninterrupted run."""
    import tempfile

    import numpy as np

    from repro_torch.cluster import FaultPlan, PipelineCell
    from repro_torch.runtime import OnDemand

    kinds = list(CL_CHAOS.items())
    off = {"hh": HH_ITEMS // 2, "q": Q_ITEMS // 2}
    script = []
    for i in range(CL_CHAOS_MESSAGES + CL_CHAOS_TAIL):
        name, kind = kinds[i % len(kinds)]
        ts = float(i // len(kinds)) if kind == "windowed" else None
        if kind in ("hh", "quantile"):
            key = "hh" if kind == "hh" else "q"
            a, w = streams[key]
            j = off[key]
            off[key] = j + CL_CHAOS_ITEMS
            script.append((name, (a[j:j + CL_CHAOS_ITEMS], w[j:j + CL_CHAOS_ITEMS]), ts))
        else:
            script.append((name, take(CL_CHAOS_ROWS), ts))
    script, tail = script[:CL_CHAOS_MESSAGES], script[CL_CHAOS_MESSAGES:]
    rng = np.random.default_rng(seed + 81)
    x = rng.normal(size=(N_DIRS, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    ids = rng.integers(0, HH_KEYS, N_DIRS).astype(np.float32)[:, None]
    probes = np.stack([np.ones(N_DIRS, np.float32),
                       rng.uniform(0.01, 0.99, N_DIRS).astype(np.float32)], 1)
    lev = np.concatenate([np.concatenate([np.full((N_DIRS // 2, 1), mode, np.float32),
                                          x[: N_DIRS // 2]], 1) for mode in (0.0, 1.0)])
    queries = [(n, {"matrix": x, "windowed": x, "leverage": lev, "hh": ids,
                    "quantile": probes}[k]) for n, k in kinds]

    def feed(router, part):
        for name, rows, ts in part:
            router.ingest(name, rows, ts=ts)

    def state(router):
        return cluster_state({n: router.cell_for(n).pipeline for n in CL_CHAOS})

    t0 = time.perf_counter()
    ref, ref_t = chaos_router()
    feed(ref, script)
    chaos_settle(ref, ref_t)
    plan = FaultPlan.seeded(seed + CL_CHAOS_SEED, CL_CHAOS_MESSAGES, p_drop=0.15,
                            p_duplicate=0.1, p_delay=0.1)
    cha, cha_t = chaos_router(plan)
    feed(cha, script)
    while cha_t.sends < CL_CHAOS_MESSAGES:
        cha.heartbeat_all()
    chaos_settle(cha, cha_t, past=CL_CHAOS_MESSAGES)
    torch.cuda.synchronize()
    chaos_s = time.perf_counter() - t0
    ref_state, cha_state = state(ref), state(cha)
    ref_ans = cluster_results(ref.query_batch(queries))
    cha_ans = cluster_results(cha.query_batch(queries))
    res = cha.stats()["_resilience"]
    counters = dict(cha_t.counters, sends=cha_t.sends)
    accounted = all(
        t_.sends == sum(t_.counters[k] for k in ("delivered", "dropped", "delayed", "crashed",
                                                 "down")) for t_ in (ref_t, cha_t))
    late = sum(r.cell_for(n).pipeline.stats()["late_rows"] for r in (ref, cha) for n in CL_CHAOS)

    # The stream goes on: the uninterrupted run, and a crash-restart mid-stream.
    feed(ref, tail)
    chaos_settle(ref, ref_t)
    cha.heartbeat_all()  # the replica syncs before the outage
    victim = cha.placement()[kinds[0][0]]
    owned = sorted(n for n, c in cha.placement().items() if c == victim)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cha.checkpoint_cell(victim, tmp, step=1)
        checkpoint_s = time.perf_counter() - t0
        feed(cha, tail[: len(tail) // 2])
        cha_t.crash(victim)
        parked = 0
        for name, rows, ts in tail[len(tail) // 2:]:
            ack = cha.ingest(name, rows, ts=ts)
            parked += name in owned and ack is None
        degraded = cha.query_batch(queries)
        degraded_log = list(cha.degraded_log)
        fresh = PipelineCell(victim, M, device=DEV, eps=EPS, policy=OnDemand(),
                             max_batch=8 * N_DIRS, default_deadline_s=3600.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reacked = cha.recover_cell(victim, fresh, tmp, step=1)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
    chaos_settle(cha, cha_t)
    rec_state, rec_ans = state(cha), cluster_results(cha.query_batch(queries))
    ref_state_after, ref_ans_after = state(ref), cluster_results(ref.query_batch(queries))
    recoveries = cha.stats()["_resilience"]["recoveries"]
    ref.close()
    cha.close()
    return dict(
        messages=len(script), tail=len(tail), chaos_s=chaos_s, counters=counters,
        resilience=res, accounted=accounted, late_rows=late,
        state_equal=cluster_same_state(cha_state, ref_state),
        answers_bitwise=cluster_gaps(cha_ans, ref_ans, {})["bitwise"],
        victim=victim, owned=owned, parked=parked,
        degraded=sum(r is not None for r in degraded), degraded_log=degraded_log,
        reacked=reacked, recoveries=recoveries, checkpoint_s=checkpoint_s, recover_s=recover_s,
        recovered_state_equal=cluster_same_state(rec_state, ref_state_after),
        recovered_bitwise=cluster_gaps(rec_ans, ref_ans_after, {})["bitwise"])


def check_cluster(torch, cl, launches: dict) -> dict:
    """Path 7's checks: parallel against sequential waves bit for bit; the
    cluster against the bare pipeline (counts, versions, HH and quantile
    answers and error bounds exactly; matrix and leverage subspace answers
    within CL_TOL of the tenant's mass, score answers within SCORE_RTOL and
    SCORE_ATOL of each other: the kernels' splits follow the pack, ROADMAP
    §3); answers against dense truth; the fan-out;
    the rebalance; the replica; chaos and recovery; the launches."""
    import numpy as np

    from repro_torch.core.leverage import QUERY_SCORE, table_scores
    from repro_torch.core.quantiles import exact_ranks
    from repro_torch.kernels import ops
    from repro_torch.runtime import get_spec

    st, ans = cl["states"], cl["answers"]
    check(cluster_same_state(st["parallel"], st["sequential"]),
          "path 7: parallel and sequential waves left different states")
    # The leverage tenants' score rows, held apart from their subspace rows.
    scores = {n: cl["queries"][n][:, 0] == QUERY_SCORE for n in CL_LEV}
    par_seq = cluster_gaps(ans["parallel"], ans["sequential"], cl["mass"], scores)
    check(par_seq["bitwise"], f"path 7: parallel and sequential answers differ: {par_seq}")
    check(cluster_same_state(st["parallel"], st["bare"], leaves="n_seen"),
          "path 7: the cluster's steps, rows, versions, CommReport totals or n_seen differ "
          "from the bare pipeline's")
    vs_bare = cluster_gaps(ans["parallel"], ans["bare"], cl["mass"], scores)
    check(vs_bare["versions_differ"] == 0 and vs_bare["exact_differ"] == 0
          and vs_bare["answer"] <= CL_TOL and vs_bare["score"] <= 1.0
          and vs_bare["error_bound"] == 0,
          f"path 7: cluster against bare pipeline {vs_bare} (limit {CL_TOL}, error bounds "
          "exactly)")

    # Answers against the truth.
    truth_gap, score_bad = {}, 0
    for name, (kind, _, eps) in cluster_fleet().items():
        _, _, est = ans["parallel"][name]
        q = cl["queries"][name]
        check(bool(np.isfinite(est).all()) and est.shape == (q.shape[0],),
              f"path 7: {name}'s answers are not finite of shape ({q.shape[0]},)")
        if kind in ("matrix", "leverage"):
            xs = q if kind == "matrix" else q[:N_DIRS, 1:]
            xt = torch.tensor(xs, device=DEV, dtype=torch.float64)
            truth = ((xt @ cl["ata"][name]) * xt).sum(1).cpu().numpy()
            gap = float(np.abs(est[:N_DIRS] - truth).max()) / cl["mass"][name]
            factor = (get_spec("P2", "shard", "matrix").err_factor if kind == "matrix"
                      else LEV_ERR_FACTOR)
            check(gap <= factor * EPS * (1 + 1e-5),
                  f"path 7: {name} gap {gap:.3e} > {factor} eps ||A||_F^2")
            truth_gap[name] = gap
            if kind == "leverage":
                snap = cl["snaps"][name]
                oracle = table_scores(snap.matrix, q[N_DIRS:, 1:], float(snap.meta["lam"]))
                got = est[N_DIRS:].astype(np.float64)
                score_bad += int((np.abs(got - oracle) > SCORE_ATOL + SCORE_RTOL
                                  * np.abs(oracle)).sum())
        elif kind == "hh":
            keys, w = cl["fed"][name]
            truth = np.bincount(keys, weights=w, minlength=HH_KEYS)
            w_total = float(w.sum())
            factor = get_spec("P1", "shard", "hh").err_factor
            gap = float(np.abs(est - truth[q[:, 0].astype(np.int64)]).max()) / w_total
            check(gap <= factor * eps, f"path 7: {name} gap {gap:.3e} W > {factor} eps W")
            heavy = {int(e) for e in np.nonzero(truth >= HQ_PHI * w_total)[0]}
            found = cl["heavy"][name]
            check(heavy <= found, f"path 7: {name} missed heavy keys {sorted(heavy - found)}")
            truth_gap[name] = gap
        else:
            values, w = cl["fed"][name]
            w_total = float(w.sum())
            is_rank = q[:, 0] == 0.0
            served = est.astype(np.float64)
            rank_err = np.abs(served[is_rank] - exact_ranks(values, w, q[is_rank, 1])) / w_total
            quant_err = np.abs(exact_ranks(values, w, served[~is_rank])
                               - q[~is_rank, 1].astype(np.float64) * w_total) / w_total
            gap = float(max(rank_err.max(), quant_err.max()))
            factor = get_spec("P1", "shard", "quantile").err_factor
            check(gap <= factor * eps, f"path 7: {name} worst rank error {gap:.3e} W > "
                                       f"{factor} eps W")
            truth_gap[name] = gap
    check(score_bad == 0, f"path 7: {score_bad} leverage score answers off the f64 oracle")

    # The fan-out: one query_packed a cell, quadform_packed in every cell
    # that holds two matrix tenants.
    check(all(v == 1 for v in cl["fanout_calls"].values()),
          f"path 7: the fan-out made {cl['fanout_calls']} query_packed calls a cell")
    packs = sum(sum(cl["placement"][n] == c for n in CL_MATRIX) >= 2
                for c in cl["fanout_calls"])
    check(cl["fanout_launches"]["quadform_packed"] == packs,
          f"path 7: the fan-out launched quadform_packed "
          f"{cl['fanout_launches']['quadform_packed']} times, {packs} cells pack")

    # Rebalance: the planned moves, state carried bit for bit, versions kept.
    check(cl["moves"] and cl["moves"] == cl["planned"],
          f"path 7: scale_to moved {cl['moves']}, planned {cl['planned']}")
    check(cluster_same_state(cl["moved_after"], cl["moved_before"]),
          "path 7: a moved tenant's state differs after the move")
    moved = cluster_gaps(cl["after_move"], ans["parallel"], cl["mass"], scores)
    check(moved["versions_differ"] == 0 and moved["exact_differ"] == 0
          and moved["answer"] <= CL_TOL and moved["score"] <= 1.0 and moved["error_bound"] == 0,
          f"path 7: answers after the move {moved}")
    check(cluster_same_state(cl["tail_states"]["cluster"], cl["tail_states"]["bare"],
                             leaves="n_seen"),
          "path 7: after one more wave the cluster's counts differ from the bare pipeline's")
    tail = cluster_gaps(cl["tail_answers"]["cluster"], cl["tail_answers"]["bare"],
                        cl["tail_mass"], scores)
    check(tail["versions_differ"] == 0 and tail["exact_differ"] == 0
          and tail["answer"] <= CL_TOL and tail["score"] <= 1.0 and tail["error_bound"] == 0,
          f"path 7: after one more wave, cluster against bare {tail}")

    rp = cl["replica"]
    check(rp["device"].startswith("cuda") and rp["read_throughs"] == 1
          and rp["first_behind"] == 0 and rp["stale_behind"] == 1
          and rp["stale_version"] == rp["first_version"] and rp["stale_equal"]
          and rp["pinned_behind"] == 1 and rp["raised"] == (1, 0) and rp["fresh_behind"] == 0
          and rp["fresh_version"] == rp["owner_version"] and rp["fresh_equal"],
          f"path 7: the replica's read-through, staleness or bound failed: {rp}")

    ch = cl["chaos"]
    check(ch["counters"]["dropped"] + ch["counters"]["delayed"] > 0
          and ch["counters"]["duplicate_deliveries"] > 0, f"path 7: no fault fired: {ch}")
    check(ch["accounted"] and ch["resilience"]["attempts"]
          == ch["resilience"]["messages"] + ch["resilience"]["retries"] == ch["counters"]["sends"],
          f"path 7: a send is unaccounted for: {ch['counters']}, {ch['resilience']}")
    check(ch["state_equal"] and ch["answers_bitwise"] and ch["late_rows"] == 0,
          "path 7: the chaos run's state or answers differ from the fault-free run's")
    check(ch["parked"] > 0 and ch["degraded"] == len(CL_CHAOS) and ch["degraded_log"]
          and all(b <= CL_STALENESS for _, b in ch["degraded_log"]),
          f"path 7: the outage parked {ch['parked']} batches, degraded {ch['degraded_log']}")
    check(ch["reacked"] > 0 and ch["recoveries"] == 1 and ch["recovered_state_equal"]
          and ch["recovered_bitwise"],
          "path 7: the recovered cell differs from the uninterrupted router")

    for name in P7_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on path 7")
    check(launches["flash_attention"] == 0, "path 7 launched flash_attention")
    check(cl["route_launches"][ops.MG_SCAN.symbol] > 0
          and cl["route_launches"][ops.MG_SCAN_SHARED.symbol] > 0,
          f"path 7 did not take both mg_scan routes: {cl['route_launches']}")
    return dict(parallel_vs_sequential=par_seq, vs_bare=vs_bare, truth=truth_gap,
                after_move=moved, after_tail=tail)


def cluster_cases(torch, mg_args, fold_args) -> list[dict]:
    """Path 7's sequential kernels on the inputs its first calls of their
    shared-memory routes gave them: ``mg_scan`` route 2 (k > MG_REGISTER_SLOTS:
    the eps-0.001 HH tenant's site scan) and ``quant_fold`` with more than
    SMEM_DEFAULT of dynamic shared memory a block (the cap-808 quantile
    tenant's coordinator), bit for bit against the plain loops on CPU copies.
    Path 5's shapes stay the ones that stand for these kernels
    (``on_path`` False), as path 6's do."""
    from repro_torch.kernels import ops

    check(mg_args is not None, "path 7 recorded no mg_scan call of route 2 (k > "
                               f"{ops.MG_REGISTER_SLOTS})")
    check(fold_args is not None,
          f"path 7 recorded no quant_fold call above {SMEM_DEFAULT} B of shared memory")
    cases = [mg_scan_case(torch, mg_args, "cluster hh-d site scan"),
             quant_fold_case(torch, fold_args, "cluster q-a coordinator fold")]
    for case in cases:
        case["on_path"] = False
    return cases


def attention_pairs(s: int, window: int) -> int:
    """(query, key) pairs causal attention over s positions needs, with a window."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_cases(torch, seed: int, prompt_len: int) -> list[dict]:
    """``flash_attention`` at the serving path's shape (bf16, Qwen3-0.6B's
    heads, ``SERVE_BATCH`` prompts of ``prompt_len``), at a ragged,
    windowed, soft-capped one in bf16 and in f32, and at the f32 serving
    check's prefill (``CHECK_PROMPT``) and its last full forward, on random
    inputs from ``seed``."""
    from repro_torch.kernels import ops, ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=DEV).manual_seed(seed + 6)
    cases = []
    for label, (b, hq, hkv, s, dh, window, cap, dtype) in (
        ("serving prefill", (SERVE_BATCH, 16, 8, prompt_len, 128, 0, 0.0, torch.bfloat16)),
        ("ragged, windowed, soft-capped", (1, 8, 2, 1000, 64, 256, 30.0, torch.bfloat16)),
        ("ragged, windowed, soft-capped", (1, 8, 2, 1000, 64, 256, 30.0, torch.float32)),
        ("f32 serving check", (1, 16, 8, CHECK_PROMPT, 128, 0, 0.0, torch.float32)),
        ("f32 serving check", (1, 16, 8, CHECK_PROMPT + CHECK_STEPS, 128, 0, 0.0,
                               torch.float32)),
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
            rate=FLOPS_BF16 if bf16 else FLOPS_F32,
            on_path=label != "ragged, windowed, soft-capped",
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
    the plain ``xla`` prefill on the same weights; the f32 kernel's launches
    and second passes in that run, and one more prefill under
    ``torch.profiler``."""
    from repro_torch.kernels import ops
    from repro_torch.models import LM

    cfg = serving_config(attn_impl="pallas", dtype="float32")
    lm = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed))
    plain = LM(serving_config(attn_impl="xla", dtype="float32"), device=DEV)
    plain.load_state_dict(lm.state_dict())
    gen = torch.Generator(device=DEV).manual_seed(seed + 8)
    toks = torch.randint(0, cfg.vocab_size, (1, CHECK_PROMPT + CHECK_STEPS), device=DEV,
                         generator=gen)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
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
    launches = ops.launch_counts()
    passes = ops.FLASH_ATTENTION_COMBINE.launches
    # One launch a layer in the prefill and in each full forward; a second
    # pass wherever the split policy cuts a q tile's keys at that length.
    lengths = range(CHECK_PROMPT, CHECK_PROMPT + CHECK_STEPS + 1)
    split = sum(any(hi - lo > ops.flash_chunk(cfg.n_heads, s, cfg.resolved_head_dim, 0,
                                              logits.device)
                    for lo, hi in ops.flash_key_tiles(s, 0)) for s in lengths)
    want = dict.fromkeys(ops.KERNELS, 0)
    want["flash_attention"] = cfg.n_layers * len(lengths)
    check(launches == want and passes == cfg.n_layers * split,
          f"f32 serving check launches {launches}, {passes} second passes; want {want}, "
          f"{cfg.n_layers * split}")
    del plain, cache
    with torch.no_grad():
        prof = device_profile(torch, lambda: lm.prefill(toks[:, :CHECK_PROMPT], CHECK_PROMPT))
    flash_ms = sum(v for k, v in prof["device_ms"].items() if "flash_attention" in k)
    return dict(prompt=CHECK_PROMPT, steps=CHECK_STEPS, prefill_kernel_vs_plain=prefill_err,
                decode_vs_forward=decode_err, logit_scale=logit_scale,
                flash_launches=launches["flash_attention"], flash_second_passes=passes,
                prefill_wall_ms=prof["wall_ms"], prefill_device_busy_ms=prof["device_busy_ms"],
                prefill_flash_ms=flash_ms,
                prefill_flash_share=flash_ms / prof["device_busy_ms"],
                prefill_flash_kernels={k: v for k, v in prof["device_count"].items()
                                       if "flash_attention" in k})


# ---------------------------------------------------------------------------
# Path 8: training Qwen3-0.6B with FD-compressed gradients
# ---------------------------------------------------------------------------


def train_config(**changes):
    """The training path's model: Qwen3-0.6B as configured (bf16, its own
    ``attn_impl`` and ``remat``), with ``changes``."""
    return serving_config(**changes)


def compression_plan(params, ccfg, m: int) -> dict:
    """What ``compress_and_aggregate`` must do with ``params``' leaves, worked
    out from their shapes on the host: the l-row chunks each shard's stacked
    sketch streams (one ``fd_gram`` and one ``fd_project`` launch of the
    batched kernels each) and the merge's chunks (one launch of the single
    kernels each), and the byte counts as the reference sums them (f32, in
    leaf order)."""
    import numpy as np

    from repro_torch.tree import leaves

    l, k = ccfg.sketch_rows, ccfg.rank
    batched = single = 0
    full = comp = np.float32(0.0)
    sketched = []
    for p in leaves(params):
        size = p.numel()
        if p.ndim < 2 or size < ccfg.min_size or p.shape[-1] < 2 * k:
            full += np.float32(4.0 * size)
            comp += np.float32(4.0 * size)
            continue
        d = p.shape[-1]
        rows = size // d
        batched += -(-rows // l)
        single += -(-m * l // l)
        full += np.float32(4.0 * size)
        comp += np.float32(4.0 * (l * d + rows * k))
        sketched.append((tuple(p.shape), rows, d))
    return dict(fd_batched=batched, fd_single=single, full_bytes=float(full),
                compressed_bytes=float(comp), ratio=float(full) / float(comp),
                sketched=sketched)


def _loss_now(torch, lm, params, batch) -> float:
    with torch.no_grad():
        return float(lm.loss(batch, params=params))


def drive_training(torch, seed: int) -> dict:
    """Path 8: Qwen3-0.6B at full width (all its layers, bf16), the launch
    counts set to 0 first: TRAIN_PLAIN_STEPS plain steps, then
    TRAIN_COMPRESSED_STEPS FD-compressed steps over TRAIN_SHARDS shards, on
    one fixed batch of TRAIN_ROWS x TRAIN_SEQ random tokens, each step timed
    on the synchronised host clock (the last under ``torch.profiler``), with
    each compressed step's kernel launches.  The first compressed step
    records the FD kernels' inputs at the (m, 2l, d) shapes it streams, and
    its ``compress_and_aggregate`` call's operands and results, held to the
    identities that do not depend on the basis right after it."""
    import repro_torch.train.step as train_step
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.optim import FDCompressConfig
    from repro_torch.train import (
        TrainConfig,
        init_train_state,
        make_compressed_train_step,
        make_train_step,
    )

    cfg = train_config()
    t0 = time.perf_counter()
    lm = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(seed + 9)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_ROWS, TRAIN_SEQ), device=DEV,
                                     generator=gen)}
    plain_cfg = TrainConfig(peak_lr=TRAIN_LR, warmup_steps=1, total_steps=100)
    ccfg = FDCompressConfig()
    comp_cfg = plain_cfg._replace(grad_compression=ccfg)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t_window = time.perf_counter()
    state = init_train_state(lm, plain_cfg)
    step = make_train_step(lm, plain_cfg)
    plain = dict(losses=[], step_s=[])
    for _ in range(TRAIN_PLAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        plain["step_s"].append(time.perf_counter() - t0)
        plain["losses"].append(float(metrics["loss"]))
    plain["loss_after"] = _loss_now(torch, lm, state.params, batch)
    plain["launches"] = ops.launch_counts()
    del state, step
    torch.cuda.empty_cache()

    state = init_train_state(lm, comp_cfg, TRAIN_SHARDS)
    plan = compression_plan(state.params, ccfg, TRAIN_SHARDS)
    step = make_compressed_train_step(lm, comp_cfg, TRAIN_SHARDS)
    comp = dict(losses=[], step_s=[], launches=[], metrics=[])
    widths = sorted({d for _, _, d in plan["sketched"]})
    shape_of = lambda b, t: tuple(b.shape[:2]) == (t, 2 * ccfg.sketch_rows)  # noqa: E731
    real_compress, seen = train_step.compress_and_aggregate, {}

    def first_compress(grads, residuals, c):
        out = real_compress(grads, residuals, c)
        if not seen:
            seen.update(grads=grads, residuals=residuals, ghat=out[0], new_r=out[1])
        return out

    recs, box, identities, prof = {}, {}, None, None
    with contextlib.ExitStack() as stack:
        # The shards' stacked sketches (T = m) and the merges (T = 1).
        for d in widths:
            for t in (TRAIN_SHARDS, 1):
                recs[("fd_gram", t, d)] = stack.enter_context(_Recorder(
                    ops, "fd_gram", lambda b, t=t, d=d: shape_of(b, t) and b.shape[2] == d))
                recs[("fd_project", t, d)] = stack.enter_context(_Recorder(
                    ops, "fd_project",
                    lambda w, u, b, t=t, d=d: shape_of(b, t) and b.shape[2] == d))
        train_step.compress_and_aggregate = first_compress
        stack.callback(setattr, train_step, "compress_and_aggregate", real_compress)
        for i in range(TRAIN_COMPRESSED_STEPS):
            before = ops.launch_counts()
            if i < TRAIN_COMPRESSED_STEPS - 1:
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                comp["step_s"].append(time.perf_counter() - t0)
            else:  # the last step under the profiler
                # About 5 M profiler events: no shapes (the eigh inputs are
                # (4, 32, 32) and, in the merges, (1, 32, 32)).
                prof = profile_ingest(torch, lambda: box.update(out=step(state, batch)), 1,
                                      shapes=False)
                state, metrics = box.pop("out")
            comp["launches"].append(_delta(ops.launch_counts(), before))
            comp["losses"].append(float(metrics["loss"]))
            comp["metrics"].append({k: float(v) for k, v in metrics.items()})
            if seen:  # outside the timed step: the first step's compression
                identities = check_train_identities(torch, seen, plan, ccfg)
                seen.clear()
    comp["loss_after"] = _loss_now(torch, lm, state.params, batch)
    launches = ops.launch_counts()
    window_s = time.perf_counter() - t_window
    return dict(cfg=cfg, lm=lm, batch=batch, ccfg=ccfg, plan=plan, state=state, plain=plain,
                comp=comp, launches=launches, profile=prof, identities=identities,
                init_s=init_s, window_s=window_s,
                recorded={key: r.args for key, r in recs.items()})


def _max_gap(a, b) -> tuple[float, float]:
    """(max |a - b|, max |b|), both as floats."""
    return float((a.float() - b.float()).abs().max()), float(b.float().abs().max())


def check_train_identities(torch, seen: dict, plan: dict, ccfg) -> dict:
    """The first compressed step's own ``compress_and_aggregate`` call (its
    per-shard bf16 gradients g_j, residuals r_j, results ``ghat`` and new_r_j)
    held to what does not depend on the basis V, for every sketched leaf:
    ``mean_j(acc_j - new_r_j)`` with ``acc_j = g_j + r_j`` (``P V``, before
    the cast to the gradients' dtype) has rank <= k, and ``ghat`` is it within
    one bf16 rounding; the byte counts are checked against the plan by
    ``check_training``."""
    from repro_torch.tree import leaves

    worst_identity, worst_rank = 0.0, 0.0
    sketched = {shape for shape, _, _ in plan["sketched"]}
    for g, r, nr, gh in zip(leaves(seen["grads"]), leaves(seen["residuals"]),
                            leaves(seen["new_r"]), leaves(seen["ghat"])):
        if tuple(g.shape[1:]) not in sketched:
            continue
        acc = g.float() + r
        pv = (acc - nr).mean(0)
        slack = BF16_ROUNDING * pv.abs() + KERNEL_RTOL * float(acc.abs().max())
        worst_identity = max(worst_identity, float(((gh.float() - pv).abs() / slack).max()))
        mat = pv.reshape(-1, pv.shape[-1]).double()
        lam = torch.linalg.eigvalsh(mat.T @ mat).flip(0).clamp_min(0.0)
        if float(lam[0]) > 0:
            worst_rank = max(worst_rank, float((lam[ccfg.rank] / lam[0]).sqrt()))
        del acc, pv, slack, mat
    check(worst_identity <= 1.0,
          f"training: ghat is {worst_identity:.3f} bf16 roundings from mean(acc - new_r)")
    check(worst_rank <= TRAIN_RANK_TOL,
          f"training: a sketched leaf of ghat has sigma_(k+1) / sigma_1 = {worst_rank:.3e} > "
          f"{TRAIN_RANK_TOL}: rank above k = {ccfg.rank}")
    return dict(ghat_vs_mean_acc_minus_new_r_over_tol=worst_identity, rank_ratio=worst_rank)


def check_train_loss_on_cpu(torch, seed: int) -> dict:
    """Qwen3-0.6B's width at TRAIN_CHECK_LAYERS layers in f32: ``LM.loss`` and
    its gradients with respect to every leaf on the card against the same
    computation on CPU copies, on one TRAIN_SEQ-token sequence: the loss
    within LOSS_RTOL, each gradient leaf within GRAD_RTOL of its largest
    entry."""
    from repro_torch.models import LM
    from repro_torch.models.weights import reference_params
    from repro_torch.tree import flatten, leaves, tree_map

    cfg = train_config(dtype="float32", n_layers=TRAIN_CHECK_LAYERS)
    lm = LM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(seed + 11))
    params = reference_params(cfg, lm.state_dict())
    gen = torch.Generator(device=DEV).manual_seed(seed + 12)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ), device=DEV, generator=gen)

    def run(p, toks):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss = lm.loss({"tokens": toks}, params=live)
        return loss.detach(), torch.autograd.grad(loss, leaves(live))

    t0 = time.perf_counter()
    loss, grads = run(params, tokens)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = run(tree_map(lambda t: t.cpu(), params), tokens.cpu())
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    check(loss_err <= LOSS_RTOL, f"training loss on the card vs the CPU: {loss_err:.3e} relative")
    worst = {}
    for (path, _), g, h in zip(flatten(params), grads, cpu_grads):
        err, scale = _max_gap(g.cpu(), h)
        worst["/".join(map(str, path))] = err / max(scale, 1e-30)
    name = max(worst, key=worst.get)
    check(worst[name] <= GRAD_RTOL,
          f"training gradient {name} on the card vs the CPU: {worst[name]:.3e} of its largest")
    return dict(layers=TRAIN_CHECK_LAYERS, loss=float(loss), loss_rel_err=loss_err,
                worst_grad=name, worst_grad_rel_err=worst[name], card_s=card_s, cpu_s=cpu_s)


def check_compression_on_cpu(torch, params, seed: int) -> dict:
    """``compress_and_aggregate`` on the card against CPU copies, at the path's
    leaf shapes: one leaf of each shape of ``params`` but the embedding
    table's (151,936 rows of d = 1,024, which stream through the (4, 32,
    1,024) shapes that wk, wo and w_down already give the kernels, and would
    double the CPU's time), TRAIN_SHARDS shards' synthetic gradients a leaf (a shared rank-k
    part whose scales run from 2 to 1, a clear gap at k, plus 1e-3 noise;
    plain noise for the 1-D leaves), zero residuals.  ``ghat`` within
    GRAD_RTOL of its largest entry, the residuals within GRAD_RTOL of the
    leaf's largest accumulated gradient, the byte counts equal."""
    from repro_torch.optim import FDCompressConfig, compress_and_aggregate, init_residuals
    from repro_torch.tree import flatten, leaves, tree_map

    picked, shapes = {}, set()
    for path, leaf in flatten(params):
        if path[0] != "embed" and tuple(leaf.shape) not in shapes:
            shapes.add(tuple(leaf.shape))
            picked["/".join(map(str, path))] = leaf
    params = picked
    ccfg, m = FDCompressConfig(), TRAIN_SHARDS
    gen = torch.Generator(device=DEV).manual_seed(seed + 13)

    def synthetic(p):
        if p.ndim < 2:
            return torch.randn((m,) + tuple(p.shape), device=DEV, generator=gen)
        d = p.shape[-1]
        rows = p.numel() // d
        k = min(ccfg.rank, d)
        v = torch.linalg.qr(torch.randn(d, k, device=DEV, generator=gen))[0].T
        u = torch.randn(m, rows, k, device=DEV, generator=gen)
        u *= torch.linspace(2.0, 1.0, k, device=DEV)
        g = u @ v + 1e-3 * torch.randn(m, rows, d, device=DEV, generator=gen)
        return g.reshape((m,) + tuple(p.shape))

    grads = tree_map(synthetic, params)
    res = init_residuals(params, m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ghat, new_r, stats = compress_and_aggregate(grads, res, ccfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = tree_map(lambda t: t.cpu(), (grads, res))
    t0 = time.perf_counter()
    cpu_ghat, cpu_r, cpu_stats = compress_and_aggregate(cpu[0], cpu[1], ccfg)
    cpu_s = time.perf_counter() - t0
    worst_g, worst_r = {}, {}
    for (path, g), gh, ch, nr, cr in zip(flatten(grads), leaves(ghat), leaves(cpu_ghat),
                                        leaves(new_r), leaves(cpu_r)):
        name = "/".join(map(str, path))
        err, scale = _max_gap(gh.cpu(), ch)
        worst_g[name] = err / max(scale, 1e-30)
        err, scale = _max_gap(nr.cpu(), cr)
        worst_r[name] = err / max(scale, float(g.abs().max()), 1e-30)
    gname, rname = max(worst_g, key=worst_g.get), max(worst_r, key=worst_r.get)
    check(worst_g[gname] <= GRAD_RTOL,
          f"compression on the card vs the CPU: ghat {gname} {worst_g[gname]:.3e}")
    check(worst_r[rname] <= GRAD_RTOL,
          f"compression on the card vs the CPU: residuals {rname} {worst_r[rname]:.3e}")
    check(float(stats.full_bytes) == float(cpu_stats.full_bytes)
          and float(stats.compressed_bytes) == float(cpu_stats.compressed_bytes),
          f"compression bytes on the card {tuple(map(float, stats))} != on the CPU "
          f"{tuple(map(float, cpu_stats))}")
    return dict(worst_ghat=gname, worst_ghat_rel_err=worst_g[gname], worst_residual=rname,
                worst_residual_rel_err=worst_r[rname], card_s=card_s, cpu_s=cpu_s)


def check_training(torch, tr) -> dict:
    """The steps' losses fall, the plain step launched no kernel, every
    compressed step launched ``fd_gram`` and ``fd_project`` as the plan says,
    its byte counts are the plan's, and the first step's compression met the
    basis-free identities."""
    plain, comp, plan = tr["plain"], tr["comp"], tr["plan"]
    for name, run in (("plain", plain), ("compressed", comp)):
        check(all(math.isfinite(x) for x in run["losses"] + [run["loss_after"]]),
              f"training {name} losses are not finite: {run['losses']}")
        check(run["loss_after"] < run["losses"][0] and run["losses"][-1] < run["losses"][0],
              f"training {name} loss did not fall: {run['losses']} then {run['loss_after']}")
    check(not any(plain["launches"].values()),
          f"the plain train step launched kernels: {plain['launches']}")
    want = dict.fromkeys(tr["launches"], 0)
    want.update(fd_gram_batched=plan["fd_batched"], fd_project_batched=plan["fd_batched"],
                fd_gram=plan["fd_single"], fd_project=plan["fd_single"])
    for i, got in enumerate(comp["launches"]):
        check(got == want, f"compressed step {i} launches {got} != the plan's {want}")
    for m in comp["metrics"]:
        check(m["comm_full_bytes"] == plan["full_bytes"]
              and m["comm_compressed_bytes"] == plan["compressed_bytes"],
              f"compressed step bytes {m} != the plan's {plan['full_bytes']} / "
              f"{plan['compressed_bytes']}")
    check(tr["identities"] is not None, "the first compressed step was not recorded")
    return dict(identities=tr["identities"], ratio=comp["metrics"][-1]["comm_full_bytes"]
                / comp["metrics"][-1]["comm_compressed_bytes"])


def train_cases(torch, recorded: dict) -> list[dict]:
    """``fd_gram`` and ``fd_project`` at the compressed step's shapes: the
    shards' stacked sketches (TRAIN_SHARDS, 2l, d) and the merges (1, 2l,
    d), for each sketched width d, on the inputs its first step gave them."""
    from repro_torch.kernels import fd_ops, ref

    cases = []
    for (kernel, t, d), args in sorted(recorded.items()):
        check(args is not None, f"the compressed step never launched {kernel} at T = {t}, d = {d}")
        b = args[-1]
        _, l, _ = b.shape
        name = kernel if t == 1 else f"{kernel}_batched"
        label = f"train {'merge' if t == 1 else 'sketch'}: (T={t}, L={l}, d={d})"
        if kernel == "fd_gram":
            cases.append(dict(
                kernel=name, shape=label, pallas=PALLAS[name],
                run=lambda b=b: fd_ops.fd_gram(b), plain=lambda b=b: ref.ref_fd_gram_batched(b),
                library=lambda b=b: torch.bmm(b, b.mT), symmetric=True, on_path=True,
                flops=2.0 * t * l * (l + 1) / 2 * d, nbytes=4.0 * (t * l * d + t * l * l)))
        else:
            w, u, _ = args
            cases.append(dict(
                kernel=name, shape=label, pallas=PALLAS[name],
                run=lambda w=w, u=u, b=b: fd_ops.fd_project(w, u, b),
                plain=lambda w=w, u=u, b=b: ref.ref_fd_project_batched(w, u, b),
                library=lambda u=u, b=b: torch.bmm(u.mT, b), on_path=True,
                flops=2.0 * t * l * l * d + t * l * d,
                nbytes=4.0 * (t * l + t * l * l + 2 * t * l * d)))
    return cases


def time_train_checkpoint(torch, state) -> dict:
    """Path 8's full-width train state through the checkpoint code that
    ``launch.train`` uses: ``AsyncCheckpointer.save`` (the caller blocks for
    the copies to host memory), its ``wait`` (compression, hashes and
    writes on the background thread), then ``ckpt.restore`` onto the card.
    Every restored leaf must equal the saved one bit for bit."""
    import tempfile

    from repro_torch import ckpt
    from repro_torch.tree import leaves

    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    with tempfile.TemporaryDirectory() as directory:
        saver = ckpt.AsyncCheckpointer(directory)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(TRAIN_COMPRESSED_STEPS, state)
        stall_s = time.perf_counter() - t0
        saver.wait()
        save_s = time.perf_counter() - t0
        disk_bytes = sum(f.stat().st_size for f in Path(directory).rglob("*") if f.is_file())
        codec = ckpt.read_manifest(directory, TRAIN_COMPRESSED_STEPS)["codec"]
        t0 = time.perf_counter()
        restored, _ = ckpt.restore(directory, TRAIN_COMPRESSED_STEPS, state, device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(restored)))
    check(same, "the restored full-width train state differs from the saved one")
    del restored
    torch.cuda.empty_cache()
    return dict(state_bytes=state_bytes, disk_bytes=disk_bytes, codec=codec, stall_s=stall_s,
                save_s=save_s, restore_s=restore_s, leaves=len(leaves(state)))


def drive_train_entry(torch) -> dict:
    """``repro_torch.launch.train.main`` on the card, ``--compress-grads
    --shards TRAIN_SHARDS`` with a checkpoint directory: TRAIN_ENTRY_STEPS
    steps, then ``--restore`` for one more.  At ``--reduced`` size: a full
    Qwen3-0.6B train state with residuals for 4 shards is about 15.5 GB,
    whose checkpoint takes minutes to write (``--train-ckpt`` times one);
    the full-width path runs through the same step functions above."""
    import io
    import tempfile

    from repro_torch.launch import train as launch_train

    with tempfile.TemporaryDirectory() as ckpt_dir:
        argv = ["--arch", TRAIN_ARCH, "--reduced", "--compress-grads", "--shards",
                str(TRAIN_SHARDS), "--global-batch", str(TRAIN_SHARDS * 2), "--seq-len", "64",
                "--ckpt-dir", ckpt_dir, "--device", DEV]
        outs = []
        t0 = time.perf_counter()
        for extra in (["--steps", str(TRAIN_ENTRY_STEPS)],
                      ["--steps", str(TRAIN_ENTRY_STEPS + 1), "--restore"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                launch_train.main(argv + extra)
            outs.append(buf.getvalue())
        entry_s = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r"loss=(\S+)", "".join(outs))]
    savings = [float(x) for x in re.findall(r"comm_saving=([0-9.]+)x", "".join(outs))]
    check(f"[train] restored step {TRAIN_ENTRY_STEPS}" in outs[1],
          f"launch.train --restore did not restore step {TRAIN_ENTRY_STEPS}: {outs[1]!r}")
    check(len(losses) >= 2 and all(math.isfinite(x) for x in losses),
          f"launch.train losses {losses}")
    check(len(savings) == len(losses) and all(s > 1.0 for s in savings),
          f"launch.train comm_saving {savings}")
    check(all("[train] done" in o for o in outs), "launch.train did not finish")
    return dict(losses=losses, comm_saving=savings, seconds=entry_s,
                lines=[line for o in outs for line in o.splitlines()])


def main() -> int:
    """Build, check the kernels, drive and check both paths, report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=64, help="P2 super-steps of 8 x 512 rows")
    ap.add_argument("--lev-steps", type=int, default=16,
                    help="pipeline super-steps (the first of the same stream)")
    ap.add_argument("--serve-prompt", type=int, default=4096, help="serving prompt length")
    ap.add_argument("--train-ckpt", action="store_true",
                    help="also save and restore path 8's full-width train state (minutes)")
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

    cluster_placement = check_cluster_names()

    t0 = time.perf_counter()
    sources = sorted({k.source for ks in ops.KERNELS.values() for k in ks})
    ptxas = _build.build(sources)
    build_s = time.perf_counter() - t0
    sass = sass_counts(_build.library_path(ops.FLASH_ATTENTION_BF16.source))
    check(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"{ops.FLASH_ATTENTION_BF16.source} has no wgmma or no TMA load in its SASS: {sass}")
    f32_sources = [k.source for ks in ops.KERNELS.values() for k in ks
                   if k is not ops.FLASH_ATTENTION_BF16]
    sass_f32 = {src: sass_counts(_build.library_path(src), SASS_F32 + ("UTMALDG",))
                for src in f32_sources}
    for src, counts in sass_f32.items():
        check(counts["HMMA"] == 0 and counts["HGMMA"] == 0,
              f"{src} holds tensor-core instructions in its SASS: {counts}")
    # The f32 flash kernel's K/V stages are fed by TMA, from registers that
    # hold its tiles without spilling.
    flash_f32 = ops.FLASH_ATTENTION.source
    check(sass_f32[flash_f32]["UTMALDG"] > 0, f"{flash_f32} has no TMA load in its SASS")
    rows = [r for r in ptxas_summary(ptxas) if r["source"] == flash_f32]
    check(rows, f"no ptxas report for {flash_f32}: remove {_build.BUILD_DIR} and run again")
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"{flash_f32} spills registers: {spilled}")

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

    # Path 6: shard P3 through the tracker, then windowed tenants in one pipeline.
    t_p6 = time.perf_counter()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    p3 = drive_p3(torch, batches)
    win = drive_windows(torch, batches, args.seed)
    torch.cuda.synchronize()
    p6_launches = ops.launch_counts()
    p6_window_s = time.perf_counter() - t_p6
    for name in P6_KERNELS:
        check(p6_launches[name] > 0, f"kernel {name} was not launched on path 6")
    p3_checks = check_p3(torch, p3, ata)
    win_checks = check_windows(torch, win)
    folds = win_folds(torch, win)
    cases += run_kernel_cases(torch, path6_cases(torch, p3, win))
    p6_s = time.perf_counter() - t_p6

    # Path 7: the cluster: cells on a hash ring, a thread a cell, the fan-out,
    # a rebalance, a replica, chaos and a crash-restart.
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t_p7 = time.perf_counter()
    # The first route-2 mg_scan (hh-d's site scan) and the first quant_fold
    # above SMEM_DEFAULT (q-a's coordinator) are recorded for the checks.
    with _Recorder(ops, "mg_scan", lambda *a: a[0].shape[1] > ops.MG_REGISTER_SLOTS) as rec_mg, \
            _Recorder(ops, "quant_fold", lambda *a: fold_smem(a) > SMEM_DEFAULT) as rec_fold:
        cl = drive_cluster(torch, batches, args.seed)
    torch.cuda.synchronize()
    p7_launches = ops.launch_counts()
    p7_window_s = time.perf_counter() - t_p7
    cl_checks = check_cluster(torch, cl, p7_launches)
    cases += run_kernel_cases(torch, cluster_cases(torch, rec_mg.args, rec_fold.args))
    p7_s = time.perf_counter() - t_p7
    for key in ("ata", "fed", "queries", "states", "answers", "moved_before", "moved_after",
                "after_move", "tail_answers", "tail_states", "snaps"):
        del cl[key]
    del p3["tracker"], p3["quadform_args"], win["pipe"], win["streams"], win["recorded"]
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
    torch.cuda.empty_cache()

    # Path 8: training Qwen3-0.6B, plain and with FD-compressed gradients.
    t_p8 = time.perf_counter()
    tr = drive_training(torch, args.seed)
    train_checks = check_training(torch, tr)
    cases += run_kernel_cases(torch, train_cases(torch, tr["recorded"]))
    train_ckpt = time_train_checkpoint(torch, tr["state"]) if args.train_ckpt else None
    leaf_template = tr["state"].params
    for key in ("lm", "state", "recorded", "batch"):
        del tr[key]
    torch.cuda.empty_cache()
    train_checks["compression_vs_cpu"] = check_compression_on_cpu(torch, leaf_template, args.seed)
    del leaf_template
    torch.cuda.empty_cache()
    train_checks["loss_vs_cpu"] = check_train_loss_on_cpu(torch, args.seed)
    entry = drive_train_entry(torch)
    p8_s = time.perf_counter() - t_p8

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
        # One wave's items over the median wave's time: neither the first
        # wave's one-time costs nor a garbage collector's pause move it.
        items_per_s_median_wave={n: hq["items"][n] / len(ws) / statistics.median(ws)
                                 for n, ws in hq["wave_s"].items()},
        wave_s=hq["wave_s"], gc=hq["gc"],
        ingest_s=hq["ingest_s"], publish_s=hq["publish_s"], latency=hq["latency"],
        profile=hq["profile"], launches=hq["launches"], save_s=hq["save_s"],
        load_s=hq["load_s"], checkpoint_bytes=hq["bytes"], leaves_equal=hq["leaves_equal"],
        answers_bit_identical_after_load=hq["loaded_bitwise"], checks=hq_checks,
        window_s=hq["hq_s"], phase_s=hq["phase_s"],
    )
    step_s = p3["step_s"]
    win_items_s = {n: win["items"][n] / win["ingest_s"][n] for n in win["items"]}
    summary["path6"] = dict(
        p3=dict(m=M, d=D, eps=EPS, s=p3["cfg"].s, steps=len(step_s),
                rows=p3_checks["rows"], step_ms_median=1e3 * statistics.median(step_s),
                step_ms_first=1e3 * step_s[0], rows_per_s=p3_checks["rows"] / sum(step_s),
                publish_s=p3["publish_s"], query_batch_s=p3["query_s"], profile=p3["profile"],
                checks=p3_checks),
        windows=dict(batches=WIN_BATCHES, rows_a_batch=WIN_ROWS, window=WIN_WINDOW,
                     buckets=WIN_BUCKETS, lateness=WIN_LATENESS, half_life=WIN_HALF_LIFE,
                     order=win["order"], items=win["items"], ingest_s=win["ingest_s"],
                     items_per_s=win_items_s, policy_publish_s=win["policy_publish_s"],
                     items_per_s_without_publishes={
                         n: win["items"][n] / max(win["ingest_s"][n]
                                                  - win["policy_publish_s"][n], 1e-9)
                         for n in win["items"]},
                     final_publish_s=win["publish_s"],
                     serve_s=win["serve_s"], folds=folds,
                     checkpoint={k: v for k, v in win["ckpt"].items() if k != "tail"},
                     checks=win_checks),
        launches=p6_launches, window_s=p6_window_s, phase_s=p6_s,
    )
    tm = cl["timing"]
    summary["path7"] = dict(
        cells=CL_CELLS, m=M, d=D, eps=EPS, waves=CL_WAVES, placement=cluster_placement,
        rows_a_wave=cl["rows_a_wave"], items_a_wave=cl["items_a_wave"],
        rows_per_s={k: dict(median=statistics.median(v["rows_per_s"]),
                            slowest=v["rows_per_s"][0], fastest=v["rows_per_s"][-1])
                    for k, v in tm.items()},
        wave_s={k: v["wave_s"] for k, v in tm.items()},
        profiled_wave={f: cl["tail_profile"][f]
                       for f in ("wall_ms", "device_busy_ms", "device_busy_share",
                                 "top_device_ms")},
        fanout=dict(latency=cl["latency"], launches=cl["fanout_launches"],
                    query_packed_calls=cl["fanout_calls"]),
        rebalance=dict(moves=cl["moves"], scale_s=cl["scale_s"],
                       s_a_moved_tenant=cl["scale_s"] / max(len(cl["moves"]), 1)),
        replica=cl["replica"],
        chaos={k: v for k, v in cl["chaos"].items() if k != "degraded_log"},
        mg_scan_routes=cl["route_launches"], checks=cl_checks, launches=p7_launches,
        window_s=p7_window_s, phase_s=p7_s, rest_s=cl["rest_s"],
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
    tcfg, prof8 = tr["cfg"], tr["profile"]
    summary["path8"] = dict(
        arch=TRAIN_ARCH, layers=tcfg.n_layers, d_model=tcfg.d_model, dtype=tcfg.dtype,
        attn_impl=tcfg.attn_impl, remat=tcfg.remat, shards=TRAIN_SHARDS, rows=TRAIN_ROWS,
        seq=TRAIN_SEQ, lr=TRAIN_LR, init_s=tr["init_s"], plain=tr["plain"],
        compressed={k: v for k, v in tr["comp"].items()}, plan={k: v for k, v in tr["plan"].items()
                                                              if k != "sketched"},
        profile=prof8, checks=train_checks, entry=entry, launches=tr["launches"],
        window_s=tr["window_s"], phase_s=p8_s, checkpoint=train_ckpt,
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
                      + hq["launches"][name] + p6_launches[name] + p7_launches[name]
                      + srun["launches"][name] + tr["launches"][name]
                      + (f32_checks["flash_launches"] if name == "flash_attention" else 0)),
            max_abs_err=max(c["max_abs_err"] for c in mine), ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"], shapes=mine,
            **{k: main[k] for k in ("chain_bound_ms", "variant", "plain_on") if k in main},
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
              f"(cp.async), {n['UTMALDG']} UTMALDG (TMA loads), {n['HMMA']} HMMA, "
              f"{n['HGMMA']} HGMMA")
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
          + f" over {HQ_WAVES - HQ_PROFILED_WAVES} waves (synchronised host clock); at the "
          "median wave "
          + ", ".join(f"{n} {v:.0f}" for n, v in hp["items_per_s_median_wave"].items())
          + f"; garbage collector {hp['gc']['pauses']} pauses, {hp['gc']['seconds']:.3f} s, "
          f"longest {hp['gc']['longest_s']:.3f} s; window {hp['window_s']:.1f} s, phase "
          f"{hp['phase_s']:.1f} s")
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
    p6 = summary["path6"]
    pc, wc = p6["p3"]["checks"], p6["windows"]["checks"]
    print(f"path 6 P3 ({card}): m = {M}, d = {D}, eps = {EPS}, s = {p6['p3']['s']}: "
          f"{p6['p3']['steps']} super-steps, median {p6['p3']['step_ms_median']:.3f} ms "
          f"(first {p6['p3']['step_ms_first']:.3f}), {p6['p3']['rows_per_s']:.0f} rows/s "
          f"(synchronised host clock); tau {pc['tau']:.6g} after {pc['doublings']} doublings; "
          f"messages {json.dumps(pc['comm'])} for {pc['rows']} rows; ||A^T A - B^T B||_2 "
          f"{pc['spectral_err']:.3e} ||A||_F^2 (limit {2 * EPS}); served directions within "
          f"{pc['max_dir_gap']:.3e} (first {P3_CHECK_DIRS}; all {N_DIRS}: "
          f"{pc['max_dir_gap_all']:.3e}; limit {pc['limit']:.3g}); publish "
          f"{p6['p3']['publish_s']:.3f} s, query_batch {p6['p3']['query_batch_s']:.3f} s")
    pp = p6["p3"]["profile"]
    print(f"path 6 P3 profile of {pp['steps']} super-steps: wall {pp['wall_ms']:.2f} ms, device "
          f"busy {pp['device_busy_ms']:.2f} ms ({pp['device_busy_share']:.1%}), "
          f"{pp['device_launches']} launches; host self ms "
          f"{json.dumps({k: round(v, 3) for k, v in pp['top_host_self_ms'].items()})}; device ms "
          f"{json.dumps({k[:60]: round(v, 3) for k, v in pp['top_device_ms'].items()})}")
    pw = p6["windows"]
    print(f"path 6 windows ({card}): items/s "
          + ", ".join(f"{n} {v:.0f}" for n, v in pw["items_per_s"].items())
          + "; without the policy publishes "
          + ", ".join(f"{n} {v:.0f}" for n, v in pw["items_per_s_without_publishes"].items())
          + "; policy publish s "
          + ", ".join(f"{n} {v:.2f}" for n, v in pw["policy_publish_s"].items())
          + f" over {WIN_BATCHES} batches (synchronised host clock); closes "
          f"{json.dumps(wc['closes'])}, publishes {json.dumps(wc['publishes'])}, late_rows "
          f"{wc['late_rows']}; window {p6['window_s']:.1f} s, phase {p6['phase_s']:.1f} s")
    for n, f in pw["folds"].items():
        print(f"path 6 serve fold {n}: {f['states']} states, {f['seconds'] * 1e3:.1f} ms, "
              f"launches {json.dumps(f['launches'])}")
    for n in ("mat-win", "mat-decay", "lev-win"):
        print(f"path 6 {n}: max gap {wc[n]['max_gap_over_mass']:.3e} of the in-state mass "
              f"(limit {wc[n]['limit']:.3g}) over {wc[n]['batches']} batches")
    print(f"path 6 lev-win scores: {wc['lev-win']['score_err_over_tol']:.3f} of tolerance; "
          f"hh-win max |estimate - weight| {wc['hh-win']['max_err_over_w']:.3e} W_win (limit "
          f"{wc['hh-win']['limit']:.3g}); q-win worst rank error "
          f"{wc['q-win']['worst_rank_err_over_w']:.3e} W_win within the certified band "
          f"{wc['q-win']['certified_band_over_w']:.3e} W_win of {wc['q-win']['states']} folded "
          f"states (the spec's envelope {wc['q-win']['envelope']:.3g}: "
          f"{'met' if wc['q-win']['within_envelope'] else 'missed, ROADMAP.md §3'})")
    ck = pw["checkpoint"]
    wp = ck["profile"]
    print(f"path 6 profile of one arrival (5 tenants, the loaded copy): wall "
          f"{wp['wall_ms']:.1f} ms, eigh {wp['eigh_host_ms']:.1f} ms of host time "
          f"({wp['eigh_host_share']:.1%}, {wp['eigh_calls']} calls), device busy "
          f"{wp['device_busy_share']:.1%}")
    print(f"path 6 checkpoint after {WIN_SAVE_AFTER} arrivals: save {ck['save_s']:.2f} s, load "
          f"{ck['load_s']:.2f} s, {ck['bytes']} bytes; leaves equal {ck['leaves_equal']}, "
          f"published equal {ck['published_equal']}; after one more batch "
          f"{json.dumps(wc['tail_gap'])}, HH and quantile bit-identical; launches in the window "
          f"{json.dumps({k: p6['launches'][k] for k in P6_KERNELS})}")
    p7 = summary["path7"]
    rs = p7["rows_per_s"]
    print(f"path 7 cluster ({card}): {CL_CELLS} cells of m = {M}, d = {D}, eps = {EPS}; "
          f"{p7['rows_a_wave']} rows and {p7['items_a_wave']} HH and quantile items a wave; "
          "rows/s at the median of the timed waves (slowest-fastest), synchronised host clock: "
          + ", ".join(f"{k} {v['median']:.0f} ({v['slowest']:.0f}-{v['fastest']:.0f})"
                      for k, v in rs.items())
          + f"; parallel / sequential {rs['parallel']['median'] / rs['sequential']['median']:.3f}"
          f", sequential / bare {rs['sequential']['median'] / rs['bare']['median']:.3f}")
    pw7 = p7["profiled_wave"]
    print(f"path 7 profile of the parallel wave after the rebalance ({CL_CELLS + 1} cells): "
          f"wall {pw7['wall_ms']:.1f} ms, device busy "
          f"{pw7['device_busy_ms']:.1f} ms ({pw7['device_busy_share']:.1%}); device ms "
          f"{json.dumps({k[:60]: round(v, 2) for k, v in list(pw7['top_device_ms'].items())[:6]})}")
    fl = p7["fanout"]["latency"]["query_batch fan-out"]
    print(f"path 7 query_batch fan-out of {fl['directions']} queries over {fl['calls']} calls: "
          f"{fl['directions'] / fl['qps_median'] * 1e3:.2f} ms median "
          f"({fl['directions'] / fl['qps_fastest'] * 1e3:.2f}-"
          f"{fl['directions'] / fl['qps_slowest'] * 1e3:.2f}); query_packed calls a cell "
          f"{json.dumps(p7['fanout']['query_packed_calls'])}, launches "
          f"{json.dumps({k: v for k, v in p7['fanout']['launches'].items() if v})}")
    rb, ch = p7["rebalance"], p7["chaos"]
    c7 = p7["checks"]
    print(f"path 7 rebalance to {CL_CELLS + 1} cells: moves {rb['moves']}, scale_to "
          f"{rb['scale_s']:.3f} s ({rb['s_a_moved_tenant']:.3f} s a moved tenant); answers "
          f"after the move within {c7['after_move']['answer']:.3e} ||A_t||_F^2 (scores "
          f"{c7['after_move']['score']:.3f} of their tolerance), after one more wave against "
          f"the bare pipeline {c7['after_tail']['answer']:.3e} (scores "
          f"{c7['after_tail']['score']:.3f}), error bounds equal")
    print(f"path 7 parallel vs sequential: bit-identical {c7['parallel_vs_sequential']['bitwise']}"
          f"; cluster vs bare pipeline: matrix and leverage subspace answers within "
          f"{c7['vs_bare']['answer']:.3e} ||A_t||_F^2 (limit {CL_TOL}), leverage scores "
          f"{c7['vs_bare']['score']:.3f} of their tolerance (rtol {SCORE_RTOL}, atol "
          f"{SCORE_ATOL}), error bounds {c7['vs_bare']['error_bound']:.3e} relative (exactly "
          "required), HH and quantile answers exact; "
          f"against the truth {json.dumps({k: float(f'{v:.4g}') for k, v in c7['truth'].items()})}")
    print(f"path 7 replica: {json.dumps(p7['replica'])}")
    print(f"path 7 chaos: {ch['messages']} messages, {ch['chaos_s']:.1f} s for both routers; "
          f"transport {json.dumps(ch['counters'])}; router "
          + json.dumps({k: ch["resilience"][k] for k in ("messages", "attempts", "retries",
                                                          "backoff_s", "unreachable")})
          + f"; state equal {ch['state_equal']}, answers bit-identical {ch['answers_bitwise']}")
    print(f"path 7 crash of {ch['victim']} ({', '.join(ch['owned'])}): checkpoint "
          f"{ch['checkpoint_s']:.2f} s, {ch['parked']} batches parked, {ch['degraded']} answers "
          f"degraded to the replica, recover_cell {ch['recover_s']:.2f} s ({ch['reacked']} "
          f"batches replayed); state equal {ch['recovered_state_equal']}, answers bit-identical "
          f"{ch['recovered_bitwise']}; window {p7['window_s']:.1f} s, phase {p7['phase_s']:.1f} s")
    print(f"path 7 launches {json.dumps({k: p7['launches'][k] for k in P7_KERNELS})}, mg_scan "
          f"routes {json.dumps(p7['mg_scan_routes'])}")
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
          f"(limit {LOGIT_ATOL}); f32 flash_attention {f32_checks['flash_launches']} launches, "
          f"{f32_checks['flash_second_passes']} second passes; one f32 prefill of "
          f"{CHECK_PROMPT} tokens: wall {f32_checks['prefill_wall_ms']:.2f} ms, device busy "
          f"{f32_checks['prefill_device_busy_ms']:.2f} ms, flash_attention "
          f"{f32_checks['prefill_flash_ms']:.3f} ms ({f32_checks['prefill_flash_share']:.1%})")
    p8, plan, cv = summary["path8"], summary["path8"]["plan"], train_checks
    cm, cl, ce = p8["compressed"], cv["loss_vs_cpu"], cv["compression_vs_cpu"]
    print(f"path 8 training {TRAIN_ARCH} ({card}): {p8['layers']} layers, d_model "
          f"{p8['d_model']}, {p8['dtype']}, attn {p8['attn_impl']}, remat {p8['remat']}; "
          f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens a step over m = {TRAIN_SHARDS} shards; plain step "
          f"s {[round(x, 3) for x in p8['plain']['step_s']]}, losses "
          f"{[round(x, 4) for x in p8['plain']['losses']]} then {p8['plain']['loss_after']:.4f}; "
          f"compressed step s {[round(x, 2) for x in cm['step_s']]} (and one profiled), losses "
          f"{[round(x, 4) for x in cm['losses']]} then {cm['loss_after']:.4f}; comm_saving "
          f"{cm['metrics'][-1]['comm_full_bytes'] / cm['metrics'][-1]['comm_compressed_bytes']:.3f}"
          f"x (the shapes' plan {plan['ratio']:.3f}x); window {p8['window_s']:.1f} s")
    print(f"path 8 ({card}) launches a compressed step {json.dumps({k: v for k, v in cm['launches'][0].items() if v})}"
          f" (plan: {plan['fd_batched']} batched and {plan['fd_single']} single of each FD "
          f"kernel); profile of the last compressed step: wall {prof8['wall_ms']:.1f} ms, device busy "
          f"{prof8['device_busy_ms']:.1f} ms ({prof8['device_busy_share']:.1%}), eigh "
          f"{prof8['eigh_host_ms']:.1f} ms of host time ({prof8['eigh_host_share']:.1%}, "
          f"{prof8['eigh_calls']} calls), fd_gram {prof8['shrink_kernel_device_ms']['fd_gram']:.1f} ms "
          f"and fd_project {prof8['shrink_kernel_device_ms']['fd_project']:.1f} ms of device time; "
          f"the profiler's own {prof8['profiler_s']:.1f} s")
    print(f"path 8 checks ({card}): loss card vs CPU ({cl['layers']} layers, f32) {cl['loss_rel_err']:.3e} "
          f"relative (limit {LOSS_RTOL}), worst gradient {cl['worst_grad']} "
          f"{cl['worst_grad_rel_err']:.3e} (limit {GRAD_RTOL}); compression card vs CPU (a leaf "
          f"of each shape but the embedding's): ghat {ce['worst_ghat']} {ce['worst_ghat_rel_err']:.3e}, "
          f"residuals {ce['worst_residual']} {ce['worst_residual_rel_err']:.3e} (limit "
          f"{GRAD_RTOL}), card {ce['card_s']:.1f} s, CPU {ce['cpu_s']:.1f} s; the first step's "
          f"ghat {cv['identities']['ghat_vs_mean_acc_minus_new_r_over_tol']:.3f} of a bf16 "
          f"rounding from mean(acc - new_r), whose sigma_(k+1) / sigma_1 is "
          f"{cv['identities']['rank_ratio']:.3e} (limit {TRAIN_RANK_TOL})")
    print(f"path 8 launch.train ({card}; --reduced, --compress-grads --shards {TRAIN_SHARDS}, restored "
          f"step {TRAIN_ENTRY_STEPS}): losses {entry['losses']}, comm_saving "
          f"{entry['comm_saving']}, {entry['seconds']:.1f} s; phase {p8_s:.1f} s")
    if train_ckpt:
        print(f"path 8 checkpoint of the full-width train state ({card}; {train_ckpt['leaves']} "
              f"leaves, {train_ckpt['state_bytes'] / 1e9:.3f} GB, {train_ckpt['codec']}): the "
              f"caller's stall {train_ckpt['stall_s']:.1f} s, written after "
              f"{train_ckpt['save_s']:.1f} s ({train_ckpt['disk_bytes'] / 1e9:.3f} GB on disk), "
              f"restored onto the card in {train_ckpt['restore_s']:.1f} s, bit for bit")
    print("summary: " + json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
