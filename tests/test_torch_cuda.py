"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and ``nvcc``; they skip elsewhere.  The file
imports neither JAX nor the reference, so it runs on a GPU machine that has
only PyTorch:  ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: 1e-5 of the largest plain value (f32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fd_ops, ops, ref


def _close(got, want, rtol=1e-5, atol=None):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert got.shape == want.shape
    if atol is None:
        atol = rtol * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("t,l,n,d", [(8, 400, 1024, 1024), (1, 400, 1024, 1024), (3, 37, 45, 131)])
def test_cuda_kernels_match_plain(t, l, n, d):
    """Each CUDA kernel against its plain version on the card, ragged shapes
    included.  Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(t * l + n + d)
    b = torch.randn(t, l, d, device="cuda", generator=gen)
    x = torch.randn(t, n, d, device="cuda", generator=gen)
    lam, u = ref.eigh_descending(ref.ref_fd_gram_batched(b))
    w, _ = ref.shrink_weights(lam, l // 2)
    w, u = w.contiguous(), u.contiguous()
    before = ops.launch_counts()
    pairs = [
        (fd_ops.fd_gram(b), ref.ref_fd_gram_batched(b)),
        (fd_ops.fd_project(w, u, b), ref.ref_fd_project_batched(w, u, b)),
        (ops.quadform_packed(b, x), ref.ref_quadform_packed(b, x)),
        (ops.quadform(b[0], x[0]), ref.ref_quadform(b[0], x[0])),
    ]
    torch.cuda.synchronize()
    for got, want in pairs:
        _close(got, want)
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    # A stack (t > 1) counts as the batched and packed kernels, one buffer as
    # the single ones; quadform(b[0], x[0]) is always a single launch.
    one = int(t == 1)
    assert launched == {"fd_gram": one, "fd_gram_batched": 1 - one, "fd_project": one,
                        "fd_project_batched": 1 - one, "quadform": 1 + one,
                        "quadform_packed": 1 - one, "levscore": 0, "flash_attention": 0,
                        "mg_scan": 0, "quant_merge_pack": 0, "quant_fold": 0}

    # The whole shrink, sign-free: B'^T B' and the shrink mass delta.
    out, delta = ops.fd_shrink(b)
    want_out, want_delta = ref.ref_fd_shrink(b)
    _close(out.mT @ out, want_out.mT @ want_out, rtol=1e-4)  # via f32 eigh on the card
    _close(delta, want_delta, rtol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        fd_ops.fd_gram(b.mT)


def _on_card(shape, gen, misaligned):
    """Random f32 of ``shape`` on the card; ``misaligned`` views it 4 bytes
    into its storage, so the kernel cannot stage it with 16-byte copies."""
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, device="cuda", generator=gen)
    return (flat[1:] if misaligned else flat[:n]).view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("t,l,n,d,misaligned", [
    (3, 37, 45, 131, True),  # ragged, on offset views: 4-byte staging
    (1, 0, 100, 64, False),  # an empty sketch answers zeros
    (1, 1, 1024, 1024, False),  # one row of B
    (2, 600, 300, 1024, False),  # 15 L tiles, more than one cluster of 8 holds
    (2, 64, 1, 128, False),  # one direction
    (1, 200, 1024, 1024, True),  # the serving shape, 4 bytes off alignment
    (1, 9782, 1024, 1024, False),  # P3's served matrix at eps 0.02: 245 L tiles
    (2, 9782, 300, 131, True),  # tall and ragged, on offset views
])
def test_cuda_quadform_matches_plain(t, l, n, d, misaligned):
    """``quadform_packed`` and ``quadform`` on the card against their plain
    versions at the kernel's edges; two runs bit-equal (the L split is
    reduced in cluster-rank order, with no atomics); one launch per call.
    Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(t * l + n + d)
    b = _on_card((t, l, d), gen, misaligned)
    x = _on_card((t, n, d), gen, misaligned)
    before = ops.launch_counts()
    got, again = ops.quadform_packed(b, x), ops.quadform_packed(b, x)
    one = ops.quadform(b[0], x[0])
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert (after["quadform"] - before["quadform"],
            after["quadform_packed"] - before["quadform_packed"]) == ((3, 0) if t == 1 else (1, 2))
    assert torch.equal(got, again)
    _close(got, ref.ref_quadform_packed(b, x))
    _close(one, ref.ref_quadform(b[0], x[0]))
    if l == 0:
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fd_gram", "fd_project"])
@pytest.mark.parametrize("t,l,d,misaligned", [
    (8, 400, 1024, False),  # the site shrink
    (1, 400, 1024, False),  # the coordinator shrink: split across a cluster
    (8, 200, 1024, False),  # refresh_spectra
    (3, 37, 131, True),  # ragged, on offset views: 4-byte staging
    (1, 1, 1024, False),  # one row
    (2, 600, 1024, False),  # more tiles than one cluster holds
    (3, 64, 20, False),  # d < 32, on the TMA path
    (2, 50, 7, True),  # d < 32, 4-byte staging
    # The compressed train step's local sketches: m = 4 shards, 2l = 32 rows,
    # Qwen3-0.6B's gradient widths (d_model, the q heads, d_ff).
    (4, 32, 1024, False),
    (4, 32, 2048, False),
    (4, 32, 3072, False),
])
def test_cuda_fd_kernels_match_plain(kernel, t, l, d, misaligned):
    """``fd_gram`` and ``fd_project`` on the card against their plain versions
    at the path's shapes and the kernels' edges: within 1e-5 of the largest
    plain value; two runs bit-equal (the d or k split is reduced in
    cluster-rank order, with no atomics); one launch per call; G exactly
    symmetric.  Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(t * l + d)
    b = _on_card((t, l, d), gen, misaligned)
    if kernel == "fd_gram":
        run, plain = (lambda: fd_ops.fd_gram(b)), (lambda: ref.ref_fd_gram_batched(b))
    else:
        w = torch.rand(t, l, device="cuda", generator=gen)
        u = _on_card((t, l, l), gen, misaligned)
        run = lambda: fd_ops.fd_project(w, u, b)  # noqa: E731
        plain = lambda: ref.ref_fd_project_batched(w, u, b)  # noqa: E731
    counted = kernel if t == 1 else f"{kernel}_batched"  # one buffer, or a stack
    before = ops.launch_counts()[counted]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert ops.launch_counts()[counted] - before == 2
    assert torch.equal(got, again)
    _close(got, plain())
    if kernel == "fd_gram":
        assert torch.equal(got, got.mT)


@pytest.mark.cuda
def test_tracker_on_the_card_launches_the_shrink_kernels():
    """Ingest through ``DistributedMatrixTracker`` on a CUDA device runs the
    Gram and projection kernels, and its sketch agrees with the same tracker
    on the CPU (sign-free ``B^T B``, 1e-4 of its largest entry: f32 ``eigh``
    on two devices).  Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.core.tracker import DistributedMatrixTracker

    rows = np.random.default_rng(7).standard_normal((3, 2 * 48, 64)).astype(np.float32)
    on_card = DistributedMatrixTracker(2, 64, eps=0.5, device="cuda")
    on_cpu = DistributedMatrixTracker(2, 64, eps=0.5, device="cpu")
    before = ops.launch_counts()
    for batch in rows:
        on_card.update(batch)
        on_cpu.update(batch)
    after = ops.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    # Two sites' buffers shrink as a stack, the coordinator's alone.
    assert delta["fd_gram_batched"] > 0 and delta["fd_gram"] > 0
    assert (delta["fd_project"], delta["fd_project_batched"]) == (delta["fd_gram"],
                                                                  delta["fd_gram_batched"])
    b_card = torch.from_numpy(on_card.sketch_matrix()).double()
    b_cpu = torch.from_numpy(on_cpu.sketch_matrix()).double()
    _close(b_card.T @ b_card, b_cpu.T @ b_cpu, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,misaligned", [
    (1024, 1024, False),  # the served score queries
    (37, 131, False),
    (300, 1000, False),  # ragged
    (1, 1024, False),  # a single score query
    (37, 131, True),  # ragged, on offset views: 4-byte staging
    (64, 20, False),  # d < 32, on the TMA path
    (50, 7, True),  # d < 32, 4-byte staging
])
def test_cuda_levscore_matches_plain(n, d, misaligned):
    """``levscore`` on the card against its plain version, on a factor that
    is not symmetric (the kernel contracts ``M[k, i]`` as the plain version
    does), ragged N and d and offset views included; two runs bit-equal;
    one launch per call.  Needs a CUDA card and nvcc: ``pytest -m cuda``
    there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    a = torch.randn(d, d, device="cuda", generator=gen)
    m = _on_card((d, d), gen, misaligned)
    m.copy_(a @ a.T / d + torch.eye(d, device="cuda") + 0.1 * torch.randn(
        d, d, device="cuda", generator=gen))
    x = _on_card((n, d), gen, misaligned)
    before = ops.launch_counts()["levscore"]
    got, again = ops.levscore(m, x), ops.levscore(m, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["levscore"] - before == 2
    assert torch.equal(got, again)
    _close(got, ref.ref_levscore(m, x))
    assert ops.levscore(m, x[:0]).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,dh,window,softcap,dtype", [
    (1, 8, 2, 1000, 64, 256, 30.0, torch.float32),  # ragged, windowed, soft-capped
    (2, 4, 4, 200, 32, 0, 0.0, torch.float32),  # dh = 32
    (1, 16, 8, 520, 128, 0, 0.0, torch.float32),  # the f32 serving check's shape, split
    (1, 4, 2, 1, 128, 0, 0.0, torch.float32),  # one row
    (1, 4, 2, 40, 64, 0, 0.0, torch.float32),  # less than one 64-row q tile
    (1, 4, 2, 300, 64, 1, 0.0, torch.float32),  # window 1: each row sees itself
    (1, 4, 2, 300, 64, 20, 30.0, torch.float32),  # a window narrower than a key tile
    (1, 4, 2, 300, 32, 400, 0.0, torch.float32),  # a window longer than s
    (2, 4, 4, 777, 64, 0, 0.0, torch.float32),  # split, s no multiple of a piece
    (1, 16, 2, 600, 128, 0, 0.0, torch.float32),  # a GQA group of 8
    (1, 16, 8, 700, 128, 0, 0.0, torch.bfloat16),  # Qwen3-0.6B's heads, ragged s
    (1, 8, 2, 1000, 64, 256, 30.0, torch.bfloat16),  # the wgmma kernel's masks and cap
    (2, 4, 4, 200, 32, 0, 0.0, torch.bfloat16),  # dh = 32: the 64-byte swizzle
    (1, 4, 2, 1, 128, 0, 0.0, torch.bfloat16),  # one row
    (1, 4, 2, 100, 64, 0, 0.0, torch.bfloat16),  # less than one 128-row tile
    (1, 16, 2, 4096, 128, 0, 0.0, torch.bfloat16),  # a GQA group of 8
])
def test_cuda_flash_attention_matches_plain(b, hq, hkv, s, dh, window, softcap, dtype):
    """``flash_attention`` on the card (bf16: ``flash_attention_wgmma.cu``;
    f32: ``flash_attention.cu``) against its plain version on the same
    inputs: f32 within 1e-5 of the largest output; bf16 against the plain
    version in f32 of the same bf16 inputs, each element within one bf16
    rounding of itself (2^-8 of its magnitude) plus 1e-5 of the largest
    output; two runs bit-equal; one launch per call (and, where the f32
    kernel splits a q tile's keys, one second pass); a head dim the kernel
    is not built for raises.  Needs a CUDA card
    and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(s + dh)
    q, k, v = (torch.randn(b, h, s, dh, device="cuda", generator=gen).to(dtype)
               for h in (hq, hkv, hkv))
    kw = dict(window=window, logit_softcap=softcap)
    before = ops.launch_counts()["flash_attention"]
    passes = ops.FLASH_ATTENTION_COMBINE.launches
    got, again = ops.flash_attention(q, k, v, **kw), ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] - before == 2
    chunk = ops.flash_chunk(b * hq, s, dh, window, q.device)
    split = dtype == torch.float32 and any(hi - lo > chunk
                                           for lo, hi in ops.flash_key_tiles(s, window))
    assert ops.FLASH_ATTENTION_COMBINE.launches - passes == 2 * split
    assert got.dtype == dtype and torch.equal(got, again)
    want = ref.ref_attention(q.float(), k.float(), v.float(), **kw)
    if dtype == torch.float32:
        _close(got, want)
    else:
        _close(got.float(), want, rtol=2.0**-8, atol=1e-5 * float(want.abs().max()))
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q[..., :16], k[..., :16], v[..., :16])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 3, 64])
def test_cuda_flash_attention_f32_any_split_matches_plain(chunk):
    """The f32 kernel with its key ranges cut into pieces of at most ``chunk``
    key tiles, whatever ``flash_split`` would choose: 1 (every tile its own
    piece, rows that see no key in most pieces), 2 and 3 (uneven pieces),
    and none (64): each within 1e-5 of the largest output of the plain
    version, two runs bit-equal.  Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(chunk)
    q, k, v = (torch.randn(1, h, 1000, 64, device="cuda", generator=gen) for h in (8, 2, 2))
    for window, cap in ((0, 0.0), (256, 30.0)):
        got, again = (ops.flash_attention_f32(q, k, v, window, 0.125, cap, chunk)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _close(got, ref.ref_attention(q, k, v, window=window, scale=0.125, logit_softcap=cap))


def _mg_inputs(s, k, b, gen):
    """S Misra--Gries summaries half full (keys from a small range, so items
    hit, fill and evict) and (S, b) items with ties in their weights and some
    zero weights."""
    keys = torch.randint(0, 3 * k, (s, k), device="cuda", generator=gen, dtype=torch.int32)
    keys[:, k // 2:] = -1
    counts = torch.where(keys >= 0, torch.randint(1, 5, (s, k), device="cuda", generator=gen)
                         .float(), 0.0)
    weight, shrink = counts.sum(1), torch.zeros(s, device="cuda")
    items = torch.randint(0, 3 * k, (s, b), device="cuda", generator=gen, dtype=torch.int32)
    w = torch.randint(0, 4, (s, b), device="cuda", generator=gen).float()  # ties and zeros
    return keys, counts, weight, shrink, items, w


@pytest.mark.cuda
@pytest.mark.parametrize("s,k,b,minus_one", [
    (50, 200, 1250, False),  # path 5's site scan: route 1, 7 slots a lane
    (3, 7, 100, False),
    (1, 40, 33, False),
    (3, 600, 400, False),  # route 2: the slots in shared memory
    (5, 64, 300, True),  # items keyed -1 hit every empty slot
    (4, 1, 60, False),  # one counter
])
def test_cuda_mg_scan_matches_plain_bit_for_bit(s, k, b, minus_one):
    """``mg_scan`` against the plain step-by-step loop on CPU copies of its
    inputs, bit for bit (the same f32 additions and comparisons in the same
    order), one launch a call of the route k chooses.  Needs a CUDA card and
    nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(s + k + b)
    args = _mg_inputs(s, k, b, gen)
    if minus_one:
        args[4][:, ::5] = -1
    route = ops.MG_SCAN if k <= ops.MG_REGISTER_SLOTS else ops.MG_SCAN_SHARED
    before, total = route.launches, ops.launch_counts()["mg_scan"]
    got = ops.mg_scan(*args)
    torch.cuda.synchronize()
    assert route.launches == before + 1 and ops.launch_counts()["mg_scan"] == total + 1
    for g, w in zip(got, ref.ref_mg_scan(*(a.cpu() for a in args))):
        assert torch.equal(g.cpu(), w)


def _q_summaries(rng, rows, cap, n, eps):
    """``rows`` packed GK summaries on the CPU (``quant_insert`` of ``n``
    lognormal values on a grid of 0.25, so values repeat across summaries,
    with integer weights, some zero)."""
    from repro_torch.core import quantiles as tq

    values = np.round(rng.lognormal(3.0, 1.5, (rows, n)) * 4.0) / 4.0
    weights = rng.integers(0, 100, (rows, n)).astype(np.float32)
    empty = tq.QuantState(*(x.expand(rows, *x.shape).clone() for x in tq.quant_init(cap, "cpu")))
    return tq.quant_insert(empty, torch.tensor(values, dtype=torch.float32),
                           torch.tensor(weights), eps)


def _q_batch(rng, rows, n):
    """A site-insert batch (``exact_batch``) on the CPU: +inf holes at its
    zero-weight values, in the middle of each row."""
    from repro_torch.core import quantiles as tq

    values = np.round(rng.lognormal(3.0, 1.5, (rows, n)) * 4.0) / 4.0
    weights = rng.integers(0, 100, (rows, n)).astype(np.float32)
    weights[:, ::7] = 0.0
    return tq.exact_batch(torch.tensor(values, dtype=torch.float32), torch.tensor(weights))


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu(), w), (g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("t,la,lb,batch", [
    (50, 808, 250, True),  # path 5's site inserts: zero-weight +inf holes inside b
    (1, 808, 808, False),  # a merge of two full summaries
    (3, 37, 23, False),  # small and ragged, values repeated across the lists
    (2, 3000, 3000, True),  # too large for shared memory: the rows' arrays in scratch
])
def test_cuda_quant_merge_pack_matches_plain_bit_for_bit(t, la, lb, batch):
    """``quant_merge_pack`` against the plain merge and step-by-step pack on
    CPU copies of its inputs, bit for bit (f64 prefix sums rounded to f32,
    then the plain version's f32 operations in its order), one launch a
    call.  Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(t + la + lb)
    a = _q_summaries(rng, t, la, 4 * la, 0.0025)
    b = _q_batch(rng, t, lb) if batch else _q_summaries(rng, t, lb, 4 * lb, 0.0025)
    before = ops.launch_counts()["quant_merge_pack"]
    got = ops.quant_merge_pack(tuple(x.cuda() for x in a), tuple(x.cuda() for x in b), 0.02, la)
    torch.cuda.synchronize()
    assert ops.launch_counts()["quant_merge_pack"] == before + 1
    _same_bits(got, ref.ref_quant_merge_pack(a, b, 0.02, la))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [50, 4])
def test_cuda_quant_fold_matches_plain_bit_for_bit(m):
    """``quant_fold``: a coordinator of cap 808 folds m shipped summaries,
    every third site an all-pad non-sender, in one launch, bit for bit
    against the plain per-site loop on CPU copies.  Needs a CUDA card and
    nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(m)
    cap = 808
    coord = tuple(x[:1] for x in _q_summaries(rng, 1, cap, 3000, 0.005))
    shipped = _q_summaries(rng, m, cap, 1500, 0.0025)
    send = torch.arange(m) % 3 != 1
    pads = (float("inf"), 0.0, 0.0, 0.0)
    shipped = tuple(torch.where(send[:, None], x, p)[None] for x, p in zip(shipped[:4], pads)) + (
        torch.where(send, shipped.weight, 0.0)[None],)
    before = ops.launch_counts()["quant_fold"]
    got = ops.quant_fold(tuple(x.cuda() for x in coord), tuple(x.cuda() for x in shipped),
                         0.01, cap)
    torch.cuda.synchronize()
    assert ops.launch_counts()["quant_fold"] == before + 1
    _same_bits(got, ref.ref_quant_fold(coord, shipped, 0.01, cap))


def _from_two_threads(calls, reps):
    """Run each of two zero-argument calls ``reps`` times on a thread of its
    own, both started together; return each thread's outputs."""
    import threading

    start = threading.Barrier(2)
    outs = [[], []]

    def run(i):
        start.wait()
        for _ in range(reps):
            outs[i].append(calls[i]())
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def _fold_call(rng, cap, m):
    """A fold of m summaries into one coordinator of ``cap`` slots, whose
    block takes more than 48 KB of dynamic shared memory (no scratch)."""
    coord = tuple(x[:1].cuda() for x in _q_summaries(rng, 1, cap, 4 * cap, 0.005))
    shipped = tuple(x[None].cuda() for x in _q_summaries(rng, m, cap, 2 * cap, 0.0025))
    dev, la, lb = coord[0].device, coord[0].shape[1], shipped[0].shape[-1]
    assert ops.QUANT_FOLD.query(dev, *ops.QUANT_SCRATCH, 1, la, lb, cap) == 0
    assert ops.QUANT_FOLD.query(dev, *ops.QUANT_SMEM, la, lb, cap) > 48 * 1024
    return lambda: ops.quant_fold(coord, shipped, 0.01, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["mg_scan k=600,1000", "mg_scan k=7000,12000",
                                  "quant_fold cap=600,808"])
def test_cuda_launches_from_two_threads_match_serial(pair):
    """Two threads launch at once, 200 times each, at two sizes (as two
    cells of a cluster do): no launch error, every result bit-identical to
    the same call made alone, and the launch counts exact.  ``mg_scan`` at k
    = 7,000 and 12,000 and ``quant_fold`` at cap 600 and 808 (67 and 90 KB a
    block) take their routes with more than 48 KB of dynamic shared memory,
    whose limit each launch sets to the kernel's maximum.  Needs a CUDA
    card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    reps = 200
    gen = torch.Generator(device="cuda").manual_seed(11)
    rng = np.random.default_rng(11)
    if pair.startswith("mg_scan"):
        ks = [int(k) for k in pair.split("=")[1].split(",")]
        args = [_mg_inputs(2, k, 300, gen) for k in ks]
        calls = [lambda a=a: ops.mg_scan(*a) for a in args]
        name = "mg_scan"
    else:
        calls = [_fold_call(rng, 600, 4), _fold_call(rng, 808, 4)]
        name = "quant_fold"
    alone = [call() for call in calls]
    torch.cuda.synchronize()
    before = ops.launch_counts()[name]
    outs = _from_two_threads(calls, reps)
    assert ops.launch_counts()[name] == before + 2 * reps
    for want, got in zip(alone, outs):
        for out in got:
            for g, w in zip(out, want):
                assert torch.equal(g, w)
