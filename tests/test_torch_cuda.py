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
    assert launched == {"fd_gram": 1, "fd_project": 1, "quadform": 2, "levscore": 0,
                        "flash_attention": 0}

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
    before = ops.launch_counts()["quadform"]
    got, again = ops.quadform_packed(b, x), ops.quadform_packed(b, x)
    one = ops.quadform(b[0], x[0])
    torch.cuda.synchronize()
    assert ops.launch_counts()["quadform"] - before == 3
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
    before = ops.launch_counts()[kernel]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert ops.launch_counts()[kernel] - before == 2
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
    assert after["fd_gram"] > before["fd_gram"]
    assert after["fd_project"] - before["fd_project"] == after["fd_gram"] - before["fd_gram"]
    b_card = torch.from_numpy(on_card.sketch_matrix()).double()
    b_cpu = torch.from_numpy(on_cpu.sketch_matrix()).double()
    _close(b_card.T @ b_card, b_cpu.T @ b_cpu, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1024, 1024), (37, 131), (300, 1000)])
def test_cuda_levscore_matches_plain(n, d):
    """``levscore`` on the card against its plain version, on a factor that
    is not symmetric (the kernel contracts ``M[k, i]`` as the plain version
    does), ragged N and d included; two runs bit-equal; one launch per
    call.  Needs a CUDA card and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    a = torch.randn(d, d, device="cuda", generator=gen)
    m = (a @ a.T / d + torch.eye(d, device="cuda") + 0.1 * torch.randn(
        d, d, device="cuda", generator=gen)).contiguous()
    x = torch.randn(n, d, device="cuda", generator=gen)
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
    (2, 4, 4, 200, 32, 0, 0.0, torch.float32),
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
    output; two runs bit-equal; one launch per call; a head dim the kernel
    is not built for raises.  Needs a CUDA card
    and nvcc: ``pytest -m cuda`` there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(s + dh)
    q, k, v = (torch.randn(b, h, s, dh, device="cuda", generator=gen).to(dtype)
               for h in (hq, hkv, hkv))
    kw = dict(window=window, logit_softcap=softcap)
    before = ops.launch_counts()["flash_attention"]
    got, again = ops.flash_attention(q, k, v, **kw), ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] - before == 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = ref.ref_attention(q.float(), k.float(), v.float(), **kw)
    if dtype == torch.float32:
        _close(got, want)
    else:
        _close(got.float(), want, rtol=2.0**-8, atol=1e-5 * float(want.abs().max()))
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q[..., :16], k[..., :16], v[..., :16])
