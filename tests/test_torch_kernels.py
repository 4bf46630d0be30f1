"""The port's kernel layer against the reference's oracles and Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version, which is
held here to ``repro.kernels.ref`` and to the reference's wrappers
(interpreted Pallas) at 1e-5, over ragged L, N and d.  The CUDA kernels
themselves run only on the card: ``test_torch_cuda.py`` holds them to the
same plain versions there.
"""
import ast
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import resolve_device
from repro_torch.kernels import fd_ops, ops

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5  # both sides accumulate in f32; only the summation order differs

# (L, d) pairs off every block multiple the reference pads to.
SHAPES = [(8, 32), (5, 17), (13, 40), (1, 3)]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _orthogonal(rng, t, l):
    return np.stack([np.linalg.qr(rng.normal(size=(l, l)))[0] for _ in range(t)]).astype(np.float32)


@pytest.mark.parametrize("l,d", SHAPES)
def test_plain_gram_and_project_match_reference(l, d):
    rng = np.random.default_rng(l * 100 + d)
    b = rng.normal(size=(3, l, d)).astype(np.float32)
    u = _orthogonal(rng, 3, l)
    w = rng.uniform(0, 1, size=(3, l)).astype(np.float32)
    tb, tu, tw = torch.tensor(b), torch.tensor(u), torch.tensor(w)

    _close(fd_ops.fd_gram(tb[0]), jref.ref_fd_gram(jnp.asarray(b[0])))
    _close(fd_ops.fd_gram(tb), jref.ref_fd_gram_batched(jnp.asarray(b)))
    _close(fd_ops.fd_project(tw[0], tu[0], tb[0]),
           jref.ref_fd_project(jnp.asarray(w[0]), jnp.asarray(u[0]), jnp.asarray(b[0])))
    _close(fd_ops.fd_project(tw, tu, tb),
           jref.ref_fd_project_batched(jnp.asarray(w), jnp.asarray(u), jnp.asarray(b)))


@pytest.mark.parametrize("l,d,n", [(8, 32, 16), (5, 17, 3), (13, 40, 9), (0, 12, 4)])
def test_plain_quadform_matches_reference_and_pallas(l, d, n):
    rng = np.random.default_rng(l + 7 * d + 31 * n)
    b = rng.normal(size=(2, l, d)).astype(np.float32)
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    tb, tx = torch.tensor(b), torch.tensor(x)
    _close(ops.quadform(tb[0], tx[0]), jops.quadform(jnp.asarray(b[0]), jnp.asarray(x[0])))
    _close(ops.quadform_packed(tb, tx), jops.quadform_packed(jnp.asarray(b), jnp.asarray(x)))
    if l:
        _close(ops.quadform(tb[0], tx[0]), jref.ref_quadform(jnp.asarray(b[0]), jnp.asarray(x[0])))


@pytest.mark.parametrize("two_l,d", [(8, 24), (6, 11)])
def test_plain_shrink_and_spectra_match_pallas(two_l, d):
    """Sign-invariant parity of the batched shrink and spectrum refresh
    against the reference's fused Pallas pipeline (interpreted)."""
    rng = np.random.default_rng(two_l * d)
    b = (rng.normal(size=(3, two_l, d)) * np.linspace(3, 1, d)).astype(np.float32)
    out, delta = ops.fd_shrink(torch.tensor(b))
    jout, jdelta = jops.fd_shrink(jnp.asarray(b), path="pallas")
    jout = np.asarray(jout, np.float64)
    out = out.numpy().astype(np.float64)
    _close(np.einsum("tld,tle->tde", out, out), np.einsum("tld,tle->tde", jout, jout))
    _close(delta, jdelta)

    sk = b[:, : two_l // 2]
    s, vt = ops.fd_spectra(torch.tensor(sk))
    js, jvt = jops.fd_spectra(jnp.asarray(sk), path="pallas")
    _close(s, js)
    # sigma^2-weighted projectors are sign-free: V^T diag(s^2) V == B^T B.
    s, vt, js, jvt = (np.asarray(a, np.float64) for a in (s, vt, js, jvt))
    _close(np.einsum("tl,tld,tle->tde", s**2, vt, vt),
           np.einsum("tl,tld,tle->tde", js**2, jvt, jvt))


def test_wrappers_check_operands_and_count_only_launches():
    b = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="float32"):
        fd_ops.fd_gram(b.double())
    with pytest.raises(ValueError, match="contiguous"):
        fd_ops.fd_gram(torch.zeros(8, 4).T)
    with pytest.raises(ValueError, match="fd_gram wants"):
        fd_ops.fd_gram(torch.zeros(8))
    with pytest.raises(ValueError, match="shape mismatch"):
        fd_ops.fd_project(torch.zeros(3), torch.zeros(4, 4), b)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.quadform(b, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.quadform(b.to("meta"), torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="l <= d"):
        ops.fd_spectra(torch.zeros(1, 9, 8))
    # The plain versions on CPU tensors are not kernel launches.
    ops.reset_launch_counts()
    ops.fd_shrink(torch.ones(2, 4, 8))
    ops.quadform(b, torch.ones(3, 8))
    ops.levscore(torch.eye(8), torch.ones(3, 8))
    ops.flash_attention(torch.ones(1, 2, 3, 8), torch.ones(1, 1, 3, 8), torch.ones(1, 1, 3, 8))
    ops.mg_scan(torch.full((2, 3), -1, dtype=torch.int32), torch.zeros(2, 3), torch.zeros(2),
                torch.zeros(2), torch.ones(2, 4, dtype=torch.int32), torch.ones(2, 4))
    summary = (*(torch.ones(2, 5) for _ in range(4)), torch.ones(2))
    ops.quant_merge_pack(summary, summary, 0.1, 3)
    ops.quant_fold(summary, tuple(x[:, None] for x in summary), 0.1, 5)
    assert ops.launch_counts() == dict.fromkeys(
        ("fd_gram", "fd_gram_batched", "fd_project", "fd_project_batched", "quadform",
         "quadform_packed", "levscore", "flash_attention", "mg_scan", "quant_merge_pack",
         "quant_fold"), 0)


def test_entry_points_refuse_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


# The f32 kernels' sources, and what would put tensor cores in them.
F32_SOURCES = ("fd_gram.cu", "fd_project.cu", "quadform.cu", "levscore.cu", "flash_attention.cu",
               "f32_staging.cuh", "mg_scan.cu", "quant_merge.cu")
TENSOR_CORE = re.compile(r"wgmma|mma\.sync|wmma|tf32", re.IGNORECASE)


def _code(path: Path) -> str:
    """A CUDA source with its comments removed."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.DOTALL)


def test_f32_kernel_sources_use_no_tensor_cores():
    """ROADMAP's numerics rule: the f32 kernels are IEEE f32 FMAs on the CUDA
    cores, so their code names no wgmma, mma.sync, wmma or TF32 (the bf16
    wgmma source is the control that the scan finds them)."""
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    found = {name: sorted(set(TENSOR_CORE.findall(_code(csrc / name)))) for name in F32_SOURCES}
    assert not any(found.values()), found
    assert TENSOR_CORE.search(_code(csrc / "flash_attention_wgmma.cu"))


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names.update(a.value for a in node.args if isinstance(a, ast.Constant))
    return names


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    scanned = {f.relative_to(REPO / "src" / "repro_torch").as_posix() for f in files[:-1]}
    assert {"core/leverage.py", "core/protocols.py", "query/service.py",
            "runtime/pipeline.py", "runtime/policies.py", "models/attention.py",
            "models/transformer.py", "serve/engine.py", "configs/registry.py",
            "ckpt/checkpoint.py", "runtime/ingest_packed.py", "core/hh.py",
            "core/quantiles.py", "core/sampling.py", "core/windows.py",
            "runtime/windowed.py"} <= scanned
    bad = {
        f"{f.relative_to(REPO)}: {name}"
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "repro")
    }
    assert not bad, sorted(bad)
