"""Plain PyTorch versions of every ported kernel (the ``ref.py`` contracts).

The wrappers in ``fd_ops.py`` / ``ops.py`` run these for tensors that lie
on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the
card.  All products accumulate in f32, as the reference's
``preferred_element_type=f32`` does.
"""
from __future__ import annotations

import torch

__all__ = [
    "eigh_descending",
    "ref_attention",
    "ref_fd_gram",
    "ref_fd_gram_batched",
    "ref_fd_project",
    "ref_fd_project_batched",
    "ref_fd_shrink",
    "ref_fd_spectra",
    "ref_levscore",
    "ref_quadform",
    "ref_quadform_packed",
    "shrink_weights",
    "spectra_weights",
]


def ref_fd_gram(b: torch.Tensor) -> torch.Tensor:
    """FD Gram product ``G = B @ B.T`` in f32.  b: (L, d) -> (L, L)."""
    b32 = b.float()
    return b32 @ b32.T


def ref_fd_project(w: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """FD shrink projection ``diag(w) @ (U.T @ B)``.

    w: (L,), u: (L, L), b: (L, d) -> (L, d) in b's dtype.
    """
    out = w.float()[:, None] * (u.float().T @ b.float())
    return out.to(b.dtype)


def ref_fd_gram_batched(b: torch.Tensor) -> torch.Tensor:
    """Stacked FD Grams ``G_t = B_t @ B_t.T``.  b: (T, L, d) -> (T, L, L)."""
    b32 = b.float()
    return b32 @ b32.mT


def ref_fd_project_batched(w: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stacked shrink projections ``diag(w_t) @ (U_t.T @ B_t)``.

    w: (T, L), u: (T, L, L), b: (T, L, d) -> (T, L, d) in b's dtype.
    """
    out = w.float()[..., None] * (u.float().mT @ b.float())
    return out.to(b.dtype)


def shrink_weights(lam: torch.Tensor, half: int) -> tuple[torch.Tensor, torch.Tensor]:
    """FD shrink weights from descending, clamped eigenvalues ``lam`` (T, 2l).

    ``delta_t = lam_t[l]`` is the shrink mass; ``w = sqrt((lam - delta)+ / lam)``
    with rows whose eigenvalue is ~0 weighted zero.  Shared by the plain
    and the kernel shrink so the two differ only in their products.
    """
    delta = lam[:, half]
    w = torch.sqrt((lam - delta[:, None]).clamp_min(0.0) / lam.clamp_min(1e-30))
    w = torch.where(lam > 1e-30, w, torch.zeros_like(w))
    return w, delta


def spectra_weights(lam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, w)`` for the spectrum refresh: ``s = sqrt(lam)``, ``w = 1/s``
    with rows below ``1e-7 * s_max`` weighted zero."""
    s = torch.sqrt(lam)
    tol = s[:, :1] * 1e-7
    w = torch.where(s > tol, 1.0 / s.clamp_min(1e-30), torch.zeros_like(s))
    return s, w


def eigh_descending(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``eigh`` of stacked Grams, eigenvalues descending and clamped at 0.

    The f32 solver can fail on a Gram of a mostly-zero buffer whose few
    live entries span many orders of magnitude, where the reference's
    solver does not: MKL's ``ssyevd`` raises on such a 40 x 40 Gram from a
    leverage coordinator fold, and returns NaNs without raising on one
    from a P1 coordinator shrink (4 live rows of 40).  Such a batch is
    solved in f64 and rounded back to f32.
    """
    try:
        lam, u = torch.linalg.eigh(g)  # ascending
        solved = bool(torch.isfinite(lam).all() & torch.isfinite(u).all())
    except torch.linalg.LinAlgError:
        solved = False
    if not solved:
        lam, u = (t.to(g.dtype) for t in torch.linalg.eigh(g.double()))
    return lam.flip(-1).clamp_min(0.0), u.flip(-1)


def ref_fd_shrink(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One full FD shrink of a stacked buffer: (T, 2l, d) -> (B', delta).

    Gram -> eigh (descending) -> clamp -> ``delta_t = lam_t[l]`` -> guarded
    ``w`` -> projection, batched over the leading axis.  Also accepts an
    unstacked (2l, d) buffer -> ((2l, d), ()).
    """
    squeeze = b.ndim == 2
    bs = b[None] if squeeze else b
    lam, u = eigh_descending(ref_fd_gram_batched(bs))
    w, delta = shrink_weights(lam, bs.shape[1] // 2)
    out = ref_fd_project_batched(w, u, bs)
    if squeeze:
        return out[0], delta[0]
    return out, delta


def ref_fd_spectra(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked sketch spectra via the Gram trick: (T, l, d) -> (s, vt).

    ``s`` (T, l) descending singular values, ``vt`` (T, l, d) right singular
    directions (rows below ``1e-7 * s_max`` zeroed).
    """
    lam, u = eigh_descending(ref_fd_gram_batched(b))
    s, w = spectra_weights(lam)
    return s, ref_fd_project_batched(w, u, b)


def ref_quadform(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched quadratic form ``q_j = ||B x_j||^2``.  b: (L, d), x: (N, d) -> (N,)."""
    bx = b.float() @ x.float().T
    return (bx * bx).sum(0)


def ref_quadform_packed(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Packed form: b (T, L, d), x (T, N, d) -> (T, N); row t uses sketch t."""
    bx = b.float() @ x.float().mT
    return (bx * bx).sum(1)


def ref_levscore(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ridge leverage scores ``tau_j = x_j^T M x_j`` in f32.

    m: (d, d), x: (N, d) -> (N,).  Contracts ``x @ M`` (never ``M.T``: the
    factor is a pseudo-inverse, symmetric only to rounding).
    """
    xf = x.float()
    return (xf @ m.float() * xf).sum(1)


def ref_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    scale: float | None = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Causal multi-head attention with GQA, a sliding window and a logit soft-cap, in f32.

    q: (b, hq, sq, dh); k, v: (b, hkv, skv, dh) with hq % hkv == 0 -> (b, hq,
    sq, dh) in q's dtype.  ``window`` > 0 masks keys ``window`` or more
    positions behind the query; 0 means unlimited.  Query i sits at position
    ``i + skv - sq`` of the key stream (the last sq positions, as in decode).
    Rows that see no key answer 0.
    """
    _, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = dh**-0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if logit_softcap > 0.0:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # rows that see no key
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
