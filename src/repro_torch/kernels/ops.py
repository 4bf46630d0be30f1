"""Public entry points of the matrix kernels.

* ``fd_gram`` / ``fd_project`` — FD shrink products (see fd_ops.py).
* ``fd_shrink`` / ``fd_spectra`` — the batched FD shrink and spectrum
  refresh: one Gram launch, one batched ``torch.linalg.eigh``, one
  projection launch for a whole ``(T, L, d)`` pack.
* ``quadform`` / ``quadform_packed`` — batched ``||B x_j||^2``, one launch
  of ``csrc/quadform.cu`` for one sketch or a packed stack of them.
* ``levscore`` — batched ridge leverage scores ``x_j^T M x_j``, one launch
  of ``csrc/levscore.cu`` (its kernel and, where it splits the contraction
  over blocks, a second pass that adds their partial scores in order).
* ``flash_attention`` — causal self-attention with GQA, a sliding window and
  a logit soft-cap: one launch of ``csrc/flash_attention_wgmma.cu`` (bf16,
  on the tensor cores) or of ``csrc/flash_attention.cu`` (f32).
* ``mg_scan`` — weighted Misra--Gries over an item stream for S summaries at
  once, one launch of ``csrc/mg_scan.cu`` (the heavy-hitter kind's
  ``mg_update_stream``; no Pallas kernel: the reference's ``lax.scan``).
* ``quant_pack`` — the greedy GK compress of T rows of sorted tuples, one
  launch of ``csrc/quant_pack.cu`` (the quantile kind's ``_quant_pack``; no
  Pallas kernel: the reference's ``lax.fori_loop``).

Dispatch is by the tensors' device, as in fd_ops.py: CUDA launches the
kernel or raises, CPU runs the plain version from ``ref.py``.
``launch_counts`` reads each kernel's launch count: a launch of one
buffer or sketch counts as ``fd_gram`` / ``fd_project`` / ``quadform``, of
a stack as ``fd_gram_batched`` / ``fd_project_batched`` /
``quadform_packed`` (the reference's two Pallas kernels each), and the two
flash sources count as one kernel; ``reset_launch_counts`` sets them to
zero.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaKernel
from repro_torch.kernels.fd_ops import (
    FD_GRAM,
    FD_GRAM_BATCHED,
    FD_PROJECT,
    FD_PROJECT_BATCHED,
    fd_gram,
    fd_project,
    operands_on_cpu,
)

__all__ = [
    "KERNELS",
    "fd_gram",
    "fd_project",
    "fd_shrink",
    "fd_spectra",
    "flash_attention",
    "launch_counts",
    "levscore",
    "mg_scan",
    "quadform",
    "quadform_packed",
    "quant_pack",
    "reset_launch_counts",
]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# One source for one sketch (T = 1, counted as quadform) and a packed stack
# (T > 1, counted as quadform_packed), as for the FD kernels.
QUADFORM = CudaKernel("quadform.cu", "quadform_launch", [_P, _P, _P, _I, _I, _I, _I])
QUADFORM_PACKED = CudaKernel("quadform.cu", "quadform_launch", [_P, _P, _P, _I, _I, _I, _I])
LEVSCORE = CudaKernel("levscore.cu", "levscore_launch", [_P, _P, _P, _P, _L, _I, _I])
_F = ctypes.c_float
_FLASH_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F]
FLASH_ATTENTION = CudaKernel("flash_attention.cu", "flash_attention_launch", _FLASH_ARGS)
FLASH_ATTENTION_BF16 = CudaKernel("flash_attention_wgmma.cu", "flash_attention_bf16_launch",
                                  _FLASH_ARGS)
# Head dims both flash sources are built for, and the source of each dtype.
FLASH_HEAD_DIMS = (32, 64, 128)
_FLASH_BY_DTYPE = {torch.float32: FLASH_ATTENTION, torch.bfloat16: FLASH_ATTENTION_BF16}
# csrc/levscore.cu's answer to how many floats of scratch a launch needs for
# its partial scores (0 where it does not split the contraction).
LEVSCORE_SCRATCH = ("levscore_scratch_floats", [_P, _P, _I, _I])

MG_SCAN = CudaKernel("mg_scan.cu", "mg_scan_launch", [_P] * 10 + [_I, _I, _I])
QUANT_PACK = CudaKernel("quant_pack.cu", "quant_pack_launch", [_P] * 9 + [_I, _I, _I])

# Every hand-written kernel of the port by name, one for each Pallas kernel
# of the reference and one for each of its sequential loops, with its
# sources.
KERNELS = {"fd_gram": (FD_GRAM,), "fd_gram_batched": (FD_GRAM_BATCHED,),
           "fd_project": (FD_PROJECT,), "fd_project_batched": (FD_PROJECT_BATCHED,),
           "quadform": (QUADFORM,), "quadform_packed": (QUADFORM_PACKED,),
           "levscore": (LEVSCORE,), "flash_attention": (FLASH_ATTENTION_BF16, FLASH_ATTENTION),
           "mg_scan": (MG_SCAN,), "quant_pack": (QUANT_PACK,)}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel on the card since the last reset."""
    return {name: sum(k.launches for k in ks) for name, ks in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for ks in KERNELS.values():
        for k in ks:
            k.launches = 0


def quadform_packed(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cross-tenant packed ``||B_t x_tj||^2``: (T, L, d) x (T, N, d) -> (T, N).

    One launch serves every tenant in the pack.  Ragged per-tenant query
    counts can be zero-padded to a shared N: zero directions answer 0.
    """
    if b.ndim != 3 or x.ndim != 3 or x.shape[0] != b.shape[0] or x.shape[2] != b.shape[2]:
        raise ValueError(f"quadform_packed shape mismatch: b{tuple(b.shape)} x{tuple(x.shape)}")
    if operands_on_cpu(b=b, x=x):
        return ref.ref_quadform_packed(b, x)
    t, l, d = b.shape
    n = x.shape[1]
    q = torch.empty((t, n), dtype=torch.float32, device=b.device)
    if q.numel():
        (QUADFORM if t == 1 else QUADFORM_PACKED).launch(b.device, b.data_ptr(), x.data_ptr(),
                                                         q.data_ptr(), t, l, n, d)
    return q


def quadform(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ``||B x_j||^2``: (L, d) x (N, d) -> (N,).  L = 0 answers zeros."""
    if b.ndim != 2 or x.ndim != 2 or x.shape[1] != b.shape[1]:
        raise ValueError(f"quadform shape mismatch: b{tuple(b.shape)} x{tuple(x.shape)}")
    if operands_on_cpu(b=b, x=x):
        return ref.ref_quadform(b, x)
    return quadform_packed(b[None], x[None])[0]


def levscore(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched ridge leverage scores ``x_j^T M x_j``: (d, d) x (N, d) -> (N,).

    M need not be symmetric; only ``x^T M x`` is computed.  N = 0 (and
    d = 0) answer without a launch.
    """
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"scoring factor must be square (d, d), got {tuple(m.shape)}")
    if x.ndim != 2 or x.shape[1] != m.shape[0]:
        raise ValueError(f"levscore shape mismatch: m{tuple(m.shape)} x{tuple(x.shape)}")
    if operands_on_cpu(m=m, x=x):
        return ref.ref_levscore(m, x)
    n, d = x.shape
    if not (n and d):
        return torch.zeros(n, dtype=torch.float32, device=x.device)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    floats = LEVSCORE.query(x.device, *LEVSCORE_SCRATCH, m.data_ptr(), x.data_ptr(), n, d)
    part = torch.empty(floats, dtype=torch.float32, device=x.device)
    LEVSCORE.launch(x.device, m.data_ptr(), x.data_ptr(), out.data_ptr(), part.data_ptr(),
                    part.numel(), n, d)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    scale: float | None = None,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """Causal self-attention with GQA: q (b, hq, s, dh), k and v (b, hkv, s, dh) -> (b, hq, s, dh).

    Online softmax in f32, output in q's dtype (f32 or bf16, the same for all
    three; bf16 runs on the tensor cores, f32 on the CUDA cores).  The kv
    head of query head h is ``h // (hq // hkv)``; ``window`` > 0
    masks keys ``window`` or more positions behind the query, ``logit_softcap``
    > 0 caps the logits before the mask, and ``scale`` defaults to
    ``dh ** -0.5``.  Any s: the kernel masks the ragged edge, nothing is
    padded.  On the card dh must be one of ``FLASH_HEAD_DIMS``; non-contiguous
    views are copied to contiguous ones first.  There is no backward.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q (b, hq, s, dh), k and v (b, hkv, s, dh); "
                         f"got q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != dh:
        raise ValueError(f"flash_attention is self-attention: k, v must be ({b}, hkv, {s}, {dh}), "
                         f"got {tuple(k.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"GQA needs hq % hkv == 0, got {hq}, {hkv}")
    if q.dtype not in _FLASH_BY_DTYPE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    if q.device.type == "cpu":
        return ref.ref_attention(q, k, v, window=window, scale=scale, logit_softcap=logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel is built for head dims {FLASH_HEAD_DIMS}, "
                         f"got {dh}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention has no backward (nor has the reference's)")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel():
        _FLASH_BY_DTYPE[q.dtype].launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), b, hq, hkv, s, dh,
                                        dh**-0.5 if scale is None else scale, window,
                                        logit_softcap)
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (vector and TMA loads), copied if not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fd_shrink(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FD shrink: (..., 2l, d) -> (B' (..., 2l, d), delta (...)).

    Any number of leading batch axes — one buffer (2l, d), T tenants' or
    m sites' (T, 2l, d), a pack's site buffers (T, m, 2l, d) — flatten
    into one contiguous (B, 2l, d) batch: one Gram launch, ONE batched
    ``eigh`` over the (B, 2l, 2l) Grams, one projection launch with the
    ``diag(w)`` rescale in its epilogue; the axes are restored after.
    Numerics match ``ref.ref_fd_shrink``.
    """
    lead, (l2, d) = b.shape[:-2], b.shape[-2:]
    bs = b.reshape(-1, l2, d)
    lam, u = ref.eigh_descending(fd_gram(bs))
    w, delta = ref.shrink_weights(lam, l2 // 2)
    out = fd_project(w.contiguous(), u.contiguous(), bs)
    return out.reshape(*lead, l2, d), delta.reshape(lead)


def fd_spectra(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched sketch spectra: (T, l, d) -> (s (T, l), vt (T, l, d)).

    Singular values descending and right singular directions of every
    stacked sketch, up to per-row sign; rows whose singular value is below
    ``1e-7 * s_max`` come back zero.  Requires l <= d.
    """
    if b.ndim != 3 or b.shape[1] > b.shape[2]:
        raise ValueError(f"fd_spectra wants stacked (T, l, d) with l <= d, got {tuple(b.shape)}")
    lam, u = ref.eigh_descending(fd_gram(b))
    s, w = ref.spectra_weights(lam)
    return s, fd_project(w.contiguous(), u.contiguous(), b)


def _int_operands_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Check a kernel's int32 operands: contiguous and on ``device``."""
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"operands on different devices: {name} on {t.device}, not {device}")


def mg_scan(keys, counts, weight, shrink, item_keys, item_weights):
    """Weighted Misra--Gries over a stream for S summaries at once.

    keys (S, k) int32 (-1 empty), counts (S, k) f32, weight and shrink (S,)
    f32; item_keys (S, b) int32 and item_weights (S, b) f32, absorbed in
    order -> new (keys, counts, weight, shrink).  Summary s takes row s of
    the items.  b = 0 answers the state, without a launch.
    """
    s_, k = keys.shape[0], keys.shape[-1]
    if (keys.ndim != 2 or counts.shape != keys.shape or weight.shape != (s_,)
            or shrink.shape != (s_,) or item_keys.ndim != 2 or item_keys.shape[0] != s_
            or item_weights.shape != item_keys.shape or k < 1):
        raise ValueError(
            f"mg_scan shape mismatch: keys{tuple(keys.shape)} counts{tuple(counts.shape)} "
            f"weight{tuple(weight.shape)} shrink{tuple(shrink.shape)} "
            f"items{tuple(item_keys.shape)} weights{tuple(item_weights.shape)}")
    on_cpu = operands_on_cpu(counts=counts, weight=weight, shrink=shrink,
                             item_weights=item_weights)
    _int_operands_on(counts.device, keys=keys, item_keys=item_keys)
    if on_cpu:
        return ref.ref_mg_scan(keys, counts, weight, shrink, item_keys, item_weights)
    b = item_keys.shape[1]
    if b == 0 or s_ == 0:
        return tuple(a.clone() for a in (keys, counts, weight, shrink))
    out = tuple(torch.empty_like(a) for a in (keys, counts, weight, shrink))
    MG_SCAN.launch(keys.device, keys.data_ptr(), counts.data_ptr(), weight.data_ptr(),
                   shrink.data_ptr(), item_keys.data_ptr(), item_weights.data_ptr(),
                   *(a.data_ptr() for a in out), s_, k, b)
    return out


def quant_pack(v, rmin, rmax, wv, thresh, cap: int):
    """Greedy GK compress of T rows of sorted interval tuples into ``cap`` slots.

    v, rmin, rmax, wv (T, n) f32, each row sorted by value with ``+inf``
    pads last; thresh (T,) f32 -> (values, g, delta, wv), each (T, cap).
    See ``ref.ref_quant_pack`` for the rule.
    """
    if (v.ndim != 2 or rmin.shape != v.shape or rmax.shape != v.shape or wv.shape != v.shape
            or thresh.shape != v.shape[:1] or cap < 1):
        raise ValueError(
            f"quant_pack shape mismatch: v{tuple(v.shape)} rmin{tuple(rmin.shape)} "
            f"rmax{tuple(rmax.shape)} wv{tuple(wv.shape)} thresh{tuple(thresh.shape)} cap={cap}")
    if operands_on_cpu(v=v, rmin=rmin, rmax=rmax, wv=wv, thresh=thresh):
        return ref.ref_quant_pack(v, rmin, rmax, wv, thresh, cap)
    t, n = v.shape
    out = (torch.full((t, cap), float("inf"), device=v.device),
           *(torch.zeros(t, cap, device=v.device) for _ in range(3)))
    if t and n:
        QUANT_PACK.launch(v.device, v.data_ptr(), rmin.data_ptr(), rmax.data_ptr(),
                          wv.data_ptr(), thresh.data_ptr(), *(a.data_ptr() for a in out),
                          t, n, cap)
    return out
