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
  on the tensor cores) or of ``csrc/flash_attention.cu`` (f32; where it
  splits the long key ranges into pieces, ``flash_split``, a second pass
  merges them in order).
* ``mg_scan`` — weighted Misra--Gries over an item stream for S summaries at
  once, one launch of ``csrc/mg_scan.cu`` (the heavy-hitter kind's
  ``mg_update_stream``; no Pallas kernel: the reference's ``lax.scan``):
  the slots in registers for k <= ``MG_REGISTER_SLOTS``, in shared memory
  above, chosen by k and counted as one kernel.
* ``quant_merge_pack`` — merge T rows of two GK summaries and pack each into
  ``cap`` slots, one launch of ``csrc/quant_merge.cu`` (the quantile kind's
  ``quant_merge``, which ends in the reference's ``lax.fori_loop`` of
  ``_quant_pack``; no Pallas kernel).
* ``quant_fold`` — the coordinator's merge of m shipped summaries, site by
  site, in one launch of the same kernel.

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
import functools
import itertools

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
    "quant_fold",
    "quant_merge_pack",
    "reset_launch_counts",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# One source for one sketch (T = 1, counted as quadform) and a packed stack
# (T > 1, counted as quadform_packed), as for the FD kernels.
QUADFORM = CudaKernel("quadform.cu", "quadform_launch", [_P, _P, _P, _I, _I, _I, _I])
QUADFORM_PACKED = CudaKernel("quadform.cu", "quadform_launch", [_P, _P, _P, _I, _I, _I, _I])
LEVSCORE = CudaKernel("levscore.cu", "levscore_launch", [_P, _P, _P, _P, _L, _I, _I])
# The f32 flash source: its kernel (q, k, v, o, scratch, scratch floats, b,
# hq, hkv, s, dh, scale, window, softcap, chunk), the second pass that merges
# a split launch's pieces, and its answer to how many floats of scratch a
# launch needs (0 where no q tile is split).
FLASH_ATTENTION = CudaKernel("flash_attention.cu", "flash_attention_launch",
                             [_P] * 5 + [_L, _I, _I, _I, _I, _I, _F, _I, _F, _I])
FLASH_ATTENTION_COMBINE = CudaKernel("flash_attention.cu", "flash_attention_combine_launch",
                                     [_P, _P] + [_I] * 6)
FLASH_SCRATCH = ("flash_attention_scratch_floats", [_I] * 6)
# ... and to how many of its blocks an SM holds at head dim dh.
FLASH_BLOCKS_PER_SM = ("flash_attention_blocks_per_sm", [_I])
FLASH_ATTENTION_BF16 = CudaKernel("flash_attention_wgmma.cu", "flash_attention_bf16_launch",
                                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _F])
# Head dims both flash sources are built for.
FLASH_HEAD_DIMS = (32, 64, 128)
# csrc/flash_attention.cu's work item: a q tile of FLASH_BQ rows, whose
# visible key tiles of FLASH_BKV keys are walked in pieces of at most
# ``chunk`` tiles (``flash_split``).
FLASH_BQ, FLASH_BKV = 64, 64
# flash_split's model, in times of one key tile on a busy SM: what an item
# costs besides its tiles (q-tile load, pipeline fill, store), what the
# second pass costs, and the share of an SM's rate one block alone gets; and
# the tiles a block slot must average before a split cannot pay.
_ITEM_COST, _COMBINE_COST, _ALONE_RATE, _NO_SPLIT_TILES = 0.3, 0.5, 0.85, 16
# Blocks of the f32 flash kernel an SM holds, by (device, dh).
_FLASH_PER_SM: dict = {}
# csrc/levscore.cu's answer to how many floats of scratch a launch needs for
# its partial scores (0 where it does not split the contraction).
LEVSCORE_SCRATCH = ("levscore_scratch_floats", [_P, _P, _I, _I])

# mg_scan's two routes, chosen by k: a summary's slots in registers (k <=
# MG_REGISTER_SLOTS, 16 a lane) or in shared memory.
MG_REGISTER_SLOTS = 512
MG_SCAN = CudaKernel("mg_scan.cu", "mg_scan_registers_launch", [_P] * 10 + [_I, _I, _I])
MG_SCAN_SHARED = CudaKernel("mg_scan.cu", "mg_scan_shared_launch", [_P] * 10 + [_I, _I, _I])
# One kernel behind two entries: T merges of row pairs (quant_merge_pack) and
# T coordinators' folds of m summaries each (quant_fold).
QUANT_MERGE_PACK = CudaKernel("quant_merge.cu", "quant_merge_pack_launch",
                              [_P] * 16 + [_I, _I, _I, _I, _F])
QUANT_FOLD = CudaKernel("quant_merge.cu", "quant_fold_launch", [_P] * 16 + [_I] * 5 + [_F])
# csrc/quant_merge.cu's answer to how many floats of scratch a launch needs
# (0 where a row's merge fits in shared memory).
QUANT_SCRATCH = ("quant_merge_scratch_floats", [_I, _I, _I, _I])
# Its answer to how many bytes of dynamic shared memory a block takes for
# one row's working arrays (la, lb, cap), where QUANT_SCRATCH answers 0.
QUANT_SMEM = ("quant_merge_smem_bytes", [_I, _I, _I])

# Every hand-written kernel of the port by name, one for each Pallas kernel
# of the reference and one for each of its sequential loops, with its
# sources.
KERNELS = {"fd_gram": (FD_GRAM,), "fd_gram_batched": (FD_GRAM_BATCHED,),
           "fd_project": (FD_PROJECT,), "fd_project_batched": (FD_PROJECT_BATCHED,),
           "quadform": (QUADFORM,), "quadform_packed": (QUADFORM_PACKED,),
           "levscore": (LEVSCORE,), "flash_attention": (FLASH_ATTENTION_BF16, FLASH_ATTENTION),
           "mg_scan": (MG_SCAN, MG_SCAN_SHARED), "quant_merge_pack": (QUANT_MERGE_PACK,),
           "quant_fold": (QUANT_FOLD,)}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel on the card since the last reset (the f32
    flash kernel's second passes count apart, in
    ``FLASH_ATTENTION_COMBINE.launches``)."""
    return {name: sum(k.launches for k in ks) for name, ks in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0, second passes included."""
    for k in (*(k for ks in KERNELS.values() for k in ks), FLASH_ATTENTION_COMBINE):
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
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
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
    scale = dh**-0.5 if scale is None else scale
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v, window, scale, logit_softcap,
                                   flash_chunk(b * hq, s, dh, window, q.device))
    out = torch.empty_like(q)
    if out.numel():
        FLASH_ATTENTION_BF16.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), b, hq, hkv, s, dh, scale, window,
                                    logit_softcap)
    return out


def flash_attention_f32(q, k, v, window: int, scale: float, logit_softcap: float,
                        chunk: int) -> torch.Tensor:
    """``csrc/flash_attention.cu`` on contiguous, 16-byte aligned f32 CUDA
    tensors, with each q tile's key range walked in pieces of at most
    ``chunk`` key tiles (``flash_split`` picks it); a split launch is
    followed by the second pass that merges the pieces."""
    b, hq, s, dh = q.shape
    out = torch.empty_like(q)
    if not out.numel():
        return out
    args = (b, hq, s, dh, window)
    floats = FLASH_ATTENTION.query(q.device, *FLASH_SCRATCH, *args, chunk)
    part = torch.empty(floats, dtype=torch.float32, device=q.device)
    FLASH_ATTENTION.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           part.data_ptr(), floats, b, hq, k.shape[1], s, dh, scale, window,
                           logit_softcap, chunk)
    if floats:
        FLASH_ATTENTION_COMBINE.launch(q.device, part.data_ptr(), out.data_ptr(), *args, chunk)
    return out


def flash_chunk(heads: int, s: int, dh: int, window: int, device: torch.device) -> int:
    """The chunk ``flash_attention`` walks the f32 kernel's pieces in on
    ``device`` (a CUDA card): ``flash_split`` for its SMs and the blocks of
    the kernel an SM holds, asked of the library once a device and dh."""
    key = (device, dh)
    if key not in _FLASH_PER_SM:
        _FLASH_PER_SM[key] = FLASH_ATTENTION.query(device, *FLASH_BLOCKS_PER_SM, dh)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return flash_split(heads, s, window, sms, _FLASH_PER_SM[key])


def flash_key_tiles(s: int, window: int) -> list[tuple[int, int]]:
    """For each q tile of ``csrc/flash_attention.cu`` (rows ``FLASH_BQ t`` ..
    ``+ FLASH_BQ - 1``), the key tiles ``[lo, hi)`` some row of it can see
    (causal, ``window`` > 0 as in ``flash_attention``)."""
    tiles = []
    for q0 in range(0, s, FLASH_BQ):
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        tiles.append((k_lo // FLASH_BKV, -(-min(s, q0 + FLASH_BQ) // FLASH_BKV)))
    return tiles


def flash_pieces(lo: int, hi: int, chunk: int) -> list[tuple[int, int]]:
    """Key tiles ``[lo, hi)`` cut as the kernel cuts them: ceil(n / chunk)
    pieces of even length (piece p from ``lo + p n // pieces``)."""
    n = hi - lo
    pieces = -(-n // chunk)
    return [(lo + p * n // pieces, lo + (p + 1) * n // pieces) for p in range(pieces)]


@functools.lru_cache(maxsize=256)
def flash_split(heads: int, s: int, window: int, sms: int, per_sm: int) -> int:
    """The most key tiles a piece of the f32 flash kernel walks, for
    ``heads`` = b hq heads of s positions on ``sms`` SMs that hold ``per_sm``
    blocks each.

    Each candidate's pieces are dispatched as the card does, in grid order
    (the last q tile's first, all heads of an item together) to the first
    free block slot, and each SM shares its rate among the blocks it holds
    (``_ALONE_RATE`` of it for a block alone); the shortest finish, with
    ``_COMBINE_COST`` for a second pass, wins (ties to the longer pieces).
    Where the block slots would average ``_NO_SPLIT_TILES`` tiles or more,
    the grid balances itself and nothing is split."""
    lengths = [hi - lo for lo, hi in flash_key_tiles(s, window)]
    longest = max(lengths)
    if heads * sum(lengths) >= _NO_SPLIT_TILES * sms * per_sm:
        return longest
    best, best_cost, seen = longest, None, set()
    for chunk in range(longest, 0, -1):
        counts = tuple(-(-n // chunk) for n in lengths)
        if counts in seen or sum(counts) > 65535:  # the same pieces; the grid's limit
            continue
        seen.add(counts)
        items = [b - a + _ITEM_COST for lo, hi in reversed(flash_key_tiles(s, window))
                 for a, b in flash_pieces(lo, hi, chunk) for _ in range(heads)]
        cost = _makespan(items, sms, per_sm) + (_COMBINE_COST if max(counts) > 1 else 0.0)
        if best_cost is None or cost < best_cost - 1e-9:
            best, best_cost = chunk, cost
    return best


def _makespan(items: list, sms: int, per_sm: int) -> float:
    """When the last of ``items`` (tile-times of work, in dispatch order)
    finishes on ``sms`` SMs of ``per_sm`` block slots, each SM sharing its
    rate among its blocks."""
    active = [[] for _ in range(sms)]
    queue = iter(items)
    for _ in range(per_sm):
        for a in active:
            a.extend(itertools.islice(queue, 1))
    now = 0.0
    while True:
        busy = [a for a in active if a]
        if not busy:
            return now
        rate = [(_ALONE_RATE if len(a) == 1 else 1.0) / len(a) for a in busy]
        step = min(min(a) / r for a, r in zip(busy, rate))
        now += step
        for a, r in zip(busy, rate):
            left = [w - step * r for w in a]
            a[:] = [w for w in left if w > 1e-9]
            a.extend(itertools.islice(queue, len(left) - len(a)))


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
    (MG_SCAN if k <= MG_REGISTER_SLOTS else MG_SCAN_SHARED).launch(
        keys.device, keys.data_ptr(), counts.data_ptr(), weight.data_ptr(), shrink.data_ptr(),
        item_keys.data_ptr(), item_weights.data_ptr(), *(a.data_ptr() for a in out), s_, k, b)
    return out


def _summaries_on_cpu(name: str, a, b, cap: int, fold: bool) -> bool:
    """Check two stacks of summaries for the merge kernel; True on the CPU.

    a: (values, g, delta, wv) (T, la) and weight (T,); b: the same with
    (T, lb) and (T,), or for a fold (T, m, lb) and (T, m), where la must be
    ``cap`` (each merge's output is the next one's input).
    """
    if len(a) != 5 or len(b) != 5:
        raise ValueError(f"{name} takes (values, g, delta, wv, weight) summaries")
    t, la = a[0].shape if a[0].ndim == 2 else (-1, -1)
    lead = b[4].shape
    lb = b[0].shape[-1] if b[0].ndim == len(lead) + 1 else -1
    if (t < 0 or lb < 0 or any(x.shape != (t, la) for x in a[:4]) or a[4].shape != (t,)
            or lead[:1] != (t,) or len(lead) != 1 + fold
            or any(x.shape != (*lead, lb) for x in b[:4]) or cap < 1 or (fold and la != cap)):
        raise ValueError(
            f"{name} shape mismatch: a {[tuple(x.shape) for x in a]}, "
            f"b {[tuple(x.shape) for x in b]}, cap={cap}")
    return operands_on_cpu(**{f"{s}{i}": x for s, xs in (("a", a), ("b", b))
                              for i, x in enumerate(xs)})


def _merge_launch(kernel: CudaKernel, a, b, two_eps: float, cap: int, *m: int):
    t, la = a[0].shape
    lb = b[0].shape[-1]
    dev = a[0].device
    # The kernel writes every slot, the pads too.
    out = (*(torch.empty(t, cap, device=dev) for _ in range(4)), torch.empty(t, device=dev))
    if t == 0:
        return out
    floats = kernel.query(dev, *QUANT_SCRATCH, t, la, lb, cap)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    kernel.launch(dev, *(x.data_ptr() for x in (*a, *b, *out)),
                  scratch.data_ptr() if floats else None, t, *m, la, lb, cap, two_eps)
    return out


def quant_merge_pack(a, b, two_eps: float, cap: int):
    """Merge T rows of two GK summaries and pack each into ``cap`` slots.

    a, b: ``(values, g, delta, wv, weight)``, leaves (T, la) / (T, lb) f32
    and weights (T,); each row's finite values ascending, ``b`` may hold
    ``+inf`` pads anywhere -> the merged (values, g, delta, wv) (T, cap) and
    weight (T,), packed at ``thresh = f32(two_eps) * weight``.  See
    ``ref.ref_quant_merge_pack`` for the rule.
    """
    if _summaries_on_cpu("quant_merge_pack", a, b, cap, fold=False):
        return ref.ref_quant_merge_pack(a, b, two_eps, cap)
    return _merge_launch(QUANT_MERGE_PACK, a, b, two_eps, cap)


def quant_fold(a, b, two_eps: float, cap: int):
    """Fold m shipped summaries into T coordinators', site 0 first, in one launch.

    a: ``(values, g, delta, wv, weight)``, leaves (T, cap) and weights (T,);
    b: leaves (T, m, lb) and weights (T, m) -> ``a`` after m
    ``quant_merge_pack`` steps, each at ``f32(two_eps)`` times its merged
    weight.  Every site is merged, all-pad ones too.  m = 0 answers ``a``
    without a launch.
    """
    if _summaries_on_cpu("quant_fold", a, b, cap, fold=True):
        return ref.ref_quant_fold(a, b, two_eps, cap)
    if b[4].shape[1] == 0:
        return tuple(x.clone() for x in a)
    return _merge_launch(QUANT_FOLD, a, b, two_eps, cap, b[4].shape[1])
