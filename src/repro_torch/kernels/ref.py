"""Plain PyTorch versions of every ported kernel (the ``ref.py`` contracts).

The wrappers in ``fd_ops.py`` / ``ops.py`` run these for tensors that lie
on the CPU; ``chip_smoke.py`` holds each CUDA kernel against them on the
card (the sequential kernels against them run on CPU copies of the
inputs, bit for bit).  All products accumulate in f32, as the reference's
``preferred_element_type=f32`` does.  ``ref_mg_scan`` and ``ref_quant_pack``
are the sequential loops the reference runs as XLA code (a ``lax.scan``
and a ``lax.fori_loop``), written step by step with the f32 additions and
comparisons in the order the reference makes them; ``ref_quant_merge_pack``
is the quantile merge that ends in the pack, and ``ref_quant_fold`` its loop
over the shipped summaries of m sites.
"""
from __future__ import annotations

import torch

__all__ = [
    "eigh_descending",
    "ref_attention",
    "ref_attention_merge",
    "ref_attention_partial",
    "ref_fd_gram",
    "ref_fd_gram_batched",
    "ref_fd_project",
    "ref_fd_project_batched",
    "ref_fd_shrink",
    "ref_fd_spectra",
    "ref_levscore",
    "ref_mg_scan",
    "ref_quadform",
    "ref_quadform_packed",
    "ref_quant_fold",
    "ref_quant_merge_pack",
    "ref_quant_pack",
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


# The f32 flash kernel's row state before any key: its running max (log2 units).
FLASH_NEG_INF = -1e30
LOG2E = 1.4426950408889634


def ref_attention_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rows: tuple[int, int],
    keys: tuple[int, int],
    *,
    window: int = 0,
    scale: float | None = None,
    logit_softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What one piece of ``csrc/flash_attention.cu``'s split leaves for query
    rows ``rows`` = [r0, r1) over keys ``keys`` = [k0, k1) of causal
    self-attention (q, k, v as in ``ref_attention`` with sq = skv), in f32:
    the rows' largest visible logit times log2(e), ``m`` (b, hq, r1 - r0)
    (``FLASH_NEG_INF`` where a row sees none of these keys), the sum ``l`` of
    the weights 2^(x log2(e) - m) over them, and ``o`` = their weighted sum
    of v, unnormalised (b, hq, r1 - r0, dh).  Not on the card's path: the
    CPU tests hold the split's arithmetic with it."""
    hq, dh = q.shape[1], q.shape[3]
    group = hq // k.shape[1]
    scale = dh**-0.5 if scale is None else scale
    (r0, r1), (k0, k1) = rows, keys
    qf = q[:, :, r0:r1].float() * scale
    kf = k[:, :, k0:k1].float().repeat_interleave(group, dim=1)
    vf = v[:, :, k0:k1].float().repeat_interleave(group, dim=1)
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if logit_softcap > 0.0:
        x = logit_softcap * torch.tanh(x / logit_softcap)
    x = x * LOG2E
    qpos = torch.arange(r0, r1, device=q.device)[:, None]
    kpos = torch.arange(k0, k1, device=q.device)[None, :]
    seen = kpos <= qpos
    if window > 0:
        seen &= kpos > qpos - window
    x = x.masked_fill(~seen, FLASH_NEG_INF)
    m = x.amax(-1) if k1 > k0 else torch.full(x.shape[:-1], FLASH_NEG_INF, device=q.device)
    p = torch.where(seen, torch.exp2(x - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhqk,bhkd->bhqd", p, vf)


def ref_attention_merge(parts) -> torch.Tensor:
    """Merge pieces ``(m, l, o)`` of ``ref_attention_partial`` for the same
    rows, in their order, as the f32 flash kernel's second pass does:
    m = max m_c, w_c = 2^(m_c - m), o = sum w_c o_c / sum w_c l_c, where a
    row with l = 0 (it saw no key) divides by 1."""
    m = parts[0][0]
    for mc, _, _ in parts[1:]:
        m = torch.maximum(m, mc)
    l = torch.zeros_like(m)
    o = torch.zeros_like(parts[0][2])
    for mc, lc, oc in parts:
        w = torch.exp2(mc - m)
        l = l + w * lc
        o = o + w[..., None] * oc
    return o / torch.where(l == 0.0, 1.0, l)[..., None]


def _mg_step(keys, counts, weight, shrink, key, w):
    """One weighted Misra--Gries update of S summaries: keys, counts (S, k);
    weight, shrink (S,); one item each, key (S,) int32, w (S,) f32."""
    rows = torch.arange(keys.shape[0], device=keys.device)
    hit = keys == key[:, None]
    any_hit = hit.any(-1)
    empty = keys == -1
    any_empty = empty.any(-1)
    first_empty = empty.to(torch.int32).argmax(-1)  # the first empty slot
    # Case 1: existing counter.
    counts_hit = counts + torch.where(hit, w[:, None], 0.0)
    # Case 2: take an empty slot.
    keys_ins = keys.index_put((rows, first_empty), key)
    counts_ins = counts.index_put((rows, first_empty), w)
    # Case 3: decrement everyone by delta = min(min_count, w); the first
    # minimal slot takes the key if weight is left over.
    min_c = counts.amin(-1)
    delta = torch.minimum(min_c, w)
    counts_dec = (counts - delta[:, None]).clamp_min(0.0)
    w_left = w - delta
    freed = counts.argmin(-1)
    take = w_left > 0.0
    keys_dec = keys.index_put((rows, freed), torch.where(take, key, keys[rows, freed]))
    counts_dec = counts_dec.index_put((rows, freed), torch.where(take, w_left, counts_dec[rows, freed]))
    new_keys = torch.where(any_hit[:, None], keys,
                           torch.where(any_empty[:, None], keys_ins, keys_dec))
    new_counts = torch.where(any_hit[:, None], counts_hit,
                             torch.where(any_empty[:, None], counts_ins, counts_dec))
    new_shrink = shrink + torch.where(any_hit | any_empty, 0.0, delta)
    return new_keys, new_counts, weight + w, new_shrink


def ref_mg_scan(keys, counts, weight, shrink, item_keys, item_weights):
    """Weighted Misra--Gries over a stream, one item at a time, for S summaries.

    keys (S, k) int32 (-1 empty), counts (S, k) f32, weight and shrink (S,)
    f32; items (S, b) int32 keys and f32 weights, absorbed in order ->
    the updated (keys, counts, weight, shrink).  Ties go to the first slot:
    the first empty one takes a new key, and the first minimal one is freed.
    """
    state = (keys, counts, weight, shrink)
    for t in range(item_keys.shape[1]):
        state = _mg_step(*state, item_keys[:, t], item_weights[:, t])
    return state


def ref_quant_pack(v, rmin, rmax, wv, thresh, cap: int):
    """Greedy GK compress of T rows of sorted interval tuples into ``cap`` slots.

    v, rmin, rmax, wv (T, n) f32, each row sorted by value with ``+inf``
    pads last; thresh (T,) f32 -> (values, g, delta, wv), each (T, cap),
    pads ``+inf`` / 0.  Tuple i folds forward into i + 1 when their values
    are equal, or when the merged band ``acc + g + d - wv`` of the next stays
    within ``thresh`` and something was emitted already; the overflow past
    ``cap`` keeps folding into the last slot.
    """
    t, n = v.shape
    dev = v.device
    g = (rmin - torch.cat([torch.zeros(t, 1, device=dev), rmin[:, :-1]], 1)).clamp_min(0.0)
    d = (rmax - rmin).clamp_min(0.0)
    live = torch.isfinite(v)
    # Tuple i + 1's quantities at step i (nxt = min(i + 1, n - 1)).
    has_next = torch.cat([live[:, 1:], torch.zeros(t, 1, dtype=torch.bool, device=dev)], 1)
    same = has_next & torch.cat([v[:, 1:] == v[:, :-1],
                                 torch.zeros(t, 1, dtype=torch.bool, device=dev)], 1)
    g_n, d_n, wv_n = (torch.cat([a[:, 1:], a[:, -1:]], 1) for a in (g, d, wv))

    out_v = torch.full((t, cap), float("inf"), device=dev)
    out_g, out_d, out_wv = (torch.zeros(t, cap, device=dev) for _ in range(3))
    rows = torch.arange(t, device=dev)
    count = torch.zeros(t, dtype=torch.int64, device=dev)
    acc = torch.zeros(t, device=dev)
    acc_wv = torch.zeros(t, device=dev)
    for i in range(n):
        live_i = live[:, i]
        acc = acc + torch.where(live_i, g[:, i], 0.0)
        band = acc + g_n[:, i] + d_n[:, i] - wv_n[:, i]
        fold = same[:, i] | (has_next[:, i] & (band <= thresh) & (count > 0))
        emit = live_i & ~fold
        idx = count.clamp_max(cap - 1)
        carry_g = torch.where(count >= cap, out_g[:, cap - 1], 0.0)
        for out, val in ((out_v, v[:, i]), (out_g, acc + carry_g), (out_d, d[:, i]),
                         (out_wv, wv[:, i] + acc_wv)):
            out[rows, idx] = torch.where(emit, val, out[rows, idx])
        count = count + emit.to(torch.int64)
        acc = torch.where(emit, 0.0, acc)
        # wv only carries across equal-value folds.
        acc_wv = torch.where(same[:, i] & live_i, acc_wv + wv[:, i], 0.0)
    return out_v, out_g, out_d, out_wv


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sums along the last axis, each prefix summed in f64 left to
    right and rounded to f32: what torch's CPU ``cumsum`` of f32 gives, and
    what the merge kernel computes (a CUDA ``cumsum`` of f32 is a parallel f32
    scan, which rounds elsewhere)."""
    return torch.cumsum(x.double(), -1).float()


def ref_quant_merge_pack(a, b, two_eps: float, cap: int):
    """Merge two rows of GK summaries and pack the result into ``cap`` slots.

    a, b: ``(values, g, delta, wv, weight)`` with (T, la) / (T, lb) tuples and
    (T,) weights; each row's finite values ascending, ``+inf`` pads anywhere
    in ``b`` (a pad holds g = delta = wv = 0).  Sorts the union stably (equal
    values: ``a``'s first), rebuilds each tuple's rank interval as its own
    plus the other summary's certified interval at that value, and packs at
    ``thresh = f32(two_eps) * (a.weight + b.weight)`` -> the merged
    ``(values, g, delta, wv, weight)``, (T, cap) and (T,).
    """
    v = torch.cat([a[0], b[0]], -1)
    g = torch.cat([a[1], b[1]], -1)
    d = torch.cat([a[2], b[2]], -1)
    wv = torch.cat([a[3], b[3]], -1)
    la, n = a[0].shape[-1], v.shape[-1]
    idx = torch.arange(n, device=v.device)
    order = torch.argsort(v, dim=-1, stable=True)  # ties: A entries first
    v, g, d, wv = (torch.gather(t, -1, order) for t in (v, g, d, wv))
    is_a = order < la
    live = torch.isfinite(v)

    cum_a = _prefix_sum(torch.where(is_a, g, 0.0))
    cum_b = _prefix_sum(torch.where(is_a, 0.0, g))
    rmin = cum_a + cum_b  # own inclusive rank + other mass sorted before
    own_cum = torch.where(is_a, cum_a, cum_b)

    pos_a = torch.where(is_a & live, idx, n)
    pos_b = torch.where(~is_a & live, idx, n)
    tail = torch.full(v.shape[:-1] + (1,), n, dtype=idx.dtype, device=v.device)
    next_a = torch.cat([_suffix_min(pos_a)[..., 1:], tail], -1)
    next_b = torch.cat([_suffix_min(pos_b)[..., 1:], tail], -1)
    n_other = torch.where(is_a, next_b, next_a)
    w_other = torch.where(is_a, b[4][..., None], a[4][..., None])
    safe = n_other.clamp(0, n - 1)
    v_s, wv_s = torch.gather(v, -1, safe), torch.gather(wv, -1, safe)
    up = (torch.gather(own_cum, -1, safe) + torch.gather(d, -1, safe)
          - wv_s * (v_s > v).to(torch.float32))
    upper_other = torch.where(n_other < n, up, w_other)
    rmax = own_cum + d + upper_other

    rmin = torch.cummax(rmin, dim=-1).values
    rmax = torch.maximum(rmax, rmin)
    weight = a[4] + b[4]
    thresh = torch.tensor(two_eps, dtype=torch.float32, device=v.device) * weight
    return (*ref_quant_pack(v, rmin, rmax, wv, thresh, cap), weight)


def ref_quant_fold(a, b, two_eps: float, cap: int):
    """Fold m shipped summaries into a coordinator's, site 0 first.

    a: ``(values, g, delta, wv, weight)`` with (T, cap) tuples and (T,)
    weights; b: the same with (T, m, lb) and (T, m).  Every site is merged,
    the all-pad ones too: the pack's prefix sums round, so an all-pad merge
    need not leave the bits as they were.
    """
    for j in range(b[0].shape[1]):
        a = ref_quant_merge_pack(a, tuple(x[:, j] for x in b), two_eps, cap)
    return a
