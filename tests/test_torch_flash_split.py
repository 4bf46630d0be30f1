"""The f32 flash kernel's split over keys, in plain PyTorch on the CPU.

``csrc/flash_attention.cu`` cuts the key range of each 64-row q tile into
pieces of at most ``ops.flash_split``'s chunk of 64-key tiles
(``ops.flash_key_tiles``, ``ops.flash_pieces``); each piece keeps its rows'
max, sum and unnormalised output, and a second pass merges the pieces in
order.  Here the same pieces go through ``ref.ref_attention_partial`` and
``ref.ref_attention_merge`` and must give ``ref.ref_attention`` within 1e-6
of its largest output (f32 sums in another order, exp2 of logits times
log2(e)); and the pieces must cover every (query, key) pair the mask lets
through exactly once, and no key tile the mask hides from the whole q tile.
No JAX: the kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

H100_SMS = 132


def _split_attention(q, k, v, chunk, **kw):
    """Attention computed piece by piece, as the kernel cuts it, and merged."""
    s = q.shape[2]
    out = torch.empty_like(q)
    for t, (lo, hi) in enumerate(ops.flash_key_tiles(s, kw.get("window", 0))):
        rows = (t * ops.FLASH_BQ, min(s, (t + 1) * ops.FLASH_BQ))
        parts = [ref.ref_attention_partial(q, k, v, rows, (a * ops.FLASH_BKV,
                                                          min(s, b * ops.FLASH_BKV)), **kw)
                 for a, b in ops.flash_pieces(lo, hi, chunk)]
        out[:, :, rows[0]:rows[1]] = ref.ref_attention_merge(parts)
    return out


@pytest.mark.parametrize("b,hq,hkv,s,dh,window,cap,chunk", [
    (1, 2, 1, 520, 16, 0, 0.0, None),  # causal, the policy's split on an H100
    (2, 4, 2, 300, 8, 0, 0.0, 1),  # every key tile its own piece: rows that see no key in most
    (1, 4, 1, 333, 8, 100, 0.0, 3),  # GQA group of 4, windowed, ragged
    (1, 2, 2, 200, 8, 40, 5.0, 2),  # capped, a window narrower than a q tile
    (1, 2, 1, 257, 8, 1, 0.0, 1),  # window 1: a row sees only itself
    (1, 2, 1, 1, 8, 0, 0.0, None),  # one row
])
def test_split_attention_matches_plain(b, hq, hkv, s, dh, window, cap, chunk):
    rng = np.random.default_rng(s + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, dh)).astype(np.float32))
               for h in (hq, hkv, hkv))
    chunk = chunk or ops.flash_split(b * hq, s, window, H100_SMS, 2)
    kw = dict(window=window, logit_softcap=cap)
    got = _split_attention(q, k, v, chunk, **kw)
    want = ref.ref_attention(q, k, v, **kw)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_merge_of_pieces_that_see_nothing():
    """A piece in which a row sees no key weighs 0, and a row that sees no key
    in any piece (a row past s in the kernel) comes out 0, not NaN."""
    q = torch.ones(1, 1, 64, 4)
    k = v = torch.ones(1, 1, 128, 4)
    # Keys 64..127 lie after every query row 0..63: nothing is visible.
    empty = ref.ref_attention_partial(q, k, v, (0, 64), (64, 128))
    assert torch.all(empty[0] == ref.FLASH_NEG_INF) and torch.all(empty[1] == 0.0)
    assert torch.equal(ref.ref_attention_merge([empty, empty]), torch.zeros(1, 1, 64, 4))
    seen = ref.ref_attention_partial(q, k, v, (0, 64), (0, 64))
    assert torch.equal(ref.ref_attention_merge([seen, empty]), ref.ref_attention_merge([seen]))


@pytest.mark.parametrize("s,window", [(1, 0), (100, 0), (520, 0), (1000, 256), (700, 1),
                                      (300, 20), (300, 400), (4096, 0)])
def test_pieces_cover_each_visible_pair_once(s, window):
    """For the policy's chunk and others: a q tile's pieces are disjoint,
    contiguous and cover its key tiles; every visible (query, key) pair's key
    tile is among them, and each of them holds a visible pair."""
    tiles = ops.flash_key_tiles(s, window)
    assert len(tiles) == -(-s // ops.FLASH_BQ)
    kpos = np.arange(s)[None, :]
    for t, (lo, hi) in enumerate(tiles):
        qpos = np.arange(t * ops.FLASH_BQ, min(s, (t + 1) * ops.FLASH_BQ))[:, None]
        visible = (kpos <= qpos) & ((kpos > qpos - window) if window > 0 else True)
        assert np.unique(np.nonzero(visible.any(0))[0] // ops.FLASH_BKV).tolist() == list(
            range(lo, hi))
    policy = ops.flash_split(4 * 16, s, window, H100_SMS, 2)
    assert 1 <= policy <= max(hi - lo for lo, hi in tiles)
    for chunk in sorted({1, 2, 5, policy}):
        items = 0
        for lo, hi in tiles:
            pieces = ops.flash_pieces(lo, hi, chunk)
            items += len(pieces)
            assert pieces[0][0] == lo and pieces[-1][1] == hi
            assert all(a < b <= a + chunk for a, b in pieces)
            assert all(p[1] == n[0] for p, n in zip(pieces, pieces[1:]))
        assert items <= 65535  # the kernel's grid
