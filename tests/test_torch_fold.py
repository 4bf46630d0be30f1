"""The quantile merge kernel's rules, on the CPU (no JAX, no card).

``csrc/quant_merge.cu`` merges two GK summaries and packs the result; its
fold entry merges a coordinator's m shipped summaries in one launch.  The
kernel is held bit for bit to ``ref_quant_merge_pack`` / ``ref_quant_fold``
on the card (``test_torch_cuda.py``); these tests pin what that parity rests
on: the prefix sums are f64 sums rounded to f32, the merged order is the
merge path with ties to ``a``, and the fold is the per-site loop.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import quantiles as tq
from repro_torch.kernels import ops, ref


def _summaries(rng, rows: int, cap: int, n: int, eps: float) -> tq.QuantState:
    """``rows`` packed summaries of ``n`` lognormal values on a grid of 0.25
    (duplicates) with small integer weights, some zero."""
    values = np.round(rng.lognormal(1.0, 0.8, (rows, n)) * 4.0) / 4.0
    weights = rng.integers(0, 5, (rows, n)).astype(np.float32)
    empty = tq.QuantState(*(x.expand(rows, *x.shape).clone() for x in tq.quant_init(cap, "cpu")))
    return tq.quant_insert(empty, torch.tensor(values, dtype=torch.float32),
                           torch.tensor(weights), eps)


def test_cpu_cumsum_is_f64_prefix_rounded_to_f32():
    """torch's CPU ``cumsum`` of f32 equals each prefix summed in f64 left to
    right and rounded to f32 (numpy's sequential ``cumsum``), at the fold's
    shapes: the merge kernel's prefix sums, and so its bit parity with the
    plain version on the CPU, rest on this.  A sequential f32 sum differs."""
    rng = np.random.default_rng(0)
    for x in (rng.uniform(1.0, 100.0, (50, 808)), rng.lognormal(3.0, 2.0, (1, 1616))):
        x = x.astype(np.float32)
        want = np.cumsum(x.astype(np.float64), axis=-1).astype(np.float32)
        got = torch.cumsum(torch.tensor(x), -1).numpy()
        assert got.tobytes() == want.tobytes()
        assert ref._prefix_sum(torch.tensor(x)).numpy().tobytes() == want.tobytes()
        f32_seq = np.add.accumulate(x, axis=-1, dtype=np.float32)
        assert f32_seq.tobytes() != want.tobytes()


@pytest.mark.parametrize("cap,eps", [(24, 0.1), (6, 0.01)])
def test_plain_fold_is_the_per_site_loop_of_quant_merge(cap, eps):
    """``quant_fold`` (m = 5, sites 1 and 3 all-pad non-senders) equals five
    ``quant_merge``s in site order, bit for bit; the all-pad merges are
    walked too.  At cap = 6 and eps = 0.01 the packs overflow into the last
    slot."""
    rng = np.random.default_rng(1)
    m = 5
    coord = tq.QuantState(*(x[0] for x in _summaries(rng, 1, cap, 60, eps / 2)))
    shipped = _summaries(rng, m, cap, 80, eps / 4)
    send = torch.tensor([True, False, True, False, True])
    shipped = tq.QuantState(
        values=torch.where(send[:, None], shipped.values, float("inf")),
        g=torch.where(send[:, None], shipped.g, 0.0),
        delta=torch.where(send[:, None], shipped.delta, 0.0),
        wv=torch.where(send[:, None], shipped.wv, 0.0),
        weight=torch.where(send, shipped.weight, 0.0))
    want = coord
    for j in range(m):
        want = tq.quant_merge(want, tq.QuantState(*(x[j] for x in shipped)), eps, cap)
    got = tq.quant_fold(coord, shipped, eps, cap)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.numpy().tobytes() == w.numpy().tobytes()
    assert torch.isfinite(got.values).sum() > 0
    if cap == 6:  # every slot taken: the tuples past cap folded into the last
        assert bool(torch.isfinite(got.values).all())


def test_merge_of_stacked_rows_is_each_rows_merge():
    """``quant_merge`` on (2, 3) leading axes, a site insert's ``exact_batch``
    with zero-weight holes as ``b``, equals the merge of each row alone, bit
    for bit: the rows are flattened for one launch and restored after."""
    rng = np.random.default_rng(2)
    a = _summaries(rng, 6, 16, 40, 0.05)
    values = np.round(rng.lognormal(1.0, 0.8, (6, 30)) * 4.0) / 4.0
    weights = rng.integers(0, 4, (6, 30)).astype(np.float32)
    b = tq.exact_batch(torch.tensor(values, dtype=torch.float32), torch.tensor(weights))
    stack = [tq.QuantState(*(x.reshape(2, 3, *x.shape[1:]) for x in s)) for s in (a, b)]
    got = tq.quant_merge(*stack, 0.05, 16)
    for r in range(6):
        want = tq.quant_merge(*(tq.QuantState(*(x[r] for x in s)) for s in (a, b)), 0.05, 16)
        for g, w in zip(got, want):
            assert g.reshape(6, *g.shape[2:])[r].numpy().tobytes() == w.numpy().tobytes()


def _grid_lists(seed: int):
    """Two ascending lists on a coarse grid (values shared between them),
    ``+inf`` at ``a``'s end and at random places in ``b``."""
    rng = np.random.default_rng(seed)
    a = np.unique(rng.integers(0, 40, 25)).astype(np.float32)
    b = np.unique(rng.integers(0, 40, 30)).astype(np.float32)
    b[rng.random(b.shape[0]) < 0.2] = np.inf
    return (torch.tensor(np.concatenate([a, [np.inf] * 3]), dtype=torch.float32),
            torch.tensor(b, dtype=torch.float32))


@pytest.mark.parametrize("lists", [
    (torch.tensor([0.5, 1.0, 1.0 + 2**-20, 2.0, 4.0, float("inf"), float("inf")]),
     torch.tensor([0.25, 1.0, float("inf"), 2.0, 2.0 + 2**-20, float("inf"), 4.0, 7.0])),
    _grid_lists(3),
])
def test_merge_path_positions_give_the_stable_sort(lists):
    """The kernel's merged places, ``i + #(b < a_i)`` for ``a`` and ``j + #(a
    <= b_j)`` for ``b``'s finite entries taken in order, are the stable
    ``argsort`` of the concatenation (ties to ``a``): duplicates across the
    lists, ``+inf`` pads at ``a``'s end and in the middle of ``b``."""
    a, b = lists
    a_live, b_live = a[torch.isfinite(a)], b[torch.isfinite(b)]
    pos_a = torch.arange(len(a_live)) + torch.searchsorted(b_live, a_live, right=False)
    pos_b = torch.arange(len(b_live)) + torch.searchsorted(a_live, b_live, right=True)
    source = torch.empty(len(a_live) + len(b_live), dtype=torch.int64)
    source[pos_a] = torch.nonzero(torch.isfinite(a))[:, 0]
    source[pos_b] = len(a) + torch.nonzero(torch.isfinite(b))[:, 0]
    order = torch.argsort(torch.cat([a, b]), stable=True)
    assert torch.equal(order[: len(source)], source)


@pytest.mark.parametrize("case", ["fold cap", "leading axes", "fold sites", "weights"])
def test_merge_wrappers_refuse_mismatched_shapes(case):
    """``quant_merge_pack`` and ``quant_fold`` raise ``ValueError`` on a
    coordinator whose width is not ``cap``, and on leading axes (rows, sites,
    weights) that do not match."""
    summary = tuple(torch.ones(2, 6) for _ in range(4)) + (torch.ones(2),)
    shipped = tuple(x[:, None].expand(2, 3, *x.shape[1:]).contiguous() for x in summary)
    with pytest.raises(ValueError, match="shape mismatch"):
        if case == "fold cap":
            ops.quant_fold(summary, shipped, 0.1, 5)
        elif case == "leading axes":
            ops.quant_merge_pack(summary, tuple(x[:1] for x in summary), 0.1, 6)
        elif case == "fold sites":
            ops.quant_fold(summary, (*shipped[:4], torch.ones(2, 4)), 0.1, 6)
        else:
            ops.quant_merge_pack(summary[:4] + (torch.ones(3),), summary, 0.1, 6)
