"""The port's Frequent Directions sketch against the reference's.

Eigenvectors differ in sign (and in order within degenerate eigenvalues)
between the frameworks, so only sign-invariant quantities are compared:
``n_seen`` exactly, ``frob`` to 1e-6 relative (f32 sums in another order),
``B^T B`` and ``delta_sum`` to 1e-5 relative.  The streams are Gaussian
with a mild column scale, so the Gram spectrum is well conditioned and the
shrink mass ``delta`` — an interior eigenvalue — keeps f32 accuracy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fd as jfd
from repro_torch.core import fd as tfd

D, L = 32, 8


def _stream(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, D)) * np.linspace(2.0, 1.0, D)).astype(np.float32)


def _gram(buf) -> np.ndarray:
    b = np.asarray(buf, np.float64)
    return b.T @ b


def _assert_state_parity(port: tfd.FDState, ref: jfd.FDState) -> None:
    assert int(port.n_seen) == int(ref.n_seen)
    np.testing.assert_allclose(float(port.frob), float(ref.frob), rtol=1e-6)
    np.testing.assert_allclose(float(port.delta_sum), float(ref.delta_sum), rtol=1e-5)
    want = _gram(ref.buf)
    np.testing.assert_allclose(_gram(port.buf.numpy()), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [61, 64])  # ragged (zero-padded last chunk) and whole
def test_fd_update_stream_matches_reference(n):
    a = _stream(n, n)
    ref = jfd.fd_update_stream(jfd.fd_init(L, D), jnp.asarray(a))
    port = tfd.fd_update_stream(tfd.fd_init(L, D, device="cpu"), torch.tensor(a))
    assert int(port.n_seen) == n  # zero padding is not counted
    _assert_state_parity(port, ref)

    # The FD envelope: 0 <= ||Ax||^2 - ||Bx||^2 <= delta_sum for unit x.
    x = np.random.default_rng(1).normal(size=(D, 16))
    x /= np.linalg.norm(x, axis=0)
    gap = np.sum((a.astype(np.float64) @ x) ** 2, 0) - tfd.fd_query(port, torch.tensor(x)).numpy()
    slack = 1e-5 * float(port.frob)  # f32 accumulation noise
    assert np.all(gap >= -slack) and np.all(gap <= float(port.delta_sum) + slack)


def test_fd_merge_matches_reference():
    a, b = _stream(3, 40), _stream(4, 27)
    ra = jfd.fd_update_stream(jfd.fd_init(L, D), jnp.asarray(a))
    rb = jfd.fd_update_stream(jfd.fd_init(L, D), jnp.asarray(b))
    pa = tfd.fd_update_stream(tfd.fd_init(L, D, device="cpu"), torch.tensor(a))
    pb = tfd.fd_update_stream(tfd.fd_init(L, D, device="cpu"), torch.tensor(b))
    _assert_state_parity(tfd.fd_merge(pa, pb), jfd.fd_merge(ra, rb))
    with pytest.raises(ValueError, match="identically-shaped"):
        tfd.fd_merge(pa, tfd.fd_init(L + 1, D, device="cpu"))


def test_stacked_state_advances_each_sketch_as_alone():
    """The site axis: T sketches in one stacked state, one batched shrink per
    chunk, end where T separate sketches would."""
    rows = np.stack([_stream(10 + t, 30) for t in range(3)])
    zero = tfd.fd_init(L, D, device="cpu")
    stacked = tfd.FDState(*(leaf.expand(3, *leaf.shape).clone() for leaf in zero))
    stacked = tfd.fd_update_stream(stacked, torch.tensor(rows))
    for t in range(3):
        alone = tfd.fd_update_stream(zero, torch.tensor(rows[t]))
        assert int(stacked.n_seen[t]) == int(alone.n_seen)
        np.testing.assert_allclose(float(stacked.frob[t]), float(alone.frob), rtol=1e-6)
        np.testing.assert_allclose(float(stacked.delta_sum[t]), float(alone.delta_sum), rtol=1e-5)
        want = _gram(alone.buf.numpy())
        np.testing.assert_allclose(_gram(stacked.buf[t].numpy()), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_fdsketch_copy_matches_reference_oracle():
    a = _stream(5, 50)
    ref, port = jfd.FDSketch(L, D), tfd.FDSketch(L, D)
    ref.extend(a)
    port.extend(a)
    assert port.state_dict() == ref.state_dict()
    assert port.covariance_error(a) == ref.covariance_error(a)


def test_fd_update_rejects_wrong_chunk_and_bad_l():
    st = tfd.fd_init(L, D, device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        tfd.fd_update(st, torch.zeros(L - 1, D))
    with pytest.raises(ValueError, match="l must be >= 1"):
        tfd.fd_init(0, D, device="cpu")
