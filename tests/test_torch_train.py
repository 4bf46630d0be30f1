"""The port's training stack against the reference, on the CPU.

The model is ``tests/test_train.py``'s ``TINY`` (f32, two layers in one scan
group of two repeats), so the reference stacks each block leaf over a repeat
axis and its norm scales are (2, 64) matrices: the weight decay and the
gradient compression decide on those stacked leaves, and the port trains in
that layout (``models/weights.py``).  Both packages start from the same
weights (the port's random init, as numpy); gradients and batches come from
a numpy seed or the token stream.  Each reference function is compiled
once, in a module fixture.

The reference's compressed step runs under ``shard_map``; with more than
one shard it is composed here from its own pieces (``lm.loss``,
``compress_and_aggregate``, ``adamw_update``) under ``jax.vmap`` with an
axis name, as ``repro.train.step``'s ``inner`` composes them, so its
collectives run in this process.  Each shard keeps its own residuals in
both packages, and every shard's are compared.

Tolerances:
  * the loss: 1e-5 relative; gradients, one AdamW update, the moments after
    steps and the compression's outputs: 1e-5 of the leaf's largest entry
    (f32 sums in other orders; the compression's basis is an eigenvector
    basis, compared only through products that do not depend on its signs,
    on gradients with a clear gap at the rank k);
  * a train step, from the reference's state before it: the moments to
    1e-5 and the parameters' change to 1e-3 in Frobenius norm
    (``_close_updates``: AdamW scales each element's step by 1 / its own
    RMS gradient, which amplifies f32 roundoff where that gradient is tiny);
    a compressed step on real gradients, whose sketch has no clear gap at k:
    1e-4 and 1e-2 (``COMPRESSED_RTOL``);
  * the learning rate: 1e-6 relative;
  * byte counts, token batches, checkpoint restarts and carried-over state:
    exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.data import TokenStream as JTokenStream
from repro.models.config import ModelConfig as JModelConfig
from repro.models.transformer import LM as JLM
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress_and_aggregate as j_compress
from repro.optim import init_residuals as j_init_residuals
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.grad_compress import FDCompressConfig as JFDCompressConfig
from repro.train import step as jstep
from repro_torch import ckpt
from repro_torch.data import TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.models import LM, ModelConfig
from repro_torch.models.weights import (
    params_from_reference,
    reference_params,
    train_state_from_reference,
)
from repro_torch.optim import FDCompressConfig, adamw_update, compress_and_aggregate
from repro_torch.optim import warmup_cosine
from repro_torch.optim.adamw import AdamWState
from repro_torch.train import (
    TrainConfig,
    aggregate_shards,
    init_train_state,
    make_compressed_train_step,
    make_train_step,
)
from repro_torch.tree import flatten, leaves, tree_map, unflatten

RTOL = 1e-5
UPDATE_RTOL = 1e-3
# The compressed step on real gradients: their merged sketch has no clear gap
# at the rank k, so f32 roundoff in its eigenvectors moves the basis, ghat and
# the residuals by up to about 2e-5 of their largest entry (measured on these
# steps), and AdamW's per-element scaling carries that into the update.
COMPRESSED_RTOL, COMPRESSED_UPDATE_RTOL = 1e-4, 1e-2

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=256, dtype="float32", remat="none")
J_TINY = JModelConfig(**TINY)
TINY_CFG = ModelConfig(**TINY)
SEQ, BATCH, M = 64, 8, 4
K, L = 8, 16  # the compression's rank and sketch rows (the reference's defaults)
TCFG = dict(peak_lr=1e-2, warmup_steps=5, total_steps=100)
MIN_SIZE = 2048  # tests/test_train.py's: the (2, 64, 32) projections are compressed


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(got, want, rtol=RTOL, what="", scale=None):
    """max |got - want| <= rtol * scale, the scale being the largest |want|
    unless given."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if scale is None else scale, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max |port - reference| {err:.3e} > {rtol} * {scale:.3e}"


def _pairs(got, want):
    """(name, port leaf, reference leaf) in the reference's order, which the
    port's trees share (the paths are checked)."""
    got_leaves = flatten(got)
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (jpath, w) in zip(got_leaves, want_leaves):
        assert [str(p) for p in path] == [str(getattr(k, "key", getattr(k, "idx", k)))
                                          for k in jpath]
        yield "/".join(map(str, path)), g, np.asarray(w)


def _close_trees(got, want, rtol=RTOL, scales=None):
    for i, (name, g, w) in enumerate(_pairs(got, want)):
        _close(g, w, rtol, what=name, scale=None if scales is None else scales[i])


def _close_updates(got, want, start, lr: float, rtol: float = UPDATE_RTOL):
    """Parameters after an AdamW step of rate ``lr`` from ``start``: each
    leaf's change within ``rtol`` of the reference's change in
    Frobenius norm, and no element more than two steps (2 lr) apart.  AdamW divides each
    element's step by that element's RMS gradient, so where a gradient
    element sits at f32 roundoff of its leaf's largest, its step follows the
    roundoff; the moments, held to ``RTOL``, show the gradients agree."""
    for (name, g, w), s in zip(_pairs(got, want), leaves(start)):
        g, s = g.detach().numpy(), np.asarray(s)
        moved = np.linalg.norm(w - s)
        assert np.linalg.norm(g - w) <= rtol * moved + RTOL * np.abs(w).max(), name
        assert np.abs(g - w).max() <= 2.0 * lr * (1.0 + np.abs(s).max()), name


def _batch(step: int, batch: int = BATCH) -> np.ndarray:
    return JTokenStream(global_batch=batch, seq_len=SEQ, vocab=256, seed=0).batch_at(step)[
        "tokens"]


@pytest.fixture(scope="module")
def start():
    """Initial weights in the reference's layout, as numpy: the port's random
    init (``LM``, seed 0) stacked by ``reference_params``."""
    return _np(reference_params(TINY_CFG, LM(TINY_CFG, device="cpu").state_dict()))


@pytest.fixture(scope="module")
def ref_lm():
    return JLM(J_TINY)


def _gapped(rng, shape, m: int, noise: float = 1e-3) -> np.ndarray:
    """m shards' gradients of ``shape``: a shared rank-K part whose scales
    run from 2 down to 1 (so its basis is well conditioned in f32), a clear
    gap at K, plus noise; (m, *shape) f32."""
    d_out, rows = shape[-1], int(np.prod(shape[:-1]))
    v = np.linalg.qr(rng.normal(size=(d_out, min(K, d_out))))[0].T
    k = v.shape[0]
    u = rng.normal(size=(m, rows, k)) * np.linspace(2.0, 1.0, k)
    g = u @ v + noise * rng.normal(size=(m, rows, d_out))
    return g.reshape((m,) + tuple(shape)).astype(np.float32)


# --------------------------------------------------------------------------
# The loss and its gradients, the regrouping, the schedule, one AdamW update
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_grads(ref_lm, start):
    tokens = _batch(0)
    loss, grads = jax.jit(jax.value_and_grad(ref_lm.loss))(start, {"tokens": tokens})
    return dict(tokens=tokens, loss=float(loss), grads=_np(grads))


@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_reference(start, ref_grads, remat):
    """``LM.loss`` on weights in the reference's layout, and its gradients
    with respect to every stacked leaf; with ``remat="block"`` each block is
    recomputed in backward, with the same numbers.  The module's own
    weights, loaded per layer, give the same loss."""
    lm = LM(dataclasses.replace(TINY_CFG, remat=remat), device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), _torch(start))
    tokens = torch.tensor(ref_grads["tokens"])
    loss = lm.loss({"tokens": tokens}, params=params)
    grads = torch.autograd.grad(loss, leaves(params))
    assert abs(loss.item() - ref_grads["loss"]) <= RTOL * abs(ref_grads["loss"])
    _close_trees(unflatten(params, grads), ref_grads["grads"])
    lm.load_state_dict(params_from_reference(TINY_CFG, start))
    assert torch.equal(lm.loss({"tokens": tokens}), loss.detach())


def test_regrouping_round_trips(start):
    """``reference_params`` inverts ``params_from_reference``: the per-layer
    state dict stacks back into the reference's leaves, in its order, bit for
    bit; the norm scales of a group stack into (repeats, d) matrices."""
    back = reference_params(TINY_CFG, params_from_reference(TINY_CFG, start))
    _close_trees(back, start, rtol=0.0)
    shapes = {"/".join(map(str, p)): tuple(t.shape) for p, t in flatten(back)}
    assert shapes["groups/0/pos0/norm1"] == (2, 64)
    assert shapes["groups/0/pos0/attn/wq"] == (2, 64, 64)
    assert shapes["final_norm"] == (64,)


def test_warmup_cosine_matches_reference():
    steps = np.arange(121)
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    _close(warmup_cosine(torch.tensor(steps), **kw),
           jax.jit(functools.partial(j_warmup_cosine, **kw))(steps), 1e-6)
    assert float(warmup_cosine(0, **kw)) == 0.0


def test_adamw_update_matches_reference(start):
    """One update with the global-norm clip active, on the stacked leaves: the
    stacked (2, 64) norm scales are decayed, the lone final norm is not."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), start)
    grads = jax.tree.map(lambda p: (10.0 * rng.normal(size=p.shape)).astype(np.float32), params)
    mu = jax.tree.map(lambda p: (0.1 * rng.normal(size=p.shape)).astype(np.float32), params)
    nu = jax.tree.map(lambda p: rng.uniform(size=p.shape).astype(np.float32), params)
    count, lr = 3, 1e-2
    want, want_opt = jax.jit(functools.partial(j_adamw_update, lr=lr))(
        grads, JAdamWState(mu, nu, jnp.int32(count)), params)
    got, got_opt = adamw_update(_torch(grads), AdamWState(_torch(mu), _torch(nu),
                                                          torch.tensor(count, dtype=torch.int32)),
                                _torch(params), lr=lr)
    _close_trees(got, _np(want))
    _close_trees(got_opt.mu, _np(want_opt.mu))
    _close_trees(got_opt.nu, _np(want_opt.nu))
    assert int(got_opt.count) == int(want_opt.count) == count + 1
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in jax.tree.leaves(grads)))
    assert gnorm > 1.0  # the clip scales every gradient
    # With zero gradients and moments, only the decay moves a parameter: the
    # stacked norms by lr * wd * p, the lone final norm not at all.
    zero = tree_map(torch.zeros_like, _torch(params))
    moved, _ = adamw_update(zero, AdamWState(zero, zero, torch.tensor(count)), _torch(params),
                            lr=lr)
    norm1 = torch.tensor(params["groups"][0]["pos0"]["norm1"])
    torch.testing.assert_close(moved["groups"][0]["pos0"]["norm1"], norm1 - lr * 0.1 * norm1)
    assert torch.equal(moved["final_norm"], torch.tensor(params["final_norm"]))


# --------------------------------------------------------------------------
# compress_and_aggregate at m = 4, against the reference under vmap
# --------------------------------------------------------------------------


# Pods as sites, as the reference's hierarchical mode is meant; the pod axis
# second, so that the port moves the compressed axis to the front.
HIER_MESH = {"data": 3, "pod": 2}
# The stacked (2, 64) norms take the plain mean here: sketched across 2
# pods they would give 4 rows for a rank-8 basis, whose last rows are f32
# roundoff normalised to unit length, in both packages.
HIER_MIN_SIZE = 4096


@pytest.fixture(scope="module")
def compress_case(start):
    """Gapped per-shard gradients and random per-shard residuals at the
    model's leaf shapes: M shards, and the shards of ``HIER_MESH``; with the
    reference's outputs for them, from one compile: the M shards at
    ``min_size`` 4096 and 64 under ``jax.vmap(axis_name="data")``, and the
    mesh in the hierarchical mode, a dense ``pmean`` over ``data`` and then
    compression across ``pod`` (``repro.train.step``'s ``inner``), under a
    ``vmap`` for each axis."""
    rng = np.random.default_rng(2)

    def case(lead: tuple):
        n = int(np.prod(lead))
        grads = jax.tree.map(lambda p: _gapped(rng, p.shape, n).reshape(lead + p.shape)
                             if p.ndim >= 2
                             else rng.normal(size=lead + p.shape).astype(np.float32), start)
        res = jax.tree.map(lambda p: (0.1 * rng.normal(size=lead + p.shape)).astype(np.float32)
                           if p.ndim >= 2 else np.zeros(lead, np.float32), start)
        return grads, res

    flat, hier = case((M,)), case(tuple(HIER_MESH.values()))
    jcfg = JFDCompressConfig(rank=K, sketch_rows=L)

    def per_min_size(g, r):
        return {ms: j_compress(g, r, jcfg._replace(min_size=ms)) for ms in (4096, 64)}

    def pooled(g, r):
        return j_compress(jax.lax.pmean(g, "data"), r,
                          jcfg._replace(min_size=HIER_MIN_SIZE, axis="pod"))

    def everything(flat, hier):
        return (jax.vmap(per_min_size, axis_name="data")(*flat),
                jax.vmap(jax.vmap(pooled, axis_name="pod"), axis_name="data")(*hier))

    want_flat, want_hier = _np(jax.jit(everything)(flat, hier))
    return dict(flat=flat, hier=hier, want_flat=want_flat, want_hier=want_hier)


def _close_compression(got, want, grads, res, lead: int):
    """``ghat`` (each of the reference's devices holds the same), every
    shard's residuals and the byte counts.  A residual is held within RTOL of
    its leaf's largest accumulated gradient ``g + r``: where the basis spans
    a leaf (the (2, 64) norms: 8 rows in all) the residual is f32 roundoff
    of that."""
    got_g, got_r, stats = got
    want_g, want_r, want_stats = want
    first = (0,) * lead
    _close_trees(got_g, jax.tree.map(lambda a: a[first], want_g))
    acc = [float(np.abs(g).max() + np.abs(r).max()) for g, r in zip(jax.tree.leaves(grads),
                                                                    jax.tree.leaves(res))]
    _close_trees(got_r, want_r, scales=[max(a, float(np.abs(w).max()))
                                        for a, w in zip(acc, jax.tree.leaves(want_r))])
    assert float(stats.full_bytes) == float(want_stats.full_bytes[first])
    assert float(stats.compressed_bytes) == float(want_stats.compressed_bytes[first])


@pytest.mark.parametrize("min_size", [4096, 64])
def test_compress_and_aggregate_matches_reference(compress_case, min_size):
    """M shards.  At the reference's ``min_size`` the stacked norms take the
    plain mean and keep their residuals; at 64 they are sketched, as
    Qwen3-0.6B's (28, 1024) ones are."""
    grads, res = compress_case["flat"]
    got = compress_and_aggregate(_torch(grads), _torch(res),
                                 FDCompressConfig(rank=K, sketch_rows=L, min_size=min_size))
    _close_compression(got, compress_case["want_flat"][min_size], grads, res, 1)
    norm1 = got[1]["groups"][0]["pos0"]["norm1"]
    sketched = not torch.equal(norm1, torch.tensor(res["groups"][0]["pos0"]["norm1"]))
    assert sketched == (min_size == 64)


def test_hierarchical_compression_matches_reference(compress_case):
    """The hierarchical mode on a 3 x 2 mesh: the gradients averaged over
    ``data``, then compressed across ``pod``, each data shard with its own
    residuals (they differ here, so its results do)."""
    grads, res = compress_case["hier"]
    got = aggregate_shards(_torch(grads), _torch(res),
                           FDCompressConfig(rank=K, sketch_rows=L, min_size=HIER_MIN_SIZE),
                           HIER_MESH, compress_axis="pod")
    _close_compression(got, compress_case["want_hier"], grads, res, 2)
    wq = got[1]["groups"][0]["pos0"]["attn"]["wq"]
    assert not torch.equal(wq[0, 0], wq[0, 1]) and not torch.equal(wq[0, 0], wq[1, 0])


# --------------------------------------------------------------------------
# Train steps
# --------------------------------------------------------------------------


def _ref_state(start, residuals: bool):
    params = jax.tree.map(jnp.asarray, start)
    return jstep.TrainState(params, j_adamw_init(params),
                            j_init_residuals(params) if residuals else None)


def test_train_steps_match_reference(ref_lm, start):
    """Three plain steps on the token stream, each from the reference's state
    before it: the loss, the moments and the parameters' change."""
    step = jax.jit(jstep.make_train_step(ref_lm, jstep.TrainConfig(**TCFG)))
    states, metrics = [_ref_state(start, residuals=False)], []
    for i in range(3):
        state, m = step(states[-1], {"tokens": _batch(i)})
        states.append(state)
        metrics.append(m)
    _check_steps(states, metrics, make_train_step(LM(TINY_CFG, device="cpu"),
                                                  TrainConfig(**TCFG)))


def _residual_shards(tree):
    """Every device's buffer of each residual leaf: (devices, ...)."""
    return jax.tree.map(
        lambda a: np.stack([np.asarray(s.data) for s in a.addressable_shards]), tree)


@pytest.fixture(scope="module")
def ref_one_shard(ref_lm, start):
    """Two of the reference's own compressed steps on a one-device mesh."""
    tc = jstep.TrainConfig(**TCFG, grad_compression=JFDCompressConfig(min_size=MIN_SIZE))
    mesh = jax.make_mesh((1,), ("data",))
    step = jstep.make_compressed_train_step(ref_lm, tc, mesh)
    # Replicated on the mesh from the start, as the step returns it: one compile.
    state = jax.device_put(_ref_state(start, residuals=True), NamedSharding(mesh, P()))
    states, metrics = [state], []
    for i in range(2):
        state, m = step(state, {"tokens": _batch(i)})
        states.append(state)
        metrics.append(m)
    return states, metrics


def _compressed_port_step(m):
    return make_compressed_train_step(LM(TINY_CFG, device="cpu"), TrainConfig(
        **TCFG, grad_compression=FDCompressConfig(min_size=MIN_SIZE)), m)


def _check_steps(states, metrics, step, residuals=None):
    """Each step of the port from the reference's state before it against the
    reference's state after it.  ``residuals`` (the compressed steps): a
    state's residuals, every device's buffer stacked on a leading axis, for
    each state."""
    rtol, update_rtol = ((RTOL, UPDATE_RTOL) if residuals is None
                         else (COMPRESSED_RTOL, COMPRESSED_UPDATE_RTOL))
    for i, want_metrics in enumerate(metrics):
        before, after = _np(states[i]), _np(states[i + 1])
        shards = None
        if residuals is not None:
            n = leaves(residuals[i])[0].shape[0]
            shards = [jax.tree.map(lambda a, j=j: a[j], residuals[i]) for j in range(n)]
        got, m = step(train_state_from_reference(before, residuals=shards, device="cpu"),
                      {"tokens": _batch(i)})
        assert abs(float(m["loss"]) - float(want_metrics["loss"])) <= RTOL * float(
            want_metrics["loss"])
        assert int(m["step"]) == i + 1
        for key in ("comm_full_bytes", "comm_compressed_bytes"):
            assert (key in m) == (key in want_metrics)
            if key in m:
                assert float(m[key]) == float(want_metrics[key])
        _close_trees(got.opt.mu, after.opt.mu, rtol)
        _close_trees(got.opt.nu, after.opt.nu, rtol)
        _close_updates(got.params, after.params, before.params,
                       float(warmup_cosine(i + 1, **TCFG)), update_rtol)
        if residuals is not None:
            _close_trees(got.residuals, residuals[i + 1], rtol)
        else:
            assert got.residuals is None
    return got


def test_compressed_step_one_shard_matches_reference(ref_one_shard):
    """m = 1 against ``make_compressed_train_step`` on a one-device mesh, two
    steps: the loss, the byte counts, the moments, the device's residuals
    and the parameters' change."""
    states, metrics = ref_one_shard
    _check_steps(states, metrics, _compressed_port_step(1),
                 [_residual_shards(s.residuals) for s in states])


def test_train_state_carries_over_from_reference(ref_one_shard):
    """The reference's state after a compressed step, leaf for leaf; its one
    device's residuals become shard 0's; a residual tree a device becomes
    the shard axis."""
    state = ref_one_shard[0][1]
    got = train_state_from_reference(_np(state), device="cpu")
    _close_trees(got.params, _np(state.params), rtol=0.0)
    _close_trees(got.opt.mu, _np(state.opt.mu), rtol=0.0)
    assert got.opt.count.dtype == torch.int32 and int(got.opt.count) == int(state.opt.count) == 1
    _close_trees(got.residuals, _residual_shards(state.residuals), rtol=0.0)
    two = train_state_from_reference(_np(state), residuals=[_np(state.residuals)] * 2,
                                     device="cpu")
    assert all(r.shape[0] == 2 for r in leaves(two.residuals))


@pytest.fixture(scope="module")
def ref_four_shards(ref_lm, start):
    """Two steps of the reference's pieces composed under vmap over 4 shards,
    as ``make_compressed_train_step``'s ``inner`` composes them."""
    tc = jstep.TrainConfig(**TCFG, grad_compression=JFDCompressConfig(min_size=MIN_SIZE))

    def inner(params, opt, residuals, tokens):
        loss, grads = jax.value_and_grad(ref_lm.loss)(params, {"tokens": tokens})
        loss = jax.lax.pmean(loss, "data")
        grads, new_res, stats = j_compress(grads, residuals, tc.grad_compression)
        new_params, new_opt = j_adamw_update(grads, opt, params, lr=jstep._lr(tc, opt.count),
                                             b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
                                             grad_clip=tc.grad_clip)
        metrics = {"loss": loss, "comm_full_bytes": stats.full_bytes,
                   "comm_compressed_bytes": stats.compressed_bytes}
        return new_params, new_opt, new_res, metrics

    run = jax.jit(jax.vmap(inner, in_axes=(None, None, 0, 0), axis_name="data"))
    state = _ref_state(start, residuals=True)
    res = [_np(jax.tree.map(lambda r: jnp.stack([r] * M), state.residuals))]
    states, metrics = [state], []
    for i in range(2):
        params, opt, r, m = run(state.params, state.opt, res[-1],
                                _batch(i).reshape(M, BATCH // M, SEQ))
        params, opt, m = jax.tree.map(lambda a: a[0], (params, opt, m))
        state = jstep.TrainState(params, opt, state.residuals)
        states.append(state)
        res.append(_np(r))
        metrics.append(m)
    return states, metrics, res


def test_compressed_step_four_shards_matches_reference(ref_four_shards):
    """m = 4, two steps: each shard's micro-batch and its own residuals (every
    shard's compared), the mean loss, the byte counts, the moments and the
    parameters' change."""
    states, metrics, res = ref_four_shards
    got = _check_steps(states, metrics, _compressed_port_step(M), res)
    wq = got.residuals["groups"][0]["pos0"]["attn"]["wq"]
    assert not torch.equal(wq[0], wq[1])  # the shards' buffers differ


def test_hierarchical_step_pools_then_compresses():
    """``compress_axis``: a dense mean over the other mesh axis, then
    compression across ``compress_axis``.  On a 2 x 2 mesh the inner
    shards of a pod pool the same gradients, so their residuals stay equal,
    and the bytes are those of compressing across 2 shards."""
    lm = LM(TINY_CFG, device="cpu")
    tc = TrainConfig(**TCFG, grad_compression=FDCompressConfig(min_size=MIN_SIZE))
    mesh = {"pod": 2, "data": 2}
    state = init_train_state(lm, tc, mesh)
    assert all(r.shape[:2] == (2, 2) for r in leaves(state.residuals))
    new, m = make_compressed_train_step(lm, tc, mesh, compress_axis="pod")(
        state, {"tokens": _batch(0)})
    for r in leaves(new.residuals):
        assert torch.equal(r[:, 0], r[:, 1])
    _, flat = make_compressed_train_step(lm, tc, 2)(init_train_state(lm, tc, 2),
                                                    {"tokens": _batch(0)})
    assert float(m["comm_compressed_bytes"]) == float(flat["comm_compressed_bytes"])
    assert float(m["comm_full_bytes"]) > float(m["comm_compressed_bytes"])
    with pytest.raises(ValueError, match="compress_axis"):
        make_compressed_train_step(lm, tc, mesh, compress_axis="model")


def test_token_stream_matches_reference():
    for kw in (dict(global_batch=8, seq_len=64, vocab=256, seed=0),
               dict(global_batch=4, seq_len=33, vocab=151936, seed=3, host_index=1,
                    host_count=2)):
        for step in (0, 7):
            assert np.array_equal(TokenStream(**kw).batch_at(step)["tokens"],
                                  JTokenStream(**kw).batch_at(step)["tokens"])


# --------------------------------------------------------------------------
# The reference's training tests, on the port alone
# --------------------------------------------------------------------------


def _train(n_steps, state=None, start=0, tc=None, m=None, batch=BATCH):
    lm = LM(TINY_CFG, device="cpu")
    tc = tc or TrainConfig(**TCFG)
    if state is None:
        state = init_train_state(lm, tc, m or 1)
    step = make_train_step(lm, tc) if m is None else make_compressed_train_step(lm, tc, m)
    ds = TokenStream(global_batch=batch, seq_len=SEQ, vocab=256, seed=0)
    losses, metrics = [], None
    for i in range(start, start + n_steps):
        state, metrics = step(state, ds.batch_at(i))
        losses.append(float(metrics["loss"]))
    return state, losses, metrics


def test_loss_decreases():
    """The reference's test over 14 steps where it takes 40 (the loss falls
    by 1.0 within 13 here)."""
    _, losses, _ = _train(14)
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_checkpoint_restart_determinism(tmp_path):
    """A compressed run restarted from the port's checkpoint (residuals
    included) ends bit-identical to an uninterrupted one."""
    tc = TrainConfig(**TCFG, grad_compression=FDCompressConfig(min_size=2048))
    full, _, _ = _train(2, tc=tc, m=2)
    half, _, _ = _train(1, tc=tc, m=2)
    ckpt.save(str(tmp_path), 1, half)
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored, _ = ckpt.restore(str(tmp_path), 1, half, device="cpu")
    resumed, _, _ = _train(1, state=restored, start=1, tc=tc, m=2)
    assert len(leaves(full)) == len(leaves(resumed)) > len(leaves(full.params)) * 3
    for a, b in zip(leaves(full), leaves(resumed)):
        assert torch.equal(a, b)


def test_fd_gradient_compression_trains_and_saves_comm():
    """The reference's test at m = 8 over 16 steps where it takes 35 (the
    loss falls by 1.0 within 16 steps here)."""
    tc = TrainConfig(peak_lr=1e-2, warmup_steps=5, total_steps=60,
                     grad_compression=FDCompressConfig(rank=8, sketch_rows=16, min_size=2048))
    _, losses, m = _train(16, tc=tc, m=8, batch=16)
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])
    ratio = float(m["comm_full_bytes"]) / float(m["comm_compressed_bytes"])
    assert ratio > 2.0, ratio


def test_train_launcher_runs_and_restores_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--global-batch", "4",
            "--seq-len", "16", "--compress-grads", "--shards", "2", "--ckpt-dir", str(tmp_path)]
    launch_train.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "[train] step 1/2 loss=" in out and "comm_saving=" in out and "[train] done" in out
    launch_train.main(argv + ["--steps", "3", "--restore"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out and "[train] step 3/3 loss=" in out
    assert ckpt.latest_step(str(tmp_path)) == 3
