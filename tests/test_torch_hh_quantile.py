"""The port's heavy-hitter and quantile kinds against the reference, on the CPU.

The same numpy inputs (a fixed seed, no hypothesis) go through the
reference and the port.  Held exactly: Misra--Gries states and ``mg_items``
(the scan and the merge make the same f32 additions in the same order),
``CommReport`` units, and every event stream's result (the same numpy
code).  Held to 1e-6 of the total weight W: ``w_i``/``w_hat`` and the
quantile summaries' ranks (f32 cumulative sums in torch's order, not
XLA's); their values exactly.  The kernels' plain versions run here; the
kernels themselves are held to them on the card (``test_torch_cuda.py``).

Threshold decisions (a site ships at ``w_i >= (eps/2m) w_hat``, a quantile
tuple folds at ``band <= 2 eps W``) could flip for a sum within f32
rounding of its threshold; the exact ``CommReport`` and value equalities
check that none did on these inputs.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_multidevice

from repro.core import hh as jhh
from repro.core import protocols as jprot
from repro.core import quantiles as jq
from repro.query import PackedRequest as JRequest
from repro.runtime import OnDemand as RefOnDemand
from repro.runtime import StreamingPipeline as RefPipeline
from repro.runtime.registry import create_protocol as ref_create
from repro_torch.core import distributed as tdist
from repro_torch.core import hh as thh
from repro_torch.core import protocols as tprot
from repro_torch.core import quantiles as tq
from repro_torch.query import PackedRequest
from repro_torch.runtime import OnDemand, StreamingPipeline, create_protocol

EPS, B, D = 0.2, 48, 8


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def hh_stream(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Zipf keys over 40 ids, small integer weights: ties among counts, and
    one item in eight of weight zero."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.6, n) % 40).astype(np.int64)
    weights = rng.integers(1, 5, n).astype(np.float64)
    weights[rng.random(n) < 0.125] = 0.0
    return keys, weights


def q_stream(seed: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Lognormal values on a grid of 0.25 (duplicates), Zipf-ish weights."""
    rng = np.random.default_rng(seed)
    values = np.round(rng.lognormal(1.0, 0.8, n) * 4.0) / 4.0
    weights = np.minimum(rng.zipf(2.0, n), 20).astype(np.float64)
    return values, weights


def _pairs(stream, steps: int, rows: int) -> list[np.ndarray]:
    a, w = stream
    return [np.stack([a[s * rows:(s + 1) * rows], w[s * rows:(s + 1) * rows]], 1)
            for s in range(steps)]


def _np(state) -> list[np.ndarray]:
    return [np.asarray(leaf.cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf)
            for leaf in state]


def _close_w(got, want, w_total):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-6 * w_total)


def _same_table(got, want, w_total):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    _close_w(got[:, 1], want[:, 1], w_total)


# ---------------------------------------------------------------------------
# core: Misra--Gries and the quantile summary on tensors
# ---------------------------------------------------------------------------


def test_mg_update_stream_and_merge_match_reference():
    """Three summaries of k = 6 counters over 40 ids: every case of the
    update (hit, empty slot, decrement with a tie for the minimum, a
    zero-weight key taking an empty slot), then the merge, with ties among
    the merged counts.  The port's merge drops zero-count keys, as the
    reference's does: ``mg_merge(s, mg_init(k))`` is not ``s`` when ``s``
    holds such a key (ROADMAP §3, ``test_mg_merge_identity_absorption``)."""
    k, sites, b = 6, 3, 40
    keys, w = (a.reshape(sites, b) for a in hh_stream(0, sites * b))
    w[:, 0] = 0.0  # a zero-weight first item lands in an empty slot
    port = thh.mg_update_stream(tdist._tile(thh.mg_init(k, "cpu"), sites),
                                torch.tensor(keys, dtype=torch.int32), torch.tensor(w))
    # The reference's functions under one jit each: one compile, not one an op.
    stacked = jax.jit(jax.vmap(jhh.mg_update_stream))(
        jax.vmap(lambda _: jhh.mg_init(k))(jnp.arange(sites)), jnp.asarray(keys), jnp.asarray(w))
    refs = [jhh.MGState(*(leaf[s] for leaf in stacked)) for s in range(sites)]
    ref_merge = jax.jit(jhh.mg_merge)
    for s in range(sites):
        one = thh.MGState(*(leaf[s] for leaf in port))
        for got, want in zip(_np(one), _np(refs[s])):
            np.testing.assert_array_equal(got, want)
        assert thh.mg_items(one) == jhh.mg_items(refs[s])
        assert float(thh.mg_estimate(one, keys[s, 1])) == float(
            jhh.mg_estimate(refs[s], jnp.asarray(keys[s, 1])))
    one = thh.mg_update(thh.MGState(*(leaf[0] for leaf in port)), torch.tensor(3, dtype=torch.int32),
                        torch.tensor(2.0))
    want = jax.jit(jhh.mg_update)(refs[0], jnp.int32(3), jnp.float32(2.0))
    for got, wnt in zip(_np(one), _np(want)):
        np.testing.assert_array_equal(got, wnt)

    pick = lambda st, s: thh.MGState(*(leaf[s] for leaf in st))  # noqa: E731
    for a, c in ((0, 1), (1, 2), (2, 0)):
        got = thh.mg_merge(pick(port, a), pick(port, c))
        want = ref_merge(refs[a], refs[c])
        for g, wnt in zip(_np(got), _np(want)):
            np.testing.assert_array_equal(g, wnt)
    zero_key = thh.mg_update(thh.mg_init(k, "cpu"), torch.tensor(7, dtype=torch.int32),
                             torch.tensor(0.0))
    absorbed = thh.mg_merge(zero_key, thh.mg_init(k, "cpu"))
    assert thh.mg_items(zero_key) == {7: 0.0} and thh.mg_items(absorbed) == {}
    ref_zero = jax.jit(jhh.mg_update)(jhh.mg_init(k), jnp.int32(7), jnp.float32(0.0))
    assert jhh.mg_items(ref_merge(ref_zero, jhh.mg_init(k))) == {}


def test_quant_insert_and_merge_match_reference():
    """Two summaries of capacity 24 take two batches each (duplicate values,
    zero weights, more distinct values than the capacity), then merge:
    values exactly, ranks to 1e-6 W."""
    cap, eps, rows, n = 24, 0.1, 2, 60
    vals, ws = q_stream(1, 2 * rows * n)
    ws[::9] = 0.0
    vals = vals.reshape(2, rows, n).astype(np.float32)
    ws = ws.reshape(2, rows, n).astype(np.float32)
    port = tdist._tile(tq.quant_init(cap, "cpu"), rows)
    ref = jax.vmap(lambda _: jq.quant_init(cap))(jnp.arange(rows))
    # The reference's functions under one jit each: one compile, not one an op.
    ref_insert = jax.jit(jax.vmap(lambda st, v, w: jq.quant_insert(st, v, w, eps)))
    for batch in range(2):
        port = tq.quant_insert(port, torch.tensor(vals[batch]), torch.tensor(ws[batch]), eps)
        ref = ref_insert(ref, vals[batch], ws[batch])
    refs = [jq.QuantState(*(leaf[r] for leaf in ref)) for r in range(rows)]
    w_total = float(ws.sum())
    pick = lambda st, r: tq.QuantState(*(leaf[r] for leaf in st))  # noqa: E731
    for r in range(rows):
        got, want = _np(pick(port, r)), _np(refs[r])
        np.testing.assert_array_equal(got[0], want[0])  # values, +inf pads included
        for g, wnt in zip(got[1:], want[1:]):
            _close_w(g, wnt, w_total)
        _same_table(tq.quant_table(pick(port, r)), jq.quant_table(refs[r]), w_total)
        assert tq.quant_band(pick(port, r)) == pytest.approx(jq.quant_band(refs[r]),
                                                             abs=1e-6 * w_total)
    got = tq.quant_merge(pick(port, 0), pick(port, 1), eps / 2, cap)
    want = jax.jit(jq.quant_merge, static_argnums=(2, 3))(refs[0], refs[1], eps / 2, cap)
    np.testing.assert_array_equal(_np(got)[0], _np(want)[0])
    _same_table(tq.quant_table(got), jq.quant_table(want), w_total)
    empty = tq.quant_insert(pick(port, 0), torch.zeros(0), torch.zeros(0), eps)
    assert all(torch.equal(a, b) for a, b in zip(empty, pick(port, 0)))


# ---------------------------------------------------------------------------
# event streams: the same numpy code, so the same results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,name", [("hh", "P1"), ("hh", "P2"), ("hh", "P3"), ("hh", "P3wr"),
                                       ("hh", "P4"), ("quantile", "P1"), ("quantile", "P3")])
def test_event_streams_match_reference(kind, name):
    m = 4
    a, w = hh_stream(2, 3000) if kind == "hh" else q_stream(2, 3000)
    sites = np.random.default_rng(3).integers(0, m, a.shape[0])
    if kind == "hh":
        want = jprot.run_hh_protocol(name, a, w, sites, m, EPS, seed=5)
        got = tprot.run_hh_protocol(name, a, w, sites, m, EPS, seed=5)
        assert got.estimates == want.estimates
        assert got.heavy_hitters(0.1) == want.heavy_hitters(0.1)
    else:
        want = jq.run_quantile_protocol(name, a, w, sites, m, EPS, seed=5)
        got = tq.run_quantile_protocol(name, a, w, sites, m, EPS, seed=5)
        np.testing.assert_array_equal(got.table, want.table)
        np.testing.assert_array_equal(got.quantile([0.1, 0.5, 0.9]), want.quantile([0.1, 0.5, 0.9]))
    assert got.w_hat == want.w_hat
    assert got.comm.report(m).as_dict() == want.comm.report(m).as_dict()


# ---------------------------------------------------------------------------
# super-step engine: hh_p1_step and quant_p1_step against the reference
# ---------------------------------------------------------------------------


def _shard_pair(kind: str):
    ref = ref_create("P1", engine="shard", kind=kind, mesh=_mesh1(), eps=EPS, axis="data")
    port = create_protocol("P1", engine="shard", kind=kind, m=1, eps=EPS, device="cpu")
    return ref, port


def _assert_shard_parity(port, ref, kind, comm=None, answers=None):
    """The port's super-step protocol against the reference's protocol, or
    against ``comm`` and ``answers`` the reference printed."""
    comm = ref.comm_report().as_dict() if comm is None else comm
    assert port.comm_report().as_dict() == comm
    if answers is None:
        answers = dict(w_hat=ref.total_weight(),
                       estimates=ref.estimates() if kind == "hh" else None,
                       table=None if kind == "hh" else ref.table().tolist())
    w_hat = port.total_weight()
    np.testing.assert_allclose(w_hat, answers["w_hat"], rtol=1e-6)
    if kind == "hh":
        want = {int(e): v for e, v in answers["estimates"].items()}
        assert port.estimates() == want
        assert port.heavy_hitters(0.1) == sorted(e for e, v in want.items()
                                                 if v >= (0.1 - EPS / 2) * answers["w_hat"])
    else:
        _same_table(port.table(), np.asarray(answers["table"], np.float32), w_hat)


@pytest.mark.parametrize("kind", ["hh", "quantile"])
def test_shard_step_at_one_site_matches_one_device_mesh(kind):
    """``hh_p1_step`` / ``quant_p1_step`` at m = 1 against the reference on a
    one-device mesh, step by step; then the state payload of one package
    restores in the other and one more step agrees."""
    stream = hh_stream(4, 6 * B) if kind == "hh" else q_stream(4, 6 * B)
    batches = _pairs(stream, 6, B)
    ref, port = _shard_pair(kind)
    for rows in batches[:4]:
        ref.step(rows)
        port.step(rows)
        _assert_shard_parity(port, ref, kind)
    assert port.rows_seen == ref.rows_seen == 4 * B
    leaves = 14 if kind == "hh" else 16
    for src, dst in ((ref, port), (port, ref)):
        arrays, meta = src.state_payload()
        assert sorted(arrays) == [f"leaf_{i:03d}" for i in range(leaves)]
        dst.restore_payload(arrays, meta)
        _assert_shard_parity(port, ref, kind)
    for rows in batches[4:]:
        ref.step(rows)
        port.step(rows)
    _assert_shard_parity(port, ref, kind)


# ---------------------------------------------------------------------------
# pipeline: HH, quantile and matrix tenants in both packages
# ---------------------------------------------------------------------------


def _tenants(pipe):
    pipe.add_tenant("mat", D)
    pipe.add_hh_tenant("hh", engine="shard")
    pipe.add_hh_tenant("hh-ev", protocol="P2", engine="event")
    pipe.add_quantile_tenant("q", engine="shard")
    pipe.add_quantile_tenant("q-ev", engine="event", seed=3)


def _feed(pipe, waves):
    for wave in waves:
        pipe.ingest_many(wave)
    for name in pipe.tenants():
        pipe.publish(name)


def _queries():
    ids = np.arange(12, dtype=np.float32)[:, None]
    q = np.array([[0.0, 1.5], [1.0, 0.5], [0.0, 7.25], [1.0, 0.9], [1.0, 0.1]], np.float32)
    x = np.random.default_rng(9).normal(size=(3, D)).astype(np.float32)
    return {"mat": x, "hh": ids, "hh-ev": ids, "q": q, "q-ev": q}


def _answers(pipe, packed_cls):
    """Every tenant's ``query_batch`` and ``query_packed`` answers, heavy
    hitters and quantiles, as plain values.  The port packs the matrix
    tenant with the lookups (one ``quadform`` launch among them); the
    reference serves its matrix tenant from the cached spectrum instead and
    packs only the lookups, which keeps its interpreted Pallas compile out
    of the test: ``packed-mat`` is held to the reference's ``mat``."""
    qs = _queries()
    port = packed_cls is PackedRequest
    out = {name: pipe.engine.query_batch(x, tenant=name, **({} if port or name != "mat"
                                                             else {"path": "cached"})).estimates
           for name, x in qs.items()}
    packed = pipe.engine.query_packed([packed_cls(name, x) for name, x in qs.items()
                                       if port or name != "mat"])
    out.update({f"packed-{r.tenant}": r.estimates for r in packed})
    if not port:
        out["packed-mat"] = out["mat"]
    for name in ("hh", "hh-ev"):
        out[f"hitters-{name}"] = np.asarray(pipe.heavy_hitters(name, 0.1))
    for name in ("q", "q-ev"):
        out[f"quantiles-{name}"] = pipe.quantiles(name, [0.1, 0.5, 0.99])
    return out


def _assert_answers(got, want, mass):
    for key, w in want.items():
        g = np.asarray(got[key], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, key
        if key.endswith("mat"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
        elif key in ("q", "packed-q"):  # rank answers carry f32 sums of W
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * mass)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_pipeline_matches_reference_and_checkpoints_cross_packages(tmp_path):
    """A matrix tenant (super-step P2), HH tenants (super-step P1, event P2)
    and quantile tenants (super-step P1, event P1) ingest the same waves in
    both pipelines; ``query_batch``, ``query_packed``, ``heavy_hitters`` and
    ``quantiles`` agree.  Each package loads the other's checkpoint, answers
    as the writer did, and resumes ingest where it stopped."""
    keys, kw = hh_stream(7, 5 * B)
    vals, vw = q_stream(7, 5 * B)
    rows = np.random.default_rng(8).normal(size=(5, B, D)).astype(np.float32)
    waves = [[("mat", rows[s]),
              ("hh", np.stack([keys[s * B:(s + 1) * B], kw[s * B:(s + 1) * B]], 1)),
              ("hh-ev", (keys[s * B:(s + 1) * B], kw[s * B:(s + 1) * B])),
              ("q", np.stack([vals[s * B:(s + 1) * B], vw[s * B:(s + 1) * B]], 1)),
              ("q-ev", np.stack([vals[s * B:(s + 1) * B],
                                 vw[s * B:(s + 1) * B]], 1))]
             for s in range(5)]
    mass = float(vw.sum())
    ref = RefPipeline(_mesh1(), eps=EPS, policy=RefOnDemand())
    port = StreamingPipeline(1, eps=EPS, policy=OnDemand(), device="cpu")
    for pipe in (ref, port):
        _tenants(pipe)
        _feed(pipe, waves[:3])
    want = _answers(ref, JRequest)
    _assert_answers(_answers(port, PackedRequest), want, mass)
    for name in port.tenants():
        assert tuple(port.stats(name))[:5] == tuple(ref.stats(name))[:5]
        assert port.stats(name).workload == ref.stats(name).workload
        assert port.tracker(name).comm_report().as_dict() == ref.tracker(name).comm_report().as_dict()
    assert port.stats()["rows"] == ref.stats()["rows"]

    ref.save(str(tmp_path / "ref"))
    port.save(str(tmp_path / "port"))
    from_ref = StreamingPipeline.load(str(tmp_path / "ref"), 1, device="cpu")
    from_port = RefPipeline.load(str(tmp_path / "port"), _mesh1())
    _assert_answers(_answers(from_ref, PackedRequest), want, mass)
    _assert_answers(_answers(from_port, JRequest), want, mass)
    for pipe in (ref, port, from_ref, from_port):
        _feed(pipe, waves[3:])
    want = _answers(ref, JRequest)
    for pipe, cls in ((port, PackedRequest), (from_ref, PackedRequest), (from_port, JRequest)):
        _assert_answers(_answers(pipe, cls), want, mass)
    for pipe in (ref, port, from_ref, from_port):
        pipe.close()


# ---------------------------------------------------------------------------
# four sites: the reference on a four-device mesh, in one subprocess
# ---------------------------------------------------------------------------


REF_M4 = """
import json, numpy as np, jax
from repro.runtime.registry import create_protocol
batches = {{"hh": np.load({hh!r}), "quantile": np.load({q!r})}}
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
out = {{}}
for kind, rows in batches.items():
    p = create_protocol("P1", engine="shard", kind=kind, mesh=mesh, eps={eps}, axis="data")
    for batch in rows:
        p.step(batch)
    out[kind] = dict(comm=p.comm_report().as_dict(),
                     answers=dict(w_hat=p.total_weight(),
                                  estimates=p.estimates() if kind == "hh" else None,
                                  table=None if kind == "hh" else p.table().tolist()))
print("RESULT", json.dumps(out))
"""


M4, M4_STEPS = 4, 3
M4_WAIT_S = 600  # beyond run_multidevice's own 420 s limit


def _m4_batches() -> dict:
    return {"hh": np.stack(_pairs(hh_stream(6, M4_STEPS * M4 * B), M4_STEPS, M4 * B)),
            "quantile": np.stack(_pairs(q_stream(6, M4_STEPS * M4 * B), M4_STEPS, M4 * B))}


@pytest.fixture(scope="module", autouse=True)
def four_device_reference(tmp_path_factory):
    """The reference at m = 4 on four fake devices, in one ``run_multidevice``
    subprocess for both kinds, started in a thread when the file's first
    test starts: it runs beside the in-process tests, and the m = 4 test
    waits for its answer."""
    tmp = tmp_path_factory.mktemp("m4")
    for kind, arr in _m4_batches().items():
        np.save(tmp / f"{kind}.npy", arr)
    out: dict = {}

    def run():
        try:
            out["stdout"] = run_multidevice(REF_M4.format(
                hh=str(tmp / "hh.npy"), q=str(tmp / "quantile.npy"), eps=EPS), n_devices=M4)
        except Exception as e:  # raised again in the test that reads it
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    yield thread, out
    thread.join(timeout=M4_WAIT_S)


def test_both_kinds_at_four_sites_match_four_device_mesh(four_device_reference):
    """HH P1 and quantile P1 at m = 4 against a four-device mesh: the
    coordinator folds the four shipped summaries in site order, as the
    reference's unrolled loop does."""
    thread, out = four_device_reference
    thread.join(timeout=M4_WAIT_S)
    assert not thread.is_alive(), "the four-device reference did not finish"
    if "error" in out:
        raise out["error"]
    ref = json.loads(out["stdout"].split("RESULT ", 1)[1])
    for kind, rows in _m4_batches().items():
        port = create_protocol("P1", engine="shard", kind=kind, m=M4, eps=EPS, device="cpu")
        for batch in rows:
            port.step(batch)
        _assert_shard_parity(port, None, kind, comm=ref[kind]["comm"],
                             answers=ref[kind]["answers"])
