"""Packed multi-tenant ingest and pipeline checkpoints, on the CPU.

Packed ingest (``StreamingPipeline.ingest_many`` over
``runtime.ingest_packed`` and ``core.distributed.make_packed_runner``)
must be invisible downstream: against serial ingest of the same batches,
every tenant's ``n_seen`` and ``CommReport`` exactly, ``frob`` to 1e-6
relative and served answers to 1e-5 (``eigh``'s rotation freedom means
raw buffers may differ), for P1, P2 and leverage P1 at m = 1 and m = 4
(the port needs no mesh for m = 4).  The ``stats()`` counters equal the
reference's on the same fleet; the resident stack is reused and
invalidated as in the reference; a checkpoint taken while states still
live in the pack restores bit-identically; and a pipeline checkpoint
written by either package loads in the other and serves the same answers.
"""
import importlib

import jax
import numpy as np
import pytest

from repro.runtime import OnDemand as RefOnDemand
from repro.runtime import StreamingPipeline as RefPipeline
from repro_torch.core.leverage import subspace_query
from repro_torch.runtime import EveryKSteps, OnDemand, StreamingPipeline

# The modules (each package's runtime exports a function of the same name).
ipm = importlib.import_module("repro_torch.runtime.ingest_packed")
ref_ipm = importlib.import_module("repro.runtime.ingest_packed")

D = 32
SIZES = {"t0": 32, "t1": 16, "t2": 8}
COUNTERS = ("rows", "batches", "waves", "packed_launches", "packed_tenants", "packed_rows",
            "pad_rows", "serial_steps", "retraces", "restacks", "shrink_launches",
            "pack_occupancy")


def _rows(rng, n):
    """A rank-4 stream plus noise: heavy directions that cross P2's thresholds."""
    basis = np.linspace(-1.0, 1.0, 4 * D).reshape(4, D) + np.eye(4, D)
    return (rng.normal(size=(n, 4)) * [4.0, 3.0, 2.0, 1.0] @ basis
            + 0.1 * rng.normal(size=(n, D))).astype(np.float32)


def _waves(rng, waves=3, cold="t1", sizes=SIZES):
    out = []
    for w in range(waves):
        for name, n in sizes.items():
            if not (name == cold and w == 0):  # the cold tenant joins a wave late
                out.append((name, _rows(rng, n)))
    return out


def _fleet(m=1, protocol="P2", policy=None):
    pipe = StreamingPipeline(m, eps=0.2, policy=policy or EveryKSteps(2), device="cpu")
    for name in SIZES:
        if protocol == "LP1":
            pipe.add_leverage_tenant(name, D, engine="shard", eps=0.3)
        else:
            pipe.add_tenant(name, D, protocol=protocol)
    return pipe


def _ref_fleet(mesh):
    pipe = RefPipeline(mesh, eps=0.2, policy=RefOnDemand())
    for name in SIZES:
        pipe.add_tenant(name, D, protocol="P2")
    return pipe


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _served(pipe, name, xs, leverage=False):
    tickets = [pipe.submit(name, subspace_query(x) if leverage else x) for x in xs]
    pipe.flush()
    return np.array([t.result()[0] for t in tickets])


def _snapshot_answers(pipe, name, xs):
    """``||B x||^2`` over the tenant's latest published snapshot, in numpy:
    what the reference's engine serves, without compiling its query path."""
    b = np.asarray(pipe.store.get(name).matrix, np.float64)
    return np.square(xs.astype(np.float64) @ b.T).sum(1)


def _payload(pipe, name):
    return pipe._tenant(name).adapter.state_payload()[0]


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("protocol", ["P2", "P1", "LP1"])
def test_packed_matches_serial(protocol, m):
    rng = np.random.default_rng(7)
    # Leverage packs equal batches: the reservoir's spill is folded in
    # candidate order, which padding would shift (as in the reference).
    sizes = {"t0": 16, "t1": 16, "t2": 16} if protocol == "LP1" else SIZES
    batches = _waves(rng, sizes=sizes)
    pa, pb = _fleet(m, protocol), _fleet(m, protocol)
    assert pa.ingest_many(batches, packed=True) == pb.ingest_many(batches, packed=False)
    sa, sb = pa.stats(), pb.stats()
    # A pack of two while t1 is cold, then one of three: two restacks.
    assert (sa["packed_launches"], sa["restacks"], sb["packed_launches"]) == (3, 2, 0)
    assert sa["rows"] == sb["rows"] and sa["shrink_launches"] < sb["shrink_launches"]
    xs = rng.normal(size=(6, D)).astype(np.float32)
    for name in sizes:
        a, b = pa.tracker(name), pb.tracker(name)
        proto_a, proto_b = getattr(a, "_proto", a), getattr(b, "_proto", b)
        assert proto_a.rows_seen == proto_b.rows_seen
        assert a.comm_report().as_dict() == b.comm_report().as_dict()
        sta, stb = proto_a.state, proto_b.state
        for fd in ("site_fd", "coord_fd"):
            assert np.array_equal(getattr(sta, fd).n_seen, getattr(stb, fd).n_seen)
            _close(getattr(sta, fd).frob, getattr(stb, fd).frob, rtol=1e-6)
        assert pa.stats(name)[:5] == pb.stats(name)[:5]
        _close(_served(pa, name, xs, protocol == "LP1"), _served(pb, name, xs, protocol == "LP1"))
    pa.close()
    pb.close()


def test_stats_match_reference_and_checkpoints_cross_packages(tmp_path, monkeypatch):
    """One fleet, three P2 tenants at m = 1, packed in both packages.

    Publishing on demand keeps the reference's spectrum refreshes (and
    their compiles) out of it, as ``_snapshot_answers`` keeps its query
    path's; the packed waves run as with any policy.
    """
    monkeypatch.setattr(ref_ipm, "_SHAPES_SEEN", set())
    monkeypatch.setattr(ipm, "_SHAPES_SEEN", set())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    rng = np.random.default_rng(3)
    # No cold tenant here: a pack of two would cost the reference one more
    # compile (the cold start is held to serial ingest above).
    batches = _waves(rng, cold=None)
    tails = [_waves(rng, waves=1, cold=None) for _ in range(2)]
    xs = rng.normal(size=(4, D)).astype(np.float32)
    ref, port = _ref_fleet(mesh), _fleet(policy=OnDemand())
    for pipe in (ref, port):
        pipe.ingest_many(batches, packed=True)
        for name in SIZES:
            pipe.publish(name)
        # The publishes read every state; the next wave reuses the stack.
        pipe.ingest_many(tails[0], packed=True)
    rs, ps = ref.stats(), port.stats()
    assert {k: rs[k] for k in COUNTERS} == {k: ps[k] for k in COUNTERS}
    # One restack (the first wave), one launch shape, 40 zero slots a wave.
    assert (rs["restacks"], rs["retraces"], rs["pad_rows"]) == (1, 1, 160)
    for name in SIZES:
        assert tuple(ref.stats(name))[:5] == tuple(port.stats(name))[:5]

    # No query since the last wave: both save while states sit in the pack.
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref.save(ref_dir)
    port.save(port_dir)
    from_ref = StreamingPipeline.load(ref_dir, 1, device="cpu")
    from_port = RefPipeline.load(port_dir, mesh)
    for name in SIZES:
        for a, b in ((from_ref, ref), (from_port, port)):
            pa, pb = _payload(a, name), _payload(b, name)
            assert all(np.array_equal(np.asarray(pa[k]), np.asarray(pb[k])) for k in pb)
            assert tuple(a.stats(name))[:5] == tuple(b.stats(name))[:5]
        _close(_served(from_ref, name, xs), _snapshot_answers(ref, name, xs))
        _close(_snapshot_answers(from_port, name, xs), _served(port, name, xs))
    # Ingest resumes in the other package where it stopped.
    for pipe in (ref, port, from_ref, from_port):
        pipe.ingest_many(tails[1], packed=True)
        for name in SIZES:
            pipe.publish(name)
    for name in SIZES:
        _close(_served(from_ref, name, xs), _snapshot_answers(ref, name, xs))
        _close(_snapshot_answers(from_port, name, xs), _served(port, name, xs))
    for pipe in (ref, port, from_ref, from_port):
        pipe.close()


def test_resident_stack_reused_and_invalidated():
    rng = np.random.default_rng(1)
    pipe = _fleet()
    for _ in range(3):
        pipe.ingest_many(_waves(rng, waves=1, cold=None), packed=True)
    s = pipe.stats()
    assert s["packed_launches"] == 3
    assert s["restacks"] == 1  # only the first wave stacked member states
    # An out-of-band serial step bumps that tenant's epoch ...
    pipe.ingest("t0", _rows(rng, 16))
    pipe.ingest_many(_waves(rng, waves=1, cold=None), packed=True)
    assert pipe.stats()["restacks"] == 2  # ... so the next packed wave restacks
    pipe.ingest_many(_waves(rng, waves=1, cold=None), packed=True)
    assert pipe.stats()["restacks"] == 2  # and the wave after is resident again
    pipe.close()


def test_mid_pack_save_load_and_tenant_moves(tmp_path):
    rng = np.random.default_rng(2)
    pipe = _fleet()
    pipe.ingest_many(_waves(rng), packed=True)
    proto = pipe.tracker("t0")._proto
    assert proto._pack_slot is not None  # the state still lives in the pack
    ckdir = str(tmp_path / "ck")
    pipe.save(ckdir, step=5, attachments={"owner": "cell-0"})
    restored = StreamingPipeline.load(ckdir, 1, device="cpu")
    assert restored.stats("t0") == pipe.stats("t0")
    for name in SIZES:  # bit-identical right after the load
        a, b = _payload(restored, name), _payload(pipe, name)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    tail = _waves(rng, waves=1, cold=None)
    pipe.ingest_many(tail, packed=True)
    restored.ingest_many(tail, packed=True)
    xs = rng.normal(size=(4, D)).astype(np.float32)
    for name in SIZES:
        _close(_served(restored, name, xs), _served(pipe, name, xs))

    # One tenant moves: live export, or read from the checkpoint alone.
    live = pipe.export_tenant("t1")
    read = StreamingPipeline.read_tenant_export(ckdir, "t1")
    assert read["arrays"].keys() == live["arrays"].keys()
    for payload, source in ((live, pipe), (read, None)):
        other = StreamingPipeline(1, eps=0.2, device="cpu")
        other.import_tenant(payload)
        if source is not None:
            _close(_served(other, "t1", xs), _served(source, "t1", xs))
        assert other.store.versions("t1") == (source or restored).store.versions("t1")[
            : len(other.store.versions("t1"))]
        with pytest.raises(ValueError, match="already registered"):
            other.import_tenant(payload)
        other.close()
    with pytest.raises(KeyError, match="not in checkpoint"):
        StreamingPipeline.read_tenant_export(ckdir, "nope")
    pipe.close()
    restored.close()
