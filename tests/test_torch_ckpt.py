"""The port's checkpoint format against the reference's, on the CPU.

``repro_torch.ckpt`` must write what ``repro.ckpt`` writes — the same leaf
names in the same order, the same manifest entries (file, shape, dtype,
sha256 of the raw ``.npy`` bytes), the same codec — so each package reads
the other's checkpoints; a corrupt leaf raises ``IOError`` naming it; and
``SketchStore.save``/``load`` round-trip the store exactly.
"""
import os
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.query import SketchStore as JStore
from repro_torch import ckpt
from repro_torch.query import SketchStore


class Pair(NamedTuple):
    b: np.ndarray
    a: np.ndarray


def _tree(rng):
    """dict keys out of order, a NamedTuple, a list, a tuple, a None, a scalar."""
    return {
        "z": rng.normal(size=(3, 5)).astype(np.float32),
        "state": Pair(b=rng.integers(0, 9, size=(4,)).astype(np.int32),
                      a=rng.normal(size=(2, 2)).astype(np.float32)),
        "list": [rng.normal(size=(6,)).astype(np.float32), (np.float32(2.5), None)],
        "a": {"y": np.arange(3, dtype=np.int32), "x": np.ones((), np.float32)},
    }


def _as_torch(tree):
    """The same tree with its numpy leaves as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, Pair):
        return Pair(*(_as_torch(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return tree if tree is None else torch.from_numpy(np.asarray(tree))


def _leaves(tree):
    return [np.asarray(leaf) for _, leaf in ckpt.checkpoint._flatten(tree)]


def test_round_trip_latest_step_and_async(tmp_path, rng):
    tree = _as_torch(_tree(rng))
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    path = ckpt.save(d, 3, tree, extra={"note": "x"})
    assert os.path.basename(path) == "step_000000003"
    got, extra = ckpt.restore(d, 3, tree, device="cpu")
    assert extra == {"note": "x"}
    assert isinstance(got["state"], Pair) and isinstance(got["list"][1], tuple)
    assert got["list"][1][1] is None
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # The writer copies on the caller's thread: a later in-place write to
    # the caller's tensor does not reach the checkpoint.
    saver = ckpt.AsyncCheckpointer(d, keep=2)
    for step in (4, 5, 6):
        saved_z = tree["z"].clone()
        saver.save(step, tree)
        tree["z"].add_(1.0)
    saver.wait()
    assert sorted(os.listdir(d)) == ["step_000000005", "step_000000006"]
    assert ckpt.latest_step(d) == 6
    got = ckpt.read_subset(d, 6, ["z"])["z"]
    np.testing.assert_array_equal(got, saved_z.numpy())
    with pytest.raises(KeyError, match="missing leaves"):
        ckpt.read_subset(d, 6, ["nope"])
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(d, 6, {**tree, "z": torch.zeros(2)}, device="cpu")


def test_corrupt_leaf_raises_ioerror(tmp_path, rng):
    d = str(tmp_path)
    ckpt.save(d, 0, {"a": rng.normal(size=(64,)).astype(np.float32), "b": np.ones(3, np.float32)})
    meta = ckpt.read_manifest(d, 0)["leaves"]["a"]
    fn = os.path.join(d, "step_000000000", meta["file"])
    with open(fn, "rb") as f:
        data = bytearray(f.read())
    data[len(data) // 2] ^= 0xFF
    with open(fn, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(IOError, match="leaf a"):
        ckpt.read_subset(d, 0, ["a"])
    with pytest.raises(IOError, match="leaf a"):
        ckpt.restore(d, 0, {"a": np.zeros(64), "b": np.zeros(3)}, device="cpu")
    assert ckpt.read_subset(d, 0, ["b"])["b"].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_checkpoint(tmp_path, rng, writer):
    tree = _tree(rng)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(ref_dir, 1, tree, extra={"k": 1})
    ckpt.save(port_dir, 1, _as_torch(tree), extra={"k": 1})
    ref_m, port_m = jckpt.read_manifest(ref_dir, 1), ckpt.read_manifest(port_dir, 1)
    # The same leaf names in the same order, the same files and hashes.
    assert list(port_m["leaves"]) == list(ref_m["leaves"])
    assert port_m["leaves"] == ref_m["leaves"]
    assert port_m["codec"] == ref_m["codec"] and port_m["extra"] == ref_m["extra"]
    src = ref_dir if writer == "reference" else port_dir
    names = list(ref_m["leaves"])
    want = dict(zip(names, _leaves(tree)))
    if writer == "reference":
        got, _ = ckpt.restore(src, 1, _as_torch(tree), device="cpu")
        got_leaves = dict(zip(names, _leaves(got)))
    else:
        got, _ = jckpt.restore(src, 1, tree)
        got_leaves = {n: np.asarray(a) for n, a in zip(names, jax.tree.leaves(got))}
    subset = (ckpt if writer == "reference" else jckpt).read_subset(src, 1, names)
    for n in names:
        np.testing.assert_array_equal(got_leaves[n], want[n])
        np.testing.assert_array_equal(subset[n], want[n])


def test_sketch_store_save_load(tmp_path, rng):
    store = SketchStore(retain=2)
    for tenant, (l, d) in (("a/b", (4, 6)), ("c", (3, 6))):
        for v in range(3):
            store.publish(tenant, rng.normal(size=(l, d)), frob=1.5 + v, eps=0.1, n_seen=10 * v,
                          meta={"step": v}, published_at=float(v))
    path = store.save(str(tmp_path), step=2)
    assert path.endswith("step_000000002")
    for loaded in (SketchStore.load(str(tmp_path)), JStore.load(str(tmp_path))):
        assert loaded.tenants() == store.tenants()
        assert loaded.retain == 2
        for t in store.tenants():
            assert loaded.versions(t) == store.versions(t) == [2, 3]
            for v in store.versions(t):
                a, b = store.get(t, v), loaded.get(t, v)
                np.testing.assert_array_equal(np.asarray(b.matrix), a.matrix)
                assert (b.frob, b.eps, b.n_seen, dict(b.meta), b.published_at) == (
                    a.frob, a.eps, a.n_seen, dict(a.meta), a.published_at)
    again = SketchStore.load(str(tmp_path))
    assert again.publish("c", np.ones((3, 6)), frob=1.0, eps=0.1).version == 4
    with pytest.raises(FileNotFoundError):
        SketchStore.load(str(tmp_path / "empty"))
