"""Fault-tolerant checkpointing: atomic, hashed, device-agnostic, async.

Layout (one directory per step), the reference's (``repro.ckpt``) byte for
byte, so each package reads the other's checkpoints:

    <dir>/step_000123/
        manifest.json    — step, tree description, codec, extra, and per
                           leaf its file, shape, dtype and the sha256 of
                           its raw ``.npy`` bytes
        <leaf-path>.npy.zst   (``.npy.zlib`` without ``zstandard``)

Leaf names are the tree's path keys joined with ``__`` (``"root"`` for a
bare leaf), in the order ``jax.tree_util`` flattens a pytree: dict keys
sorted, NamedTuples by field, lists and tuples by index, ``None`` holding
no leaf (``repro_torch.tree`` walks trees in that order).  A bf16 leaf is
stored as the reference stores one: its raw 2-byte words as ``.npy`` of
dtype ``<V2``, with ``"bfloat16"`` as its dtype in the manifest.

Guarantees:
  * atomic: written to ``.tmp-step_000123`` then ``os.rename``d — a crash
    never leaves a half-readable checkpoint; ``latest_step`` only sees
    renamed directories.
  * integrity: per-leaf sha256 verified on restore (a corrupt leaf is
    reported by name).
  * device-agnostic: ``restore`` puts every leaf on the ``device`` it is
    given (the CUDA card by default); nothing in the format depends on
    where the tree was saved.
  * async: ``AsyncCheckpointer`` copies the tree to host memory on the
    caller's thread and compresses and writes it on a background thread.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import children as _children
from repro_torch.tree import flatten as _flatten
from repro_torch.tree import unflatten

try:  # optional: fall back to stdlib zlib on minimal installs
    import zstandard
except ModuleNotFoundError:
    zstandard = None

__all__ = [
    "save",
    "restore",
    "latest_step",
    "read_extra",
    "read_manifest",
    "read_subset",
    "AsyncCheckpointer",
]

_MANIFEST = "manifest.json"


def _compressor() -> tuple[str, "callable"]:
    if zstandard is not None:
        return "zstd", zstandard.ZstdCompressor(level=3).compress
    return "zlib", lambda raw: zlib.compress(raw, 6)


def _decompress(codec: str, data: bytes) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd; install `zstandard` to restore it"
            )
        return zstandard.ZstdDecompressor().decompress(data)
    if codec == "zlib":
        return zlib.decompress(data)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _describe(tree) -> str:
    """A readable description of the tree's structure (``*`` for a leaf)."""
    if tree is None:
        return "None"
    children = _children(tree)
    if children is None:
        return "*"
    inner = ", ".join(
        f"{k!r}: {_describe(c)}" if isinstance(tree, dict)
        else f"{k}={_describe(c)}" if hasattr(tree, "_fields")
        else _describe(c)
        for k, c in children
    )
    if isinstance(tree, dict):
        return "{" + inner + "}"
    if hasattr(tree, "_fields"):
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, list):
        return "[" + inner + "]"
    return "(" + inner + ("," if len(children) == 1 else "") + ")"


def _leaf_paths(tree) -> list[tuple[str, object]]:
    return [("__".join(str(k) for k in path) or "root", leaf) for path, leaf in _flatten(tree)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """The leaf as a numpy array, and its dtype's name for the manifest (a
    bf16 tensor as its int16 bit patterns, named ``bfloat16``)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bf16: its bits
            return leaf.view(torch.int16).numpy(), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _npy(arr: np.ndarray, dtype: str) -> bytes:
    """The ``.npy`` bytes of a leaf.  A bf16 leaf's header names it ``<V2``,
    as numpy writes ml_dtypes' bfloat16 (the same length as ``<i2``, so the
    header's padding is unchanged)."""
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    raw = buf.getvalue()
    if dtype == "bfloat16":
        raw = raw.replace(b"'descr': '<i2'", b"'descr': '<V2'", 1)
    return raw


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree, *, extra: dict | None = None) -> str:
    """Write a checkpoint atomically; returns the final path."""
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = os.path.join(directory, f".tmp-step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    codec, compress = _compressor()
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({_describe(tree)})",
        "codec": codec,
        "extra": extra or {},
        "leaves": {},
    }
    for name, leaf in _leaf_paths(tree):
        arr, dtype = _to_host(leaf)
        raw = _npy(arr, dtype)
        fn = f"{name}.npy.{'zst' if codec == 'zstd' else codec}"
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(compress(raw))
        manifest["leaves"][name] = {
            "file": fn,
            "shape": list(arr.shape),
            "dtype": dtype,
            "sha256": hashlib.sha256(raw).hexdigest(),
        }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return sorted(
        int(m.group(1)) for d in os.listdir(directory) if (m := re.fullmatch(r"step_(\d+)", d))
    )


def latest_step(directory: str) -> int | None:
    """Newest fully-written step under ``directory`` (None when empty).

    Only renamed ``step_*`` directories count — an in-flight ``.tmp-*``
    write is invisible, which is what makes ``save`` atomic to readers.
    """
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """Read a checkpoint's full manifest (no leaf I/O): every leaf's name,
    shape, dtype and sha256, and the ``extra`` metadata."""
    with open(os.path.join(directory, f"step_{step:09d}", _MANIFEST)) as f:
        return json.load(f)


def read_extra(directory: str, step: int) -> dict:
    """Read only the ``extra`` metadata of a checkpoint (no leaf I/O), for
    callers whose tree structure ``extra`` describes (the sketch store)."""
    return read_manifest(directory, step)["extra"]


def _read_leaf(path: str, codec: str, name: str, meta: dict) -> np.ndarray:
    """One leaf's array, sha256-verified; corruption raises ``IOError``."""
    with open(os.path.join(path, meta["file"]), "rb") as f:
        try:
            raw = _decompress(codec, f.read())
        except Exception as exc:
            # A truncated payload usually dies in the decompressor before
            # the sha check can name the leaf; keep the attribution.
            raise IOError(f"checkpoint corruption in leaf {name} ({path}): {exc}") from exc
    if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
        raise IOError(f"checkpoint corruption in leaf {name} ({path})")
    return np.load(io.BytesIO(raw), allow_pickle=False)


def read_subset(directory: str, step: int, names) -> dict[str, np.ndarray]:
    """Read only the named leaves of a checkpoint, sha256-verified, as numpy.

    ``names`` are flattened leaf names as they appear in the manifest; one
    tenant's leaves of a pipeline checkpoint, say.  Unknown names raise
    ``KeyError`` before any leaf I/O happens.
    """
    path = os.path.join(directory, f"step_{step:09d}")
    manifest = read_manifest(directory, step)
    codec = manifest.get("codec", "zstd")
    names = list(names)
    missing = [n for n in names if n not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint {path} missing leaves {missing}")
    return {n: _read_leaf(path, codec, n, manifest["leaves"][n]) for n in names}


def restore(directory: str, step: int, template, *, device=None):
    """Restore into ``template``'s structure, every leaf a tensor on ``device``
    (``None``: the CUDA card).  Returns ``(tree, extra)``."""
    device = resolve_device(device)
    path = os.path.join(directory, f"step_{step:09d}")
    manifest = read_manifest(directory, step)
    codec = manifest.get("codec", "zstd")
    out = []
    for name, leaf in _leaf_paths(template):
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint {path} missing leaf {name}")
        arr = _read_leaf(path, codec, name, meta)
        if list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(
                f"leaf {name}: checkpoint shape {arr.shape} != template {tuple(np.shape(leaf))}"
            )
        out.append(_to_tensor(arr, meta["dtype"]).to(device))
    return unflatten(template, out), manifest["extra"]


class AsyncCheckpointer:
    """Copy to the host on the caller's thread, write in the background."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, *, extra: dict | None = None):
        """Copy ``tree`` to host memory now, write it in a background thread.

        Blocks only for the previous outstanding write (one at a time) and
        the device-to-host copies; compression and disk I/O happen off the
        caller's thread.  Write errors surface on the next ``wait``.
        """
        self.wait()  # one outstanding write at a time
        # Copies, so the caller may go on writing into its tensors.
        host = [leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
                else np.array(leaf) for _, leaf in _flatten(tree)]
        host_tree = unflatten(tree, host)

        def work():
            try:
                save(self.directory, step, host_tree, extra=extra)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Block until the outstanding write finishes; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)
