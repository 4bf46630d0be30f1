"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each source in ``csrc/`` has a plain C entry point and compiles on its own
into ``build/kernels/<stem>-<hash>.so`` at the root of the checkout, keyed
by a hash of the source, the headers in ``csrc/`` and the flags, so a
changed source or header rebuilds and an unchanged one loads.  Nothing is
built when a module is imported: a kernel builds at its first launch, or
when ``build`` is called for several at once (one ``nvcc`` each, all
started together).

Launch contract of every entry point: it launches on the stream it is
given (PyTorch's current stream), allocates nothing, and returns
``cudaGetLastError()``; ``CudaKernel`` raises if that is not 0.  A source
may also export a host function that launches nothing and answers an
integer, such as the scratch a launch needs (``CudaKernel.query``).

Threads may launch at once (the cluster drives each cell on a thread of
its own, and ctypes lets go of the GIL during a call): a kernel is built
and loaded once under a lock, each build writes a temporary file of its
own thread, and launch counts rise under a lock.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "CudaKernel", "build", "library_path"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
# A checkout (src/repro_torch/kernels) builds into <checkout>/build/kernels;
# an installed package builds beside its sources.
BUILD_DIR = (
    _HERE.parents[2] / "build" / "kernels" if _HERE.parents[1].name == "src" else _HERE / "build"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, on stderr
)
# Held while a kernel is built and loaded, and while a count rises.
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def library_path(source: str) -> Path:
    """Where ``source``'s shared library lives, keyed by the source, every
    header in ``csrc/`` (any source may include one) and the flags."""
    key = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{key.hexdigest()[:16]}.so"


def _report_path(source: str) -> Path:
    """Where the ptxas report of ``source``'s library is kept."""
    return library_path(source).with_suffix(".ptxas")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build(sources) -> dict[str, str]:
    """Compile every source in ``sources`` that is not built yet, all at once.

    Returns ``{source: ptxas report}`` for every source in ``sources``: the
    compiler's output of this call's build, or the one saved beside the
    library when it was built.  Raises with the compiler's output if any of
    them fails.
    """
    pending = [s for s in sources if not library_path(s).exists()]
    reports = {s: _report_path(s).read_text() for s in sources
               if s not in pending and _report_path(s).exists()}
    if not pending:
        return reports
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in pending:
        out = library_path(source)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, proc, tmp, out))
    failures = []
    for source, proc, tmp, out in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{source} (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        _report_path(source).write_text(text)
        os.replace(tmp, out)
        reports[source] = text
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return reports


class CudaKernel:
    """One C entry point of one source, loaded at its first launch.

    ``launches`` is a plain count, raised by one (under a lock) each time
    ``launch`` has started the kernel on the card and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None
        self._queries = {}

    def _entry(self):
        if self._fn is None:
            with _LOAD_LOCK:
                if self._fn is None:
                    build([self.source])
                    self._lib = ctypes.CDLL(str(library_path(self.source)))
                    fn = getattr(self._lib, self.symbol)
                    fn.argtypes = [*self.argtypes, ctypes.c_void_p]  # last: the stream
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a CUDA error."""
        fn = self._entry()
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} ({self.source}) failed to launch: CUDA error {rc}")
        with _COUNT_LOCK:
            self.launches += 1

    def query(self, device: torch.device, symbol: str, argtypes: list, *args) -> int:
        """Call ``symbol``, a host function of the same library that launches
        nothing, on ``device``, and return its answer; raise if it is negative
        (minus a CUDA error).  No count moves."""
        self._entry()
        fn = self._queries.get(symbol)
        if fn is None:
            fn = getattr(self._lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_longlong
            self._queries[symbol] = fn
        with torch.cuda.device(device):
            answer = fn(*args)
        if answer < 0:
            raise RuntimeError(f"{symbol} ({self.source}) failed: CUDA error {-answer}")
        return answer
