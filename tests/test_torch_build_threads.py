"""The kernels' build and load code under threads, on the CPU.

The cluster drives each cell on a thread of its own, and ctypes lets go of
the GIL during a foreign call, so two cells can reach a kernel's first
launch at once.  ``CudaKernel._entry`` must then build and load the library
once, and ``build`` must give each thread's compiler output a file of its
own, and the launch counts must not lose a launch.  No JAX, no compiler,
no card: the build, the loader and the launch are replaced by fakes.
"""
import contextlib
import ctypes
import threading
import time

from repro_torch.kernels import _build

THREADS = 8


def _at_once(fn, n=THREADS):
    """Run ``fn`` on ``n`` threads released together; return their results."""
    start = threading.Barrier(n)
    out = [None] * n

    def run(i):
        start.wait(timeout=10)
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def test_entry_builds_and_loads_once_from_many_threads(monkeypatch):
    calls = {"build": 0, "load": 0}

    def slow_build(sources):
        calls["build"] += 1
        time.sleep(0.05)  # other threads arrive while this one builds
        return {}

    class SlowLibrary:
        def __init__(self, path):
            calls["load"] += 1
            time.sleep(0.02)
            self.entry = lambda *args: 0

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "library_path", lambda source: source + ".so")
    monkeypatch.setattr(_build.ctypes, "CDLL", SlowLibrary)
    kernel = _build.CudaKernel("fake.cu", "entry", [ctypes.c_void_p])
    fns = _at_once(kernel._entry)
    assert calls == {"build": 1, "load": 1}
    assert all(fn is fns[0] for fn in fns)
    assert fns[0].restype is ctypes.c_int and len(fns[0].argtypes) == 2


def test_build_gives_each_thread_its_own_temporary_file(monkeypatch, tmp_path):
    outputs = []
    inside = threading.Barrier(THREADS)

    class FakeCompiler:
        """Records the output file and writes it, as nvcc would, once every
        thread has started its own compiler (none found the library)."""

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            outputs.append(out)
            inside.wait(timeout=10)
            with open(out, "w") as f:
                f.write(out)
            self.returncode = 0

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path", lambda source: tmp_path / "fake.so")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeCompiler)
    reports = _at_once(lambda: _build.build(["fake.cu"]))
    assert len(outputs) == THREADS and len(set(outputs)) == THREADS
    assert all(r == {"fake.cu": "ptxas info"} for r in reports)
    assert (tmp_path / "fake.so").exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_launch_counts_lose_no_launch_under_threads(monkeypatch):
    """Threads launch at once, and each read of the count hands the
    interpreter to another thread, as a switch between the read and the
    write of ``launches += 1`` would: the count is exact."""

    class YieldingCount(_build.CudaKernel):
        @property
        def launches(self):
            value = self._count
            time.sleep(0)  # another thread runs between the read and the write
            return value

        @launches.setter
        def launches(self, value):
            self._count = value

    monkeypatch.setattr(_build.torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build.torch.cuda, "current_stream",
                        lambda device: type("Stream", (), {"cuda_stream": 0})())
    kernel = YieldingCount("fake.cu", "entry", [])
    kernel._fn = lambda stream: 0  # a launch that returns cudaSuccess
    per_thread = 100
    _at_once(lambda: [kernel.launch("cuda") for _ in range(per_thread)])
    assert kernel.launches == THREADS * per_thread
