"""Sharded, deterministic, prefetching host data pipeline.

Production loaders on a 1000-node fleet must be: (a) deterministic under
restart (step -> batch is a pure function of (seed, step)), (b) shardable
(each host materialises only its slice), (c) overlapped with compute.  This
pipeline provides all three without external deps:

  * ``TokenStream`` — stateless step->batch generator (seeded counter RNG);
    restart at step k reproduces exactly the batch a non-restarted run would
    have seen (checkpoint/restore correctness is tested on this invariant).
  * ``Prefetcher`` — background-thread double buffering.
  * per-host slicing via (host_index, host_count).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.data.synthetic import lm_token_batch

__all__ = ["TokenStream", "Prefetcher"]


@dataclass(frozen=True)
class TokenStream:
    """Deterministic synthetic LM token stream."""

    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by host_count {self.host_count}"
            )

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.host_count

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, host): restart-deterministic."""
        rng = np.random.default_rng((self.seed, step, self.host_index))
        tokens = lm_token_batch(rng, self.host_batch, self.seq_len, self.vocab)
        return {"tokens": tokens}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of any step-indexed source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
