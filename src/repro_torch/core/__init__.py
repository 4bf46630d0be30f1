"""Core: the paper's contribution — continuous distributed matrix tracking.

Ported so far:
  * fd.py          — Frequent Directions sketch (tensors + numpy oracle)
  * comm.py        — uniform message accounting (``CommReport``)
  * protocols.py   — event-driven matrix protocols MP1–MP4 (numpy copy)
  * leverage.py    — leverage-score row sampling: oracle, codec, event
                     streams, the tensor reservoir
  * distributed.py — super-step engine with the sites on a tensor axis:
                     matrix P1/P2, leverage P1
  * tracker.py     — continuous tracking facade for training integration
"""
from repro_torch.core.fd import (
    FDSketch,
    FDState,
    fd_init,
    fd_matrix,
    fd_merge,
    fd_query,
    fd_shrink,
    fd_update,
    fd_update_stream,
)
from repro_torch.core.comm import CommReport
from repro_torch.core.distributed import ProtocolConfig, make_protocol_runner
from repro_torch.core.tracker import DistributedMatrixTracker
