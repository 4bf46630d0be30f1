"""Core: the paper's contribution — continuous distributed matrix tracking.

Ported so far:
  * fd.py          — Frequent Directions sketch (tensors + numpy oracle)
  * comm.py        — uniform message accounting (``CommReport``)
  * protocols.py   — event-driven heavy-hitter (HHP1–HHP4) and matrix
                     (MP1–MP4) protocols (numpy copy)
  * hh.py          — Misra--Gries summaries on tensors (``mg_scan``
                     kernel) + the numpy oracles and snapshot codec
  * quantiles.py   — GK quantile summaries on tensors (``quant_pack``
                     kernel) + the numpy summary, event streams and codec
  * leverage.py    — leverage-score row sampling: oracle, codec, event
                     streams, the tensor reservoir
  * distributed.py — super-step engine with the sites on a tensor axis:
                     matrix P1/P2, heavy-hitter P1, quantile P1, leverage P1
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
