"""Streaming runtime: the paper's continuous loop as one coherent layer.

Ported so far:

  * registry.py — typed ``SketchProtocol`` interface + one registration
                  point; the super-step engine's matrix P1 and P2.
"""
from repro_torch.runtime.registry import (
    ProtocolSpec,
    SketchProtocol,
    create_protocol,
    get_spec,
    protocol_names,
    register_protocol,
    specs,
)

__all__ = [
    "ProtocolSpec",
    "SketchProtocol",
    "create_protocol",
    "get_spec",
    "protocol_names",
    "register_protocol",
    "specs",
]
