"""Batched serving: prefill and decode against the KV cache."""
from repro_torch.serve.engine import ServeConfig, ServeEngine, greedy_consistency, make_serve_step

__all__ = ["ServeConfig", "ServeEngine", "greedy_consistency", "make_serve_step"]
