"""Serving engine of the port: continuous batching over the HDP planner.

`pool`   — request lifecycle + thread-safe pool (copied).
`engine` — ServeEngine: admission, prefill→decode KV handoff, decode slab.
"""
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.pool import Request, RequestPool

__all__ = ["Request", "RequestPool", "ServeConfig", "ServeEngine"]
