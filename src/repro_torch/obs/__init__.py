"""Observability surface of the port: tracing, metrics, flight recorder.

    from repro_torch.obs import get_metrics, get_recorder, get_tracer

    with get_tracer().span("prefill", composition=comp):
        ...
    get_metrics().counter("serve.prefill_waves").inc()

All three are process-global singletons, as in the reference package.
Tracing is disabled by default (``REPRO_TRACE=1`` enables it at import).
"""
from repro_torch.obs.metrics import get_metrics
from repro_torch.obs.recorder import get_recorder
from repro_torch.obs.trace import get_tracer

__all__ = ["get_metrics", "get_recorder", "get_tracer"]
