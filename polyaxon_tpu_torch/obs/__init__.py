"""Observability (port of ``polyaxon_tpu/obs``): run-lifecycle tracing
(``obs.trace``), the Prometheus metrics registry (``obs.metrics``), the
failure flight recorder (``obs.flight``), serving-request span trees
(``obs.reqtrace``) and their phase summary (``obs.analyze``'s
``request_phases``). The rest of the JAX package's analysis plane
(``rules``, ``history``, the run report of ``analyze``, ``oracle``) is
ROADMAP.md, Queue 1 item 9."""

from polyaxon_tpu_torch.obs import flight, metrics, trace
from polyaxon_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
)
from polyaxon_tpu_torch.obs.trace import (
    ENV_TRACE_PARENT,
    RunTracer,
    Span,
    add_event,
    build_timeline,
    current_span,
    read_trace,
)

__all__ = [
    "flight",
    "metrics",
    "trace",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "ENV_TRACE_PARENT",
    "RunTracer",
    "Span",
    "add_event",
    "build_timeline",
    "current_span",
    "read_trace",
]
