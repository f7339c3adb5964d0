"""Observability (port of ``polyaxon_tpu/obs``): run-lifecycle tracing
(``obs.trace``), the Prometheus metrics registry (``obs.metrics``), and
the analysis plane that reads them: declarative alert rules with SLO
burn-rate support (``obs.rules``), the metrics-history ring
(``obs.history``), per-run attribution reports (``obs.analyze``), the
telemetry oracle (``obs.oracle``), the failure flight recorder
(``obs.flight``) and serving-request span trees (``obs.reqtrace``)."""

from polyaxon_tpu_torch.obs import analyze, flight, metrics, reqtrace, rules, trace
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
    "analyze",
    "flight",
    "metrics",
    "reqtrace",
    "rules",
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
