"""Tracking (port of ``polyaxon_tpu/tracking``): the run's event,
outputs, status and lineage files, and the system-metrics sampler."""

from polyaxon_tpu_torch.tracking.events import (
    EventWriter,
    V1EventKind,
    list_event_names,
    read_events,
    tail_file,
)
from polyaxon_tpu_torch.tracking.run import (
    ENV_ARTIFACTS_PATH,
    ENV_OUTPUTS_PATH,
    ENV_PROJECT,
    ENV_RUN_NAME,
    ENV_RUN_UUID,
    Run,
    from_env,
    get_or_create_run,
)
from polyaxon_tpu_torch.tracking.systemmetrics import (
    SystemMetricsMonitor,
    gpu_metrics,
    host_metrics,
)

__all__ = [
    "ENV_ARTIFACTS_PATH",
    "ENV_OUTPUTS_PATH",
    "ENV_PROJECT",
    "ENV_RUN_NAME",
    "ENV_RUN_UUID",
    "EventWriter",
    "Run",
    "SystemMetricsMonitor",
    "V1EventKind",
    "from_env",
    "get_or_create_run",
    "gpu_metrics",
    "host_metrics",
    "list_event_names",
    "read_events",
    "tail_file",
]
