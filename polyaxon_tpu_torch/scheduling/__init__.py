"""Multi-tenant scheduling: queues, priority classes, quotas, fair-share
admission, and priority preemption (ISSUE 2; docs/scheduling.md).

Port of ``polyaxon_tpu/scheduling/__init__.py``, the same code under the port's
module names.
"""

from polyaxon_tpu_torch.scheduling.admission import (
    AdmissionController,
    AdmissionDecision,
    LIVE_STATUSES,
)
from polyaxon_tpu_torch.scheduling.catalog import (
    DEFAULT_PRIORITY_CLASS,
    DEFAULT_QUEUE,
    PRIORITY_CLASSES,
    RunSchedInfo,
    SchedulingError,
    V1Queue,
    V1Quota,
    gang_priority,
    resolve_priority_class,
    sched_info,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "DEFAULT_PRIORITY_CLASS",
    "DEFAULT_QUEUE",
    "LIVE_STATUSES",
    "PRIORITY_CLASSES",
    "RunSchedInfo",
    "SchedulingError",
    "V1Queue",
    "V1Quota",
    "gang_priority",
    "resolve_priority_class",
    "sched_info",
]
