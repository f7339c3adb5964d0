"""Scheduling catalog: named queues, priority classes, project quotas.

The multi-tenant policy vocabulary (ISSUE 2; Borg/Kubernetes lineage —
PAPERS.md, Burns et al. 2016): operations name a **queue**
(``V1Operation.queue``) and a **priority class**
(``environment.priority_class_name``); projects carry **quotas** (max
concurrent runs, max TPU chips, fair-share weight). Queues and quotas
persist in the control-plane store (``queues``/``quotas`` tables); the
priority-class catalog is fixed — the k8s-style four-tier ladder below —
so specs stay portable across deployments.

``RunSchedInfo`` is the admission view of one run: resolved once at
compile time into ``meta["scheduling"]`` (so ticks never re-parse
specs), with a dict-walking fallback for runs submitted before this
subsystem existed.

Port of ``polyaxon_tpu/scheduling/catalog.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from polyaxon_tpu_torch.schemas.base import BaseSchema

# k8s-flavoured priority ladder. Higher admits/evicts first. "default"
# is deliberately above "low" so an unannotated run can still preempt
# an explicitly best-effort one.
PRIORITY_CLASSES: dict[str, int] = {
    "low": 0,
    "default": 1,
    "high": 2,
    "critical": 3,
}

DEFAULT_QUEUE = "default"
DEFAULT_PRIORITY_CLASS = "default"


class SchedulingError(ValueError):
    """A spec references an unknown queue or priority class."""


class V1Queue(BaseSchema):
    name: str
    priority: int = 0
    concurrency: Optional[int] = None  # None = unlimited
    preemptible: bool = False  # runs admitted here may be evicted
    description: Optional[str] = None


class V1Quota(BaseSchema):
    project: str
    max_runs: Optional[int] = None  # max CONCURRENT runs
    max_chips: Optional[int] = None  # max concurrent TPU chips
    weight: float = 1.0  # fair-share weight across projects


def resolve_priority_class(name: Optional[str]) -> int:
    """Priority-class name → numeric priority; unknown names raise so a
    bad spec fails at compile, not silently at the back of the queue."""
    if not name:
        return PRIORITY_CLASSES[DEFAULT_PRIORITY_CLASS]
    key = str(name).lower()
    if key not in PRIORITY_CLASSES:
        raise SchedulingError(
            f"unknown priority class `{name}` "
            f"(catalog: {sorted(PRIORITY_CLASSES)})")
    return PRIORITY_CLASSES[key]


def gang_priority(queue_priority: int, class_priority: int) -> int:
    """Scalar priority for the native slice pool's eviction compare:
    queue priority dominates, priority class breaks ties within a
    queue. Classes span [0, 4) so queue levels never interleave."""
    return int(queue_priority) * len(PRIORITY_CLASSES) + int(class_priority)


@dataclasses.dataclass
class RunSchedInfo:
    """One run's admission-relevant facts."""

    queue: str = DEFAULT_QUEUE
    priority_class: str = DEFAULT_PRIORITY_CLASS
    priority: int = PRIORITY_CLASSES[DEFAULT_PRIORITY_CLASS]
    chips: int = 0
    preemptible: bool = False
    # Resolved from the queue catalog by the admission pass; stays 0
    # for callers that never looked the queue row up.
    queue_priority: int = 0

    def effective(self, queue_priority: int) -> tuple[int, int]:
        """Lexicographic (queue priority, class priority) — the order
        the admission pass and victim selection both compare by."""
        return (queue_priority, self.priority)

    def to_meta(self) -> dict:
        return {
            "queue": self.queue,
            "priority_class": self.priority_class,
            "priority": self.priority,
            "chips": self.chips,
            "preemptible": self.preemptible,
        }


def _env_dict(spec: Optional[dict]) -> dict:
    """component.run.environment out of a serialized spec dict."""
    run = ((spec or {}).get("component") or {}).get("run") or {}
    return run.get("environment") or {}


def sched_info(record) -> RunSchedInfo:
    """Admission facts for a run record.

    Prefers the ``meta["scheduling"]`` stamp written at compile; falls
    back to walking the serialized launch plan / spec (camelCase
    aliases) so pre-subsystem runs and hand-crafted store rows still
    schedule sanely. Never raises: a malformed stamp degrades to the
    default queue rather than wedging the admission pass.
    """
    stamp = (record.meta or {}).get("scheduling") or {}
    if stamp.get("queue"):
        return RunSchedInfo(
            queue=str(stamp.get("queue") or DEFAULT_QUEUE),
            priority_class=str(
                stamp.get("priority_class") or DEFAULT_PRIORITY_CLASS),
            priority=int(stamp.get("priority") or 0),
            chips=int(stamp.get("chips") or 0),
            preemptible=bool(stamp.get("preemptible")),
        )
    plan = record.launch_plan or {}
    resources = plan.get("resources") or {}
    spec = record.resolved_spec or record.spec or {}
    env = _env_dict(spec)
    queue = plan.get("queue") or spec.get("queue") or DEFAULT_QUEUE
    class_name = (env.get("priorityClassName")
                  or env.get("priority_class_name")
                  or DEFAULT_PRIORITY_CLASS)
    try:
        priority = resolve_priority_class(class_name)
    except SchedulingError:
        class_name, priority = DEFAULT_PRIORITY_CLASS, resolve_priority_class(None)
    return RunSchedInfo(
        queue=str(queue),
        priority_class=str(class_name).lower(),
        priority=priority,
        chips=int(resources.get("chips") or 0),
        preemptible=bool(resources.get("preemptible")),
    )
