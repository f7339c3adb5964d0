"""Run statuses (the part of ``polyaxon_tpu/lifecycle.py`` that tracking
needs): the same status values, as a stdlib ``str`` enum, and ``now()``.
The transition graph and the condition models stay with the control
plane (ROADMAP.md, Queue 1 item 4b)."""

from __future__ import annotations

import datetime as _dt
from enum import Enum


def now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


class V1Statuses(str, Enum):
    CREATED = "created"
    ON_SCHEDULE = "on_schedule"
    RESUMING = "resuming"
    AWAITING_CACHE = "awaiting_cache"
    COMPILED = "compiled"
    QUEUED = "queued"
    SCHEDULED = "scheduled"
    STARTING = "starting"
    RUNNING = "running"
    PROCESSING = "processing"
    STOPPING = "stopping"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    UPSTREAM_FAILED = "upstream_failed"
    STOPPED = "stopped"
    SKIPPED = "skipped"
    WARNING = "warning"
    UNSCHEDULABLE = "unschedulable"
    PREEMPTED = "preempted"
    RETRYING = "retrying"
    UNKNOWN = "unknown"
    DONE = "done"
