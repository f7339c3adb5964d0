"""Run lifecycle: statuses, conditions, and the legal transition graph.

Mirrors the capability of the reference's ``polyaxon/lifecycle`` layer
(SURVEY.md §2 "Lifecycle", [K]): a run advances
created → compiled → queued → scheduled → starting → running →
{succeeded, failed, stopped, skipped, upstream_failed, done}, with
auxiliary states (resuming, retrying, on_schedule, awaiting_cache) and
a monotonic condition list recorded on every transition.

TPU-native addition: ``PREEMPTED`` is first-class (preemptible TPU-VM
slices are part of the north star) and is restartable without counting
against ``max_retries`` unless the spec says otherwise.

Port of ``polyaxon_tpu/lifecycle.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import datetime as _dt
from enum import Enum
from typing import Optional

from pydantic import BaseModel, Field


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

    @classmethod
    def terminal_values(cls) -> set["V1Statuses"]:
        return {
            cls.SUCCEEDED,
            cls.FAILED,
            cls.UPSTREAM_FAILED,
            cls.STOPPED,
            cls.SKIPPED,
            cls.DONE,
        }


DONE_STATUSES = V1Statuses.terminal_values()
RUNNABLE_STATUSES = {V1Statuses.QUEUED, V1Statuses.SCHEDULED, V1Statuses.STARTING}
PENDING_STATUSES = {
    V1Statuses.CREATED,
    V1Statuses.ON_SCHEDULE,
    V1Statuses.AWAITING_CACHE,
    V1Statuses.COMPILED,
    V1Statuses.RESUMING,
}
LIVE_STATUSES = {V1Statuses.RUNNING, V1Statuses.PROCESSING, V1Statuses.STOPPING}

# Legal forward edges of the state machine. Anything may move to a terminal
# failure/stop state; PREEMPTED and RETRYING loop back into the queue.
_TRANSITIONS: dict[V1Statuses, set[V1Statuses]] = {
    V1Statuses.CREATED: {
        V1Statuses.ON_SCHEDULE,
        V1Statuses.RESUMING,
        V1Statuses.AWAITING_CACHE,
        V1Statuses.COMPILED,
        V1Statuses.SKIPPED,
    },
    V1Statuses.ON_SCHEDULE: {V1Statuses.COMPILED, V1Statuses.AWAITING_CACHE},
    V1Statuses.RESUMING: {V1Statuses.COMPILED, V1Statuses.AWAITING_CACHE},
    V1Statuses.AWAITING_CACHE: {V1Statuses.COMPILED, V1Statuses.SUCCEEDED, V1Statuses.SKIPPED},
    V1Statuses.COMPILED: {V1Statuses.QUEUED},
    V1Statuses.QUEUED: {V1Statuses.SCHEDULED, V1Statuses.UNSCHEDULABLE},
    V1Statuses.UNSCHEDULABLE: {V1Statuses.QUEUED, V1Statuses.SCHEDULED},
    V1Statuses.SCHEDULED: {V1Statuses.STARTING, V1Statuses.RUNNING, V1Statuses.PREEMPTED},
    V1Statuses.STARTING: {V1Statuses.RUNNING, V1Statuses.PREEMPTED},
    V1Statuses.RUNNING: {
        V1Statuses.PROCESSING,
        V1Statuses.STOPPING,
        V1Statuses.SUCCEEDED,
        V1Statuses.FAILED,
        V1Statuses.WARNING,
        V1Statuses.PREEMPTED,
    },
    V1Statuses.PROCESSING: {V1Statuses.RUNNING, V1Statuses.SUCCEEDED, V1Statuses.FAILED},
    V1Statuses.WARNING: {V1Statuses.RUNNING, V1Statuses.SUCCEEDED, V1Statuses.FAILED},
    V1Statuses.STOPPING: {V1Statuses.STOPPED, V1Statuses.FAILED},
    V1Statuses.PREEMPTED: {V1Statuses.RETRYING, V1Statuses.QUEUED, V1Statuses.FAILED},
    V1Statuses.RETRYING: {V1Statuses.QUEUED, V1Statuses.COMPILED},
    V1Statuses.UNKNOWN: set(V1Statuses),
}
# Universal edges: any non-terminal state can be stopped or fail outright.
_UNIVERSAL_TARGETS = {
    V1Statuses.STOPPING,
    V1Statuses.STOPPED,
    V1Statuses.FAILED,
    V1Statuses.UPSTREAM_FAILED,
    V1Statuses.UNKNOWN,
    V1Statuses.DONE,
}


class V1StatusCondition(BaseModel):
    type: V1Statuses
    status: bool = True
    reason: Optional[str] = None
    message: Optional[str] = None
    last_update_time: _dt.datetime = Field(default_factory=now)
    last_transition_time: _dt.datetime = Field(default_factory=now)

    @classmethod
    def get_condition(
        cls,
        type: V1Statuses,  # noqa: A002 - mirrors upstream kwarg name
        status: bool = True,
        reason: Optional[str] = None,
        message: Optional[str] = None,
    ) -> "V1StatusCondition":
        return cls(type=type, status=status, reason=reason, message=message)


class LifecycleError(Exception):
    pass


def is_done(status: V1Statuses) -> bool:
    return status in DONE_STATUSES


def can_transition(current: V1Statuses, target: V1Statuses) -> bool:
    if current == target:
        return False
    if is_done(current) and target != V1Statuses.DONE:
        return False
    if target in _UNIVERSAL_TARGETS:
        return True
    return target in _TRANSITIONS.get(current, set())


def validate_transition(current: V1Statuses, target: V1Statuses) -> None:
    if not can_transition(current, target):
        raise LifecycleError(f"Illegal lifecycle transition: {current.value} -> {target.value}")


class StatusTracker(BaseModel):
    """Holds the current status plus the condition history for one run."""

    status: V1Statuses = V1Statuses.CREATED
    conditions: list[V1StatusCondition] = Field(
        default_factory=lambda: [V1StatusCondition(type=V1Statuses.CREATED)]
    )

    def transition(
        self,
        target: V1Statuses,
        reason: Optional[str] = None,
        message: Optional[str] = None,
        force: bool = False,
    ) -> V1StatusCondition:
        if not force:
            validate_transition(self.status, target)
        cond = V1StatusCondition.get_condition(type=target, reason=reason, message=message)
        self.status = target
        self.conditions.append(cond)
        return cond

    @property
    def is_done(self) -> bool:
        return is_done(self.status)
