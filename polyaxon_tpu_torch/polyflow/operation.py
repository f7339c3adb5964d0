"""``V1Operation`` — a concrete, parameterized execution of a component.

Parity with the reference's ``polyflow/operations`` (SURVEY.md §2/§3.1
[K]): binds params, presets, queue, matrix, schedule, DAG wiring
(dependencies/trigger/conditions/joins), and patches (``runPatch``) onto
an inline ``component`` or a referenced one (``hubRef``/``pathRef``/
``urlRef``).

Port of ``polyaxon_tpu/polyflow/operation.py``, the same code under the
port's module names.
"""

from __future__ import annotations

from typing import Annotated, Any, Optional, Union

from pydantic import Field, field_validator, model_validator

from polyaxon_tpu_torch.polyflow.component import V1Component
from polyaxon_tpu_torch.polyflow.environment import (
    V1Cache,
    V1Hook,
    V1Notification,
    V1Plugins,
    V1Termination,
)
from polyaxon_tpu_torch.polyflow.io import V1Param
from polyaxon_tpu_torch.polyflow.matrix import Matrix
from polyaxon_tpu_torch.polyflow.schedules import Schedule
from polyaxon_tpu_torch.schemas.base import BaseSchema


class V1TriggerPolicy:
    ALL_SUCCEEDED = "all_succeeded"
    ALL_FAILED = "all_failed"
    ALL_DONE = "all_done"
    ONE_SUCCEEDED = "one_succeeded"
    ONE_FAILED = "one_failed"
    ONE_DONE = "one_done"

    VALUES = {ALL_SUCCEEDED, ALL_FAILED, ALL_DONE, ONE_SUCCEEDED, ONE_FAILED, ONE_DONE}


class V1Join(BaseSchema):
    query: str
    sort: Optional[str] = None
    limit: Optional[int] = None
    params: Optional[dict[str, V1Param]] = None


class V1Build(BaseSchema):
    hub_ref: Optional[str] = None
    connection: Optional[str] = None
    params: Optional[dict[str, V1Param]] = None
    run_patch: Optional[dict[str, Any]] = None
    patch_strategy: Optional[str] = None
    queue: Optional[str] = None
    presets: Optional[list[str]] = None


class V1EventTrigger(BaseSchema):
    kinds: list[str]
    ref: str


class V1PatchStrategy:
    REPLACE = "replace"
    ISNULL = "isnull"
    POST_MERGE = "post_merge"
    PRE_MERGE = "pre_merge"

    VALUES = {REPLACE, ISNULL, POST_MERGE, PRE_MERGE}


AnnotatedMatrix = Annotated[Matrix, Field(discriminator="kind")]
AnnotatedSchedule = Annotated[Schedule, Field(discriminator="kind")]


class V1Operation(BaseSchema):
    version: Optional[float] = 1.1
    kind: Optional[str] = "operation"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[list[str]] = None
    params: Optional[dict[str, V1Param]] = None
    presets: Optional[list[str]] = None
    queue: Optional[str] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    build: Optional[V1Build] = None
    hooks: Optional[list[V1Hook]] = None
    notifications: Optional[list[V1Notification]] = None
    schedule: Optional[AnnotatedSchedule] = None
    events: Optional[list[V1EventTrigger]] = None
    joins: Optional[list[V1Join]] = None
    matrix: Optional[AnnotatedMatrix] = None
    dependencies: Optional[list[str]] = None
    trigger: Optional[str] = None
    conditions: Optional[str] = None
    skip_on_upstream_skip: Optional[bool] = None
    run_patch: Optional[dict[str, Any]] = None
    patch_strategy: Optional[str] = None
    is_preset: Optional[bool] = None
    is_approved: Optional[bool] = None
    component: Optional[V1Component] = None
    hub_ref: Optional[str] = None
    path_ref: Optional[str] = None
    url_ref: Optional[str] = None
    template: Optional[dict[str, Any]] = None

    @field_validator("kind")
    @classmethod
    def _check_kind(cls, v):
        if v not in (None, "operation"):
            raise ValueError(f"Expected kind `operation`, got `{v}`")
        return v

    @field_validator("trigger")
    @classmethod
    def _check_trigger(cls, v):
        if v is not None and v not in V1TriggerPolicy.VALUES:
            raise ValueError(f"Unknown trigger policy `{v}`")
        return v

    @field_validator("patch_strategy")
    @classmethod
    def _check_strategy(cls, v):
        if v is not None and v not in V1PatchStrategy.VALUES:
            raise ValueError(f"Unknown patch strategy `{v}`")
        return v

    @model_validator(mode="after")
    def _check_ref(self):
        refs = [r for r in (self.component, self.hub_ref, self.path_ref, self.url_ref) if r is not None]
        if not self.is_preset and len(refs) == 0:
            raise ValueError(
                "Operation requires one of: inline `component`, `hubRef`, `pathRef`, `urlRef`"
            )
        if len(refs) > 1:
            raise ValueError("Operation must reference exactly one component source")
        return self

    @property
    def has_component(self) -> bool:
        return self.component is not None
