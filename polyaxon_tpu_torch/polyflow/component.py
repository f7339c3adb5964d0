"""``V1Component`` — the reusable, typed unit of execution.

Parity with the reference's ``polyflow/component`` (SURVEY.md §2 [K]):
a versioned spec with declared inputs/outputs and a run section (one of
the run kinds). Operations reference or inline components and bind params.

Port of ``polyaxon_tpu/polyflow/component.py``, the same code under the
port's module names.
"""

from __future__ import annotations

from typing import Annotated, Any, Optional, Union

from pydantic import Field, field_validator

from polyaxon_tpu_torch.polyflow.environment import V1Cache, V1Plugins, V1Termination, V1Hook
from polyaxon_tpu_torch.polyflow.io import V1IO
from polyaxon_tpu_torch.polyflow.runs import RunSpec, V1RunKind
from polyaxon_tpu_torch.schemas.base import BaseSchema

AnnotatedRun = Annotated[RunSpec, Field(discriminator="kind")]


class V1Component(BaseSchema):
    version: Optional[float] = 1.1
    kind: Optional[str] = "component"
    name: Optional[str] = None
    description: Optional[str] = None
    tags: Optional[list[str]] = None
    presets: Optional[list[str]] = None
    queue: Optional[str] = None
    cache: Optional[V1Cache] = None
    termination: Optional[V1Termination] = None
    plugins: Optional[V1Plugins] = None
    hooks: Optional[list[V1Hook]] = None
    inputs: Optional[list[V1IO]] = None
    outputs: Optional[list[V1IO]] = None
    template: Optional[dict[str, Any]] = None
    run: AnnotatedRun

    @field_validator("kind")
    @classmethod
    def _check_kind(cls, v):
        if v not in (None, "component"):
            raise ValueError(f"Expected kind `component`, got `{v}`")
        return v

    @property
    def run_kind(self) -> str:
        return self.run.kind

    def get_io(self, name: str) -> Optional[V1IO]:
        for io in (self.inputs or []) + (self.outputs or []):
            if io.name == name:
                return io
        return None

    def is_native_kind(self) -> bool:
        return self.run_kind in V1RunKind.NATIVE
