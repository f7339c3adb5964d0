"""Pydantic base for every spec type in the polyflow IR.

The reference's spec universe is camelCase YAML (``hubRef``, ``runPatch``,
``maxIterations`` — SURVEY.md §2 "Polyflow IR" [K]); Python fields are
snake_case. ``BaseSchema`` wires a camelCase alias generator with
populate-by-name so both spellings parse, serializes by alias, and drops
``None`` fields on dump so round-tripped YAML stays minimal.

Port of ``polyaxon_tpu/schemas/base.py``, the same code under the port's
module names.
"""

from __future__ import annotations

from typing import Any

from pydantic import BaseModel, ConfigDict


def to_camel(snake: str) -> str:
    head, *tail = snake.split("_")
    return head + "".join(word.capitalize() for word in tail)


class BaseSchema(BaseModel):
    model_config = ConfigDict(
        alias_generator=to_camel,
        populate_by_name=True,
        extra="forbid",
        validate_assignment=True,
        use_enum_values=True,
    )

    def to_dict(self, *, exclude_none: bool = True) -> dict[str, Any]:
        return self.model_dump(by_alias=True, exclude_none=exclude_none, mode="json")

    @classmethod
    def from_dict(cls, data: dict[str, Any]):
        return cls.model_validate(data)

    def clone(self):
        return self.model_copy(deep=True)
