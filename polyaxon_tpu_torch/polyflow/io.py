"""Typed inputs/outputs (``V1IO``) and params (``V1Param``).

Capability parity with the reference's ``polyaxon/polyflow/io`` +
``polyflow/params`` (SURVEY.md §2 [K]): components declare typed IO with
defaults/optionality; operations bind params by value or by reference to
another run's outputs; params can be routed into init containers
(``toInit``) or the process env (``toEnv``), or kept context-only.

Port of ``polyaxon_tpu/polyflow/io.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Optional, Union

from pydantic import field_validator

from polyaxon_tpu_torch.schemas.base import BaseSchema


class IOTypes:
    ANY = "any"
    INT = "int"
    FLOAT = "float"
    BOOL = "bool"
    STR = "str"
    DICT = "dict"
    LIST = "list"
    URI = "uri"
    AUTH = "auth"
    PATH = "path"
    METRIC = "metric"
    METADATA = "metadata"
    DATETIME = "datetime"
    DATE = "date"
    UUID = "uuid"
    GIT = "git"
    IMAGE = "image"
    DOCKERFILE = "dockerfile"
    EVENT = "event"
    ARTIFACTS = "artifacts"
    TENSORBOARD = "tensorboard"
    # TPU-native addition: a slice topology literal such as "v5e-64" or
    # "2x4" — validated by the compiler against the accelerator catalog.
    TPU_TOPOLOGY = "tpu_topology"

    VALUES = {
        ANY, INT, FLOAT, BOOL, STR, DICT, LIST, URI, AUTH, PATH, METRIC,
        METADATA, DATETIME, DATE, UUID, GIT, IMAGE, DOCKERFILE, EVENT,
        ARTIFACTS, TENSORBOARD, TPU_TOPOLOGY,
    }


_TRUE = {"true", "1", "yes", "y", "on", "t"}
_FALSE = {"false", "0", "no", "n", "off", "f"}


def parse_value(value: Any, type_: Optional[str], *, name: str = "") -> Any:
    """Coerce/validate ``value`` against an IO type name."""
    if value is None or type_ in (None, IOTypes.ANY):
        return value
    try:
        if type_ == IOTypes.INT:
            if isinstance(value, bool):
                raise ValueError
            if isinstance(value, float) and not value.is_integer():
                raise ValueError
            return int(value)
        if type_ in (IOTypes.FLOAT, IOTypes.METRIC):
            if isinstance(value, bool):
                raise ValueError
            return float(value)
        if type_ == IOTypes.BOOL:
            if isinstance(value, bool):
                return value
            text = str(value).strip().lower()
            if text in _TRUE:
                return True
            if text in _FALSE:
                return False
            raise ValueError
        if type_ in (IOTypes.STR, IOTypes.URI, IOTypes.PATH, IOTypes.IMAGE,
                     IOTypes.UUID, IOTypes.TPU_TOPOLOGY):
            if isinstance(value, (dict, list)):
                raise ValueError
            return str(value)
        if type_ in (IOTypes.DICT, IOTypes.METADATA, IOTypes.GIT,
                     IOTypes.DOCKERFILE, IOTypes.EVENT, IOTypes.ARTIFACTS,
                     IOTypes.AUTH, IOTypes.TENSORBOARD):
            if not isinstance(value, dict):
                raise ValueError
            return value
        if type_ == IOTypes.LIST:
            if not isinstance(value, list):
                raise ValueError
            return value
        if type_ in (IOTypes.DATETIME, IOTypes.DATE):
            if isinstance(value, (_dt.datetime, _dt.date)):
                return value
            return _dt.datetime.fromisoformat(str(value))
    except (TypeError, ValueError):
        raise ValueError(
            f"Param{' ' + name if name else ''}: value {value!r} is not a valid `{type_}`"
        ) from None
    raise ValueError(f"Unknown IO type `{type_}`")


class V1IO(BaseSchema):
    name: str
    description: Optional[str] = None
    type: Optional[str] = None
    value: Optional[Any] = None
    is_optional: Optional[bool] = None
    is_list: Optional[bool] = None
    is_flag: Optional[bool] = None
    arg_format: Optional[str] = None
    connection: Optional[str] = None
    to_init: Optional[bool] = None
    to_env: Optional[str] = None
    options: Optional[list[Any]] = None

    @field_validator("type")
    @classmethod
    def _check_type(cls, v: Optional[str]) -> Optional[str]:
        if v is not None and v not in IOTypes.VALUES:
            raise ValueError(f"Unknown IO type `{v}`")
        return v

    def validate_value(self, value: Any) -> Any:
        if value is None:
            if self.is_optional or self.value is not None:
                return self.value
            raise ValueError(f"Input `{self.name}` is required and no value was provided")
        if self.is_list:
            if not isinstance(value, list):
                raise ValueError(f"Input `{self.name}` expects a list, got {value!r}")
            value = [parse_value(item, self.type, name=self.name) for item in value]
        else:
            value = parse_value(value, self.type, name=self.name)
        if self.options and value not in self.options:
            raise ValueError(
                f"Input `{self.name}`: {value!r} not in allowed options {self.options}"
            )
        return value


class V1Param(BaseSchema):
    value: Optional[Any] = None
    ref: Optional[str] = None
    connection: Optional[str] = None
    context_only: Optional[bool] = None
    to_init: Optional[bool] = None
    to_env: Optional[str] = None

    @property
    def is_ref(self) -> bool:
        return self.ref is not None

    @property
    def is_runs_ref(self) -> bool:
        return bool(self.ref) and self.ref.startswith("runs.")

    @property
    def is_ops_ref(self) -> bool:
        return bool(self.ref) and self.ref.startswith("ops.")

    def get_ref_parts(self) -> tuple[str, str, str]:
        """``runs.<uuid>.outputs.<name>`` → ("runs", "<uuid>", "outputs.<name>")."""
        if not self.ref:
            raise ValueError("Param has no ref")
        parts = self.ref.split(".", 2)
        if len(parts) != 3:
            raise ValueError(f"Malformed param ref `{self.ref}`")
        return parts[0], parts[1], parts[2]


def validate_params_against_io(
    params: Optional[dict[str, V1Param]],
    inputs: Optional[list[V1IO]],
    outputs: Optional[list[V1IO]] = None,
    *,
    allow_extra: bool = False,
    provided_externally: Optional[set[str]] = None,
) -> dict[str, Any]:
    """Check every non-ref param against declared IO and fill defaults.

    Returns the fully-resolved ``{name: value}`` mapping the interpolation
    context will expose as ``params.*``.
    """
    params = dict(params or {})
    declared_inputs = {io.name: io for io in (inputs or [])}
    declared = dict(declared_inputs)
    declared.update({io.name: io for io in (outputs or []) if io.name not in declared})
    resolved: dict[str, Any] = {}
    for name, param in params.items():
        if param.context_only:
            continue
        if name not in declared:
            if allow_extra:
                resolved[name] = param.value
                continue
            raise ValueError(
                f"Param `{name}` was provided but the component declares no matching input/output"
            )
        if param.is_ref:
            # Ref params are resolved by the compiler once the upstream run
            # exists; type checking is deferred to resolution time.
            continue
        resolved[name] = declared[name].validate_value(param.value)
    # Only *inputs* can be required: outputs are produced by the run.
    for name, io in declared_inputs.items():
        if name in resolved:
            continue
        param = params.get(name)
        if param is not None and param.is_ref:
            continue
        if provided_externally and name in provided_externally:
            # A matrix/join/tuner binds this param per-trial at compile time.
            continue
        resolved[name] = io.validate_value(None)
    return resolved
