"""Template interpolation: ``{{ params.x }}`` / ``{{ globals.* }}``.

Parity target: the reference's context resolution (SURVEY.md §3.1 [K]):
container command/args/env and IO values may reference bound params and
run globals with jinja-style expressions. Rendered with a sandboxed
jinja2 environment (jinja2 is available in-env [E]).

Port of ``polyaxon_tpu/polyaxonfile/context.py``, the same code under
the port's module names.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

from jinja2 import StrictUndefined, Undefined
from jinja2.sandbox import SandboxedEnvironment

_ENV = SandboxedEnvironment(
    undefined=StrictUndefined,
    keep_trailing_newline=True,
)
_LENIENT_ENV = SandboxedEnvironment(undefined=Undefined, keep_trailing_newline=True)


class ContextError(ValueError):
    pass


def default_globals(
    *,
    run_uuid: str = "",
    run_name: str = "",
    project_name: str = "",
    owner_name: str = "default",
    iteration: Optional[int] = None,
    base_path: str = "",
) -> dict[str, Any]:
    """The ``globals.*`` namespace exposed to templates — mirrors the
    reference's run context contract (uuid/name/paths/iteration [K])."""
    artifacts_path = os.path.join(base_path, run_uuid) if base_path else ""
    return {
        "owner_name": owner_name,
        "project_name": project_name,
        "project_unique_name": f"{owner_name}.{project_name}" if project_name else "",
        "uuid": run_uuid,
        "name": run_name,
        "iteration": iteration,
        "context_path": "/plx-context",
        "artifacts_path": artifacts_path,
        "run_artifacts_path": artifacts_path,
        "run_outputs_path": os.path.join(artifacts_path, "outputs") if artifacts_path else "",
    }


def render_value(value: Any, context: Mapping[str, Any], *, strict: bool = True) -> Any:
    """Recursively render jinja expressions inside strings/lists/dicts.

    A string that is exactly one ``{{ expr }}`` preserves the expression's
    native type (so ``"{{ params.lr }}"`` with lr=0.1 yields a float, not
    the string "0.1") — matching the reference's param-substitution
    behavior for typed IO.
    """
    if isinstance(value, str):
        if "{{" not in value and "{%" not in value:
            return value
        env = _ENV if strict else _LENIENT_ENV
        stripped = value.strip()
        if stripped.startswith("{{") and stripped.endswith("}}") and stripped.count("{{") == 1:
            expr = stripped[2:-2].strip()
            try:
                result = env.compile_expression(expr, undefined_to_none=False)(**context)
            except Exception as exc:
                raise ContextError(f"Failed to resolve `{value}`: {exc}") from exc
            if isinstance(result, Undefined):
                if strict:
                    raise ContextError(f"Unresolved expression `{value}`")
                return None
            return result
        try:
            return env.from_string(value).render(**context)
        except Exception as exc:
            raise ContextError(f"Failed to render `{value}`: {exc}") from exc
    if isinstance(value, list):
        return [render_value(item, context, strict=strict) for item in value]
    if isinstance(value, tuple):
        return tuple(render_value(item, context, strict=strict) for item in value)
    if isinstance(value, dict):
        return {k: render_value(v, context, strict=strict) for k, v in value.items()}
    return value
