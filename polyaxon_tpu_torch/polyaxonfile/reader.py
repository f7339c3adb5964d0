"""Polyaxonfile loading: YAML/JSON → validated IR.

Parity target: the reference's ``polyaxonfile`` package (SURVEY.md §2,
§3.1 [K]): load one or more spec files, merge them in order (later files
patch earlier ones), detect the kind (component vs operation), apply CLI
params / presets / patches, and produce a validated ``V1Operation``.

Port of ``polyaxon_tpu/polyaxonfile/reader.py``, the same code under the
port's module names.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Optional, Sequence, Union

import yaml

from polyaxon_tpu_torch.polyaxonfile.context import default_globals, render_value
from polyaxon_tpu_torch.polyaxonfile.patch import patch_dict
from polyaxon_tpu_torch.polyflow.component import V1Component
from polyaxon_tpu_torch.polyflow.io import V1Param, validate_params_against_io
from polyaxon_tpu_torch.polyflow.operation import V1Operation


class PolyaxonfileError(ValueError):
    pass


def _load_one(source: Union[str, dict]) -> list[dict]:
    """A source may be a path, a YAML payload string, or an already-parsed
    dict. Multi-document YAML streams yield multiple specs."""
    if isinstance(source, dict):
        return [copy.deepcopy(source)]
    text = source
    looks_like_path = isinstance(source, str) and "\n" not in source and (
        os.sep in source or source.endswith((".yaml", ".yml", ".json"))
    )
    if looks_like_path:
        if not os.path.exists(source):
            raise PolyaxonfileError(f"Polyaxonfile not found: {source}")
        with open(source) as handle:
            text = handle.read()
    try:
        docs = [d for d in yaml.safe_load_all(text) if d is not None]
    except yaml.YAMLError as exc:
        raise PolyaxonfileError(f"Invalid YAML: {exc}") from exc
    if not docs:
        raise PolyaxonfileError(f"Empty Polyaxonfile: {source!r}")
    for doc in docs:
        if not isinstance(doc, dict):
            raise PolyaxonfileError(f"Polyaxonfile documents must be mappings, got {type(doc)}")
    return docs


def load_specs(sources: Union[str, dict, Sequence[Union[str, dict]]]) -> dict:
    """Load and merge (post-merge order) one or more spec sources."""
    if isinstance(sources, (str, dict)):
        sources = [sources]
    docs: list[dict] = []
    for src in sources:
        docs.extend(_load_one(src))
    merged = docs[0]
    for doc in docs[1:]:
        merged = patch_dict(merged, doc)
    return merged


def spec_kind(data: dict) -> str:
    kind = data.get("kind")
    if kind in ("component", "operation"):
        return kind
    # Kindless files with a `run` section are components; with `component`
    # or a hub/path ref they are operations (reference behavior [K]).
    if "run" in data:
        return "component"
    if any(key in data for key in ("component", "hubRef", "pathRef", "urlRef")):
        return "operation"
    raise PolyaxonfileError(
        "Cannot determine spec kind: expected `kind: component|operation`, "
        "a `run` section, or a component reference"
    )


def get_component(data: dict) -> V1Component:
    data = dict(data)
    data.setdefault("kind", "component")
    return V1Component.from_dict(data)


def get_operation(data: dict) -> V1Operation:
    data = dict(data)
    data.setdefault("kind", "operation")
    return V1Operation.from_dict(data)


def check_polyaxonfile(
    polyaxonfile: Union[str, dict, Sequence[Union[str, dict]], None] = None,
    *,
    url: Optional[str] = None,
    hub: Optional[str] = None,
    params: Optional[dict[str, Any]] = None,
    presets: Optional[Sequence[Union[str, dict]]] = None,
    patch: Optional[dict] = None,
    patch_strategy: Optional[str] = None,
    validate_params: bool = True,
) -> V1Operation:
    """The front-door used by CLI/client (mirrors ``check_polyaxonfile``
    in the reference's call stack, SURVEY.md §3.1): produce a validated
    ``V1Operation`` from any accepted source + CLI overrides.
    """
    if hub is not None:
        op = V1Operation(hub_ref=hub)
    elif url is not None:
        op = V1Operation(url_ref=url)
    else:
        if polyaxonfile is None:
            raise PolyaxonfileError("No Polyaxonfile source provided")
        data = load_specs(polyaxonfile)
        kind = spec_kind(data)
        if kind == "component":
            component = get_component(data)
            op = V1Operation(component=component)
        else:
            op = get_operation(data)

    if params:
        merged: dict[str, V1Param] = dict(op.params or {})
        for name, value in params.items():
            if isinstance(value, V1Param):
                merged[name] = value
            elif isinstance(value, dict) and ("value" in value or "ref" in value):
                merged[name] = V1Param.from_dict(value)
            else:
                merged[name] = V1Param(value=value)
        op.params = merged

    if presets:
        op = apply_presets(op, presets)

    if patch:
        op_dict = patch_dict(op.to_dict(), patch, patch_strategy)
        op = get_operation(op_dict)

    if validate_params and op.component is not None:
        validate_params_against_io(
            op.params,
            op.component.inputs,
            op.component.outputs,
            provided_externally=matrix_param_names(op),
        )
    return op


def matrix_param_names(op: V1Operation) -> set[str]:
    """Param names a matrix binds per-trial (plus joins), which therefore
    need no operation-level value."""
    names: set[str] = set()
    matrix = op.matrix
    if matrix is not None:
        if hasattr(matrix, "params") and getattr(matrix, "params", None):
            names.update(matrix.params.keys())
        if hasattr(matrix, "values") and getattr(matrix, "values", None):
            for mapping in matrix.values:
                names.update(mapping.keys())
        # Hyperband/iterative also inject the resource param per rung.
        resource = getattr(matrix, "resource", None)
        if resource is not None:
            names.add(resource.name)
    for join in op.joins or []:
        names.update((join.params or {}).keys())
    return names


def apply_presets(
    op: V1Operation, presets: Sequence[Union[str, dict]]
) -> V1Operation:
    """Apply named/inline preset fragments onto an operation, in order.

    A preset is an operation-shaped partial spec (often just
    ``runPatch``/``environment``/``queue``); its ``patchStrategy``
    (default post_merge) governs the merge — the [B] gpu→tpu preset swap
    flows through here.
    """
    op_dict = op.to_dict()
    for preset in presets:
        preset_data = load_specs(preset) if not isinstance(preset, dict) else copy.deepcopy(preset)
        preset_data.pop("isPreset", None)
        preset_data.pop("is_preset", None)
        preset_data.pop("kind", None)
        strategy = preset_data.pop("patchStrategy", preset_data.pop("patch_strategy", None))
        op_dict = patch_dict(op_dict, preset_data, strategy)
    return get_operation(op_dict)


def resolve_operation_context(
    op: V1Operation,
    *,
    params: Optional[dict[str, Any]] = None,
    run_uuid: str = "",
    run_name: str = "",
    project_name: str = "",
    owner_name: str = "default",
    iteration: Optional[int] = None,
    artifacts_root: str = "",
    extra_context: Optional[dict[str, Any]] = None,
) -> V1Operation:
    """Render ``{{ params.* }}`` / ``{{ globals.* }}`` through the whole
    operation once params are bound (the compile step of SURVEY.md §3.1).
    Returns a new, fully-literal ``V1Operation``.
    """
    if op.component is None:
        raise PolyaxonfileError("Cannot resolve an operation without an inline component")
    bound = dict(op.params or {})
    for name, value in (params or {}).items():
        bound[name] = value if isinstance(value, V1Param) else V1Param(value=value)
    unbound = matrix_param_names(op) - set(bound)
    if unbound:
        raise PolyaxonfileError(
            f"Matrix-bound params {sorted(unbound)} must be bound per-trial before "
            "resolution (pass them via `params=`)"
        )
    param_values = validate_params_against_io(
        bound, op.component.inputs, op.component.outputs
    )
    # The rendered operation carries the fully-bound params so downstream
    # consumers (compiler toEnv/toInit routing) see trial bindings too.
    op = op.clone()
    op.params = bound or None
    context = {
        "params": param_values,
        "globals": default_globals(
            run_uuid=run_uuid,
            run_name=run_name or (op.name or ""),
            project_name=project_name,
            owner_name=owner_name,
            iteration=iteration,
            base_path=artifacts_root,
        ),
    }
    if extra_context:
        context.update(extra_context)
    rendered = render_value(op.to_dict(), context)
    # Apply the operation's runPatch onto the component run — this is
    # where preset fragments (e.g. the gpu→tpu environment swap, which
    # apply_presets records as run_patch) take effect.
    patch = rendered.pop("runPatch", None)
    if patch:
        if not rendered.get("component"):
            raise PolyaxonfileError(
                "runPatch/presets need a resolved inline component "
                "(pathRef/urlRef operations must be inlined first)")
        strategy = rendered.get("patchStrategy")
        run = rendered["component"].get("run") or {}
        rendered["component"]["run"] = patch_dict(run, patch, strategy)
    return get_operation(rendered)
