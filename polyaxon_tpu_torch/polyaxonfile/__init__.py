"""Port of ``polyaxon_tpu/polyaxonfile/__init__.py``, the same code
under the port's module names.
"""

from polyaxon_tpu_torch.polyaxonfile.context import ContextError, default_globals, render_value
from polyaxon_tpu_torch.polyaxonfile.patch import patch_dict
from polyaxon_tpu_torch.polyaxonfile.reader import (
    PolyaxonfileError,
    apply_presets,
    check_polyaxonfile,
    get_component,
    get_operation,
    load_specs,
    resolve_operation_context,
    spec_kind,
)

__all__ = [
    "ContextError",
    "PolyaxonfileError",
    "apply_presets",
    "check_polyaxonfile",
    "default_globals",
    "get_component",
    "get_operation",
    "load_specs",
    "patch_dict",
    "render_value",
    "resolve_operation_context",
    "spec_kind",
]
