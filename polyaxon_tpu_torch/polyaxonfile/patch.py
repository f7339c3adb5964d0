"""Deep-patch semantics for presets and runPatch.

Parity target: the reference's preset/patch engine (SURVEY.md §5.6 [K]) —
the [B] acceptance bar is "existing Polyaxonfiles run unchanged after
swapping the environment preset from gpu to tpu", which is entirely this
module's semantics. Strategies:

- ``post_merge`` (default): the patch wins on conflicts; dicts merge
  recursively; lists are replaced by the patch's list.
- ``pre_merge``: the base wins on conflicts; dicts merge recursively.
- ``replace``: patched keys replace base keys wholesale (no recursion).
- ``isnull``: patch applies only where the base value is missing/None.

Port of ``polyaxon_tpu/polyaxonfile/patch.py``, the same code under the
port's module names.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

from polyaxon_tpu_torch.polyflow.operation import V1PatchStrategy


def _merge(base: Any, patch: Any, *, patch_wins: bool) -> Any:
    if isinstance(base, dict) and isinstance(patch, dict):
        out = dict(base)
        for key, pval in patch.items():
            if key in out:
                out[key] = _merge(out[key], pval, patch_wins=patch_wins)
            else:
                out[key] = copy.deepcopy(pval)
        return out
    # Scalars/lists/mismatched types: pick a side.
    if patch_wins:
        return copy.deepcopy(patch) if patch is not None else base
    return base if base is not None else copy.deepcopy(patch)


def _isnull_merge(base: Any, patch: Any) -> Any:
    if base is None:
        return copy.deepcopy(patch)
    if isinstance(base, dict) and isinstance(patch, dict):
        out = dict(base)
        for key, pval in patch.items():
            out[key] = _isnull_merge(out.get(key), pval)
        return out
    return base


def patch_dict(
    base: Optional[dict],
    patch: Optional[dict],
    strategy: Optional[str] = None,
) -> dict:
    base = copy.deepcopy(base or {})
    patch = patch or {}
    strategy = strategy or V1PatchStrategy.POST_MERGE
    if strategy == V1PatchStrategy.POST_MERGE:
        return _merge(base, patch, patch_wins=True)
    if strategy == V1PatchStrategy.PRE_MERGE:
        return _merge(base, patch, patch_wins=False)
    if strategy == V1PatchStrategy.REPLACE:
        out = dict(base)
        out.update(copy.deepcopy(patch))
        return out
    if strategy == V1PatchStrategy.ISNULL:
        return _isnull_merge(base, patch)
    raise ValueError(f"Unknown patch strategy `{strategy}`")
