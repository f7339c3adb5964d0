"""V1Join resolution: collect values from matching runs into params.

Upstream joins (SURVEY.md §2 "Polyflow IR": joins) let an operation
gather its inputs from a QUERY over other runs — e.g. every trial of a
sweep contributes its best checkpoint path to a selection job. The
query grammar here is the upstream search subset that matters for the
embedded plane:

    "pipeline: <uuid>, status: succeeded, tags: best"

comma-separated ``field: value`` filters over pipeline, parent, project,
status, kind, name, uuid, and tags (tags matches ANY listed tag).
``sort`` orders by created_at (``-created_at`` for newest first);
``limit`` caps the result.

Each join param's value is a *context reference* evaluated per matched
run and collected into a list:

    uuid | name | status | artifacts_dir | outputs | outputs.<key> |
    inputs.<name>

Port of ``polyaxon_tpu/controlplane/joins.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import logging
from typing import Any, Optional

from polyaxon_tpu_torch.controlplane.store import RunRecord, Store
from polyaxon_tpu_torch.lifecycle import V1Statuses

logger = logging.getLogger(__name__)


class JoinError(ValueError):
    pass


_FIELDS = {"pipeline", "parent", "project", "status", "kind", "name", "uuid",
           "tags"}


def parse_query(query: str) -> dict[str, str]:
    filters: dict[str, str] = {}
    for clause in query.split(","):
        clause = clause.strip()
        if not clause:
            continue
        field, sep, value = clause.partition(":")
        field, value = field.strip(), value.strip()
        if not sep or not value:
            raise JoinError(f"join query clause {clause!r} is not `field: value`")
        if field not in _FIELDS:
            raise JoinError(
                f"unknown join query field `{field}` (known: {sorted(_FIELDS)})")
        filters[field] = value
    if not filters:
        raise JoinError(f"empty join query {query!r}")
    return filters


def find_runs(store: Store, query: str, *, project: str,
              sort: Optional[str] = None,
              limit: Optional[int] = None) -> list[RunRecord]:
    filters = parse_query(query)
    kwargs: dict[str, Any] = {}
    if "pipeline" in filters:
        kwargs["pipeline_uuid"] = filters["pipeline"]
    if "parent" in filters:
        kwargs["parent_uuid"] = filters["parent"]
    if "kind" in filters:
        kwargs["kind"] = filters["kind"]
    if "status" in filters:
        kwargs["statuses"] = [V1Statuses(filters["status"])]
    kwargs["project"] = filters.get("project", project)
    records = store.list_runs(**kwargs)
    if "uuid" in filters:
        records = [r for r in records if r.uuid == filters["uuid"]]
    if "name" in filters:
        records = [r for r in records if r.name == filters["name"]]
    if "tags" in filters:
        wanted = {t.strip() for t in filters["tags"].split("|")}
        records = [r for r in records if wanted & set(r.tags or [])]
    reverse = False
    if sort:
        reverse = sort.startswith("-")
        key = sort.lstrip("-")
        if key != "created_at":
            raise JoinError(f"unsupported join sort `{sort}`")
    records.sort(key=lambda r: r.created_at, reverse=reverse)
    if limit:
        records = records[:limit]
    return records


def _context_value(record: RunRecord, streams, ref: str) -> Any:
    if ref == "uuid":
        return record.uuid
    if ref == "name":
        return record.name
    if ref == "status":
        return record.status.value
    if ref == "artifacts_dir":
        return streams.run_dir(record.uuid)
    if ref == "outputs":
        return streams.get_outputs(record.uuid)
    if ref.startswith("outputs."):
        return streams.get_outputs(record.uuid).get(ref[len("outputs."):])
    if ref.startswith("inputs."):
        name = ref[len("inputs."):]
        param = (record.params or {}).get(name) or {}
        return param.get("value") if isinstance(param, dict) else param
    raise JoinError(f"unknown join context ref `{ref}`")


def resolve_joins(store: Store, streams, joins: list[dict], *,
                  project: str,
                  matched: Optional[list] = None) -> dict[str, list]:
    """Evaluate every join; returns {param_name: [value per matched run]}.
    ``matched`` (optional out-param): collects the matched runs' uuids —
    the compile step stamps them as the run's upstream lineage edges."""
    out: dict[str, list] = {}
    for join in joins:
        records = find_runs(
            store, join["query"], project=project,
            sort=join.get("sort"), limit=join.get("limit"))
        if matched is not None:
            matched.extend(r.uuid for r in records)
        for name, param in (join.get("params") or {}).items():
            ref = param.get("value") if isinstance(param, dict) else param
            if not isinstance(ref, str):
                raise JoinError(
                    f"join param `{name}` must reference a context value")
            out[name] = [_context_value(r, streams, ref) for r in records]
    return out
