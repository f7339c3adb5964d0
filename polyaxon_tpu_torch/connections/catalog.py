"""Connection catalog: named external systems resolvable at compile time.

Loaded from (first match wins):
1. an explicit path / list of dicts passed by the caller,
2. ``POLYAXON_TPU_CONNECTIONS`` (path to a json/yaml catalog),
3. ``<home>/connections.yaml`` next to the control-plane DB.

The compiler resolves ``init.connection`` / notification connection
names through the catalog; a dangling name is a compile error (matching
upstream behavior where the agent refuses unknown connections) instead
of a silent no-op at runtime.

Port of ``polyaxon_tpu/connections/catalog.py``, the same code under the
port's module names.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence, Union

from polyaxon_tpu_torch.connections.schemas import V1Connection

ENV_CONNECTIONS = "POLYAXON_TPU_CONNECTIONS"


class ConnectionResolutionError(ValueError):
    """Catalog lookup/validation failure. Named explicitly so importers
    never shadow the ``ConnectionError`` OSError builtin."""


def _load_entries(source: Union[str, Sequence[dict]]) -> list[dict]:
    if not isinstance(source, str):
        return list(source)
    with open(source) as fh:
        text = fh.read()
    if source.endswith((".yaml", ".yml")):
        import yaml

        data = yaml.safe_load(text)
    else:
        data = json.loads(text)
    if isinstance(data, dict):
        data = data.get("connections", [])
    if not isinstance(data, list):
        raise ConnectionResolutionError(
            f"connection catalog {source!r} must be a list or "
            "{'connections': [...]}")
    return data


class ConnectionCatalog:
    def __init__(self, source: Union[str, Sequence[dict], None] = None, *,
                 home: Optional[str] = None):
        entries: list[dict] = []
        if source is not None:
            entries = _load_entries(source)
        else:
            env_path = os.environ.get(ENV_CONNECTIONS)
            if env_path:
                if not os.path.exists(env_path):
                    raise ConnectionResolutionError(
                        f"{ENV_CONNECTIONS}={env_path!r} does not exist")
                entries = _load_entries(env_path)
            elif home:
                for name in ("connections.yaml", "connections.json"):
                    path = os.path.join(home, name)
                    if os.path.exists(path):
                        entries = _load_entries(path)
                        break
        self._by_name: dict[str, V1Connection] = {}
        for entry in entries:
            conn = entry if isinstance(entry, V1Connection) else (
                V1Connection.from_dict(entry))
            conn.validate_kind()
            if conn.name in self._by_name:
                raise ConnectionResolutionError(f"duplicate connection `{conn.name}`")
            self._by_name[conn.name] = conn

    # ----------------------------------------------------------------- api
    def names(self) -> list[str]:
        return sorted(self._by_name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self._by_name)

    def get(self, name: str) -> V1Connection:
        try:
            return self._by_name[name]
        except KeyError:
            known = ", ".join(self.names()) or "<none registered>"
            raise ConnectionResolutionError(
                f"unknown connection `{name}` (known: {known})") from None

    def resolve_all(self, names: Sequence[str]) -> list[V1Connection]:
        return [self.get(n) for n in names]

    def env_for(self, names: Sequence[str]) -> dict[str, str]:
        env: dict[str, str] = {}
        for conn in self.resolve_all(names):
            env.update(conn.env_contract())
        return env

    def artifact_store(self, name: Optional[str] = None) -> Optional[V1Connection]:
        """The named store, or the single registered artifact store."""
        if name:
            conn = self.get(name)
            if not conn.is_artifact_store:
                raise ConnectionResolutionError(
                    f"connection `{name}` (kind={conn.kind}) is not an "
                    "artifact store")
            return conn
        stores = [c for c in self._by_name.values() if c.is_artifact_store]
        return stores[0] if len(stores) == 1 else None

    def to_dict(self) -> dict[str, Any]:
        return {"connections": [c.to_dict() for c in self._by_name.values()]}
