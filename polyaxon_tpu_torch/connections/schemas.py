"""Typed connection catalog schemas.

Upstream's connections package (SURVEY.md §2 "Connections" [K]:
``V1Connection``/``V1ConnectionKind`` — artifact stores, git sources,
registries — with env/volume materialization). Kinds keep the upstream
vocabulary so existing Polyaxonfiles referencing connections by name
resolve unchanged; TPU-relevant stores (GCS for checkpoints/artifacts
over the TPU-VM service account) are first-class.

Port of ``polyaxon_tpu/connections/schemas.py``, the same code under the
port's module names.
"""

from __future__ import annotations

from typing import Any, Optional

from polyaxon_tpu_torch.schemas.base import BaseSchema


class V1ConnectionKind:
    HOST_PATH = "host_path"
    VOLUME_CLAIM = "volume_claim"
    GCS = "gcs"
    S3 = "s3"
    WASB = "wasb"  # azure blob
    GIT = "git"
    REGISTRY = "registry"
    SLACK = "slack"
    DISCORD = "discord"
    WEBHOOK = "webhook"
    PAGERDUTY = "pagerduty"
    CUSTOM = "custom"

    VALUES = frozenset({
        HOST_PATH, VOLUME_CLAIM, GCS, S3, WASB, GIT, REGISTRY,
        SLACK, DISCORD, WEBHOOK, PAGERDUTY, CUSTOM,
    })
    ARTIFACT_STORES = frozenset({HOST_PATH, VOLUME_CLAIM, GCS, S3, WASB})
    NOTIFIERS = frozenset({SLACK, DISCORD, WEBHOOK, PAGERDUTY})


class V1ConnectionResource(BaseSchema):
    """A secret/config-map style reference materialized as env or files."""

    name: str
    mount_path: Optional[str] = None
    items: Optional[list[str]] = None
    is_requested: Optional[bool] = None


class V1Connection(BaseSchema):
    name: str
    kind: str
    description: Optional[str] = None
    # Kind-specific schema: {url}, {bucket}, {host_path, mount_path}, ...
    schema_: Optional[dict[str, Any]] = None
    secret: Optional[V1ConnectionResource] = None
    config_map: Optional[V1ConnectionResource] = None
    env: Optional[dict[str, str]] = None
    tags: Optional[list[str]] = None

    def validate_kind(self) -> None:
        if self.kind not in V1ConnectionKind.VALUES:
            raise ValueError(
                f"connection `{self.name}` has unknown kind `{self.kind}` "
                f"(expected one of {sorted(V1ConnectionKind.VALUES)})")

    @property
    def is_artifact_store(self) -> bool:
        return self.kind in V1ConnectionKind.ARTIFACT_STORES

    @property
    def is_notifier(self) -> bool:
        return self.kind in V1ConnectionKind.NOTIFIERS

    def store_url(self) -> Optional[str]:
        """Canonical store URL for fs.store dispatch (file:///gs:///s3://)."""
        schema = self.schema_ or {}
        # The schema dict is free-form: YAML authors write camelCase,
        # Python callers snake_case — accept both.
        get = lambda *keys: next(
            (schema[k] for k in keys if schema.get(k)), None)
        if self.kind == V1ConnectionKind.HOST_PATH:
            path = get("host_path", "hostPath", "mount_path", "mountPath")
            return f"file://{path}" if path else None
        if self.kind == V1ConnectionKind.VOLUME_CLAIM:
            path = get("mount_path", "mountPath")
            return f"file://{path}" if path else None
        if self.kind == V1ConnectionKind.GCS:
            bucket = (schema.get("bucket") or "").removeprefix("gs://")
            return f"gs://{bucket}" if bucket else None
        if self.kind == V1ConnectionKind.S3:
            bucket = (schema.get("bucket") or "").removeprefix("s3://")
            return f"s3://{bucket}" if bucket else None
        if self.kind == V1ConnectionKind.WASB:
            return schema.get("url") or schema.get("bucket")
        return schema.get("url")

    def env_contract(self) -> dict[str, str]:
        """Env vars injected into pods that request this connection."""
        prefix = f"POLYAXON_CONNECTION_{self.name.upper().replace('-', '_')}"
        env = {f"{prefix}_KIND": self.kind}
        url = self.store_url()
        if url:
            env[f"{prefix}_URL"] = url
        for key, value in (self.env or {}).items():
            env[key] = value
        return env
