"""Deployment config schema (port of ``polyaxon_tpu/deploy/schemas.py``):
the values file of ``plx-torch admin deploy -f``, field for field the
JAX package's, so one file deploys either.

Deployment types:
- ``local``    single host: embedded control plane + agent (+ gateway)
- ``compose``  multi-process on one host (api, agent, gateway rendered
               as a process list)
- ``gke-tpu``  the reference's production target, kept so its files
               validate; rendering emits the same inputs

A slice's ``topology`` on a GPU host is its cards, ``"N"``
(``agent/slices.py``).
"""

from __future__ import annotations

from typing import Any, ClassVar, Optional

from polyaxon_tpu_torch.schemas.base import BaseSchema


class V1ServiceConfig(BaseSchema):
    enabled: Optional[bool] = True
    host: Optional[str] = "127.0.0.1"
    port: Optional[int] = None
    replicas: Optional[int] = 1
    resources: Optional[dict[str, Any]] = None


class V1SliceConfig(BaseSchema):
    name: str
    accelerator: Optional[str] = "v5e"
    topology: str
    preemptible: Optional[bool] = False


class V1AgentDeployConfig(BaseSchema):
    enabled: Optional[bool] = True
    max_concurrent: Optional[int] = 4
    slices: Optional[list[V1SliceConfig]] = None
    heartbeat_timeout: Optional[float] = 60.0


class V1GatewayConfig(BaseSchema):
    enabled: Optional[bool] = True
    port: Optional[int] = 8080
    server_name: Optional[str] = "_"
    ssl: Optional[dict[str, Any]] = None


class V1DeploymentConfig(BaseSchema):
    deployment_type: str = "local"
    deployment_version: Optional[str] = None
    namespace: Optional[str] = "polyaxon-tpu"
    home: Optional[str] = None
    api: Optional[V1ServiceConfig] = None
    gateway: Optional[V1GatewayConfig] = None
    agent: Optional[V1AgentDeployConfig] = None
    artifacts_store: Optional[str] = None  # connection name
    connections: Optional[list[dict[str, Any]]] = None
    environment: Optional[dict[str, str]] = None

    TYPES: ClassVar[tuple[str, ...]] = ("local", "compose", "gke-tpu")


def check_deployment(data: dict[str, Any]) -> V1DeploymentConfig:
    config = V1DeploymentConfig.from_dict(data)
    if config.deployment_type not in V1DeploymentConfig.TYPES:
        raise ValueError(
            f"deploymentType `{config.deployment_type}` not in "
            f"{V1DeploymentConfig.TYPES}")
    names = set()
    for conn in config.connections or []:
        from polyaxon_tpu_torch.connections import V1Connection

        parsed = V1Connection.from_dict(conn)
        parsed.validate_kind()
        if parsed.name in names:
            raise ValueError(f"duplicate connection `{parsed.name}` in deploy")
        names.add(parsed.name)
    if config.artifacts_store and config.artifacts_store not in names:
        raise ValueError(
            f"artifactsStore `{config.artifacts_store}` is not among the "
            f"declared connections {sorted(names) or '<none>'}")
    ssl = (config.gateway.ssl or {}) if config.gateway else {}
    if bool(ssl.get("cert")) != bool(ssl.get("key")):
        raise ValueError(
            "gateway.ssl needs BOTH cert and key (one alone would render "
            "a broken or silently-plaintext listener)")
    return config
