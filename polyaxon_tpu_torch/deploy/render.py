"""Deployment rendering (port of ``polyaxon_tpu/deploy/render.py``):
config → concrete on-disk artifacts.

`plx-torch admin deploy -f deploy.yaml` materializes, under ``<home>/deploy``:
- ``connections.yaml``  → consumed by the control plane catalog
- ``gateway/nginx.conf`` → the proxies layer (when gateway.enabled)
- ``run.sh``            → the process plan (the port's api server + agent
                           flags)
so a host goes from a values file to a serving stack with one command.
The files are the JAX package's, with ``polyaxon_tpu_torch`` and
``plx-torch`` in place of ``polyaxon_tpu`` and ``plx``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import yaml

from polyaxon_tpu_torch.deploy.schemas import V1DeploymentConfig
from polyaxon_tpu_torch.proxies import render_nginx_conf


def render_deployment(config: V1DeploymentConfig, home: str) -> dict[str, str]:
    """Write deployment artifacts; returns {artifact name: path}."""
    deploy_dir = os.path.join(home, "deploy")
    os.makedirs(deploy_dir, exist_ok=True)
    written: dict[str, str] = {}

    if config.connections:
        path = os.path.join(home, "connections.yaml")
        with open(path, "w") as fh:
            yaml.safe_dump({"connections": config.connections}, fh)
        written["connections"] = path

    api_host = (config.api.host if config.api else "127.0.0.1") or "127.0.0.1"
    api_port = (config.api.port if config.api else None) or 8000

    gateway = config.gateway
    if gateway and gateway.enabled:
        gw_dir = os.path.join(deploy_dir, "gateway")
        os.makedirs(gw_dir, exist_ok=True)
        ssl = gateway.ssl or {}
        conf = render_nginx_conf(
            api_host=api_host, api_port=api_port,
            listen_port=gateway.port or 8080,
            server_name=gateway.server_name or "_",
            ssl_cert=ssl.get("cert", ""), ssl_key=ssl.get("key", ""),
        )
        path = os.path.join(gw_dir, "nginx.conf")
        with open(path, "w") as fh:
            fh.write(conf)
        written["gateway"] = path

    # Process plan: how to start the stack with these values.
    agent = config.agent
    slice_flags = ""
    if agent and agent.slices:
        slice_flags = " ".join(
            f"--slice {s.name}:{s.topology}" + (":spot" if s.preemptible else "")
            for s in agent.slices
        )
    import shlex

    lines = ["#!/bin/sh", "# generated by polyaxon_tpu_torch (plx-torch admin deploy)",
             f"export POLYAXON_TPU_HOME={shlex.quote(home)}"]
    for key, value in (config.environment or {}).items():
        lines.append(f"export {key}={shlex.quote(str(value))}")
    server_cmd = (f"python -m polyaxon_tpu_torch.cli server --host {api_host} "
                  f"--port {api_port}")
    if agent is None or agent.enabled:
        server_cmd += " --with-agent"
        if agent and agent.max_concurrent:
            server_cmd += f" --max-concurrent {agent.max_concurrent}"
        if agent and agent.heartbeat_timeout:
            server_cmd += f" --heartbeat-timeout {agent.heartbeat_timeout}"
        if slice_flags:
            server_cmd += f" {slice_flags}"
    lines.append(server_cmd)
    path = os.path.join(deploy_dir, "run.sh")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    os.chmod(path, 0o755)
    written["run"] = path

    summary = {
        "deploymentType": config.deployment_type,
        "namespace": config.namespace,
        "artifacts": written,
    }
    path = os.path.join(deploy_dir, "deploy.json")
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=2)
    written["summary"] = path
    return written
