"""Execution-environment specs: container, environment, init, termination,
cache, plugins, hooks, notifications.

Capability parity with the reference's ``polyflow/environment`` +
``polyflow/init`` + ``polyflow/termination`` + ``polyflow/cache`` +
``polyflow/plugins`` + ``polyflow/hooks`` (SURVEY.md §2 [K]), recast for
TPU slices: resource requests use ``google.com/tpu`` and carry slice
topology; node selectors become slice selectors; preemptible slices are a
first-class environment flag (BASELINE north star [B]).

Port of ``polyaxon_tpu/polyflow/environment.py``, the same code under
the port's module names.
"""

from __future__ import annotations

from typing import Any, Optional, Union

from pydantic import ConfigDict, field_validator

from polyaxon_tpu_torch.schemas.base import BaseSchema

TPU_RESOURCE = "google.com/tpu"
GPU_RESOURCE = "nvidia.com/gpu"


class V1EnvVar(BaseSchema):
    name: str
    value: Optional[Any] = None
    value_from: Optional[dict[str, Any]] = None


class V1ResourceSpec(BaseSchema):
    model_config = ConfigDict(extra="allow", populate_by_name=True)
    limits: Optional[dict[str, Union[int, float, str]]] = None
    requests: Optional[dict[str, Union[int, float, str]]] = None

    def tpu_chips(self) -> int:
        for source in (self.limits, self.requests):
            if source and TPU_RESOURCE in source:
                return int(source[TPU_RESOURCE])
        return 0


class V1Container(BaseSchema):
    """The user process spec. A pared-down, k8s-compatible container schema
    (the reference embeds the full k8s ``V1Container`` [K]); unknown k8s
    fields are preserved via ``extra="allow"`` so Polyaxonfiles written for
    the reference parse unchanged.
    """

    model_config = ConfigDict(extra="allow", populate_by_name=True)

    name: Optional[str] = None
    image: Optional[str] = None
    command: Optional[Union[str, list[str]]] = None
    # Args commonly carry interpolated param values ("{{ params.lr }}" →
    # 0.1), so non-string items are allowed and coerced in args_list().
    args: Optional[Union[str, list[Any]]] = None
    env: Optional[list[V1EnvVar]] = None
    resources: Optional[V1ResourceSpec] = None
    working_dir: Optional[str] = None
    volume_mounts: Optional[list[dict[str, Any]]] = None

    def command_list(self) -> list[str]:
        if self.command is None:
            return []
        return [self.command] if isinstance(self.command, str) else list(self.command)

    def args_list(self) -> list[str]:
        if self.args is None:
            return []
        if isinstance(self.args, str):
            return [self.args]
        return [a if isinstance(a, str) else str(a) for a in self.args]


class V1TpuTopology(BaseSchema):
    """TPU-native replacement for GPU count requests: which slice shape a
    run wants. ``accelerator`` + ``topology`` determine chip count and the
    ICI torus; ``slices`` > 1 means multi-slice over DCN.
    """

    accelerator: str = "v5e"  # v4 | v5e | v5p | v6e ...
    topology: Optional[str] = None  # e.g. "2x4", "4x8", "8x16"; None → single host
    slices: int = 1
    chips_per_host: Optional[int] = None
    preemptible: Optional[bool] = None
    reserved: Optional[bool] = None

    @field_validator("topology")
    @classmethod
    def _check_topology(cls, v: Optional[str]) -> Optional[str]:
        if v is None:
            return v
        dims = v.lower().split("x")
        if not (1 <= len(dims) <= 3) or not all(d.isdigit() and int(d) > 0 for d in dims):
            raise ValueError(f"Bad TPU topology `{v}` (expected e.g. '2x4' or '4x4x8')")
        return v.lower()

    def dims(self) -> tuple[int, ...]:
        if not self.topology:
            # No explicit torus: a single host's worth of chips.
            return (self.chips_per_host or _default_chips_per_host(self.accelerator),)
        return tuple(int(d) for d in self.topology.split("x"))

    def chips_per_slice(self) -> int:
        n = 1
        for d in self.dims():
            n *= d
        return n

    def total_chips(self) -> int:
        return self.chips_per_slice() * self.slices

    def hosts_per_slice(self) -> int:
        cph = self.chips_per_host or _default_chips_per_host(self.accelerator)
        return max(1, self.chips_per_slice() // cph)

    def total_hosts(self) -> int:
        return self.hosts_per_slice() * self.slices


def _default_chips_per_host(accelerator: str) -> int:
    return {"v2": 4, "v3": 4, "v4": 4, "v5e": 4, "v5p": 4, "v6e": 4}.get(accelerator, 4)


class V1Environment(BaseSchema):
    """Scheduling/runtime environment applied to every replica.

    The reference carries k8s pod-level knobs (nodeSelector, tolerations,
    affinity, labels, annotations, serviceAccountName, imagePullSecrets —
    [K]); those are preserved for compatibility, and ``tpu`` adds the
    slice topology request that replaces ``nvidia.com/gpu`` counts [B].
    """

    model_config = ConfigDict(extra="allow", populate_by_name=True)

    labels: Optional[dict[str, str]] = None
    annotations: Optional[dict[str, str]] = None
    node_selector: Optional[dict[str, str]] = None
    tolerations: Optional[list[dict[str, Any]]] = None
    affinity: Optional[dict[str, Any]] = None
    node_name: Optional[str] = None
    service_account_name: Optional[str] = None
    image_pull_secrets: Optional[list[str]] = None
    security_context: Optional[dict[str, Any]] = None
    priority_class_name: Optional[str] = None
    restart_policy: Optional[str] = None
    host_network: Optional[bool] = None
    dns_policy: Optional[str] = None
    scheduler_name: Optional[str] = None
    tpu: Optional[V1TpuTopology] = None


class V1Init(BaseSchema):
    """One init phase: clone a repo, fetch artifacts, render a dockerfile,
    download a file, or run an arbitrary init container — plus the
    TPU-native ``tpu_metadata`` initializer that discovers slice metadata
    (coordinator address, process index, topology) before the main process
    starts (north star: "init containers discover TPU-VM slice metadata").
    """

    model_config = ConfigDict(extra="allow", populate_by_name=True)

    git: Optional[dict[str, Any]] = None
    artifacts: Optional[dict[str, Any]] = None
    dockerfile: Optional[dict[str, Any]] = None
    file: Optional[dict[str, Any]] = None
    tensorboard: Optional[dict[str, Any]] = None
    lineage_ref: Optional[str] = None
    model_ref: Optional[str] = None
    connection: Optional[str] = None
    path: Optional[str] = None
    container: Optional[V1Container] = None
    tpu_metadata: Optional[bool] = None


class V1Termination(BaseSchema):
    max_retries: Optional[int] = None
    ttl: Optional[int] = None
    timeout: Optional[int] = None
    # TPU-native: preemption of a preemptible slice does not consume a
    # retry unless this is set.
    preemption_counts_as_retry: Optional[bool] = None


class V1Cache(BaseSchema):
    disable: Optional[bool] = None
    ttl: Optional[int] = None
    io: Optional[list[str]] = None
    sections: Optional[list[str]] = None


class V1Plugins(BaseSchema):
    auth: Optional[bool] = None
    docker: Optional[bool] = None
    shm: Optional[bool] = None
    mount_artifacts_store: Optional[bool] = None
    collect_artifacts: Optional[bool] = None
    collect_logs: Optional[bool] = None
    collect_resources: Optional[bool] = None
    sync_statuses: Optional[bool] = None
    auto_resume: Optional[bool] = None
    log_level: Optional[str] = None
    # TPU-native: stream libtpu metrics (duty cycle, HBM, ICI counters)
    # into tracking alongside psutil host metrics [B].
    collect_tpu_metrics: Optional[bool] = None
    # Capture a jax.profiler trace as a run artifact (SURVEY §5.1).
    capture_profile: Optional[Union[bool, dict[str, Any]]] = None


class V1Hook(BaseSchema):
    trigger: Optional[str] = None  # succeeded | failed | stopped | done
    connection: Optional[str] = None
    hub_ref: Optional[str] = None
    conditions: Optional[str] = None
    presets: Optional[list[str]] = None
    params: Optional[dict[str, Any]] = None
    queue: Optional[str] = None


class V1Notification(BaseSchema):
    connections: list[str]
    trigger: Optional[str] = None
