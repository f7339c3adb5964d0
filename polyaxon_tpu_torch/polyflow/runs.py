"""Run kinds: what a component actually executes.

Capability parity with the reference's ``polyflow/run`` universe
(SURVEY.md §2 [K]): V1Job, V1Service, V1Dag, V1Tuner, the Kubeflow
delegation kinds (V1TFJob/V1PyTorchJob/V1MPIJob/V1RayJob/V1DaskJob), and
notifier/cleaner auxiliaries — plus the net-new first-class **V1JAXJob**
(BASELINE north star [B]): an SPMD JAX runtime whose workers emit XLA
collectives over ICI, with an explicit device-mesh spec (dp/fsdp/tp/pp/
sp/cp/ep axes) instead of replica-role dictionaries.

Port of ``polyaxon_tpu/polyflow/runs.py``, the same code under the
port's module names.
"""

from __future__ import annotations

from typing import Any, Literal, Optional, Union

from pydantic import field_validator, model_validator

from polyaxon_tpu_torch.polyflow.environment import (
    V1Container,
    V1Environment,
    V1Init,
    V1TpuTopology,
)
from polyaxon_tpu_torch.schemas.base import BaseSchema


class V1RunKind:
    JOB = "job"
    SERVICE = "service"
    DAG = "dag"
    JAXJOB = "jaxjob"
    TFJOB = "tfjob"
    PYTORCHJOB = "pytorchjob"
    MPIJOB = "mpijob"
    RAYJOB = "rayjob"
    DASKJOB = "daskjob"
    TUNER = "tuner"
    NOTIFIER = "notifier"
    CLEANER = "cleaner"
    WATCHDOG = "watchdog"

    VALUES = {
        JOB, SERVICE, DAG, JAXJOB, TFJOB, PYTORCHJOB, MPIJOB, RAYJOB,
        DASKJOB, TUNER, NOTIFIER, CLEANER, WATCHDOG,
    }
    # Kinds the TPU-native runtime executes in-process; the Kubeflow kinds
    # are accepted for spec compatibility and compiled to a launch plan,
    # with execution delegated to their frameworks.
    NATIVE = {JOB, SERVICE, DAG, JAXJOB, TUNER, NOTIFIER, CLEANER, WATCHDOG}


class _BaseRun(BaseSchema):
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None
    volumes: Optional[list[dict[str, Any]]] = None
    init: Optional[list[V1Init]] = None
    sidecars: Optional[list[V1Container]] = None


class V1Job(_BaseRun):
    kind: Literal["job"] = "job"
    container: V1Container


class V1Service(_BaseRun):
    kind: Literal["service"] = "service"
    container: V1Container
    ports: Optional[list[int]] = None
    replicas: Optional[int] = None
    is_external: Optional[bool] = None
    rewrite_path: Optional[bool] = None


# --------------------------------------------------------------------------
# JAXJob — the first-class TPU runtime kind
# --------------------------------------------------------------------------

class V1MeshSpec(BaseSchema):
    """Logical device mesh requested by a JAXJob.

    ``axes`` maps axis name → size in mesh order (row-major over the slice
    topology). Sizes may use -1 for "fill with remaining chips" (at most
    one axis). ``dcn_axes`` lists axes laid over DCN (cross-slice) rather
    than ICI — the compiler validates that their product equals
    ``topology.slices`` so tensor-traffic axes stay on ICI (SURVEY §2c).
    """

    axes: dict[str, int]
    dcn_axes: Optional[list[str]] = None
    allow_split_physical_axes: Optional[bool] = None

    @field_validator("axes")
    @classmethod
    def _check_axes(cls, v: dict[str, int]):
        if not v:
            raise ValueError("mesh.axes cannot be empty")
        fills = [k for k, s in v.items() if s == -1]
        if len(fills) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {fills}")
        for k, s in v.items():
            if s == 0 or s < -1:
                raise ValueError(f"Bad size {s} for mesh axis `{k}`")
        return v

    def resolved_axes(self, total_chips: int) -> dict[str, int]:
        axes = dict(self.axes)
        known = 1
        fill_key = None
        for k, s in axes.items():
            if s == -1:
                fill_key = k
            else:
                known *= s
        if fill_key is not None:
            if total_chips % known:
                raise ValueError(
                    f"Mesh axes {axes} do not divide {total_chips} chips"
                )
            axes[fill_key] = total_chips // known
            known *= axes[fill_key]
        if known != total_chips:
            raise ValueError(
                f"Mesh axes {axes} require {known} chips but the topology has {total_chips}"
            )
        return axes


class V1JaxCheckpointing(BaseSchema):
    enabled: Optional[bool] = True
    interval_steps: Optional[int] = None
    max_to_keep: Optional[int] = 3
    async_save: Optional[bool] = True
    restore_on_start: Optional[bool] = True


class V1JAXJob(_BaseRun):
    """SPMD JAX training/eval job over a TPU slice (net-new, [B]).

    One container spec runs on every host of the slice (SPMD); the mesh
    spec shards the program over chips. Replaces the reference's
    TFJob/PyTorchJob replica-role dicts: there is no chief/ps/worker
    asymmetry in a JAX gang — ``jax.distributed`` assigns process ids
    at bootstrap (SURVEY §2c).
    """

    kind: Literal["jaxjob"] = "jaxjob"
    container: Optional[V1Container] = None
    topology: Optional[V1TpuTopology] = None
    mesh: Optional[V1MeshSpec] = None
    checkpointing: Optional[V1JaxCheckpointing] = None
    # Builtin runtime: run polyaxon_tpu_torch.runtime with this config instead of
    # a user container command (the quick-path for the model zoo).
    runtime: Optional[dict[str, Any]] = None
    num_processes: Optional[int] = None

    @model_validator(mode="after")
    def _check(self):
        if self.container is None and self.runtime is None:
            raise ValueError("jaxjob requires either `container` or `runtime`")
        if self.mesh is not None and self.topology is not None:
            dcn = set(self.mesh.dcn_axes or [])
            unknown = dcn - set(self.mesh.axes)
            if unknown:
                raise ValueError(f"dcnAxes {sorted(unknown)} not in mesh.axes")
            dcn_product = 1
            for name in dcn:
                size = self.mesh.axes[name]
                if size != -1:
                    dcn_product *= size
            if dcn and self.topology.slices % dcn_product:
                raise ValueError(
                    f"Product of dcnAxes sizes ({dcn_product}) must divide "
                    f"topology.slices ({self.topology.slices})"
                )
        return self

    def get_topology(self) -> V1TpuTopology:
        if self.topology is not None:
            return self.topology
        if self.environment is not None and self.environment.tpu is not None:
            return self.environment.tpu
        return V1TpuTopology(accelerator="v5e", topology=None, slices=1)


# --------------------------------------------------------------------------
# Kubeflow-compatible delegation kinds (spec compatibility [B])
# --------------------------------------------------------------------------

class V1KFReplica(BaseSchema):
    replicas: Optional[int] = 1
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None
    volumes: Optional[list[dict[str, Any]]] = None
    init: Optional[list[V1Init]] = None
    sidecars: Optional[list[V1Container]] = None
    container: Optional[V1Container] = None


class _KubeflowRun(_BaseRun):
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[dict[str, Any]] = None


class V1TFJob(_KubeflowRun):
    kind: Literal["tfjob"] = "tfjob"
    chief: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    ps: Optional[V1KFReplica] = None
    evaluator: Optional[V1KFReplica] = None

    def replica_map(self) -> dict[str, V1KFReplica]:
        out = {}
        for name in ("chief", "worker", "ps", "evaluator"):
            rep = getattr(self, name)
            if rep is not None:
                out[name] = rep
        return out


class V1PyTorchJob(_KubeflowRun):
    kind: Literal["pytorchjob"] = "pytorchjob"
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    elastic_policy: Optional[dict[str, Any]] = None

    def replica_map(self) -> dict[str, V1KFReplica]:
        out = {}
        for name in ("master", "worker"):
            rep = getattr(self, name)
            if rep is not None:
                out[name] = rep
        return out


class V1MPIJob(_KubeflowRun):
    kind: Literal["mpijob"] = "mpijob"
    launcher: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    slots_per_worker: Optional[int] = None

    def replica_map(self) -> dict[str, V1KFReplica]:
        out = {}
        for name in ("launcher", "worker"):
            rep = getattr(self, name)
            if rep is not None:
                out[name] = rep
        return out


class V1RayJob(_KubeflowRun):
    kind: Literal["rayjob"] = "rayjob"
    entrypoint: Optional[str] = None
    runtime_env: Optional[dict[str, Any]] = None
    ray_version: Optional[str] = None
    head: Optional[V1KFReplica] = None
    workers: Optional[dict[str, V1KFReplica]] = None

    def replica_map(self) -> dict[str, V1KFReplica]:
        out = {}
        if self.head is not None:
            out["head"] = self.head
        for name, rep in (self.workers or {}).items():
            out[f"worker-{name}"] = rep
        return out


class V1DaskJob(_KubeflowRun):
    kind: Literal["daskjob"] = "daskjob"
    job: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    scheduler: Optional[V1KFReplica] = None

    def replica_map(self) -> dict[str, V1KFReplica]:
        out = {}
        for name in ("job", "scheduler", "worker"):
            rep = getattr(self, name)
            if rep is not None:
                out[name] = rep
        return out


# --------------------------------------------------------------------------
# Pipeline + auxiliary kinds
# --------------------------------------------------------------------------

class V1Dag(BaseSchema):
    kind: Literal["dag"] = "dag"
    operations: list[Any]  # list[V1Operation] — validated lazily (circular)
    components: Optional[list[Any]] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[dict[str, Any]]] = None
    environment: Optional[V1Environment] = None
    connections: Optional[list[str]] = None
    volumes: Optional[list[dict[str, Any]]] = None


class V1Tuner(BaseSchema):
    kind: Literal["tuner"] = "tuner"
    hub_ref: Optional[str] = None
    container: Optional[V1Container] = None
    params: Optional[dict[str, Any]] = None
    presets: Optional[list[str]] = None
    queue: Optional[str] = None


class V1NotifierJob(_BaseRun):
    kind: Literal["notifier"] = "notifier"
    connections: Optional[list[str]] = None
    container: Optional[V1Container] = None
    params: Optional[dict[str, Any]] = None


class V1CleanerJob(_BaseRun):
    kind: Literal["cleaner"] = "cleaner"
    connections: Optional[list[str]] = None
    container: Optional[V1Container] = None


class V1WatchdogJob(_BaseRun):
    """Agent-side auxiliary (upstream's watchdog kind): a job-like run
    that monitors cluster/run health on an interval."""

    kind: Literal["watchdog"] = "watchdog"
    connections: Optional[list[str]] = None
    container: Optional[V1Container] = None
    interval_seconds: Optional[int] = None

    @field_validator("interval_seconds")
    @classmethod
    def _check_interval(cls, v):
        if v is not None and v <= 0:
            raise ValueError(f"intervalSeconds must be > 0, got {v}")
        return v


RunSpec = Union[
    V1Job, V1Service, V1JAXJob, V1TFJob, V1PyTorchJob, V1MPIJob,
    V1RayJob, V1DaskJob, V1Dag, V1Tuner, V1NotifierJob, V1CleanerJob,
    V1WatchdogJob,
]
