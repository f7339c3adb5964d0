"""Launch plans: the compiled, concrete form of an operation.

TPU-native analogue of the reference's polypod converter layer
(SURVEY.md §2 "Compiler", §3.2 [K]): where upstream emits k8s pod specs
(main + sidecar + init containers, env contract, ``nvidia.com/gpu``
requests), this compiler emits a ``V1LaunchPlan`` — per-process env/cmd
for every host of a TPU slice gang, ``google.com/tpu`` resource +
topology requests [B], init/sidecar phases — which a slice provider
(local subprocess executor today, GKE TPU-VM provider in production)
materializes. Pure + deterministic → golden-testable (SURVEY §4).

Port of ``polyaxon_tpu/compiler/plan.py``, the same code under the
port's module names.
"""

from __future__ import annotations

import sys
from typing import Any, Optional

from polyaxon_tpu_torch.schemas.base import BaseSchema

COORDINATOR_PLACEHOLDER = "__COORDINATOR__"  # provider substitutes host0:port
COORDINATOR_PORT = 8476


class V1ProcessSpec(BaseSchema):
    index: int
    host_index: int = 0
    replica_name: Optional[str] = None  # kubeflow kinds: worker/ps/master/...
    command: list[str]
    args: list[str] = []
    env: dict[str, str] = {}
    working_dir: Optional[str] = None
    image: Optional[str] = None
    ports: Optional[list[int]] = None


class V1InitPhase(BaseSchema):
    kind: str  # git | artifacts | file | dockerfile | tpu_metadata | container
    config: dict[str, Any] = {}
    connection: Optional[str] = None
    path: Optional[str] = None


class V1SidecarSpec(BaseSchema):
    kind: str  # sync | container
    command: Optional[list[str]] = None
    config: dict[str, Any] = {}


class V1ResourceRequest(BaseSchema):
    resources: dict[str, Any] = {}
    accelerator: Optional[str] = None
    topology: Optional[str] = None
    slices: int = 1
    chips: int = 0
    hosts: int = 1
    preemptible: bool = False
    node_selector: Optional[dict[str, str]] = None


class V1LaunchPlan(BaseSchema):
    run_uuid: str
    run_name: Optional[str] = None
    project: Optional[str] = None
    run_kind: str
    artifacts_dir: str
    outputs_dir: str
    resources: V1ResourceRequest
    num_processes: int = 1
    processes: list[V1ProcessSpec] = []
    init: list[V1InitPhase] = []
    sidecars: list[V1SidecarSpec] = []
    termination: Optional[dict[str, Any]] = None
    queue: Optional[str] = None
    labels: Optional[dict[str, str]] = None

    def process_env(self, index: int) -> dict[str, str]:
        return self.processes[index].env


def builtin_runtime_command() -> list[str]:
    return [sys.executable, "-m", "polyaxon_tpu_torch.runtime.launch"]


# The port's sidecar (``polyaxon_tpu_torch.sidecar``) and compile.py's
# watch loop (``polyaxon_tpu_torch.utils.watchloop``), named as the JAX
# package names its own.
def sidecar_sync_command(run_dir: str, store_dir: str) -> list[str]:
    return [
        sys.executable, "-m", "polyaxon_tpu_torch.sidecar",
        "--run-dir", run_dir, "--store-dir", store_dir,
    ]
