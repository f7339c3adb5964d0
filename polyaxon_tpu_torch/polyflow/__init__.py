"""Polyflow IR — the typed spec universe (SURVEY.md §2 "Polyflow IR").

Port of ``polyaxon_tpu/polyflow/__init__.py``, the same code under the
port's module names.
"""

from polyaxon_tpu_torch.polyflow.component import V1Component
from polyaxon_tpu_torch.polyflow.environment import (
    GPU_RESOURCE,
    TPU_RESOURCE,
    V1Cache,
    V1Container,
    V1EnvVar,
    V1Environment,
    V1Hook,
    V1Init,
    V1Notification,
    V1Plugins,
    V1ResourceSpec,
    V1Termination,
    V1TpuTopology,
)
from polyaxon_tpu_torch.polyflow.io import IOTypes, V1IO, V1Param, validate_params_against_io
from polyaxon_tpu_torch.polyflow.matrix import (
    V1Asha,
    V1Bayes,
    V1FailureEarlyStopping,
    V1GridSearch,
    V1Hyperband,
    V1Hyperopt,
    V1HpChoice,
    V1HpLinSpace,
    V1HpLogSpace,
    V1HpLogUniform,
    V1HpPChoice,
    V1HpRange,
    V1HpUniform,
    V1Iterative,
    V1Mapping,
    V1MetricEarlyStopping,
    V1OptimizationMetric,
    V1OptimizationResource,
    V1RandomSearch,
)
from polyaxon_tpu_torch.polyflow.operation import (
    V1Build,
    V1EventTrigger,
    V1Join,
    V1Operation,
    V1PatchStrategy,
    V1TriggerPolicy,
)
from polyaxon_tpu_torch.polyflow.runs import (
    RunSpec,
    V1CleanerJob,
    V1Dag,
    V1DaskJob,
    V1JAXJob,
    V1JaxCheckpointing,
    V1Job,
    V1KFReplica,
    V1MPIJob,
    V1MeshSpec,
    V1NotifierJob,
    V1PyTorchJob,
    V1RayJob,
    V1RunKind,
    V1Service,
    V1TFJob,
    V1Tuner,
    V1WatchdogJob,
)
from polyaxon_tpu_torch.polyflow.schedules import (
    V1CronSchedule,
    V1DateTimeSchedule,
    V1IntervalSchedule,
)

__all__ = [name for name in dir() if name.startswith("V1") or name in
           ("IOTypes", "RunSpec", "TPU_RESOURCE", "GPU_RESOURCE", "validate_params_against_io")]
