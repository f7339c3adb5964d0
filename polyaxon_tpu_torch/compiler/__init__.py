"""Port of ``polyaxon_tpu/compiler/__init__.py``, the same code under
the port's module names.
"""

from polyaxon_tpu_torch.compiler.compile import CompilerError, ENV_JAXJOB_SPEC, compile_operation
from polyaxon_tpu_torch.compiler.plan import (
    COORDINATOR_PLACEHOLDER,
    V1InitPhase,
    V1LaunchPlan,
    V1ProcessSpec,
    V1ResourceRequest,
    V1SidecarSpec,
)

__all__ = [
    "COORDINATOR_PLACEHOLDER",
    "CompilerError",
    "ENV_JAXJOB_SPEC",
    "V1InitPhase",
    "V1LaunchPlan",
    "V1ProcessSpec",
    "V1ResourceRequest",
    "V1SidecarSpec",
    "compile_operation",
]
