from polyaxon_tpu_torch.controlplane.scheduler import Scheduler
from polyaxon_tpu_torch.controlplane.service import ControlPlane
from polyaxon_tpu_torch.controlplane.store import RunRecord, Store

__all__ = ["ControlPlane", "RunRecord", "Scheduler", "Store"]
