from polyaxon_tpu_torch.agent.agent import Agent
from polyaxon_tpu_torch.agent.executor import LocalExecutor
from polyaxon_tpu_torch.agent.slices import SliceManager

__all__ = ["Agent", "LocalExecutor", "SliceManager"]
