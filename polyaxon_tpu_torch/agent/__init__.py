from polyaxon_tpu_torch.agent.agent import Agent
from polyaxon_tpu_torch.agent.executor import LocalExecutor

__all__ = ["Agent", "LocalExecutor"]
