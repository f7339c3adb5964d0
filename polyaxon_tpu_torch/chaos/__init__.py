from polyaxon_tpu_torch.chaos.plan import (
    ENV_CHAOS_PLAN,
    ChaosKill,
    ChaosPlan,
    ChaosStore,
    Fault,
    active_plan,
    install,
    uninstall,
)

__all__ = [
    "ENV_CHAOS_PLAN",
    "ChaosKill",
    "ChaosPlan",
    "ChaosStore",
    "Fault",
    "active_plan",
    "install",
    "uninstall",
]
