from polyaxon_tpu_torch.tune.base import (
    GridSearchManager,
    IterativeManager,
    MappingManager,
    Observation,
    RandomSearchManager,
    check_early_stopping,
    top_k,
)
from polyaxon_tpu_torch.tune.asha import AshaManager
from polyaxon_tpu_torch.tune.bayes import BayesManager, GaussianProcess, acquisition
from polyaxon_tpu_torch.tune.hyperband import HyperbandManager, Rung
from polyaxon_tpu_torch.tune.hyperopt import HyperoptManager

__all__ = [
    "AshaManager",
    "BayesManager",
    "GaussianProcess",
    "GridSearchManager",
    "HyperbandManager",
    "HyperoptManager",
    "IterativeManager",
    "MappingManager",
    "Observation",
    "RandomSearchManager",
    "Rung",
    "acquisition",
    "check_early_stopping",
    "top_k",
]
