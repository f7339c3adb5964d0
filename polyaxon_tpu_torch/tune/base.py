"""Polytune search-manager interfaces (SURVEY.md §2 "Polytune" [K]).

A manager consumes *observations* (completed trials: params + metric)
and emits *suggestions* (param dicts to run next). Managers are pure
state machines — the tuner loop in the scheduler owns IO, trial
lifecycle, and preemption handling, mirroring upstream's
search_managers/ split from the tuner service.

Port of ``polyaxon_tpu/tune/base.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Any, Optional

from polyaxon_tpu_torch.polyflow.matrix import (
    V1GridSearch,
    V1Iterative,
    V1Mapping,
    V1Optimization,
    V1OptimizationMetric,
    V1RandomSearch,
)

Params = dict[str, Any]


@dataclasses.dataclass
class Observation:
    params: Params
    metric: Optional[float]
    status: str = "succeeded"  # succeeded | failed | preempted

    @property
    def usable(self) -> bool:
        return self.metric is not None and self.status == "succeeded"


class GridSearchManager:
    def __init__(self, config: V1GridSearch):
        self.config = config

    def get_suggestions(self) -> list[Params]:
        names = list(self.config.params.keys())
        grids = [self.config.params[n].to_grid() for n in names]
        combos = [dict(zip(names, values)) for values in itertools.product(*grids)]
        if self.config.num_runs:
            combos = combos[: self.config.num_runs]
        return combos


class RandomSearchManager:
    def __init__(self, config: V1RandomSearch):
        self.config = config

    def get_suggestions(self) -> list[Params]:
        rng = random.Random(self.config.seed)
        return [
            {name: hp.sample(rng) for name, hp in self.config.params.items()}
            for _ in range(self.config.num_runs)
        ]


class MappingManager:
    def __init__(self, config: V1Mapping):
        self.config = config

    def get_suggestions(self) -> list[Params]:
        return [dict(v) for v in self.config.values]


class IterativeManager:
    """Sequential sampling, one suggestion per iteration — the embedded
    equivalent of upstream's user-driven V1Iterative tuner loop (each
    iteration can observe everything before it)."""

    def __init__(self, config: V1Iterative):
        self.config = config

    def get_suggestion(self, iteration: int,
                       observations: Optional[list["Observation"]] = None) -> Params:
        del observations  # hook for smarter per-iteration policies
        # seed=None keeps random-search semantics: fresh OS entropy per
        # call (a fixed seed gives reproducible per-iteration draws).
        if self.config.seed is None:
            rng = random.Random()
        else:
            rng = random.Random(self.config.seed * 100003 + iteration)
        return {name: hp.sample(rng) for name, hp in self.config.params.items()}


def check_early_stopping(
    early_stopping: Optional[list],
    observations_for,  # Callable[[str], list[Observation]]
) -> Optional[str]:
    """Evaluate V1MetricEarlyStopping / V1FailureEarlyStopping policies.

    ``observations_for(metric_name)`` supplies trial observations with
    that metric bound (grid/random sweeps carry no sweep-level metric —
    each policy names its own). Returns None (keep going), "succeed"
    (a trial hit the target — the sweep's goal is met), or "fail"
    (failure fraction exceeded).
    """
    if not early_stopping:
        return None
    for policy in early_stopping:
        data = policy if isinstance(policy, dict) else policy.to_dict()
        kind = data.get("kind")
        if kind == "metric_early_stopping":
            optimization = data.get("optimization") or V1Optimization.MINIMIZE
            target = float(data["value"])
            for obs in observations_for(data["metric"]):
                if not obs.usable:
                    continue
                hit = (obs.metric <= target
                       if optimization == V1Optimization.MINIMIZE
                       else obs.metric >= target)
                if hit:
                    return "succeed"
        elif kind == "failure_early_stopping":
            done = [o for o in observations_for("") if o.status != "preempted"]
            failed = [o for o in done if o.status == "failed"]
            if done and 100.0 * len(failed) / len(done) >= float(data["percent"]):
                return "fail"
    return None


def top_k(
    observations: list[Observation],
    metric: V1OptimizationMetric,
    k: int,
) -> list[Observation]:
    """Best-k usable observations; failed trials rank as worst
    (upstream semantics: failure = bad observation)."""
    usable = [o for o in observations if o.usable]
    usable.sort(key=lambda o: metric.sort_key(o.metric))
    return usable[:k]
