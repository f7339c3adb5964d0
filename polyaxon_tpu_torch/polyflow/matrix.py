"""Hyperparameter search space + matrix kinds (grid/random/hyperband/bayes/
iterative/mapping).

Capability parity with the reference's ``polyflow/matrix`` (SURVEY.md §2
"Polytune" [K], [B] names Hyperband + Bayesian opt explicitly). The spec
types here are pure data; the search *algorithms* (bracket math, GP/EI)
live in ``polyaxon_tpu_torch.tune`` the way upstream splits polyflow from
hypertune.

Port of ``polyaxon_tpu/polyflow/matrix.py``, the same code under the
port's module names.
"""

from __future__ import annotations

import math
import random as _random
from typing import Any, Literal, Optional, Union

from pydantic import field_validator, model_validator

from polyaxon_tpu_torch.schemas.base import BaseSchema


# --------------------------------------------------------------------------
# Hyperparameter distributions
# --------------------------------------------------------------------------

class _Hp(BaseSchema):
    def sample(self, rng: _random.Random) -> Any:
        raise NotImplementedError

    def is_discrete(self) -> bool:
        return True

    def to_grid(self) -> list[Any]:
        raise ValueError(f"{self.__class__.__name__} cannot be enumerated for grid search")

    # Continuous-space view for Bayesian optimization: (low, high, log)
    def to_bounds(self) -> Optional[tuple[float, float, bool]]:
        return None


class V1HpChoice(_Hp):
    kind: Literal["choice"] = "choice"
    value: list[Any]

    def sample(self, rng):
        return rng.choice(self.value)

    def to_grid(self):
        return list(self.value)


class V1HpPChoice(_Hp):
    kind: Literal["pchoice"] = "pchoice"
    value: list[tuple[Any, float]]

    @field_validator("value")
    @classmethod
    def _check_probs(cls, v):
        total = sum(p for _, p in v)
        if not math.isclose(total, 1.0, rel_tol=1e-3):
            raise ValueError(f"pchoice probabilities must sum to 1, got {total}")
        return v

    def sample(self, rng):
        items = [item for item, _ in self.value]
        weights = [p for _, p in self.value]
        return rng.choices(items, weights=weights, k=1)[0]

    def to_grid(self):
        return [item for item, _ in self.value]


class V1HpRange(_Hp):
    kind: Literal["range"] = "range"
    value: list[Union[int, float]]  # [start, stop, step]

    @field_validator("value")
    @classmethod
    def _check(cls, v):
        if len(v) != 3:
            raise ValueError("range expects [start, stop, step]")
        return v

    def _items(self):
        start, stop, step = self.value
        out, x = [], start
        while (step > 0 and x < stop) or (step < 0 and x > stop):
            out.append(x)
            x = x + step
        return out

    def sample(self, rng):
        return rng.choice(self._items())

    def to_grid(self):
        return self._items()

    def to_bounds(self):
        start, stop, _ = self.value
        return (float(min(start, stop)), float(max(start, stop)), False)


def _check_triple(v, *, name):
    if len(v) != 3:
        raise ValueError(f"{name} expects [start, stop, num]")
    if int(v[2]) < 1:
        raise ValueError(f"{name} num must be >= 1")
    return v


class V1HpLinSpace(_Hp):
    kind: Literal["linspace"] = "linspace"
    value: list[Union[int, float]]  # [start, stop, num]

    @field_validator("value")
    @classmethod
    def _check(cls, v):
        return _check_triple(v, name="linspace")

    def _items(self):
        start, stop, num = self.value
        num = int(num)
        if num == 1:
            return [start]
        step = (stop - start) / (num - 1)
        return [start + i * step for i in range(num)]

    def sample(self, rng):
        return rng.choice(self._items())

    def to_grid(self):
        return self._items()

    def to_bounds(self):
        start, stop, _ = self.value
        return (float(min(start, stop)), float(max(start, stop)), False)


class V1HpLogSpace(_Hp):
    kind: Literal["logspace"] = "logspace"
    value: list[Union[int, float]]  # [start_exp, stop_exp, num] base 10

    @field_validator("value")
    @classmethod
    def _check(cls, v):
        return _check_triple(v, name="logspace")

    def _items(self):
        start, stop, num = self.value
        num = int(num)
        if num == 1:
            return [10.0 ** start]
        step = (stop - start) / (num - 1)
        return [10.0 ** (start + i * step) for i in range(num)]

    def sample(self, rng):
        return rng.choice(self._items())

    def to_grid(self):
        return self._items()


class V1HpGeomSpace(_Hp):
    kind: Literal["geomspace"] = "geomspace"
    value: list[Union[int, float]]  # [start, stop, num]

    @field_validator("value")
    @classmethod
    def _check(cls, v):
        _check_triple(v, name="geomspace")
        if v[0] == 0 or v[1] == 0:
            raise ValueError("geomspace start/stop must be nonzero")
        return v

    def _items(self):
        start, stop, num = self.value
        num = int(num)
        if num == 1:
            return [start]
        ratio = (stop / start) ** (1.0 / (num - 1))
        return [start * ratio**i for i in range(num)]

    def sample(self, rng):
        return rng.choice(self._items())

    def to_grid(self):
        return self._items()


class _ContinuousHp(_Hp):
    def is_discrete(self):
        return False


class V1HpUniform(_ContinuousHp):
    kind: Literal["uniform"] = "uniform"
    value: dict[str, float]  # {low, high}

    def sample(self, rng):
        return rng.uniform(self.value["low"], self.value["high"])

    def to_bounds(self):
        return (self.value["low"], self.value["high"], False)


class V1HpQUniform(_ContinuousHp):
    kind: Literal["quniform"] = "quniform"
    value: dict[str, float]  # {low, high, q}

    def sample(self, rng):
        q = self.value["q"]
        return round(rng.uniform(self.value["low"], self.value["high"]) / q) * q

    def to_bounds(self):
        return (self.value["low"], self.value["high"], False)


class V1HpLogUniform(_ContinuousHp):
    kind: Literal["loguniform"] = "loguniform"
    value: dict[str, float]  # {low, high} natural-log bounds

    def sample(self, rng):
        return math.exp(rng.uniform(self.value["low"], self.value["high"]))

    def to_bounds(self):
        return (self.value["low"], self.value["high"], True)


class V1HpQLogUniform(_ContinuousHp):
    kind: Literal["qloguniform"] = "qloguniform"
    value: dict[str, float]

    def sample(self, rng):
        q = self.value["q"]
        return round(math.exp(rng.uniform(self.value["low"], self.value["high"])) / q) * q

    def to_bounds(self):
        return (self.value["low"], self.value["high"], True)


class V1HpNormal(_ContinuousHp):
    kind: Literal["normal"] = "normal"
    value: dict[str, float]  # {loc, scale}

    def sample(self, rng):
        return rng.gauss(self.value["loc"], self.value["scale"])


class V1HpQNormal(_ContinuousHp):
    kind: Literal["qnormal"] = "qnormal"
    value: dict[str, float]

    def sample(self, rng):
        q = self.value["q"]
        return round(rng.gauss(self.value["loc"], self.value["scale"]) / q) * q


class V1HpLogNormal(_ContinuousHp):
    kind: Literal["lognormal"] = "lognormal"
    value: dict[str, float]

    def sample(self, rng):
        return math.exp(rng.gauss(self.value["loc"], self.value["scale"]))


class V1HpQLogNormal(_ContinuousHp):
    kind: Literal["qlognormal"] = "qlognormal"
    value: dict[str, float]

    def sample(self, rng):
        q = self.value["q"]
        return round(math.exp(rng.gauss(self.value["loc"], self.value["scale"])) / q) * q


HpParam = Union[
    V1HpChoice, V1HpPChoice, V1HpRange, V1HpLinSpace, V1HpLogSpace,
    V1HpGeomSpace, V1HpUniform, V1HpQUniform, V1HpLogUniform,
    V1HpQLogUniform, V1HpNormal, V1HpQNormal, V1HpLogNormal, V1HpQLogNormal,
]


# --------------------------------------------------------------------------
# Optimization metric + early stopping
# --------------------------------------------------------------------------

class V1Optimization:
    MAXIMIZE = "maximize"
    MINIMIZE = "minimize"


class V1OptimizationMetric(BaseSchema):
    name: str
    optimization: str = V1Optimization.MINIMIZE

    @field_validator("optimization")
    @classmethod
    def _check(cls, v):
        if v not in (V1Optimization.MAXIMIZE, V1Optimization.MINIMIZE):
            raise ValueError(f"optimization must be maximize|minimize, got {v}")
        return v

    def is_better(self, a: float, b: float) -> bool:
        """True if metric value ``a`` is strictly better than ``b``."""
        return a > b if self.optimization == V1Optimization.MAXIMIZE else a < b

    def sort_key(self, value: float) -> float:
        return -value if self.optimization == V1Optimization.MAXIMIZE else value


class V1OptimizationResource(BaseSchema):
    name: str
    type: str = "int"  # int | float

    def cast(self, value):
        return int(value) if self.type == "int" else float(value)


class V1MetricEarlyStopping(BaseSchema):
    kind: Literal["metric_early_stopping"] = "metric_early_stopping"
    metric: str
    value: float
    optimization: str = V1Optimization.MINIMIZE
    policy: Optional[dict[str, Any]] = None


class V1FailureEarlyStopping(BaseSchema):
    kind: Literal["failure_early_stopping"] = "failure_early_stopping"
    percent: float


EarlyStopping = Union[V1MetricEarlyStopping, V1FailureEarlyStopping]


# --------------------------------------------------------------------------
# Matrix kinds
# --------------------------------------------------------------------------

class V1GridSearch(BaseSchema):
    kind: Literal["grid"] = "grid"
    params: dict[str, HpParam]
    num_runs: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None


class V1RandomSearch(BaseSchema):
    kind: Literal["random"] = "random"
    params: dict[str, HpParam]
    num_runs: int
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None


class V1Hyperband(BaseSchema):
    """Hyperband successive-halving spec ([B] names it; math in tune/)."""

    kind: Literal["hyperband"] = "hyperband"
    params: dict[str, HpParam]
    max_iterations: int
    eta: float = 3
    resource: V1OptimizationResource
    metric: V1OptimizationMetric
    resume: Optional[bool] = None
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None

    @model_validator(mode="after")
    def _check(self):
        if self.max_iterations < 1:
            raise ValueError("maxIterations must be >= 1")
        if self.eta <= 1:
            raise ValueError("eta must be > 1")
        return self

    # Bracket arithmetic (the spec-level part; rung advancement lives in
    # tune.hyperband.HyperbandManager).
    @property
    def s_max(self) -> int:
        # Round before truncating: log(243)/log(3) == 4.999999999999999
        # and a bare int() would silently drop a whole bracket.
        return int(round(math.log(self.max_iterations) / math.log(self.eta), 10))

    @property
    def B(self) -> float:  # noqa: N802 - standard Hyperband symbol
        return (self.s_max + 1) * self.max_iterations

    def bracket(self, s: int) -> tuple[int, float]:
        """(num_configs n, initial resource r) for bracket ``s``."""
        n = int(math.ceil((self.B / self.max_iterations) * (self.eta**s) / (s + 1)))
        r = self.max_iterations * (self.eta ** (-s))
        return n, r


class V1Asha(BaseSchema):
    """Asynchronous Successive Halving (Li et al., MLSys 2020).

    Unlike Hyperband's synchronized rungs (a rung must fully complete
    before promotion), ASHA promotes any trial that ranks in the top
    1/eta of COMPLETED trials at its rung the moment it finishes — no
    barrier, so stragglers and preempted trials never stall the sweep.
    The natural fit for preemptible TPU slices ([B] "trials across
    preemptible slices"): slot turnover feeds either a promotion or a
    fresh bottom-rung trial, keeping every slice busy.
    """

    kind: Literal["asha"] = "asha"
    params: dict[str, HpParam]
    num_runs: int  # bottom-rung trials to draw in total
    max_iterations: int  # R: max resource any trial reaches
    min_resource: float = 1  # r: bottom-rung resource
    eta: float = 3
    resource: V1OptimizationResource
    metric: V1OptimizationMetric
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None

    @model_validator(mode="after")
    def _check(self):
        if self.num_runs < 1:
            raise ValueError("numRuns must be >= 1")
        if self.max_iterations < 1:
            raise ValueError("maxIterations must be >= 1")
        if self.eta <= 1:
            raise ValueError("eta must be > 1")
        if not 0 < self.min_resource <= self.max_iterations:
            raise ValueError(
                "minResource must be in (0, maxIterations]")
        if self.rung_resources()[0] <= 0:
            # e.g. minResource=0.5 with an int resource casts to 0.
            raise ValueError(
                f"minResource {self.min_resource} casts to a non-positive "
                f"{self.resource.type} resource")
        return self

    def rung_resources(self) -> list:
        """Resource per rung: r·eta^k capped at R (the cap rung is
        terminal). Cast duplicates are dropped — with an int resource
        and small eta, consecutive rungs can round to the same budget,
        and promoting at an identical budget would waste a trial."""
        out: list = []
        r = float(self.min_resource)
        while True:
            capped = min(r, float(self.max_iterations))
            val = self.resource.cast(capped)
            if not out or val > out[-1]:
                out.append(val)
            if capped >= self.max_iterations:
                return out
            r *= self.eta


class V1GaussianProcessConfig(BaseSchema):
    kernel: str = "matern"  # matern | rbf
    length_scale: float = 1.0
    nu: float = 1.9


class V1UtilityFunctionConfig(BaseSchema):
    acquisition_function: str = "ucb"  # ucb | ei | poi
    gaussian_process: Optional[V1GaussianProcessConfig] = None
    kappa: Optional[float] = 2.576
    eps: Optional[float] = 0.0
    num_warmup: Optional[int] = None
    num_iterations: Optional[int] = None

    @field_validator("acquisition_function")
    @classmethod
    def _check(cls, v):
        if v not in ("ucb", "ei", "poi"):
            raise ValueError(f"acquisitionFunction must be ucb|ei|poi, got {v}")
        return v


class V1Bayes(BaseSchema):
    kind: Literal["bayes"] = "bayes"
    params: dict[str, HpParam]
    num_initial_runs: int
    max_iterations: int
    metric: V1OptimizationMetric
    utility_function: Optional[V1UtilityFunctionConfig] = None
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None


class V1Hyperopt(BaseSchema):
    """Hyperopt-style sequential model-based search (upstream's
    ``V1Hyperopt`` bridge, SURVEY.md §2 "Polytune" [K] — implemented
    natively in ``tune/hyperopt.py`` rather than wrapping the hyperopt
    package, which is not in this environment).

    ``algorithm``: ``tpe`` (tree-structured Parzen estimator),
    ``anneal`` (shrinking-radius search around the incumbent), or
    ``rand`` (plain random, upstream parity).
    """

    kind: Literal["hyperopt"] = "hyperopt"
    algorithm: str = "tpe"  # tpe | rand | anneal
    params: dict[str, HpParam]
    num_runs: int
    max_iterations: Optional[int] = None
    metric: V1OptimizationMetric
    num_startup_trials: Optional[int] = None  # default: max(4, num_runs // 5)
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None

    @field_validator("algorithm")
    @classmethod
    def _check_algorithm(cls, v):
        if v not in ("tpe", "rand", "anneal"):
            raise ValueError(f"algorithm must be tpe|rand|anneal, got {v}")
        return v

    @model_validator(mode="after")
    def _check(self):
        if self.num_runs < 1:
            raise ValueError("numRuns must be >= 1")
        if self.max_iterations is not None and self.max_iterations < 0:
            raise ValueError("maxIterations must be >= 0")
        return self

    @property
    def startup_trials(self) -> int:
        if self.num_startup_trials is not None:
            return max(1, min(self.num_startup_trials, self.num_runs))
        return max(4, min(self.num_runs // 5, 20)) if self.num_runs > 4 else 1

    @property
    def total_budget(self) -> int:
        """Total trials: numRuns, optionally tightened by maxIterations
        (a cap on *model-guided* trials after the startup batch, the
        V1Bayes analogue)."""
        if self.max_iterations is not None:
            return min(self.num_runs, self.startup_trials + self.max_iterations)
        return self.num_runs


class V1Iterative(BaseSchema):
    kind: Literal["iterative"] = "iterative"
    params: dict[str, HpParam]
    max_iterations: int
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    tuner: Optional[dict[str, Any]] = None
    early_stopping: Optional[list[EarlyStopping]] = None


class V1Mapping(BaseSchema):
    kind: Literal["mapping"] = "mapping"
    values: list[dict[str, Any]]
    concurrency: Optional[int] = None
    early_stopping: Optional[list[EarlyStopping]] = None

    @property
    def num_runs(self) -> int:
        return len(self.values)


Matrix = Union[
    V1GridSearch, V1RandomSearch, V1Hyperband, V1Asha, V1Bayes, V1Hyperopt,
    V1Iterative, V1Mapping,
]
