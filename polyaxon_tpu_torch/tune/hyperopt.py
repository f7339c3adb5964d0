"""Hyperopt-style search managers, implemented natively (SURVEY.md §2
"Polytune" [K]: upstream bridges to the ``hyperopt`` package for
tpe/rand/anneal; that package is not in this environment, so the
algorithms are owned here, over the same hp-param schema the other
managers use).

- **tpe** — tree-structured Parzen estimator: split observations at the
  γ-quantile into good/bad sets, fit a 1-D Parzen density per param
  (normal kernels in (log-)space for continuous params, Laplace-smoothed
  categorical counts for discrete), sample candidates from the good
  density and rank by l(x)/g(x).
- **anneal** — sample around the incumbent with a radius that shrinks as
  observations accumulate.
- **rand** — plain random search (upstream parity for algorithm=rand).

Manager API mirrors ``tune.bayes.BayesManager`` (initial_suggestions /
get_suggestions / is_done) so the scheduler drives both identically.

Port of ``polyaxon_tpu/tune/hyperopt.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

from polyaxon_tpu_torch.polyflow.matrix import V1Hyperopt, V1Optimization
from polyaxon_tpu_torch.tune.base import Observation, Params

_EPS = 1e-12


def _quantize(hp, value: float) -> float:
    """Apply the hp's `q` rounding when it declares one (q* kinds)."""
    q = hp.value.get("q") if isinstance(hp.value, dict) else None
    return round(value / q) * q if q else value


class _ParzenDim:
    """1-D Parzen estimator over one hyperparameter.

    Three regimes, chosen from the hp schema:
    - discrete (choice/pchoice/range/*space): Laplace-smoothed
      categorical over ``to_grid()``;
    - bounded continuous (uniform/loguniform/q*): normal kernels in the
      (log-)warped interval, truncated to it;
    - unbounded continuous (normal/lognormal/q*): normal kernels in the
      (log-)warped line, bandwidth from the data spread.
    """

    def __init__(self, hp, values: list[Any]):
        self.hp = hp
        self.discrete = hp.is_discrete()
        self.bounds = None if self.discrete else hp.to_bounds()
        self.is_log = "log" in getattr(hp, "kind", "")
        if self.discrete:
            self.grid = hp.to_grid()
            counts = {repr(g): 1.0 for g in self.grid}  # Laplace smoothing
            for v in values:
                key = repr(v)
                if key in counts:
                    counts[key] += 1.0
            total = sum(counts.values())
            self.probs = [counts[repr(g)] / total for g in self.grid]
            return
        self.points = [self._warp(v) for v in values]
        if self.bounds is not None:
            low, high, _ = self.bounds
            self.span = (high - low) or 1.0
        elif len(self.points) >= 2:
            self.span = (max(self.points) - min(self.points)) or 1.0
        else:
            self.span = (float(hp.value.get("scale", 1.0))
                         if isinstance(hp.value, dict) else 1.0)
        n = len(self.points)
        if n >= 2:
            mean = sum(self.points) / n
            spread = math.sqrt(sum((p - mean) ** 2 for p in self.points) / n)
            # Silverman-style data-driven bandwidth, floored so tightly
            # clustered sets keep a little exploration.
            self.sigma = max(1.06 * spread * n ** -0.2, self.span / 50.0)
        else:
            self.sigma = self.span / 10.0

    def _warp(self, v: Any) -> float:
        return math.log(max(float(v), _EPS)) if self.is_log else float(v)

    def _unwarp(self, x: float) -> Any:
        if self.bounds is not None:
            low, high, _ = self.bounds
            x = min(max(x, low), high)
        value = math.exp(x) if self.is_log else x
        return _quantize(self.hp, value)

    def sample(self, rng: random.Random) -> Any:
        if self.discrete:
            return rng.choices(self.grid, weights=self.probs, k=1)[0]
        if not self.points:  # prior: the hp's own distribution
            return self.hp.sample(rng)
        center = rng.choice(self.points)
        return self._unwarp(rng.gauss(center, self.sigma))

    def logpdf(self, value: Any) -> float:
        if self.discrete:
            try:
                return math.log(self.probs[self.grid.index(value)])
            except ValueError:
                return math.log(_EPS)
        if not self.points:
            return 0.0  # flat prior: contributes nothing to the ratio
        x = self._warp(value)
        total = 0.0
        inv = 1.0 / (self.sigma * math.sqrt(2.0 * math.pi))
        for c in self.points:
            z = (x - c) / self.sigma
            total += inv * math.exp(-0.5 * z * z)
        return math.log(total / len(self.points) + _EPS)


class HyperoptManager:
    def __init__(self, config: V1Hyperopt):
        self.config = config
        self.rng = random.Random(config.seed)
        self._names = list(config.params.keys())
        self._sign = (1.0 if config.metric.optimization == V1Optimization.MAXIMIZE
                      else -1.0)

    # -- shared helpers ----------------------------------------------------
    def _random_params(self) -> Params:
        return {name: hp.sample(self.rng)
                for name, hp in self.config.params.items()}

    def initial_suggestions(self) -> list[Params]:
        return [self._random_params() for _ in range(self.config.startup_trials)]

    def is_done(self, observations: list[Observation]) -> bool:
        finished = len([o for o in observations if o.status != "preempted"])
        return finished >= self.config.total_budget

    # -- algorithms --------------------------------------------------------
    def get_suggestions(self, observations: list[Observation],
                        count: int = 1) -> list[Params]:
        # The scheduler rebuilds this manager every tick; reseed from the
        # observation count so a fixed seed stays deterministic per round
        # instead of replaying the same RNG stream (duplicate trials).
        if self.config.seed is not None:
            self.rng = random.Random(
                (self.config.seed * 1_000_003 + len(observations)) ^ count)
        usable = [o for o in observations if o.usable]
        algo = self.config.algorithm
        if algo == "rand" or len(usable) < 2:
            return [self._random_params() for _ in range(count)]
        if algo == "anneal":
            return [self._anneal_one(usable, len(observations))
                    for _ in range(count)]
        return self._tpe(usable, count)

    def _anneal_one(self, usable: list[Observation], n_seen: int) -> Params:
        best = max(usable, key=lambda o: self._sign * o.metric)
        # Temperature decays with observation count: explore → exploit.
        temp = 1.0 / (1.0 + 0.25 * n_seen)
        out: Params = {}
        for name, hp in self.config.params.items():
            incumbent = best.params.get(name)
            if incumbent is None:
                out[name] = hp.sample(self.rng)
                continue
            if hp.is_discrete():
                # Keep the incumbent with rising probability; else resample.
                out[name] = (incumbent if self.rng.random() > max(temp, 0.1)
                             else hp.sample(self.rng))
                continue
            dim = _ParzenDim(hp, [incumbent])
            x = dim._warp(incumbent)
            # Step scale: a temperature-sized fraction of the param span.
            out[name] = dim._unwarp(
                self.rng.gauss(x, dim.span * max(temp, 0.02)))
        return out

    def _tpe(self, usable: list[Observation], count: int,
             gamma: float = 0.25, n_candidates: int = 64) -> list[Params]:
        ranked = sorted(usable, key=lambda o: -self._sign * o.metric)
        n_good = max(1, int(math.ceil(gamma * len(ranked))))
        good, bad = ranked[:n_good], ranked[n_good:]
        if not bad:
            bad = ranked  # degenerate: everything is "good"; densities equal

        good_dims, bad_dims = {}, {}
        for name, hp in self.config.params.items():
            good_dims[name] = _ParzenDim(hp, [o.params[name] for o in good
                                              if name in o.params])
            bad_dims[name] = _ParzenDim(hp, [o.params[name] for o in bad
                                             if name in o.params])

        picked: list[Params] = []
        seen = [o.params for o in usable]
        for _ in range(count):
            best_cand, best_score = None, -math.inf
            for _ in range(n_candidates):
                cand = {name: good_dims[name].sample(self.rng)
                        for name in self._names}
                score = sum(
                    good_dims[n].logpdf(cand[n]) - bad_dims[n].logpdf(cand[n])
                    for n in self._names
                )
                if score > best_score and cand not in picked and cand not in seen:
                    best_cand, best_score = cand, score
            picked.append(best_cand if best_cand is not None
                          else self._random_params())
        return picked
