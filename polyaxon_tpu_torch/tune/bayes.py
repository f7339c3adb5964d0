"""Bayesian optimization: Gaussian-process surrogate + UCB/EI/POI
acquisition (SURVEY.md §2 "Polytune" [K]; [B] names Bayesian opt).

Numpy/scipy implementation (both in-env [E]):
- Matern-5/2 (default) or RBF kernel with jittered Cholesky;
- continuous params optimize over their (log-)bounds; discrete params
  (choice/range/...) are sampled and the acquisition picks among them;
- acquisition maximized by dense random search (cheap and robust for
  the <=20-dim spaces Polyaxonfiles declare);
- internally the objective is always *maximized* (minimize flips sign).

Port of ``polyaxon_tpu/tune/bayes.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

import numpy as np
from scipy.stats import norm

from polyaxon_tpu_torch.polyflow.matrix import V1Bayes, V1Optimization
from polyaxon_tpu_torch.tune.base import Observation, Params


def _matern52(dist: np.ndarray, length_scale: float) -> np.ndarray:
    scaled = np.sqrt(5.0) * dist / length_scale
    return (1.0 + scaled + scaled**2 / 3.0) * np.exp(-scaled)


def _rbf(dist: np.ndarray, length_scale: float) -> np.ndarray:
    return np.exp(-0.5 * (dist / length_scale) ** 2)


class GaussianProcess:
    def __init__(self, kernel: str = "matern", length_scale: float = 1.0,
                 noise: float = 1e-6):
        self.kernel = kernel
        self.length_scale = length_scale
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._y_mean = 0.0
        self._y_std = 1.0

    def _k(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        dist = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        fn = _matern52 if self.kernel == "matern" else _rbf
        return fn(dist, self.length_scale)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        self._y_mean = float(y.mean())
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        k = self._k(self._x, self._x) + self.noise * np.eye(len(yn))
        for jitter in (0.0, 1e-8, 1e-6, 1e-4):
            try:
                self._chol = np.linalg.cholesky(k + jitter * np.eye(len(yn)))
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise np.linalg.LinAlgError("GP covariance not PD even with jitter")
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, yn)
        )

    def predict(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        x = np.asarray(x, dtype=float)
        k_star = self._k(x, self._x)
        mean = k_star @ self._alpha
        v = np.linalg.solve(self._chol, k_star.T)
        var = np.clip(1.0 - np.sum(v**2, axis=0), 1e-12, None)
        return mean * self._y_std + self._y_mean, np.sqrt(var) * self._y_std


def acquisition(
    kind: str, mean: np.ndarray, std: np.ndarray, best: float,
    kappa: float = 2.576, eps: float = 0.0,
) -> np.ndarray:
    if kind == "ucb":
        return mean + kappa * std
    if kind == "ei":
        improve = mean - best - eps
        z = improve / std
        return improve * norm.cdf(z) + std * norm.pdf(z)
    if kind == "poi":
        return norm.cdf((mean - best - eps) / std)
    raise ValueError(f"Unknown acquisition `{kind}`")


class BayesManager:
    def __init__(self, config: V1Bayes):
        self.config = config
        self.rng = random.Random(config.seed)
        util = config.utility_function
        gp_cfg = (util.gaussian_process if util and util.gaussian_process else None)
        self.gp = GaussianProcess(
            kernel=(gp_cfg.kernel if gp_cfg else "matern"),
            length_scale=(gp_cfg.length_scale if gp_cfg else 1.0),
        )
        self.acq_kind = util.acquisition_function if util else "ucb"
        self.kappa = (util.kappa if util and util.kappa is not None else 2.576)
        self.eps = (util.eps if util and util.eps is not None else 0.0)
        self._names = list(config.params.keys())
        self._sign = 1.0 if config.metric.optimization == V1Optimization.MAXIMIZE else -1.0

    # -- encoding ----------------------------------------------------------
    def _encode(self, params: Params) -> list[float]:
        vec = []
        for name in self._names:
            hp = self.config.params[name]
            bounds = hp.to_bounds()
            value = params[name]
            if bounds is not None:
                low, high, is_log = bounds
                v = math.log(value) if is_log else float(value)
                span = (high - low) or 1.0
                vec.append((v - low) / span)
            else:
                grid = hp.to_grid()
                vec.append(grid.index(value) / max(len(grid) - 1, 1)
                           if value in grid else 0.5)
        return vec

    def _sample_candidates(self, n: int) -> list[Params]:
        return [
            {name: hp.sample(self.rng) for name, hp in self.config.params.items()}
            for _ in range(n)
        ]

    # -- public API --------------------------------------------------------
    def initial_suggestions(self) -> list[Params]:
        return self._sample_candidates(self.config.num_initial_runs)

    def get_suggestions(
        self, observations: list[Observation], count: int = 1,
        n_candidates: int = 2000,
    ) -> list[Params]:
        usable = [o for o in observations if o.usable]
        if len(usable) < max(2, min(self.config.num_initial_runs, 2)):
            return self._sample_candidates(count)
        x = np.array([self._encode(o.params) for o in usable])
        y = np.array([self._sign * o.metric for o in usable])
        try:
            self.gp.fit(x, y)
        except np.linalg.LinAlgError:
            return self._sample_candidates(count)
        best = float(y.max())
        picked: list[Params] = []
        for _ in range(count):
            candidates = self._sample_candidates(n_candidates)
            cx = np.array([self._encode(c) for c in candidates])
            mean, std = self.gp.predict(cx)
            scores = acquisition(self.acq_kind, mean, std, best,
                                 kappa=self.kappa, eps=self.eps)
            order = np.argsort(-scores)
            for idx in order:
                cand = candidates[int(idx)]
                if cand not in picked and all(cand != o.params for o in usable):
                    picked.append(cand)
                    break
            else:
                picked.append(candidates[int(order[0])])
        return picked

    def is_done(self, observations: list[Observation]) -> bool:
        finished = len([o for o in observations if o.status != "preempted"])
        return finished >= self.config.num_initial_runs + self.config.max_iterations
