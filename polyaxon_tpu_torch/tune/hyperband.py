"""Hyperband successive halving (Li et al., JMLR 2018) — [B] names it as
a core Polytune capability; bracket math per the paper:

    s_max = floor(log_eta R);  B = (s_max+1) R
    bracket s: n = ceil((s_max+1) eta^s / (s+1)),  r = R eta^-s
    rung i in bracket s: n_i = floor(n eta^-i) configs at r_i = r eta^i

Preemption-safe rung accounting (SURVEY.md §7 hard-part 4): a PREEMPTED
trial is *re-issued with the same params and budget* instead of scoring
as a failure — failures score as worst, preemptions never poison the
bracket.

Port of ``polyaxon_tpu/tune/hyperband.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Optional

from polyaxon_tpu_torch.polyflow.matrix import V1Hyperband
from polyaxon_tpu_torch.tune.base import Observation, Params, top_k


@dataclasses.dataclass
class Rung:
    bracket: int
    rung: int
    n_configs: int
    resource: int | float
    suggestions: list[Params]


class HyperbandManager:
    def __init__(self, config: V1Hyperband):
        self.config = config
        self.rng = random.Random(config.seed)

    # -- static structure --------------------------------------------------
    def brackets(self) -> list[int]:
        """Bracket ids, most exploratory first (s_max → 0)."""
        return list(range(self.config.s_max, -1, -1))

    def rungs_in_bracket(self, s: int) -> int:
        return s + 1

    def rung_shape(self, s: int, i: int) -> tuple[int, int | float]:
        """(n_i, r_i) for rung ``i`` of bracket ``s``."""
        n, r = self.config.bracket(s)
        n_i = int(math.floor(n * self.config.eta ** (-i)))
        r_i = r * (self.config.eta**i)
        resource = self.config.resource.cast(
            min(r_i, self.config.max_iterations)
        )
        return max(n_i, 1), resource

    def total_trials(self) -> int:
        return sum(self.rung_shape(s, 0)[0] for s in self.brackets())

    # -- iteration ---------------------------------------------------------
    def sample_params(self, n: int, rng: Optional[random.Random] = None) -> list[Params]:
        rng = rng or self.rng
        return [
            {name: hp.sample(rng) for name, hp in self.config.params.items()}
            for _ in range(n)
        ]

    def first_rung(self, s: int) -> Rung:
        n, resource = self.rung_shape(s, 0)
        # Per-bracket RNG: deterministic under manager re-instantiation
        # (the scheduler rebuilds the manager every tick) yet distinct
        # across brackets — each bracket must draw FRESH configs.
        base_seed = self.config.seed if self.config.seed is not None else 0
        rng = random.Random((base_seed << 16) + s)
        return Rung(bracket=s, rung=0, n_configs=n, resource=resource,
                    suggestions=self.sample_params(n, rng))

    def next_rung(self, s: int, i: int, observations: list[Observation]) -> Optional[Rung]:
        """Promote the top 1/eta of rung ``i`` into rung ``i+1``; None when
        the bracket is exhausted."""
        if i + 1 > s:
            return None
        n_next, resource = self.rung_shape(s, i + 1)
        survivors = top_k(observations, self.config.metric, n_next)
        if not survivors:
            return None
        return Rung(
            bracket=s, rung=i + 1, n_configs=len(survivors), resource=resource,
            suggestions=[dict(o.params) for o in survivors],
        )

    def reissue_preempted(self, observations: list[Observation]) -> list[Params]:
        """Params of preempted trials to requeue at the same rung."""
        return [dict(o.params) for o in observations if o.status == "preempted"]

    def resource_param(self) -> str:
        return self.config.resource.name
