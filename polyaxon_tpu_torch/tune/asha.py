"""Asynchronous Successive Halving — ASHA (Li et al., MLSys 2020).

Pure promotion/sampling state machine, mirroring the tune/ manager
split: the scheduler owns IO and trial lifecycle (_tick_asha), this
module owns the math. The async rule: a COMPLETED trial at rung k is
promotable to rung k+1 iff it ranks in the top ``floor(n_completed /
eta)`` of the trials completed at rung k so far. No rung barrier — a
promotion can happen while siblings are still running, and preempted
trials (requeued in place by the scheduler) never stall anyone.

Port of ``polyaxon_tpu/tune/asha.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import random
from typing import Any, Optional

from polyaxon_tpu_torch.polyflow.matrix import V1Asha, V1Optimization
from polyaxon_tpu_torch.tune.base import Params


class AshaManager:
    def __init__(self, config: V1Asha):
        self.config = config
        self.rungs = config.rung_resources()

    def n_rungs(self) -> int:
        return len(self.rungs)

    def sample_params(self, index: int,
                      base_seed: Optional[int] = None) -> Params:
        """Deterministic draw for bottom-rung trial ``index`` — stable
        under manager re-instantiation (the scheduler rebuilds every
        tick). For unseeded sweeps the scheduler draws a random base
        seed ONCE and persists it in the tuner meta, so distinct sweeps
        explore distinct points while each sweep stays tick-stable."""
        if base_seed is None:
            base_seed = self.config.seed if self.config.seed is not None else 0
        rng = random.Random((base_seed << 20) + index)
        return {name: hp.sample(rng)
                for name, hp in self.config.params.items()}

    def promotable(
        self,
        completed: list[tuple[str, Params, Optional[float]]],
    ) -> list[str]:
        """Trial ids (among ``completed`` at one rung) that currently
        rank in the top ``floor(n/eta)`` by the sweep metric. Trials
        without a usable metric (failed) rank worst and are never
        promoted."""
        usable = [(uid, m) for uid, _, m in completed if m is not None]
        k = int(len(completed) // self.config.eta)
        if k < 1 or not usable:
            return []
        maximize = (self.config.metric.optimization
                    == V1Optimization.MAXIMIZE)
        usable.sort(key=lambda t: t[1], reverse=maximize)
        return [uid for uid, _ in usable[:k]]
