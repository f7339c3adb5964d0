"""Learning-rate schedules and optimizers (port of
``polyaxon_tpu/runtime/optim.py``, which builds optax chains).

The arithmetic is optax's, written out: the schedule is read at the
update count starting from 0 (so the first update under warmup uses
lr 0), Adam's bias correction uses count + 1 and puts eps outside the
square root, adamw decays every parameter, sgd keeps a 0.9 momentum
trace, and ``clip_by_global_norm`` scales by ``max_norm / norm`` only
when ``norm >= max_norm``, with no epsilon (torch's ``clip_grad_norm_``
adds 1e-6). Unlike optax's pure functions, ``Optimizer.update`` changes
the parameters, gradients and moments in place, which keeps one copy of
each on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

Schedule = Callable[[int], float]

# optax's defaults for the optimizers the JAX package builds.
B1 = 0.9
EPS = 1e-8
MOMENTUM = 0.9


def _constant(value: float) -> Schedule:
    return lambda count: value


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``steps``, then end."""
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    def schedule(count: int) -> float:
        frac = min(count, steps) / steps
        return init * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


def build_schedule(cfg) -> Schedule:
    base = cfg.learning_rate
    decay_steps = max(cfg.steps - cfg.warmup_steps, 1)
    if cfg.lr_schedule == "constant":
        sched = _constant(base)
    elif cfg.lr_schedule == "cosine":
        sched = _cosine(base, decay_steps)
    elif cfg.lr_schedule == "linear":
        sched = _linear(base, 0.0, decay_steps)
    else:
        raise ValueError(f"Unknown lr_schedule `{cfg.lr_schedule}`")
    if cfg.warmup_steps > 0:
        warmup, boundary, after = (_linear(0.0, base, cfg.warmup_steps),
                                   cfg.warmup_steps, sched)
        # optax.join_schedules: the second schedule restarts its count.
        sched = (lambda count: warmup(count) if count < boundary
                 else after(count - boundary))
    return sched


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """A nested dict's tensors in insertion order."""
    out = []
    for value in tree.values():
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32."""
    return torch.sqrt(sum(t.to(torch.float32).square().sum()
                          for t in tensors))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """In place: ``g / norm * max_norm`` when ``norm >= max_norm``
    (decided on the device: no host sync)."""
    norm = global_norm(grads) if norm is None else norm
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


@dataclasses.dataclass
class Optimizer:
    """One of adamw, adam, sgd, with an optional global-norm clip
    before it (the order of the JAX package's optax chain)."""

    kind: str  # adamw | adam | sgd
    schedule: Schedule
    clip_norm: Optional[float] = None
    weight_decay: float = 0.0
    b2: float = 0.999  # adamw: 0.95

    def init(self, params: dict) -> dict:
        leaves = tree_leaves(params)
        zeros = lambda: [torch.zeros_like(p) for p in leaves]  # noqa: E731
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, params: dict, grads: list[torch.Tensor], state: dict,
               grad_norm: Optional[torch.Tensor] = None) -> None:
        """One update, in place on ``params``' tensors, ``grads`` (when
        clipped) and ``state``. ``grads`` follow ``tree_leaves(params)``;
        ``grad_norm`` may pass their global norm when already known."""
        leaves = tree_leaves(params)
        if self.clip_norm:
            clip_by_global_norm(grads, self.clip_norm, grad_norm)
        count = state["count"]
        lr = self.schedule(count)
        state["count"] = count + 1
        if self.kind == "sgd":
            for p, g, tr in zip(leaves, grads, state["trace"]):
                tr.mul_(MOMENTUM).add_(g)
                p.add_(tr, alpha=-lr)
            return
        bc1 = 1.0 - B1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (mu / bc1).div_((nu / bc2).sqrt_().add_(EPS))
            if self.weight_decay:
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)


def build_optimizer(cfg) -> Optimizer:
    sched = build_schedule(cfg)
    name = cfg.optimizer.lower()
    clip = cfg.grad_clip_norm or None
    if name == "adamw":
        return Optimizer("adamw", sched, clip, weight_decay=cfg.weight_decay,
                         b2=0.95)
    if name == "adam":
        return Optimizer("adam", sched, clip)
    if name == "sgd":
        return Optimizer("sgd", sched, clip)
    if name in ("lion", "adafactor"):
        raise NotImplementedError(
            f"optimizer `{name}` is not ported yet: ROADMAP.md, Queue 1 "
            "item 3b")
    raise ValueError(f"Unknown optimizer `{cfg.optimizer}`")
