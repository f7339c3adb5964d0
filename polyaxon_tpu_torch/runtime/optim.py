"""Learning-rate schedules and optimizers (port of
``polyaxon_tpu/runtime/optim.py``, which builds optax chains).

The arithmetic is optax's, written out: the schedule is read at the
update count starting from 0 (so the first update under warmup uses
lr 0), Adam's bias correction uses count + 1 and puts eps outside the
square root, adamw decays every parameter, sgd keeps a 0.9 momentum
trace, lion and adafactor take optax's defaults (``optax.lion`` and
``optax.adafactor``: the sign of an interpolated momentum with decayed
weights; factored second moments for leaves with two dims of at least
128, the decay ``1 - (count + 1) ** -0.8``, block-RMS clipping at 1 and
the step scaled by the parameter's RMS), and ``clip_by_global_norm``
scales by ``max_norm / norm`` only when ``norm >= max_norm``, with no
epsilon (torch's ``clip_grad_norm_`` adds 1e-6). ``Masked`` is
``optax.masked``: state and updates only for the leaves its mask
selects (LoRA's adapters). Unlike optax's pure functions, ``Optimizer.update`` changes
the parameters, gradients and moments in place, which keeps one copy of
each on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]

# optax's defaults for the optimizers the JAX package builds.
B1 = 0.9
EPS = 1e-8
MOMENTUM = 0.9
LION_B1, LION_B2 = 0.9, 0.99
ADAFACTOR_MIN_DIM = 128       # min_dim_size_to_factor
ADAFACTOR_DECAY = 0.8         # decay_rate
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0          # clipping_threshold (block RMS)
ADAFACTOR_MIN_SCALE = 1e-3    # scale_by_param_block_rms


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


def _factored_dims(shape) -> Optional[tuple[int, int]]:
    """optax's rule: the two largest dims (d1, d0), when the smaller of
    them is at least ``ADAFACTOR_MIN_DIM``; else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


# A leaf's layout for the optimizer: its global shape and, per sharded
# dimension, (dim, process group) of each mesh axis that shards it
# (``parallel/fsdp.py shard_layout``); ``(shape, ())`` for a whole leaf.
Layout = tuple[tuple[int, ...], tuple[tuple[int, object], ...]]


def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist

    for group in groups:
        dist.all_reduce(t, group=group)
    return t


def _mean_over(x: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    """The mean of a leaf over ``dim`` of its global shape, from this
    rank's piece: local sums all-reduced over the groups that shard
    ``dim``."""
    shape, shards = layout
    groups = [g for d, g in shards if d == dim]
    if not groups:
        return x.mean(dim)
    return _all_reduce(x.sum(dim), groups) / shape[dim]


def _rms_over(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The RMS of a whole leaf from this rank's piece."""
    shape, shards = layout
    if not shards:
        return _rms(x)
    total = _all_reduce(x.square().sum(), [g for _, g in shards])
    return (total / float(np.prod(shape))).sqrt()


def _without(layout: Layout, dim: int) -> Layout:
    """The layout of a leaf's reduction over ``dim`` (a factored second
    moment): replicated where ``dim`` was sharded (its sums were
    all-reduced), the later dimensions one lower."""
    shape, shards = layout
    return (tuple(n for i, n in enumerate(shape) if i != dim),
            tuple((d - (d > dim), g) for d, g in shards if d != dim))


def _zeros_without(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Zeros of ``p``'s shape without ``dim``; for a placed (DTensor)
    ``p``, its local piece placed as ``p`` is on the other dimensions
    and replicated on an axis that shards ``dim``."""
    shape = [n for i, n in enumerate(p.shape) if i != dim]
    if not hasattr(p, "placements"):
        return p.new_zeros(shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = p.detach().to_local()
    placements = [Replicate() if pl.is_shard() and pl.dim == dim
                  else Shard(pl.dim - (pl.dim > dim)) if pl.is_shard()
                  else pl for pl in p.placements]
    return DTensor.from_local(
        local.new_zeros([n for i, n in enumerate(local.shape) if i != dim]),
        p.device_mesh, placements, run_check=False)


@dataclasses.dataclass
class Optimizer:
    """One of adamw, adam, sgd, lion, adafactor, with an optional
    global-norm clip before it (the order of the JAX package's optax
    chain)."""

    kind: str  # adamw | adam | sgd | lion | adafactor
    schedule: Schedule
    clip_norm: Optional[float] = None
    weight_decay: float = 0.0
    b2: float = 0.999  # adamw: 0.95

    def init(self, params: dict) -> dict:
        leaves = tree_leaves(params)
        zeros = lambda: [torch.zeros_like(p) for p in leaves]  # noqa: E731
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros()}
        if self.kind == "lion":
            return {"count": 0, "mu": zeros()}
        if self.kind == "adafactor":
            v_row, v_col, v = [], [], []
            for p in leaves:
                dims = _factored_dims(tuple(p.shape))
                # A placed leaf's factored moments are placed pieces
                # too; the unused ones are one plain element.
                one = torch.zeros(1, device=p.device)
                if dims is None:
                    v_row.append(one)
                    v_col.append(one.clone())
                    v.append(torch.zeros_like(p))
                else:
                    d1, d0 = dims
                    v_row.append(_zeros_without(p, d0))
                    v_col.append(_zeros_without(p, d1))
                    v.append(one)
            return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, params: dict, grads: list[torch.Tensor], state: dict,
               grad_norm: Optional[torch.Tensor] = None,
               layout: Optional[list[Layout]] = None) -> None:
        """One update, in place on ``params``' tensors, ``grads`` (when
        clipped) and ``state``. ``grads`` follow ``tree_leaves(params)``;
        ``grad_norm`` may pass their global norm when already known.
        ``layout`` (one per leaf) is given when the tensors are pieces of
        sharded leaves: adafactor's factored moments and RMS span whole
        leaves, and are reduced over the shards."""
        self.update_leaves(tree_leaves(params), grads, state, grad_norm,
                           layout)

    @torch.no_grad()
    def update_leaves(self, leaves: list[torch.Tensor],
                      grads: list[torch.Tensor], state: dict,
                      grad_norm: Optional[torch.Tensor] = None,
                      layout: Optional[list[Layout]] = None) -> None:
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
        if self.kind == "lion":
            for p, g, mu in zip(leaves, grads, state["mu"]):
                u = torch.sign(g * (1.0 - LION_B1) + mu * LION_B1)
                if self.weight_decay:
                    u.add_(p, alpha=self.weight_decay)
                mu.mul_(LION_B2).add_(g, alpha=1.0 - LION_B2)
                p.add_(u, alpha=-lr)
            return
        if self.kind == "adafactor":
            self._adafactor(leaves, grads, state, count, lr, layout)
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

    @staticmethod
    def _adafactor(leaves, grads, state, count: int, lr: float,
                   layout: Optional[list[Layout]] = None) -> None:
        decay = 1.0 - float(np.float32(count + 1) ** np.float32(
            -ADAFACTOR_DECAY))
        for i, (p, g) in enumerate(zip(leaves, grads)):
            lay = layout[i] if layout else (tuple(p.shape), ())
            sq = g.square() + ADAFACTOR_EPS
            dims = _factored_dims(lay[0])
            if dims is None:
                v = state["v"][i]
                v.mul_(decay).add_(sq, alpha=1.0 - decay)
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][i], state["v_col"][i]
                v_row.mul_(decay).add_(_mean_over(sq, d0, lay),
                                       alpha=1.0 - decay)
                v_col.mul_(decay).add_(_mean_over(sq, d1, lay),
                                       alpha=1.0 - decay)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / _mean_over(
                    v_row, reduced_d1, _without(lay, d0)).unsqueeze(
                        reduced_d1)).rsqrt()
                u = (g * row_factor.unsqueeze(d0)
                     * v_col.rsqrt().unsqueeze(d1))
            u = u / torch.clamp(_rms_over(u, lay) / ADAFACTOR_CLIP, min=1.0)
            u = u * lr
            p_rms = _rms_over(p, lay)
            scale = torch.where(p_rms <= ADAFACTOR_MIN_SCALE,
                                torch.full_like(p_rms, ADAFACTOR_MIN_SCALE),
                                p_rms)
            p.sub_(u * scale)


class Masked:
    """``optax.masked``: ``inner`` keeps state for, and updates, only
    the leaves ``mask(params)`` marks True; the others are left as they
    are (their gradients are zero where the JAX package applies them).
    The train step hands it the gradients of the trainable leaves
    alone."""

    def __init__(self, inner: Optimizer, mask: Callable[[dict], dict]):
        self.inner = inner
        self.mask = mask

    def _selected(self, params: dict) -> list[torch.Tensor]:
        return [p for p, m in zip(tree_leaves(params),
                                  tree_leaves(self.mask(params))) if m]

    def init(self, params: dict) -> dict:
        return self.inner.init({"leaves": dict(enumerate(
            self._selected(params)))})

    def update(self, params: dict, grads: list[torch.Tensor], state: dict,
               grad_norm: Optional[torch.Tensor] = None,
               layout: Optional[list[Layout]] = None) -> None:
        """``grads`` (and ``layout``) follow the selected leaves, in tree
        order."""
        self.inner.update_leaves(self._selected(params), grads, state,
                                 grad_norm, layout)


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
    if name == "lion":
        return Optimizer("lion", sched, clip, weight_decay=cfg.weight_decay)
    if name == "adafactor":
        return Optimizer("adafactor", sched, clip)
    raise ValueError(f"Unknown optimizer `{cfg.optimizer}`")
