"""GPipe pipeline parallelism over the ``pp`` mesh axis (port of
``polyaxon_tpu/parallel/pipeline.py``).

Stage ``s`` of ``n`` runs layers ``[s·L/n, (s+1)·L/n)`` on every
microbatch; activations move stage to stage by point-to-point sends
(``ops/ring.py``'s ``ppermute``: an autograd Function whose backward
sends the gradient back), one rotation of the pp group per tick:

    tick t: stage 0 takes microbatch t; every stage applies its layers;
    outputs rotate (i → i+1); after n-1 warm-up ticks the last stage
    finishes one microbatch per tick (bubble (n-1)/(T+n-1)).

``double_buffer=True`` is the JAX package's second schedule: each tick
sends the PREVIOUS tick's output while the stage computes on what
arrived two ticks before, so stage ``s`` sees microbatch ``m`` at tick
``m + 2s``. Both give the same per-microbatch outputs, bit for bit: the
schedule moves ticks, not values.

Each rank runs only its own stage's work: the JAX package runs every
stage's function on every tick (one SPMD program) and keeps the valid
ticks; here a stage computes on a tick only where it holds a real
microbatch and sends zeros otherwise. Every transfer threads
``ops/ring.py``'s ordering token, so that the stages, which build
different graphs, run their transfers' backwards in the same order; the
token comes back as the call's ``tail``, which ``from_last_stage`` takes
in, so that a stage whose graph ends in a send still runs its backward.

The other axes run inside a stage, as the JAX package leaves them to
GSPMD around its ``shard_map`` over pp: each rank's stage computes on
its own shards (fsdp gathers at use, tp and sp shards, the cp ring over
its own cp group, whose transfers thread the same token:
``ops/ring.py shared_order``), and a send carries each rank's shard to
the rank of the next stage with the same coordinates on every other
axis (the pp group of this rank's coordinates).

The last stage's output is the layers' output. The head and the loss
run there, and ``from_last_stage`` broadcasts the result to the pp group
(every rank reports it); its backward hands the last stage its own
gradient and every stage a zero for the tail.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


def stack_stages(layer_params: dict, n_stages: int) -> dict:
    """[L, ...] stacked layer params → [n_stages, L/n_stages, ...]."""

    def split(leaf):
        L = leaf.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not divide into {n_stages} "
                             "stages")
        return leaf.reshape((n_stages, L // n_stages) + tuple(leaf.shape[1:]))

    return {k: (stack_stages(v, n_stages) if isinstance(v, dict)
                else split(v)) for k, v in layer_params.items()}


def _select(tree: dict, stage: int) -> dict:
    return {k: (_select(v, stage) if isinstance(v, dict) else v[stage])
            for k, v in tree.items()}


def _first_leaf(tree: dict):
    v = next(iter(tree.values()))
    return _first_leaf(v) if isinstance(v, dict) else v


def _microbatches(x: torch.Tensor, n_microbatches: int) -> tuple:
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} must divide into {n_microbatches} "
                         "microbatches")
    return x.reshape((n_microbatches, batch // n_microbatches)
                     + tuple(x.shape[1:])).unbind(0)


def _schedule(stage_fn: Callable, stages: dict, micro: tuple,
              n_stages: int, double_buffer: bool, transfer: Callable
              ) -> Optional[torch.Tensor]:
    """The tick schedule (module docstring) of the stages this process
    computes: ``stages`` maps each of them, in order, to its layers, and
    ``transfer(sent)`` gives what each receives of what each sends (one
    rotation of the pp group). Returns the last stage's output [B, ...]
    where this process computes it, else None."""
    held = list(stages)
    lag = 2 if double_buffer else 1
    total = len(micro) + lag * (n_stages - 1)
    zero = torch.zeros_like(micro[0])
    arrived = to_send = [zero] * len(held)
    last = []
    for t in range(total):
        outs = []
        for i, s in enumerate(held):
            m = t - lag * s  # the microbatch stage s holds now
            x_in = micro[min(t, len(micro) - 1)] if s == 0 else arrived[i]
            outs.append(stage_fn(stages[s], x_in)
                        if 0 <= m < len(micro) else zero)
        last.append(outs[-1])
        if t < total - 1:
            # Double-buffered, last tick's output is sent while this tick
            # computes; what arrives is used on the next tick.
            arrived = transfer(to_send if double_buffer else outs)
            to_send = outs
    if held[-1] != n_stages - 1:
        return None
    return torch.cat(last[lag * (n_stages - 1):], dim=0)


def pipeline_forward(mesh, stage_fn: Callable, stacked_params: dict,
                     x: torch.Tensor, *, n_microbatches: int,
                     axis_name: str = "pp", double_buffer: bool = False
                     ) -> tuple[Optional[torch.Tensor], torch.Tensor]:
    """Run ``stage_fn(local_params, x_mb)`` as a GPipe schedule over
    ``axis_name``: ``stacked_params`` leaves are ``[n_stages, ...]``
    (``stack_stages``) and ``x`` [B, ...] is stage 0's input. Returns
    (the last stage's output [B, ...] on the last stage, None on the
    others; the ordering token's tail, for ``from_last_stage``)."""
    from polyaxon_tpu_torch.ops.ring import _Axis, ppermute, shared_order

    micro = _microbatches(x, n_microbatches)
    n_stages = mesh.shape.get(axis_name, 1)
    stacked_dim = _first_leaf(stacked_params).shape[0]
    if stacked_dim != n_stages:
        raise ValueError(
            f"stacked params declare {stacked_dim} stages but mesh axis "
            f"`{axis_name}` has {n_stages} devices — they must match "
            "(a mismatch would silently drop layers)")
    axis = _Axis(mesh, axis_name)
    rotate = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    try:
        with shared_order(axis):
            out = _schedule(stage_fn,
                            {axis.index: _select(stacked_params, axis.index)},
                            micro, n_stages, double_buffer,
                            lambda sent: [ppermute(sent[0], axis, rotate)])
        tail = axis.token
    finally:
        # The token's node holds the transfers' contexts, which hold the
        # axis: drop it, or the cycle keeps the activations alive.
        axis.token = None
    return out, tail


def replay_pipeline(stage_fn: Callable, stacked_params: dict,
                    x: torch.Tensor, *, n_microbatches: int, n_stages: int,
                    double_buffer: bool = False) -> torch.Tensor:
    """``pipeline_forward``'s schedule for every stage in one process,
    each transfer the rotation it performs (stage s receives what stage
    s - 1 sends). Returns the last stage's output [B, ...]; equals the
    layers applied to each microbatch."""
    return _schedule(stage_fn, {s: _select(stacked_params, s)
                                for s in range(n_stages)},
                     _microbatches(x, n_microbatches), n_stages,
                     double_buffer,
                     lambda sent: [sent[s - 1] for s in range(n_stages)])


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, tail, src, group, is_src):
        ctx.is_src, ctx.tail_device = is_src, tail.device
        out = value.detach().clone().contiguous()
        dist.broadcast(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return ((g if ctx.is_src else None),
                torch.zeros((), device=ctx.tail_device), None, None, None)


def from_last_stage(value: Optional[torch.Tensor], tail: torch.Tensor,
                    shape, dtype, device, mesh, axis_name: str = "pp"
                    ) -> torch.Tensor:
    """``value`` of the last stage on every rank of the pp group (the
    others pass None; ``shape``, ``dtype`` and ``device`` make their
    buffer). The
    backward gives the last stage its gradient and feeds ``tail``, so
    that every stage runs its transfers' backwards."""
    from polyaxon_tpu_torch.parallel.mesh import axis_ranks

    ranks = axis_ranks(mesh, axis_name)
    is_src = value is not None
    if not is_src:
        value = torch.zeros(shape, dtype=dtype, device=device)
    return _FromLast.apply(value, tail, ranks[-1], mesh.group(axis_name),
                           is_src)
