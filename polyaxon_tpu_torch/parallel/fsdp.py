"""Sharded parameters at compute time: the model's view of a placed
state, gather at use, and gradient reduction.

The train state's parameters are DTensors placed by the rule tables
(``parallel/sharding.py``). Model code sees plain tensors only:

- a leaf replicated on every mesh axis is its local tensor;
- a leaf sharded over ``fsdp`` under a stacked-layers key
  (``ModelDef.layer_stacks``) stays a ``ShardedStack``: ``unstack``
  (``models/common.py``) cuts it into per-layer ``ShardedSlice``s and
  the per-layer body gathers each at its start (``gather_args``, applied
  by ``remat_body``), so only one layer's full weights exist at a time
  and a layer recomputed under remat gathers again, as GSPMD does inside
  the JAX package's scan;
- any other sharded leaf is gathered whole when the view is built.

Gathers are ``all_gather`` forward and ``reduce_scatter`` backward over
the axis's group. Under cp the ranks of one fsdp group build different
ring graphs (``ops/ring.py``), but a layer's gathers are made before its
body, and autograd runs the ready node made last first: every rank
reaches a layer's reduce-scatters after the whole body's backward, in
the same order. The local tensors come from ``to_local`` with
``Partial`` gradients on the replicated axes, so every parameter's
gradient arrives as a DTensor that sums over the ranks; ``reduce_grads``
redistributes it to the parameter's own placements (an all-reduce over
dp and cp; on a one-rank mesh, no collective).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.distributed as dist


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        full = g.movedim(ctx.dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // n, *full.shape[1:]))
        dist.reduce_scatter_tensor(out, full, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor from this rank's shard along ``dim``
    (differentiable: the gradient is reduce-scattered back)."""
    return _AllGather.apply(x, dim, group)


class ShardedSlice:
    """One layer's shard of a stacked parameter, gathered at use."""

    def __init__(self, local: torch.Tensor, dim: int, group):
        self.local, self.dim, self.group = local, dim, group

    def gather(self) -> torch.Tensor:
        return all_gather(self.local, self.dim, self.group)


class ShardedStack:
    """A stacked ``[L, ...]`` parameter sharded on ``dim`` (> 0)."""

    def __init__(self, local: torch.Tensor, dim: int, group):
        self.local, self.dim, self.group = local, dim, group

    def unbind(self, dim: int = 0) -> tuple[ShardedSlice, ...]:
        assert dim == 0
        return tuple(ShardedSlice(t, self.dim - 1, self.group)
                     for t in self.local.unbind(0))


def _gather_value(v):
    if isinstance(v, ShardedSlice):
        return v.gather()
    if isinstance(v, dict):
        return {k: _gather_value(x) for k, x in v.items()}
    return v


def gather_args(body):
    """``body`` with every ``ShardedSlice`` in its dict arguments
    gathered first (a no-op for plain tensors), run under the mesh that
    was current when it was wrapped: a layer recomputed under remat runs
    on autograd's device thread, which does not see the caller's
    context (ring attention reads its mesh there)."""
    from polyaxon_tpu_torch.parallel.mesh import current_mesh, use_mesh

    mesh = current_mesh()

    @functools.wraps(body)
    def gathering(*args, **kwargs):
        with use_mesh(mesh):
            return body(*(_gather_value(a) if isinstance(a, dict) else a
                          for a in args), **kwargs)

    return gathering


def _sharded_axes(t, mesh) -> list[tuple[str, int]]:
    return [(name, pl.dim) for name, pl in zip(mesh.axis_names, t.placements)
            if pl.is_shard()]


def _local_for_grad(t):
    """The local tensor, its gradient marked Partial on the replicated
    axes (the sharded ones come back already reduce-scattered)."""
    from torch.distributed.tensor import Partial

    if not t.requires_grad:
        return t.detach().to_local()
    return t.to_local(grad_placements=[
        pl if pl.is_shard() else Partial() for pl in t.placements])


def model_view(params: Any, mesh, stacks: tuple = ()) -> Any:
    """The plain-tensor tree the model computes with (module docstring)."""
    from torch.distributed.tensor import DTensor

    def view(t, top):
        if not isinstance(t, DTensor):
            return t
        local = _local_for_grad(t)
        sharded = _sharded_axes(t, mesh)
        if (len(sharded) == 1 and top in stacks and sharded[0][1] > 0):
            name, dim = sharded[0]
            return ShardedStack(local, dim, mesh.group(name))
        for name, dim in sharded:
            local = all_gather(local, dim, mesh.group(name))
        return local

    def walk(tree, top):
        if isinstance(tree, dict):
            return {k: walk(v, top if top is not None else k)
                    for k, v in tree.items()}
        return view(tree, top)

    return walk(params, None)


def local(t):
    """A DTensor's local tensor (sharing storage, no grad), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.detach().to_local() if isinstance(t, DTensor) else t


def local_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [local_tree(v) for v in tree]
    return local(tree)


def reduce_grads(params: list, mesh) -> list[torch.Tensor]:
    """Each parameter's gradient reduced to the parameter's placements
    (a sum over the ranks), as local tensors; zeros where none flowed.
    Plain parameters (no mesh) give their gradients as they are."""
    from torch.distributed.tensor import DTensor

    out = []
    for p in params:
        g = p.grad
        if g is None:
            out.append(torch.zeros_like(local(p)))
            continue
        if mesh is not None and mesh.size > 1:
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g.to_local() if isinstance(g, DTensor) else g)
    return out


def global_norm(params: list, grads: list[torch.Tensor], mesh
                ) -> torch.Tensor:
    """sqrt of the sum of squares of the full gradients, in f32: a
    sharded leaf's local sum is summed over its axis's group."""
    total = None
    sharded = None
    for p, g in zip(params, grads):
        s = g.to(torch.float32).square().sum()
        axes = _sharded_axes(p, mesh) if hasattr(p, "placements") else []
        if axes:
            sharded = s if sharded is None else sharded + s
        else:
            total = s if total is None else total + s
    if sharded is not None:
        names = {name for p in params if hasattr(p, "placements")
                 for name, _ in _sharded_axes(p, mesh)}
        for name in sorted(names):
            dist.all_reduce(sharded, group=mesh.group(name))
        total = sharded if total is None else total + sharded
    return torch.sqrt(total)
