"""Sharded parameters at compute time: the model's view of a placed
state, gather at use, and gradient reduction.

The train state's parameters are DTensors placed by the rule tables
(``parallel/sharding.py``). Model code sees plain tensors only:

- a leaf replicated on every mesh axis is its local tensor;
- a leaf's shards on a *local* axis stay local: ``ep`` always (the MoE
  experts are computed where they live), and ``tp`` for a family that
  computes on its tensor-parallel shards (``ModelDef.tensor_parallel``:
  the llama block and MoE, through ``parallel/tensor.py``);
- shards on any other axis are gathered: under a stacked-layers key
  (``ModelDef.layer_stacks``) the leaf stays a ``ShardedStack``;
  ``unstack`` (``models/common.py``) cuts it into per-layer
  ``ShardedSlice``s and the per-layer body gathers each at its start
  (``gather_args``, applied by ``remat_body``), so only one layer's full
  weights exist at a time and a layer recomputed under remat gathers
  again, as GSPMD does inside the JAX package's scan; any other sharded
  leaf is gathered whole when the view is built. A family that computes
  replicated over ``tp`` (t5, bert, vit, resnet, mnist) thus gathers its
  tp shards, and every family gathers its ``sp`` shards (the
  ``"seq"``-tagged position tables).

Gathers are ``all_gather`` forward and ``reduce_scatter`` backward over
the axis's group: a sum where the ranks computed different rows, a mean
over a *replica* axis (``tp``, ``sp``: ranks that computed the same
rows, and so the same full gradient). Under cp the ranks of one fsdp
group build different ring graphs (``ops/ring.py``), but a layer's
gathers are made before its body, and autograd runs the ready node made
last first: every rank reaches a layer's reduce-scatters after the whole
body's backward, in the same order.

The local tensors come from ``to_local`` with gradient placements per
mesh axis: ``Shard`` where the leaf is sharded, ``Replicate`` on a
replica axis (its ranks hold the same gradient: summing would count it
once per rank) and ``Partial`` elsewhere: the batch axes, cp for a
family that shards sequences, and pp when the model is pipelined (a
stage's layers, the embedding and the head have a gradient on one stage
only, and the sum assembles them; under pp every stage holds the whole
layer stack, as the reference stores it, and gathers and
reduce-scatters only its own stage's layers' fsdp shards). A leaf that
tp would shard but the composed rules leave whole over tp is computed
on each rank's tp share (``_tp_share``), so its gradient is Partial
over tp.
``reduce_grads`` brings each gradient to the parameter's own
placements: one all-reduce per Partial axis, on the mesh's own groups
(on a one-rank mesh, no collective).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.distributed as dist

from polyaxon_tpu_torch.parallel.compat import REPLICA_AXES
from polyaxon_tpu_torch.models.common import is_quantized


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, average):
        ctx.dim, ctx.group, ctx.average = dim, group, average
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
        if ctx.average:
            out = out / n
        return out.movedim(0, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, dim: int, group,
               average: bool = False) -> torch.Tensor:
    """The full tensor from this rank's shard along ``dim``
    (differentiable: the gradient is reduce-scattered back, summed, or
    averaged when the ranks computed the same gradient)."""
    return _AllGather.apply(x, dim, group, average)


def _gather_all(local: torch.Tensor, gathers) -> torch.Tensor:
    if is_quantized(local):  # an int8 serving weight
        local = local.dequantize()
    for dim, group, average in gathers:
        local = all_gather(local, dim, group, average)
    return local


class ShardedSlice:
    """One layer's shard of a stacked parameter, gathered at use
    (``gathers``: (dim, group, average) per gathered axis)."""

    def __init__(self, local: torch.Tensor, gathers):
        self.local, self.gathers = local, gathers

    def gather(self) -> torch.Tensor:
        return _gather_all(self.local, self.gathers)


class ShardedStack:
    """A stacked ``[L, ...]`` parameter sharded on dims > 0. Its leading
    dimensions are whole, so it reshapes them and indexes them as a
    tensor does (a pipeline's ``[stages, L/stages, ...]``)."""

    def __init__(self, local: torch.Tensor, gathers):
        self.local, self.gathers = local, gathers

    @property
    def shape(self) -> torch.Size:
        """The local shape (its leading dimensions are the whole's)."""
        return self.local.shape

    def _moved(self, local: torch.Tensor) -> "ShardedStack":
        lead = local.dim() - self.local.dim()
        return ShardedStack(local, [(d + lead, g, a)
                                    for d, g, a in self.gathers])

    def reshape(self, shape) -> "ShardedStack":
        """Split the leading dimension (``shape`` ends in the sharded
        dimensions as they are)."""
        return self._moved(self.local.reshape(shape))

    def __getitem__(self, i: int) -> "ShardedStack":
        return self._moved(self.local[i])

    def unbind(self, dim: int = 0) -> tuple[ShardedSlice, ...]:
        assert dim == 0
        per_layer = [(d - 1, g, a) for d, g, a in self.gathers]
        return tuple(ShardedSlice(t, per_layer)
                     for t in self.local.unbind(0))


def gathered(v):
    """``v`` with every ``ShardedSlice`` in it gathered (plain tensors as
    they are)."""
    if isinstance(v, ShardedSlice):
        return v.gather()
    if isinstance(v, dict):
        return {k: gathered(x) for k, x in v.items()}
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
            return body(*(gathered(a) if isinstance(a, dict) else a
                          for a in args), **kwargs)

    return gathering


def _sharded_axes(t, mesh) -> list[tuple[str, int]]:
    return [(name, pl.dim) for name, pl in zip(mesh.axis_names, t.placements)
            if pl.is_shard()]


def replica_axes(model_def) -> tuple:
    """The axes whose ranks compute the same gradient for ``model_def``:
    tp and sp, cp unless the model shards sequences over it, and pp
    unless it pipelines its layers over it."""
    return (REPLICA_AXES + (() if model_def.context_parallel else ("cp",))
            + (() if model_def.pipeline_parallel else ("pp",)))


def local_axes(model_def) -> tuple:
    """The axes whose shards ``model_def`` computes on where they are."""
    return ("ep",) + (("tp",) if model_def.tensor_parallel else ())


def grad_placements(t, mesh, replicas: tuple, partial: tuple = ()) -> list:
    """Per mesh axis, where a leaf's gradient lives before reduction:
    its own shard, Replicate on a replica axis (unless in ``partial``),
    Partial (a sum over the ranks) elsewhere."""
    from torch.distributed.tensor import Partial, Replicate

    return [pl if pl.is_shard() else
            (Replicate() if name in replicas and name not in partial
             else Partial())
            for name, pl in zip(mesh.axis_names, t.placements)]


def _local_for_grad(t, mesh, replicas: tuple, partial: tuple = ()):
    if not t.requires_grad:
        return t.detach().to_local()
    return t.to_local(grad_placements=grad_placements(t, mesh, replicas,
                                                      partial))


def _tp_logical(model_def, mesh):
    """The logical axes of ``model_def``'s parameters where it computes
    on tp shards over a tp axis above 1 (``_tp_share`` reads them), else
    None."""
    if (not model_def.tensor_parallel or mesh.shape.get("tp", 1) <= 1
            or model_def.logical_axes is None):
        return None
    return model_def.logical_axes()["params"]


def _tp_share(logical, placements, mesh):
    """(dim, start, length) of this tp rank's share of a leaf that
    ``TP_RULES`` shards over tp but the mesh's composed rules leave whole
    there (``CP_RULES`` puts ``heads`` back to None, ``EP_RULES`` each
    expert's ``mlp``), else None. A family that computes on tp shards
    takes that share at use, as if the leaf were sharded, so that the
    rank's heads and ``mlp`` columns meet their partners' shards; the
    leaf's gradient is then a sum over tp of the ranks' shares."""
    from polyaxon_tpu_torch.parallel.mesh import axis_rank
    from polyaxon_tpu_torch.parallel.sharding import TP_RULES

    if logical is None:
        return None
    tp_at = mesh.axis_names.index("tp")
    if placements[tp_at].is_shard():
        return None
    names = {name for name, target in TP_RULES if target == "tp"}
    for dim, name in enumerate(logical):
        if name in names:
            return dim, axis_rank(mesh, "tp"), mesh.shape["tp"]
    return None


def _take_share(t, share):
    if share is None:
        return t
    dim, idx, n = share
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of a {tuple(t.shape)} leaf does "
                         f"not divide over tp={n}")
    return t.narrow(dim, idx * (size // n), size // n)


def model_view(model_def, params: Any, mesh) -> Any:
    """The plain-tensor tree ``model_def`` computes with (module
    docstring): its stacks gathered per layer, its local axes kept and
    its replica axes' gradients Replicate; a tp share taken at use where
    the rules leave a tp-sharded axis whole (``_tp_share``)."""
    from torch.distributed.tensor import DTensor

    stacks, kept = model_def.layer_stacks, local_axes(model_def)
    replicas = replica_axes(model_def)
    tp_logical = _tp_logical(model_def, mesh)

    def view(t, top, logical):
        if not isinstance(t, DTensor):
            return t
        share = _tp_share(logical, t.placements, mesh)
        out = _take_share(_local_for_grad(
            t, mesh, replicas, ("tp",) if share is not None else ()), share)
        gathers = [(dim, mesh.group(name), name in replicas)
                   for name, dim in _sharded_axes(t, mesh)
                   if name not in kept]
        if not gathers:
            return out
        if top in stacks and all(dim > 0 for dim, _, _ in gathers):
            return ShardedStack(out, gathers)
        return _gather_all(out, gathers)

    def walk(tree, top, logical):
        if isinstance(tree, dict):
            return {k: walk(v, top if top is not None else k,
                            None if logical is None else logical[k])
                    for k, v in tree.items()}
        return view(tree, top, logical)

    return walk(params, None, tp_logical)


def serving_view(model_def, pieces: Any, placements: Any, mesh) -> Any:
    """``model_view`` of a serving tree, which holds each leaf's local
    piece (a tensor, or an int8 ``QuantizedTensor``) beside its
    placements instead of DTensors: the same gathers at use, no
    gradient. An int8 piece that is gathered is dequantized first (the
    scales of its columns are its own; along the contraction axis they
    are one all-reduced maximum)."""
    stacks, kept = model_def.layer_stacks, local_axes(model_def)
    tp_logical = _tp_logical(model_def, mesh)

    def view(t, pl, top, logical):
        t = _take_share(t, _tp_share(logical, pl, mesh))
        gathers = [(p.dim, mesh.group(name), False)
                   for name, p in zip(mesh.axis_names, pl)
                   if p.is_shard() and name not in kept]
        if not gathers:
            return t
        if top in stacks and all(dim > 0 for dim, _, _ in gathers):
            return ShardedStack(t, gathers)
        return _gather_all(t, gathers)

    def walk(tree, pls, top, logical):
        if isinstance(tree, dict):
            return {k: walk(v, pls[k], top if top is not None else k,
                            None if logical is None else logical[k])
                    for k, v in tree.items()}
        return view(tree, pls, top, logical)

    return walk(pieces, placements, None, tp_logical)


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


def reduce_grads(params: list, mesh, replicas: tuple
                 ) -> list[torch.Tensor]:
    """Each parameter's gradient reduced to the parameter's placements,
    as local tensors: summed over each mesh axis where its gradient is
    still Partial, one all-reduce per axis in mesh order. The gradient's
    own placements say where (``grad_placements`` at the view, but
    autograd may already have reduced one: on CUDA a convolution
    weight's gradient arrives Replicate). Where none flowed on this rank
    (a leaf another pipeline stage uses) it is zeros, reduced all the
    same, so that every rank joins every leaf's collectives. Plain
    parameters (no mesh) give their gradients as they are."""
    from torch.distributed.tensor import DTensor

    out = []
    for p in params:
        g = p.grad
        if isinstance(g, DTensor):
            placements, g = g.placements, g.to_local()
        else:
            g = torch.zeros_like(local(p)) if g is None else g
            placements = (grad_placements(p, mesh, replicas)
                          if isinstance(p, DTensor) else ())
        if mesh is not None and mesh.size > 1:
            for name, pl in zip(mesh.axis_names, placements):
                if pl.is_partial() and mesh.shape[name] > 1:
                    dist.all_reduce(g, group=mesh.group(name))
        out.append(g)
    return out


def shard_layout(params: list, mesh) -> list:
    """Per parameter, what the optimizer needs to treat its local piece
    as the whole leaf (``runtime/optim.py Layout``): the global shape
    and (dim, group) of each mesh axis that shards it."""
    return [(tuple(p.shape),
             tuple((dim, mesh.group(name))
                   for name, dim in _sharded_axes(p, mesh)))
            if hasattr(p, "placements") else (tuple(p.shape), ())
            for p in params]


def global_norm(params: list, grads: list[torch.Tensor], mesh
                ) -> torch.Tensor:
    """sqrt of the sum of squares of the full gradients, in f32. Leaves
    are summed by the set of axes they are sharded on, and each such sum
    over those axes' groups only: a shard counts once, and a leaf
    replicated on an axis (a tp-replicated norm, any leaf under pp) is
    counted once, not once per rank."""
    by_axes: dict[tuple, torch.Tensor] = {}
    for p, g in zip(params, grads):
        s = g.to(torch.float32).square().sum()
        axes = (tuple(sorted(name for name, _ in _sharded_axes(p, mesh)))
                if hasattr(p, "placements") else ())
        by_axes[axes] = s if axes not in by_axes else by_axes[axes] + s
    total = None
    for axes in sorted(by_axes):
        s = by_axes[axes]
        for name in axes:
            dist.all_reduce(s, group=mesh.group(name))
        total = s if total is None else total + s
    return torch.sqrt(total)
