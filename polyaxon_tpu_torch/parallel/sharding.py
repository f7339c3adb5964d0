"""Logical-axis sharding rules (port of
``polyaxon_tpu/parallel/sharding.py``): how parameters and batches map
onto the mesh.

Models name every parameter's axes logically (``("embed", "mlp")``…);
a rule table maps logical names to mesh axes per strategy. The tables
and ``logical_to_spec`` are the JAX package's, as data: a spec here is a
``PartitionSpec`` tuple whose entries equal JAX's. ``tree_placements``
turns specs into DTensor placements (``Shard(dim)`` or ``Replicate()``
per mesh dimension) and ``distribute`` places a parameter tree by them.

The port places every axis. A few combinations of the model-parallel
axes raise (``require_ported``): ``pp`` beside any axis but ``dp``,
``tp`` beside ``cp``, ``ep`` or ``pp``, and ``ep`` beside ``fsdp``,
``cp`` or ``tp`` (ROADMAP.md, Queue 1 item 7c).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

Rules = Sequence[tuple[str, Union[None, str, tuple[str, ...]]]]

# Rule presets per strategy (the JAX package's). Logical vocabulary:
#   batch, seq, embed, vocab, heads, kv_heads, head_dim, mlp, layers,
#   conv_in, conv_out, classes, expert
FSDP_RULES: Rules = (
    ("batch", ("dp", "fsdp")),
    ("embed", "fsdp"),
    ("vocab", None),
    ("mlp", None),
    ("heads", None),
    ("kv_heads", None),
    ("seq", None),
)
DP_RULES: Rules = (("batch", ("dp", "fsdp")),)
TP_RULES: Rules = (
    ("batch", ("dp", "fsdp")),
    ("embed", "fsdp"),
    ("vocab", "tp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
)
TP_SP_RULES: Rules = TP_RULES + (("seq", "sp"),)
CP_RULES: Rules = (
    ("batch", ("dp", "fsdp")),
    ("embed", "fsdp"),
    ("seq", "cp"),
    ("heads", None),
)
EP_RULES: Rules = (
    ("batch", ("dp", "fsdp", "ep")),
    ("embed", "fsdp"),
    ("expert", "ep"),
    ("mlp", None),
)

STRATEGY_RULES: dict[str, Rules] = {
    "dp": DP_RULES,
    "fsdp": FSDP_RULES,
    "tp": TP_RULES,
    "tp_sp": TP_SP_RULES,
    "cp": CP_RULES,
    "ep": EP_RULES,
}

# Axes that the port places beside a model-parallel axis only as these
# pairs allow: the others are ROADMAP.md, Queue 1 item 7c.
REFUSED_BESIDE = {
    "pp": ("fsdp", "cp", "sp", "ep", "tp"),
    "tp": ("cp", "ep", "pp"),
    "ep": ("fsdp", "cp", "tp"),
}


class PartitionSpec(tuple):
    """Per tensor dimension: None, a mesh axis, or a tuple of them (JAX's
    ``PartitionSpec`` entries)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def require_ported(shape: dict) -> None:
    """Raise for a combination of mesh axes above 1 (a mesh's shape, or
    a spec's axes) that the port does not place yet."""
    big = {a for a, n in shape.items() if n > 1}
    for axis, refused in REFUSED_BESIDE.items():
        clash = sorted(big & set(refused)) if axis in big else []
        if clash:
            raise NotImplementedError(
                f"mesh axes {dict(shape)}: `{axis}` beside {clash} is not "
                "ported yet (ROADMAP.md, Queue 1 item 7c)")


def merge_rules(*rule_sets: Rules) -> Rules:
    """Later rule sets win per logical-axis name."""
    table: dict[str, Union[None, str, tuple[str, ...]]] = {}
    for rules in rule_sets:
        for name, target in rules:
            table[name] = target
    return tuple(table.items())


def rules_for_mesh(mesh, base: Optional[Rules] = None) -> Rules:
    """Compose the strategy rule sets of every axis above 1 in the mesh,
    in the JAX package's order; ``base`` overrides."""
    sets: list[Rules] = [DP_RULES]
    shape = mesh.shape
    if shape.get("fsdp", 1) > 1:
        sets.append(FSDP_RULES)
    if shape.get("tp", 1) > 1:
        sets.append(TP_RULES)
    if shape.get("sp", 1) > 1:
        sets.append(TP_SP_RULES)
    if shape.get("cp", 1) > 1:
        sets.append(CP_RULES)
    if shape.get("ep", 1) > 1:
        sets.append(EP_RULES)
    if base is not None:
        sets.append(base)
    return merge_rules(*sets)


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: Rules, *,
                    mesh=None) -> PartitionSpec:
    """Map logical axis names to a ``PartitionSpec``. A mesh axis shards
    at most one dimension (later uses replicate), and axes absent from
    the mesh or of size 1 resolve to replication."""
    table = dict(rules)
    mesh_shape = mesh.shape if mesh is not None else None
    used: set[str] = set()
    parts: list[Union[None, str, tuple[str, ...]]] = []
    for logical in logical_axes:
        target = table.get(logical) if logical is not None else None
        if target is None:
            parts.append(None)
            continue
        names = (target,) if isinstance(target, str) else tuple(target)
        kept = []
        for name in names:
            if name in used:
                continue
            if mesh_shape is not None and mesh_shape.get(name, 1) <= 1:
                continue
            kept.append(name)
            used.add(name)
        if not kept:
            parts.append(None)
        elif len(kept) == 1:
            parts.append(kept[0])
        else:
            parts.append(tuple(kept))
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def tree_map_axes(fn, logical_tree: Any) -> Any:
    """``fn`` over every logical-axes tuple of a nested dict/list."""
    if _is_axes_leaf(logical_tree):
        return fn(logical_tree)
    if isinstance(logical_tree, dict):
        return {k: tree_map_axes(fn, v) for k, v in logical_tree.items()}
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(tree_map_axes(fn, v) for v in logical_tree)
    raise TypeError(f"not a logical-axes tree leaf: {logical_tree!r}")


def spec_placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements, one per mesh dimension, for a spec."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            out[mesh.axis_names.index(name)] = Shard(dim)
    return out


def tree_placements(logical_tree: Any, mesh, rules: Rules) -> Any:
    """A logical-axes tree → a tree of DTensor placement lists (the JAX
    package's ``tree_shardings``)."""
    require_ported(mesh.shape)
    return tree_map_axes(
        lambda axes: spec_placements(logical_to_spec(axes, rules, mesh=mesh),
                                     mesh), logical_tree)


def batch_spec(mesh, rules: Rules, ndim: int = 2) -> PartitionSpec:
    """PartitionSpec for a [batch, ...] array (batch sharded, rest
    replicated)."""
    return logical_to_spec(("batch",) + (None,) * (ndim - 1), rules,
                           mesh=mesh)


def local_chunk(full: torch.Tensor, placements, mesh, coords: dict
                ) -> torch.Tensor:
    """This rank's piece of ``full`` under ``placements`` (even shards
    only: a dimension that does not divide raises)."""
    out = full
    for name, pl in zip(mesh.axis_names, placements):
        if not pl.is_shard():
            continue
        n = mesh.shape[name]
        if out.shape[pl.dim] % n:
            raise ValueError(
                f"dimension {pl.dim} of a {tuple(full.shape)} tensor does not "
                f"divide over mesh axis `{name}` of size {n}")
        out = out.chunk(n, dim=pl.dim)[coords[name]]
    return out


def distribute(tree: Any, placements: Any, mesh) -> Any:
    """Place a tree of full tensors (equal on every rank: drawn from one
    seed, or read from one checkpoint) as DTensors, each rank keeping its
    own chunk; no collective runs. ``requires_grad`` carries over."""
    from torch.distributed.tensor import DTensor

    from polyaxon_tpu_torch.parallel.bootstrap import rank

    dmesh = mesh.device_mesh()
    coords = mesh.coords(rank())

    def place(t, pl):
        local = local_chunk(t.detach(), pl, mesh, coords).contiguous()
        out = DTensor.from_local(local, dmesh, pl, run_check=False,
                                 shape=t.shape, stride=t.stride())
        return out.requires_grad_(t.requires_grad) if t.is_floating_point() \
            else out

    return _zip_map(place, tree, placements)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def param_bytes(params: Any) -> int:
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
