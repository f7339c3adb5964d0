"""Logical-axis sharding rules (port of
``polyaxon_tpu/parallel/sharding.py``): how parameters and batches map
onto the mesh.

Models name every parameter's axes logically (``("embed", "mlp")``…);
a rule table maps logical names to mesh axes per strategy. The tables
and ``logical_to_spec`` are the JAX package's, as data: a spec here is a
``PartitionSpec`` tuple whose entries equal JAX's. ``tree_placements``
turns specs into DTensor placements (``Shard(dim)`` or ``Replicate()``
per mesh dimension) and ``distribute`` places a parameter tree by them.

The port places every axis and every combination of them, as GSPMD
places any family over any mesh by the same tables: each axis's
mechanism runs inside the others' (``parallel/fsdp.py``,
``parallel/pipeline.py``, ``parallel/tensor.py``, ``ops/ring.py``).
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

class PartitionSpec(tuple):
    """Per tensor dimension: None, a mesh axis, or a tuple of them (JAX's
    ``PartitionSpec`` entries)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


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


def serving_rules(mesh) -> Rules:
    """The rules sharded serving places a model's weights by: the mesh's
    (``rules_for_mesh`` over the family's logical axes, as the JAX
    server's ``load_params`` places them), over any mesh."""
    return rules_for_mesh(mesh)


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
    return tree_map_axes(
        lambda axes: spec_placements(logical_to_spec(axes, rules, mesh=mesh),
                                     mesh), logical_tree)


def batch_spec(mesh, rules: Rules, ndim: int = 2) -> PartitionSpec:
    """PartitionSpec for a [batch, ...] array (batch sharded, rest
    replicated)."""
    return logical_to_spec(("batch",) + (None,) * (ndim - 1), rules,
                           mesh=mesh)


class _LeafShard:
    """One leaf's shard on this rank: its local shape, and each slab's
    piece (``take``)."""

    def __init__(self, shape: tuple, ranges: dict):
        self.full = tuple(shape)
        self.ranges = ranges  # dim -> (first index, length) kept here
        self.shape = tuple(ranges.get(d, (0, n))[1]
                           for d, n in enumerate(shape))

    def take(self, slab: torch.Tensor, *lead: int):
        """(local leading index, this rank's piece of ``slab``) for the
        slab at global leading indices ``lead`` (a layer, or a layer and
        an expert, of a stacked leaf; none for a whole leaf), or None when
        the slab lies outside this rank's shard. The piece is a copy, so
        the slab's memory goes with it."""
        where = []
        for d, i in enumerate(lead):
            lo, n = self.ranges.get(d, (0, self.full[d]))
            if not lo <= i < lo + n:
                return None
            where.append(i - lo)
        piece = slab
        for d, (lo, n) in self.ranges.items():
            if d >= len(lead):
                piece = piece.narrow(d - len(lead), lo, n)
        if piece is slab:
            return tuple(where), slab
        return tuple(where), piece.clone(memory_format=torch.contiguous_format)


def leaf_shard(shape, placements, mesh, coords: dict,
               what: str = "a tensor") -> _LeafShard:
    """The shard of a leaf of ``shape`` that the rank at ``coords`` holds
    under ``placements`` (even shards only: a dimension that does not
    divide raises)."""
    ranges: dict = {}
    for name, pl in zip(mesh.axis_names, placements):
        if not pl.is_shard():
            continue
        lo, n = ranges.get(pl.dim, (0, shape[pl.dim]))
        k = mesh.shape[name]
        if n % k:
            raise ValueError(
                f"dimension {pl.dim} of {what} {tuple(shape)} does not "
                f"divide over mesh axis `{name}` of size {k}")
        ranges[pl.dim] = (lo + coords[name] * (n // k), n // k)
    return _LeafShard(tuple(shape), ranges)


class ShardTaker:
    """Each rank's shards of a parameter tree drawn or read one slab at a
    time: ``leaf(path, shape)`` gives a leaf's local shape and cuts each
    slab it is handed (``_LeafShard.take``), by the placements of the
    tree's logical axes under ``rules`` on ``mesh``. So a family's init
    draws every slab from the same seeded stream on every rank and keeps
    its piece: no rank holds more than its shards and one slab. Without a
    mesh (``ShardTaker()``) every leaf is whole."""

    def __init__(self, logical_tree: Any = None, mesh=None,
                 rules: Optional[Rules] = None):
        self.mesh = mesh
        self.placements = (None if mesh is None else
                           tree_placements(logical_tree, mesh, rules))
        if mesh is not None:
            from polyaxon_tpu_torch.parallel.bootstrap import rank

            self.coords = mesh.coords(rank())

    def _placements(self, path: tuple) -> list:
        node = self.placements
        for key in path:
            node = node[key]
        return node

    def leaf(self, path: tuple, shape) -> _LeafShard:
        if self.mesh is None:
            return _LeafShard(tuple(shape), {})
        return leaf_shard(shape, self._placements(path), self.mesh,
                          self.coords, "/".join(path))

    def axes(self, path: tuple, dim: int) -> list[str]:
        """The mesh axes that shard dimension ``dim`` of the leaf at
        ``path``."""
        if self.mesh is None:
            return []
        return [name for name, pl in zip(self.mesh.axis_names,
                                         self._placements(path))
                if pl.is_shard() and pl.dim == dim]

    def whole(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole leaf ``t``."""
        return self.leaf(path, t.shape).take(t)[1]

    def tree(self, tree: dict, prefix: tuple = ()) -> dict:
        """Every leaf of a whole tree cut to its piece, one at a time (for
        a family whose init draws whole leaves, or a checkpoint read
        whole)."""
        return {k: (self.tree(v, prefix + (k,)) if isinstance(v, dict)
                    else self.whole(prefix + (k,), v))
                for k, v in tree.items()}


WHOLE = ShardTaker()


def distribute_local(tree: Any, placements: Any, mesh) -> Any:
    """Place a tree of this rank's pieces (cut by a ``ShardTaker`` under
    the same placements) as DTensors; no collective runs."""
    from torch.distributed.tensor import DTensor

    dmesh = mesh.device_mesh()

    def place(t, pl):
        out = DTensor.from_local(t.detach(), dmesh, pl, run_check=False)
        return out.requires_grad_(t.requires_grad) if t.is_floating_point() \
            else out

    return _zip_map(place, tree, placements)


def distribute(tree: Any, placements: Any, mesh) -> Any:
    """Place a tree of full tensors (equal on every rank: drawn from one
    seed, or read from one checkpoint) as DTensors, each rank keeping its
    own chunk; no collective runs. ``requires_grad`` carries over."""
    from polyaxon_tpu_torch.parallel.bootstrap import rank

    coords = mesh.coords(rank())

    def cut(t, pl):
        piece = leaf_shard(t.shape, pl, mesh, coords).take(t.detach())[1]
        return piece.requires_grad_(t.requires_grad) \
            if t.is_floating_point() else piece

    return distribute_local(_zip_map(cut, tree, placements), placements,
                            mesh)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def param_bytes(params: Any) -> int:
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
