"""Mesh-axis helpers (the counterparts of
``polyaxon_tpu/parallel/compat.py``'s ``axis_size`` and
``batch_axes_in``), and the port's split of the axes into batch,
sequence-piece and replica axes. Its ``shard_map`` and ``tpu_compiler_params`` are
JAX and Mosaic shims with no counterpart here: the port's schedules call
``torch.distributed`` on the mesh's groups directly."""

from __future__ import annotations

# Mesh axes that carry the batch dimension of activations (the rule
# tables map logical "batch" onto these; ``batch_axes_in`` keeps the JAX
# package's answer, which leaves out ep).
_BATCH_AXES = ("dp", "fsdp")

# The port's own split of the mesh axes by what their ranks compute:
# - batch axes hold different rows (``EP_RULES`` puts ep among them);
# - cp holds different sequence pieces of the same rows, for a family
#   that shards sequences (``ModelDef.context_parallel``); another
#   family's rows are copies over cp, as GSPMD replicates them there;
# - replica axes hold the same rows and compute the same gradient: tp
#   and sp, cp for a family that does not shard sequences, and pp for a
#   model that does not pipeline (a pipeline's stages hold the same rows
#   but different layers, so their gradients still sum:
#   ``parallel/fsdp.py replica_axes``).
BATCH_AXES = ("dp", "fsdp", "ep")
REPLICA_AXES = ("tp", "sp")


def axis_size(mesh, axis_name: str) -> int:
    """Size of mesh axis ``axis_name`` (1 when the mesh lacks it)."""
    return mesh.shape.get(axis_name, 1)


def axes_above_one(mesh, names) -> tuple:
    """The axes of ``names`` that ``mesh`` has above 1, in mesh order."""
    shape = mesh.shape
    return tuple(a for a in mesh.axis_names if a in names and shape[a] > 1)


def axes_product(mesh, names) -> int:
    """The product of the sizes of the axes of ``names`` (1 without a
    mesh)."""
    n = 1
    for a in (axes_above_one(mesh, names) if mesh is not None else ()):
        n *= mesh.shape[a]
    return n


def piece_axes(model_def) -> tuple:
    """The axes whose ranks hold different pieces of the global batch for
    ``model_def``: the batch axes, and cp where it shards sequences."""
    return BATCH_AXES + (("cp",) if model_def.context_parallel else ())


def batch_pieces(mesh, model_def) -> int:
    """How many different pieces of the global batch the ranks hold."""
    return axes_product(mesh, piece_axes(model_def))


def batch_axes_in(mesh):
    """The batch-carrying mesh axes above 1, as a PartitionSpec entry
    (None, a name or a tuple of names)."""
    shape = mesh.shape
    axes = tuple(a for a in _BATCH_AXES if shape.get(a, 1) > 1)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]
