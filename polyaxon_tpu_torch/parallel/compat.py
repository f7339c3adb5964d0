"""Mesh-axis helpers (the counterparts of
``polyaxon_tpu/parallel/compat.py``'s ``axis_size`` and
``batch_axes_in``). Its ``shard_map`` and ``tpu_compiler_params`` are
JAX and Mosaic shims with no counterpart here: the port's schedules call
``torch.distributed`` on the mesh's groups directly."""

from __future__ import annotations

# Mesh axes that carry the batch dimension of activations (the rule
# tables map logical "batch" onto these).
_BATCH_AXES = ("dp", "fsdp")


def axis_size(mesh, axis_name: str) -> int:
    """Size of mesh axis ``axis_name`` (1 when the mesh lacks it)."""
    return mesh.shape.get(axis_name, 1)


def batch_axes_in(mesh):
    """The batch-carrying mesh axes above 1, as a PartitionSpec entry
    (None, a name or a tuple of names)."""
    shape = mesh.shape
    axes = tuple(a for a in _BATCH_AXES if shape.get(a, 1) > 1)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]
