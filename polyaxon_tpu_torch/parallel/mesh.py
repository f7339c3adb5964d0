"""Device meshes from a JAXJob's topology and mesh spec (port of
``polyaxon_tpu/parallel/mesh.py``).

A ``Mesh`` names its axes and holds the ranks of the process group laid
out in the mesh's shape (one device per process: rank ``r`` drives
``cuda:<local id>`` or a CPU). ``Mesh.device_mesh()`` builds the
``torch.distributed.device_mesh.DeviceMesh`` over those ranks once the
process group exists (``parallel/bootstrap.py``), so the layout itself
is plain data that needs no group.

Axis convention (outermost → innermost), as in the JAX package:
``dp``, ``pp``, ``fsdp``, ``cp``, ``sp``, ``ep``, ``tp``. A single-slice
mesh is the row-major reshape of the ranks (there is no ICI torus to
map); a multi-slice mesh with ``dcn_axes`` puts the DCN axes
slowest-varying, so that each contiguous block of ranks is one slice,
as the JAX package emulates slices for devices without a slice index.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Optional, Sequence

import numpy as np
import torch

from polyaxon_tpu_torch.parallel.compat import axes_above_one, axis_size

logger = logging.getLogger(__name__)

# Canonical axis order: bandwidth-hungry axes innermost.
AXIS_ORDER: tuple[str, ...] = ("dp", "pp", "fsdp", "cp", "sp", "ep", "tp")

# Aliases accepted in specs (upstream-ish vocabulary → canonical).
AXIS_ALIASES = {"data": "dp", "model": "tp", "expert": "ep", "seq": "sp"}


def canonical_axes(axes: dict[str, int]) -> dict[str, int]:
    out: dict[str, int] = {}
    for name, size in axes.items():
        canon = AXIS_ALIASES.get(name, name)
        if canon in out:
            raise ValueError(f"Duplicate mesh axis `{name}` (alias of `{canon}`)")
        out[canon] = size
    return out


def order_axes(axes: dict[str, int]) -> dict[str, int]:
    """Order axes canonically; unknown axes keep their given order, last."""
    known = {k: axes[k] for k in AXIS_ORDER if k in axes}
    unknown = {k: v for k, v in axes.items() if k not in AXIS_ORDER}
    return {**known, **unknown}


def parse_mesh_axes(spec: str) -> dict[str, int]:
    """Parse a CLI-style mesh string — ``"tp=4,dp=2"`` / ``"fsdp=-1"``
    (-1 = absorb remaining devices) — into an axes dict. Raises
    ``ValueError`` with the JAX package's messages."""
    axes: dict[str, int] = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if name in axes:
            raise ValueError(f"mesh axis {name!r} given twice")
        try:
            axes[name] = int(size)
        except ValueError:
            raise ValueError(
                f"mesh axes expect name=size pairs "
                f"(e.g. 'tp=4,dp=2'), got {part.strip()!r}") from None
        if not name:
            raise ValueError(f"mesh axis in {part.strip()!r} has no name")
    return axes


class Mesh:
    """Named mesh axes over process ranks (``devices``: an int array in
    the mesh's shape, as JAX's ``Mesh.devices`` holds devices)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device_type: str = "cpu"):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.device_type = device_type
        self._device_mesh = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> dict[str, int]:
        """This rank's index along each axis."""
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def device_mesh(self):
        """The ``DeviceMesh`` over these ranks (needs the process group;
        built once, under the bootstrap's lock: building one creates
        process groups, which concurrent in-process runs must not
        interleave)."""
        from polyaxon_tpu_torch.parallel import bootstrap

        with bootstrap.group_lock:
            if self._device_mesh is None:
                import torch
                from torch.distributed.device_mesh import DeviceMesh

                self._device_mesh = DeviceMesh(
                    self.device_type, torch.as_tensor(self.devices),
                    mesh_dim_names=self.axis_names)
            return self._device_mesh

    def group(self, name: str):
        """The process group of axis ``name`` that holds this rank."""
        return self.device_mesh().get_group(name)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


def build_mesh(mesh_spec=None, topology=None, *,
               devices: Optional[Sequence[int]] = None,
               axes: Optional[dict[str, int]] = None,
               device_type: str = "cpu") -> Mesh:
    """Build a ``Mesh`` from a spec (``V1MeshSpec``) or raw ``axes`` over
    ``devices`` (ranks; default: every rank of the process group, or one
    when there is none). Raises ``ValueError`` when the axes' product is
    not the device count."""
    if devices is None:
        from polyaxon_tpu_torch.parallel.bootstrap import world_size

        devices = range(world_size())
    devices = list(devices)
    n = len(devices)

    if axes is None:
        axes = {"dp": n} if mesh_spec is None else mesh_spec.resolved_axes(n)
    axes = order_axes(canonical_axes(axes))

    sizes = list(axes.values())
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"Mesh axes {axes} need {total} devices, have {n}")

    dcn_axes = set()
    if mesh_spec is not None and mesh_spec.dcn_axes:
        dcn_axes = {AXIS_ALIASES.get(a, a) for a in mesh_spec.dcn_axes}
    slices = topology.slices if topology is not None else 1

    names = tuple(axes.keys())
    if slices > 1 and dcn_axes:
        # No device carries a slice index: DCN axes slowest-varying, so
        # each contiguous block of ranks is one slice.
        perm = sorted(range(len(names)), key=lambda i: names[i] not in dcn_axes)
        arr = np.asarray(devices).reshape([sizes[i] for i in perm])
        device_array = arr.transpose(tuple(np.argsort(perm)))
        logger.info(
            "hybrid mesh: dcn_axes=%s over %d emulated slices "
            "(devices lack slice_index; DCN axes placed slowest-varying)",
            sorted(dcn_axes), slices)
    else:
        device_array = np.asarray(devices).reshape(sizes)
    return Mesh(device_array, names, device_type)


def single_device_mesh(axis: str = "dp", device_type: str = "cpu") -> Mesh:
    return Mesh(np.zeros((1,), dtype=np.int64), (axis,), device_type)


def mesh_summary(mesh: Mesh) -> dict:
    kind = "cpu"
    if mesh.device_type == "cuda":
        import torch

        kind = torch.cuda.get_device_name()
    return {
        "axes": mesh.shape,
        "n_devices": mesh.size,
        "platform": "gpu" if mesh.device_type == "cuda" else "cpu",
        "device_kind": kind,
    }


# The mesh the running step computes over: the counterpart of JAX's
# `with mesh:` (the loop enters it; ring and Ulysses attention read it).
# A context variable, so that in-process runs on separate threads keep
# their own.
_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "polyaxon_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT.get()


def seq_shard(length: int, axis_name: str = "cp", *,
              mesh: Optional[Mesh] = None) -> Optional[slice]:
    """This rank's contiguous slice of a sequence of ``length`` under
    ``axis_name`` of ``mesh`` (default: the current mesh); None when the
    axis is absent or 1."""
    mesh = mesh if mesh is not None else current_mesh()
    n = axis_size(mesh, axis_name) if mesh is not None else 1
    if n <= 1:
        return None
    if length % n:
        raise ValueError(f"sequence length {length} does not divide over "
                         f"mesh axis `{axis_name}` of size {n}")
    per = length // n
    start = axis_rank(mesh, axis_name) * per
    return slice(start, start + per)


def axis_rank(mesh: Mesh, name: str) -> int:
    """This process's index along axis ``name`` (0 when absent)."""
    if name not in mesh.axis_names:
        return 0
    from polyaxon_tpu_torch.parallel.bootstrap import rank

    return mesh.coords(rank())[name]


def axis_ranks(mesh: Mesh, name: str) -> list[int]:
    """The ranks of axis ``name``'s group that holds this process, in
    axis order (global ranks, for point-to-point calls)."""
    from polyaxon_tpu_torch.parallel.bootstrap import rank

    coords = mesh.coords(rank())
    index = tuple(slice(None) if a == name else coords[a]
                  for a in mesh.axis_names)
    return [int(r) for r in np.asarray(mesh.devices[index]).reshape(-1)]


# Set while every rank of the current mesh holds the same rows (a served
# batch: `serving/gang.py`), so that the batch axes hold no different
# row blocks.
_REPLICATED_ROWS: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "polyaxon_tpu_torch_replicated_rows", default=False)


@contextlib.contextmanager
def replicated_rows():
    """Compute as if the batch axes of the current mesh held one row
    block: every rank holds the same rows (a served batch), so a
    statistic or a count over the batch is this rank's own."""
    token = _REPLICATED_ROWS.set(True)
    try:
        yield
    finally:
        _REPLICATED_ROWS.reset(token)


def row_block_axes(mesh: Optional[Mesh]) -> tuple:
    """The batch axes above 1 whose ranks hold different rows of the
    global batch (dp, fsdp, ep, in mesh order); none without a mesh or
    under ``replicated_rows``."""
    from polyaxon_tpu_torch.parallel.compat import BATCH_AXES

    if mesh is None or _REPLICATED_ROWS.get():
        return ()
    return axes_above_one(mesh, BATCH_AXES)


def row_block(mesh: Optional[Mesh]) -> tuple[int, int]:
    """(number of row blocks, this rank's block): the ranks of
    ``row_block_axes`` in the order the global batch lays its rows out
    (outer axes first)."""
    n, index = 1, 0
    for name in row_block_axes(mesh):
        n *= mesh.shape[name]
        index = index * mesh.shape[name] + axis_rank(mesh, name)
    return n, index


class _BlockMean(torch.autograd.Function):
    """The mean over the row blocks (``axes``); its backward is the same
    mean of the gradients, since every rank holds the mean."""

    @staticmethod
    def forward(ctx, t, mesh, axes, n):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, n
        return all_reduce_over(t.clone(), mesh, axes) / n

    @staticmethod
    def backward(ctx, g):
        return (all_reduce_over(g.contiguous().clone(), ctx.mesh, ctx.axes)
                / ctx.n, None, None, None)


def block_mean(t):
    """``t`` (a statistic of this rank's rows) averaged over the row
    blocks of the current mesh, differentiably: the global batch's
    statistic when the blocks hold equal row counts. ``t`` itself
    without row blocks."""
    mesh = current_mesh()
    n, _ = row_block(mesh)
    return t if n == 1 else _BlockMean.apply(t, mesh, row_block_axes(mesh),
                                             n)


def all_reduce_over(t, mesh: Mesh, names, op=None):
    """All-reduce ``t`` in place over the ranks that share this rank's
    coordinates on every axis but ``names``: one collective over the
    whole group when ``names`` holds every axis above 1, else one per
    axis (sums compose). Returns ``t``."""
    import torch.distributed as dist

    op = op if op is not None else dist.ReduceOp.SUM
    axes = axes_above_one(mesh, names)
    if not axes:
        return t
    if set(axes) == set(axes_above_one(mesh, mesh.axis_names)):
        dist.all_reduce(t, op=op)
        return t
    for name in axes:
        dist.all_reduce(t, op=op, group=mesh.group(name))
    return t


__all__ = ["AXIS_ALIASES", "all_reduce_over", "AXIS_ORDER", "Mesh", "axis_rank", "axis_ranks",
           "block_mean", "build_mesh", "canonical_axes", "current_mesh", "mesh_summary",
           "order_axes", "parse_mesh_axes", "replicated_rows",
           "row_block", "row_block_axes", "seq_shard",
           "single_device_mesh", "use_mesh"]
