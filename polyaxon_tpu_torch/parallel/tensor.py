"""Tensor parallelism over the ``tp`` mesh axis: Megatron's collective
pair, the vocab-parallel embedding and the vocab-parallel cross entropy.

The JAX package has no counterpart: GSPMD partitions its einsums by the
rule tables (``TP_RULES``: ``heads``, ``kv_heads``, ``mlp`` and
``vocab`` on ``tp``). The port computes the same function explicitly on
each rank's shards (``models/llama.py``, ``models/moe.py``):

- *copy* (identity forward, all-reduce backward) where a replicated
  activation enters column-parallel products, so the partial input
  gradients of the tp ranks sum;
- *reduce* (all-reduce forward, identity backward) after row-parallel
  products, so the partial outputs sum;
- ``vocab_embed``: each rank looks up the ids in its vocab range, zeros
  the rest, and *reduce* sums the rows;
- ``vocab_parallel_ce``: each rank holds the logits of its vocab range;
  the row max, the sum of exponentials and the target logit are
  all-reduced, so no rank builds ``[T, V]`` logits. The accuracy's
  argmax is the lowest index that reaches the global max, as
  ``argmax`` picks it.

Every function reads the tp group of the current mesh
(``parallel.mesh.use_mesh``; a layer recomputed under remat re-enters
the mesh its forward saw, ``parallel/fsdp.py``'s ``gather_args``): the
group of the ranks that share this rank's coordinates on every other
axis, so tp runs unchanged inside a cp ring, an ep owner's experts or a
pipeline stage. Where the composed rules leave a leaf that tp would
shard whole (``CP_RULES``' heads, ``EP_RULES``' expert ``mlp``), the
model view hands each rank its tp share of it (``parallel/fsdp.py
_tp_share``). At a tp group of one, or without a mesh, each is the
identity and runs no collective.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist


# (size, index) of the rank a one-process replay computes as, else None.
_REPLAY: contextvars.ContextVar[Optional[tuple[int, int]]] = \
    contextvars.ContextVar("polyaxon_tpu_torch_tp_replay", default=None)


@contextlib.contextmanager
def replay_rank(n: int, index: int):
    """Compute as rank ``index`` of an ``n``-way tp group, in one process
    and with no group: ``tp_axis`` names that rank, and *copy* and
    *reduce* are the identity, so a block returns this rank's partial
    (``replay_tp`` sums them)."""
    token = _REPLAY.set((n, index))
    try:
        yield
    finally:
        _REPLAY.reset(token)


def replay_tp(fn, n: int, args_of, remat: bool = False):
    """Every rank's partial of a row-parallel block, ``fn(*args_of(j))``
    on rank j's shards under ``replay_rank``, summed as the all-reduce
    sums them. With ``remat`` each rank's call is recomputed in the
    backward (``torch.utils.checkpoint``), so that the replicated work
    every rank repeats (its norms) is not held n times."""
    from torch.utils.checkpoint import checkpoint

    total = None
    for j in range(n):
        def rank_fn(*a, j=j):
            with replay_rank(n, j):
                return fn(*a)

        part = (checkpoint(rank_fn, *args_of(j), use_reentrant=False)
                if remat else rank_fn(*args_of(j)))
        total = part if total is None else total + part
    return total


def tp_axis(mesh=None) -> tuple[int, int, object]:
    """(size, this rank's index, group) of the tp axis of ``mesh`` (the
    current mesh by default); (1, 0, None) without one."""
    from polyaxon_tpu_torch.parallel.mesh import axis_rank, current_mesh

    replay = _REPLAY.get()
    if replay is not None:
        return replay[0], replay[1], None
    mesh = mesh if mesh is not None else current_mesh()
    n = mesh.shape.get("tp", 1) if mesh is not None else 1
    if n <= 1:
        return 1, 0, None
    return n, axis_rank(mesh, "tp"), mesh.group("tp")


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the gradient is summed over the tp group."""
    n, _, group = tp_axis()
    return x if n == 1 or group is None else _Copy.apply(x, group)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The sum of the tp ranks' partials; the gradient passes as it is."""
    n, _, group = tp_axis()
    return x if n == 1 or group is None else _Reduce.apply(x, group)


def gather_from_tp(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from the tp ranks' shards along ``dim``; the
    gradient is reduce-scattered back, summed (the ranks use it on
    different heads). A replayed rank (``replay_rank``) is handed the
    whole tensor already."""
    from polyaxon_tpu_torch.parallel.fsdp import all_gather

    n, _, group = tp_axis()
    return w if n == 1 or group is None else all_gather(w, dim, group)


def vocab_shard(vocab: int, local: int) -> Optional[tuple[int, object]]:
    """(first id, tp group) of this rank's vocab range when a table of
    ``local`` rows or columns is its tp shard of ``vocab``; None when
    the table is whole."""
    n, idx, group = tp_axis()
    if n == 1 or local == vocab:
        return None
    if local * n != vocab:
        raise ValueError(f"a vocab shard of {local} is not 1/{n} of "
                         f"{vocab}")
    return idx * local, group


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, dt,
                shard: tuple[int, object]) -> torch.Tensor:
    """Rows of ``tokens`` from a vocab-parallel table [V/tp, D]: each
    rank's own ids, zeros elsewhere, summed over tp."""
    from polyaxon_tpu_torch.models.common import _embed_rows

    start, _ = shard
    rows = table.shape[0]
    ids = tokens - start
    inside = (ids >= 0) & (ids < rows)
    x = _embed_rows(table, ids.clamp(0, rows - 1), dt)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=dt,
                                                      device=x.device))
    return reduce_from_tp(x)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


class _VocabCE(torch.autograd.Function):
    """The vocab-parallel cross entropy of the vocab shards this process
    holds (``starts``: each shard's first id), combined over them and
    then over ``group`` (None: every shard is here, ``replay_vocab_ce``)
    as the all-reduces combine them."""

    @staticmethod
    def forward(ctx, labels, starts, group, *shards):
        local = [s.max(-1) for s in shards]
        m = torch.stack([v for v, _ in local]).max(0).values
        m = _all_reduce(m.clone(), dist.ReduceOp.MAX, group)
        sums = torch.zeros((2, *m.shape), dtype=m.dtype, device=m.device)
        probs, where = [], []
        for s, start in zip(shards, starts):
            e = torch.exp(s - m[..., None])
            ids = labels - start
            inside = (ids >= 0) & (ids < s.shape[-1])
            ids = ids.clamp(0, s.shape[-1] - 1)
            sums[0] += e.sum(-1)
            sums[1] += torch.where(inside, s.gather(-1, ids[..., None])[..., 0],
                                   torch.zeros_like(m))
            probs.append(e)
            where.append((ids, inside))
        total, target = _all_reduce(sums, dist.ReduceOp.SUM, group).unbind(0)
        nll = torch.log(total) + m - target
        # The global argmax: the lowest index that reaches the max.
        big = torch.iinfo(torch.int64).max
        arg = torch.stack([
            torch.where(v == m, a + start, torch.full_like(a, big))
            for (v, a), start in zip(local, starts)]).min(0).values
        arg = _all_reduce(arg, dist.ReduceOp.MIN, group)
        correct = (arg == labels).to(torch.float32)
        ctx.save_for_backward(*(e / total[..., None] for e in probs),
                              *(t for pair in where for t in pair))
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, g, _):
        saved = ctx.saved_tensors
        n = len(saved) // 3
        grads = []
        for j, probs in enumerate(saved[:n]):
            ids, inside = saved[n + 2 * j], saved[n + 2 * j + 1]
            grad = probs * g[..., None]
            grad.scatter_add_(-1, ids[..., None],
                              -(g * inside.to(g.dtype))[..., None])
            grads.append(grad)
        return (None, None, None, *grads)


def replay_vocab_ce(shards: list, labels: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``vocab_parallel_ce`` of every rank in one process: f32 logits
    ``shards`` (rank j's vocab columns, in order) through the same
    Function, its all-reduces replaced by the combination over the
    shards."""
    per = shards[0].shape[-1]
    return _VocabCE.apply(labels.long(), [j * per for j in range(len(shards))],
                          None, *shards)


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      shard: tuple[int, object]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position cross entropy and argmax hit of f32 logits [..., V/tp]
    (this rank's vocab range) against labels [...] (ids in [0, V))."""
    start, group = shard
    return _VocabCE.apply(labels.long(), [start], group, logits)
