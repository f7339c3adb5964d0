"""Ulysses attention: sequence↔heads all-to-all context parallelism
(port of ``polyaxon_tpu/ops/ulysses.py``).

Instead of rotating K/V around a ring (``ops/ring.py``), re-shard
inside the attention block with an all-to-all so each rank sees the
FULL sequence for a SUBSET of heads::

    [B, S/n, H, D]  --all_to_all-->  [B, S, H/n, D]

then exact attention runs locally per head group (``attn_impl="flash"``:
the port's flash, the kernel on CUDA; ``"xla"``: the einsum path), and a
second all-to-all restores sequence sharding. The all-to-alls are
``all_to_all_single`` in an autograd Function whose backward is the
reverse all-to-all. Requires heads % n == 0; GQA K/V heads are repeated
up to n first when there are fewer of them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j of ``group``; chunk j of the result
    came from rank j."""
    x = x.contiguous()
    out = x.new_empty(x.shape)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, S_loc, H, D] → [B, n·S_loc, H/n, D]: split heads, gather seq."""
    b, s, h, d = x.shape
    parts = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)
    got = _all_to_all(parts, group)  # [n (source: seq shard), B, S_loc, ..]
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """[B, S, H/n, D] → [B, S/n, H, D]: split seq, gather heads."""
    b, s, hn, d = x.shape
    parts = x.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4)
    got = _all_to_all(parts, group)  # [n (source: head group), B, S_loc..]
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hn, d)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``_all_to_all``, differentiable: the transpose of this exchange is
    the same exchange, so the backward runs it on the gradient (MoE's
    expert-parallel dispatch, ``models/moe.py``)."""
    return _AllToAll.apply(x, group)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _seq_to_heads(x, n, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.n, ctx.group), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _heads_to_seq(x, n, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.n, ctx.group), None, None


def _expand_kv(k, v, n: int):
    """Heads % n check, and GQA K/V repeated up to n heads when fewer."""
    from polyaxon_tpu_torch.ops.attention import repeat_kv

    kv = k.shape[2]
    if kv % n:  # not enough kv heads to split: repeat groups up to n
        rep = n // kv if kv < n else 1
        if kv * rep != n and (kv * rep) % n:
            raise ValueError(f"kv heads {kv} incompatible with axis size {n}")
        k = repeat_kv(k, max(rep, 1))
        v = repeat_kv(v, max(rep, 1))
    return k, v


def _local_attention(q, k, v, *, causal, scale, attn_impl):
    """Exact attention of one head group over the whole sequence."""
    from polyaxon_tpu_torch.ops.attention import xla_attention

    if attn_impl == "flash":
        from polyaxon_tpu_torch.ops.flash import flash_attention

        return flash_attention(q, k, v, causal=causal, softmax_scale=scale)
    return xla_attention(q, k, v, causal=causal, softmax_scale=scale)


def _check_heads(h: int, n: int) -> None:
    if h % n:
        raise ValueError(f"Ulysses needs heads ({h}) % axis size ({n}) == 0")


def replay_ulysses(q, k, v, n: int, *, causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   attn_impl: str = "flash"):
    """Every rank's head group of an ``n``-way Ulysses split, run in one
    process on the whole row [B, S, H, D]: rank j attends with query
    heads ``j·H/n …`` and their K/V heads (after the GQA repeat), as the
    all-to-all hands them over. Equals attention over all heads."""
    _check_heads(q.shape[2], n)
    k, v = _expand_kv(k, v, n)
    qs, ks, vs = (x.chunk(n, dim=2) for x in (q, k, v))
    return torch.cat([_local_attention(qs[j], ks[j], vs[j], causal=causal,
                                       scale=softmax_scale,
                                       attn_impl=attn_impl)
                      for j in range(n)], dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      softmax_scale: Optional[float] = None,
                      axis_name: str = "cp", attn_impl: str = "xla",
                      mesh=None) -> torch.Tensor:
    """Attention over a sequence sharded on mesh axis ``axis_name``
    (this rank's [B, S_loc, H, D] shard in, its output shard out)."""
    from polyaxon_tpu_torch.parallel.mesh import current_mesh

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(
            f"ulysses_attention needs mesh axis `{axis_name}`: pass mesh=, "
            "or enter `parallel.mesh.use_mesh(mesh)`")
    n = mesh.shape[axis_name]
    _check_heads(q.shape[2], n)
    k, v = _expand_kv(k, v, n)
    if n == 1:
        return _local_attention(q, k, v, causal=causal, scale=softmax_scale,
                                attn_impl=attn_impl)
    group = mesh.group(axis_name)
    q_full, k_full, v_full = (_SeqToHeads.apply(x, n, group)
                              for x in (q, k, v))
    o = _local_attention(q_full, k_full, v_full, causal=causal,
                         scale=softmax_scale, attn_impl=attn_impl)
    return _HeadsToSeq.apply(o, n, group)
