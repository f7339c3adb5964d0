"""Ring attention: context-parallel attention over the ``cp`` mesh axis
(port of ``polyaxon_tpu/ops/ring.py``).

Each rank holds one contiguous sequence shard of Q, K and V
([B, S_loc, H, D]; ``seq → cp``). K/V rotate around the ranks of the
``cp`` group by point-to-point sends (``ppermute``: an autograd Function
whose backward runs the inverse permutation), and every visible block
runs ``flash_attention_with_lse`` — the Hopper kernels on CUDA tensors,
their plain versions on the CPU — whose partials merge exactly through
(o, lse) online-softmax combination in f32. GQA K/V travel unexpanded.

- **Zigzag placement for causal masks.** Each shard splits into two
  half-chunks, redistributed so that rank ``i`` holds global chunks
  ``i`` and ``2·cp-1-i``; every ring step then needs exactly two dense
  blocks per rank and fully-post-diagonal blocks are skipped. The
  inverse permutation restores the contiguous layout of the output.
  The per-rank pieces (``zigzag_diagonal``, ``zigzag_step``) are shared
  with ``replay_zigzag``, which runs every rank's schedule in one
  process with each permute replaced by the rotation it performs.
- **Dense ring** for non-causal attention: one block per step.
- **Odd local length**: the contiguous masked-einsum fallback (plain
  PyTorch, as the JAX package's is einsum), warned once. The global
  entry ``ring_attention`` avoids it for causal attention by padding the
  sequence tail by ``cp`` rows (shards re-cut to S_loc + 1 rows).

The rotations are synchronous: a step's transfer is not overlapped with
its blocks (the JAX package issues the next rotation first).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import warnings
from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30

_warned_einsum_fallback = False


def _warn_einsum_fallback(s_loc: int) -> None:
    """The contiguous masked fallback does ~2× the attention FLOPs of
    zigzag and einsum-not-flash math: engaging it is loud, once."""
    global _warned_einsum_fallback
    if _warned_einsum_fallback:
        return
    _warned_einsum_fallback = True
    warnings.warn(
        f"ring_attention: local sequence length {s_loc} is odd — falling "
        f"back to the contiguous masked-einsum ring (~2x the attention "
        f"FLOPs of the zigzag path, no flash kernel). For CAUSAL "
        f"attention the global ring_attention entry pads this away "
        f"automatically (the pad relies on the causal mask, so it does "
        f"not apply non-causal); inside shard_map, pad the sequence so "
        f"seq/cp is even.",
        RuntimeWarning, stacklevel=3)


# ----------------------------------------------------------- collectives
class _Axis:
    """The ``cp`` group of this rank: its global ranks in axis order,
    this rank's index and the process group.

    Every transfer of one ring call also threads ``token``, a scalar that
    orders the transfers' backwards: each runs only after the backward of
    the transfer issued after it. Ranks build different graphs (the
    zigzag's blocks depend on the rank), so without it the autograd
    engine could reach the paired sends and receives in different orders
    on two ranks and deadlock."""

    def __init__(self, mesh, axis_name: str):
        from polyaxon_tpu_torch.parallel.mesh import axis_ranks

        self.ranks = axis_ranks(mesh, axis_name)
        self.size = len(self.ranks)
        self.index = self.ranks.index(dist.get_rank()) if self.size > 1 else 0
        self.group = mesh.group(axis_name) if self.size > 1 else None
        self.token = torch.zeros((), requires_grad=True)

    def transfer(self, fn, inverse, x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` with ``inverse`` (its adjoint) as the backward."""
        out, self.token = _Transfer.apply(x, self.token, fn, inverse)
        return out


# The transfers of an enclosing schedule (a pipeline's stage sends,
# ``parallel/pipeline.py``) whose ordering token a ring call inside it
# threads too: every point-to-point transfer of a step then lies on one
# chain, and every rank runs their backwards in one order.
_ENCLOSING: contextvars.ContextVar[Optional[_Axis]] = contextvars.ContextVar(
    "polyaxon_tpu_torch_ring_enclosing", default=None)


@contextlib.contextmanager
def shared_order(axis: _Axis):
    """Ring calls inside thread ``axis``'s ordering token (and hand it
    back to ``axis`` when they end)."""
    token = _ENCLOSING.set(axis)
    try:
        yield axis
    finally:
        _ENCLOSING.reset(token)


class _Transfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token, fn, inverse):
        ctx.inverse = inverse
        return fn(x), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        return ctx.inverse(g.contiguous()), g_token, None, None


def _p2p(sends, recvs, axis: _Axis) -> None:
    """Post ``sends`` [(tensor, axis index)] and ``recvs`` [(buffer,
    axis index)] together and wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, axis.ranks[i], axis.group)
           for t, i in sends]
    ops += [dist.P2POp(dist.irecv, t, axis.ranks[i], axis.group)
            for t, i in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _permute(x: torch.Tensor, axis: _Axis, perm) -> torch.Tensor:
    """``lax.ppermute``: (src, dst) axis-index pairs; a rank that
    receives nothing gets zeros; a pair that maps a rank to itself is a
    copy with no transfer."""
    me = axis.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return x.clone()
    out = (x.new_empty if src else x.new_zeros)(x.shape)
    _p2p([(x.contiguous(), d) for d in dst if d != me],
         [(out, s) for s in src if s != me], axis)
    return out


def ppermute(x: torch.Tensor, axis: _Axis, perm) -> torch.Tensor:
    """Differentiable ``_permute``: the backward runs the inverse
    permutation."""
    inverse = [(d, s) for s, d in perm]
    return axis.transfer(functools.partial(_permute, axis=axis, perm=perm),
                         functools.partial(_permute, axis=axis, perm=inverse),
                         x)


# ----------------------------------------------------------------- blocks
def _merge(o_a, lse_a, o_b, lse_b):
    """Exact online-softmax combination of two partial attentions.
    o: [B, S, H, D] f32; lse: [B, H, S] f32."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    w_a = torch.exp(lse_a - lse_new).transpose(1, 2)[..., None]
    w_b = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
    return o_a * w_a + o_b * w_b, lse_new


def _block_attn(q, k, v, *, causal, scale):
    """One visible block through flash (the kernels on CUDA), partials
    in f32."""
    from polyaxon_tpu_torch.ops.flash import flash_attention_with_lse

    o, lse = flash_attention_with_lse(q, k, v, causal=causal,
                                      softmax_scale=scale)
    return o.to(torch.float32), lse


def zigzag_diagonal(q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, *, scale):
    """Step 0 of the zigzag on one rank: the low chunk's causal diagonal,
    the high chunk's causal diagonal merged with its view of the low
    chunk (always fully visible). Returns (acc_lo, acc_hi), each an
    (o f32, lse) pair."""
    attn = functools.partial(_block_attn, scale=scale)
    acc_lo = attn(q_lo, k_lo, v_lo, causal=True)
    o_hh, l_hh = attn(q_hi, k_hi, v_hi, causal=True)
    o_hl, l_hl = attn(q_hi, k_lo, v_lo, causal=False)
    return acc_lo, _merge(o_hh, l_hh, o_hl, l_hl)


def zigzag_step(idx: int, src: int, q_lo, q_hi, kv, acc_lo, acc_hi, *,
                scale):
    """Ring step on rank ``idx`` holding the K/V chunks of rank ``src``
    (global chunks ``src`` and ``2cp-1-src``): two dense blocks. The
    high query chunk always sees the low K/V chunk; the second block is
    the low pair when ``idx > src``, else the high pair."""
    k_lo, k_hi, v_lo, v_hi = kv
    attn = functools.partial(_block_attn, scale=scale, causal=False)
    acc_hi = _merge(*acc_hi, *attn(q_hi, k_lo, v_lo))
    if idx > src:
        acc_lo = _merge(*acc_lo, *attn(q_lo, k_lo, v_lo))
    else:
        acc_hi = _merge(*acc_hi, *attn(q_hi, k_hi, v_hi))
    return acc_lo, acc_hi


def _zigzag_perms(cp: int):
    perm_a = [(i, 2 * i if 2 * i < cp else 2 * cp - 1 - 2 * i)
              for i in range(cp)]
    perm_b = [(i, 2 * i + 1 if 2 * i + 1 < cp else 2 * cp - 2 - 2 * i)
              for i in range(cp)]
    return perm_a, perm_b


def _ring_causal_zigzag(q, k, v, *, scale, axis: _Axis):
    """Causal ring attention with zigzag placement (module docstring)."""
    cp, idx = axis.size, axis.index
    half = q.shape[1] // 2
    rotate = [(i, (i + 1) % cp) for i in range(cp)]
    perm_a, perm_b = _zigzag_perms(cp)
    even = idx % 2 == 0

    # Rank i holds global half-chunks (2i, 2i+1); zigzag wants
    # (i, 2cp-1-i): one permute for first halves (A), one for second
    # halves (B). Even ranks receive their LOW chunk via A, odd via B.
    def to_zigzag(x):
        ra = ppermute(x[:, :half], axis, perm_a)
        rb = ppermute(x[:, half:], axis, perm_b)
        return (ra, rb) if even else (rb, ra)

    q_lo, q_hi = to_zigzag(q)
    kv = (*to_zigzag(k), *to_zigzag(v))  # k_lo, k_hi, v_lo, v_hi
    acc_lo, acc_hi = zigzag_diagonal(q_lo, q_hi, *kv, scale=scale)
    for s in range(1, cp):
        kv = tuple(ppermute(x, axis, rotate) for x in kv)
        acc_lo, acc_hi = zigzag_step(idx, (idx - s) % cp, q_lo, q_hi, kv,
                                     acc_lo, acc_hi, scale=scale)

    o_lo = acc_lo[0].to(q.dtype)
    o_hi = acc_hi[0].to(q.dtype)
    inv_a = [(d, s) for (s, d) in perm_a]
    inv_b = [(d, s) for (s, d) in perm_b]
    back_a = ppermute(o_lo if even else o_hi, axis, inv_a)  # chunk 2i
    back_b = ppermute(o_hi if even else o_lo, axis, inv_b)  # chunk 2i+1
    return torch.cat([back_a, back_b], dim=1)


def replay_zigzag(q, k, v, cp: int, *, scale: Optional[float] = None):
    """Every rank's zigzag schedule for a ``cp``-way ring, run in one
    process on the whole row [B, S, H, D] (S divisible by 2·cp): rank
    ``i``'s chunks are read where the permutes would have put them and
    each step's K/V are those of rank ``(i - s) % cp``, through
    ``zigzag_diagonal`` and ``zigzag_step``. Equals causal attention."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qc, kc, vc = (x.chunk(2 * cp, dim=1) for x in (q, k, v))

    def held(idx):  # the K/V chunks rank idx holds after zigzag
        return kc[idx], kc[2 * cp - 1 - idx], vc[idx], vc[2 * cp - 1 - idx]

    out = [None] * (2 * cp)
    for idx in range(cp):
        q_lo, q_hi = qc[idx], qc[2 * cp - 1 - idx]
        acc_lo, acc_hi = zigzag_diagonal(q_lo, q_hi, *held(idx),
                                         scale=scale)
        for s in range(1, cp):
            src = (idx - s) % cp
            acc_lo, acc_hi = zigzag_step(idx, src, q_lo, q_hi, held(src),
                                         acc_lo, acc_hi, scale=scale)
        out[idx] = acc_lo[0]
        out[2 * cp - 1 - idx] = acc_hi[0]
    return torch.cat(out, dim=1).to(q.dtype)


def _ring_dense(q, k, v, *, scale, axis: _Axis):
    """Non-causal ring: every block visible, one flash call per step."""
    cp = axis.size
    rotate = [(i, (i + 1) % cp) for i in range(cp)]
    attn = functools.partial(_block_attn, scale=scale, causal=False)
    acc = attn(q, k, v)
    for _ in range(1, cp):
        k = ppermute(k, axis, rotate)
        v = ppermute(v, axis, rotate)
        acc = _merge(*acc, *attn(q, k, v))
    return acc[0].to(q.dtype)


def _ring_einsum_causal(q, k, v, *, scale, axis: _Axis):
    """Contiguous-layout causal fallback for an odd local length: blocks
    ahead of the diagonal are masked, not skipped."""
    from polyaxon_tpu_torch.ops.attention import repeat_kv

    cp, idx = axis.size, axis.index
    b, s_loc, h, d = q.shape
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    q_f = q.to(torch.float32)
    local_pos = torch.arange(s_loc, device=q.device)
    q_pos = idx * s_loc + local_pos
    perm = [(i, (i + 1) % cp) for i in range(cp)]

    o = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    for s in range(cp):
        src = (idx - s) % cp
        k_pos = src * s_loc + local_pos
        logits = torch.einsum("bqhd,bkhd->bhqk", q_f,
                              k.to(torch.float32)) * scale
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]),
                        torch.zeros_like(logits))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
        o = o * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
        k = ppermute(k, axis, perm)
        v = ppermute(v, axis, perm)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def _ring_attention_sharded(q, k, v, *, causal: bool, scale: float,
                            axis: _Axis):
    if not causal:
        return _ring_dense(q, k, v, scale=scale, axis=axis)
    if q.shape[1] % 2:
        _warn_einsum_fallback(q.shape[1])
        return _ring_einsum_causal(q, k, v, scale=scale, axis=axis)
    return _ring_causal_zigzag(q, k, v, scale=scale, axis=axis)


# ------------------------------------------------------ the odd-length pad
def _repad(x: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """Shards of S_loc rows → shards of S_loc + 1 rows of the same global
    sequence with ``cp`` zero rows at its tail: rank i keeps rows [i:]
    and takes the first i + 1 rows of rank i + 1."""
    cp, i = axis.size, axis.index
    recv = x.new_empty((x.shape[0], i + 1, *x.shape[2:])) \
        if i < cp - 1 else None
    _p2p([(x[:, :i].contiguous(), i - 1)] if i > 0 else [],
         [(recv, i + 1)] if recv is not None else [], axis)
    tail = recv if recv is not None else x.new_zeros(
        (x.shape[0], cp, *x.shape[2:]))
    return torch.cat([x[:, i:], tail], dim=1)


def _unpad(y: torch.Tensor, axis: _Axis) -> torch.Tensor:
    """The inverse cut: rank i takes the last i rows of rank i - 1 and
    keeps its first S_loc - i rows (the pads drop)."""
    cp, i = axis.size, axis.index
    s_loc = y.shape[1] - 1
    recv = y.new_empty((y.shape[0], i, *y.shape[2:])) if i > 0 else None
    _p2p([(y[:, y.shape[1] - (i + 1):].contiguous(), i + 1)]
         if i < cp - 1 else [],
         [(recv, i - 1)] if recv is not None else [], axis)
    keep = y[:, :s_loc - i]
    return torch.cat([recv, keep], dim=1) if recv is not None else keep


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True,
                   softmax_scale: Optional[float] = None,
                   axis_name: str = "cp", mesh=None) -> torch.Tensor:
    """Attention over a sequence sharded on mesh axis ``axis_name``:
    q [B, S_loc, H, D] and k, v [B, S_loc, KV, D] are this rank's shard
    of the global row; returns this rank's shard of the output. The mesh
    is ``mesh`` or the one the caller entered (``parallel.mesh.use_mesh``,
    as the runtime loop does)."""
    from polyaxon_tpu_torch.parallel.mesh import current_mesh

    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(
            f"ring_attention needs mesh axis `{axis_name}`: pass mesh=, or "
            "enter `parallel.mesh.use_mesh(mesh)` (the runtime loop does) "
            f"with a {axis_name} axis in the mesh")
    axis = _Axis(mesh, axis_name)
    outer = _ENCLOSING.get()
    if outer is not None:
        axis.token = outer.token
    try:
        # An odd local length cannot split into zigzag halves: re-cut the
        # shards to S_loc + 1 rows with cp pad rows at the sequence tail
        # (the highest positions, which causal attention never lets a
        # real query see), run zigzag, and cut back.
        if causal and q.shape[1] % 2:
            repad = functools.partial(_repad, axis=axis)
            unpad = functools.partial(_unpad, axis=axis)
            q, k, v = (axis.transfer(repad, unpad, x) for x in (q, k, v))
            out = _ring_attention_sharded(q, k, v, causal=True, scale=scale,
                                          axis=axis)
            return axis.transfer(unpad, repad, out)
        return _ring_attention_sharded(q, k, v, causal=causal, scale=scale,
                                       axis=axis)
    finally:
        # The last token's graph node holds the transfers' contexts, which
        # hold the axis: drop it, or the cycle keeps the call's graph (a
        # recomputed layer's activations, under remat) alive. An
        # enclosing schedule's transfers go on from it.
        if outer is not None:
            outer.token = axis.token
        axis.token = None
