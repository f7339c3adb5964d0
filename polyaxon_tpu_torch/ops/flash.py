"""Flash attention: the Hopper kernels and their plain versions (port of
``polyaxon_tpu/ops/flash.py``).

``flash_attention_with_lse`` keeps the JAX signature and the
``[B, S, H, D]`` layout, and is differentiable in both outputs through
``_FlashFn``. On CUDA tensors its forward launches ``csrc/flash_fwd.cu``
and its backward ``csrc/flash_bwd.cu`` (the dK/dV and dQ kernels), all
bf16 at head_dim 64, 128 or 256; both take any sequence length, causal /
sliding window / packed segments and GQA. On CPU tensors the same
autograd function runs ``flash_fwd_plain`` and
``flash_bwd_plain``, the same functions in plain PyTorch. There is no
fallback from the one to the other: a CUDA call a kernel cannot take
(another dtype or head_dim, unaligned pointers) raises. The one explicit
choice is ``bwd_impl="xla"``, which runs the plain backward on either
device, as the JAX package's chunked XLA backward does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from polyaxon_tpu_torch.ops.attention import NEG_INF

KERNEL_HEAD_DIMS = (64, 128, 256)  # forward and backward kernels

# Launches of each CUDA kernel (one per wrapper call that reached it).
launches = 0            # flash_fwd.cu
bwd_dkdv_launches = 0   # flash_bwd.cu, dK/dV
bwd_dq_launches = 0     # flash_bwd.cu, dQ


def pick_block(seq: int, preferred: int) -> int:
    """Largest power-of-two block <= preferred that divides seq."""
    block = min(preferred, seq)
    while block > 1 and seq % block:
        block //= 2
    return block


def _check_args(q, k, causal, window, segment_ids, bwd_impl,
                block_q, block_k):
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kv}")
    if window is not None and (window < 1 or not causal):
        raise ValueError("window must be >= 1 and requires causal attention")
    if segment_ids is not None and sq != sk:
        raise ValueError(f"segment_ids requires Sq == Sk, got {sq} vs {sk}")
    if causal and sq != sk:
        # The Pallas kernel masks rows >= cols with no (sk - sq) offset
        # while the einsum reference offsets; no caller passes Sq != Sk,
        # so the port refuses the case instead of picking one meaning.
        raise ValueError(
            f"causal flash attention needs Sq == Sk, got {sq} vs {sk}")
    if bwd_impl not in (None, "pallas", "xla"):
        raise ValueError(f"unknown bwd_impl `{bwd_impl}`")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if blk != "auto" and (not isinstance(blk, int) or blk < 1):
            raise ValueError(f"{name} must be a positive int or 'auto', "
                             f"got {blk!r}")


def _plain_mask(sq: int, sk: int, causal: bool, window: Optional[int],
                q_seg: Optional[torch.Tensor], k_seg: Optional[torch.Tensor],
                device) -> torch.Tensor:
    """``_block_mask`` over the whole [Sq, Sk] square, broadcastable to
    [B, H, Sq, Sk]: causal rows >= cols, window rows - cols < window,
    segment equality."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = rows >= cols
        if window:
            mask &= rows - cols < window
    mask = mask[None, None]
    if q_seg is not None:
        mask = mask & (q_seg[:, None, :, None] == k_seg[:, None, None, :])
    return mask


def _expand_kv(t: torch.Tensor, n_rep: int) -> torch.Tensor:
    return t.to(torch.float32).repeat_interleave(n_rep, dim=2)


def flash_fwd_plain(q, k, v, *, causal: bool, scale: float,
                    window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch: f32 logits and softmax,
    ``-1e30`` masking, a fully masked row gives o = 0 and
    lse = m + log(1). Returns (o [B, Sq, H, D] in q's dtype,
    lse [B, H, Sq] f32)."""
    sq, h = q.shape[1], q.shape[2]
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    qf, kf, vf = q.to(torch.float32), _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    mask = _plain_mask(sq, sk, causal, window, segment_ids, segment_ids,
                       q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, vf)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


@functools.cache
def _entry():
    """The built library and its typed C entry point (built on first
    use)."""
    from polyaxon_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    return lib, fn


def flash_fwd_cuda(q, k, v, *, causal: bool, scale: float,
                   window: Optional[int] = None,
                   segment_ids: Optional[torch.Tensor] = None):
    """Launch ``flash_fwd.cu`` on the current stream (no synchronise).
    Raises on anything the kernel does not take."""
    global launches
    from polyaxon_tpu_torch.ops import _build

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16 CUDA tensors; {name} "
                            f"is {t.dtype} on {t.device}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned {name}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    lib, fn = _entry()
    seg_ptr = seg.data_ptr() if seg is not None else None
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, seg_ptr,
              o.data_ptr(), lse.data_ptr(), b, sq, sk, h, kv, d,
              float(scale), int(causal), int(window or 0),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_fwd_bf16 launch")
    launches += 1
    return o, lse


def flash_bwd_plain(q, k, v, segment_ids, o, lse, do, dlse, *,
                    causal: bool, scale: float,
                    window: Optional[int] = None,
                    _kv_segment_ids: Optional[torch.Tensor] = None):
    """The backward kernels' function in plain PyTorch, in f32: what
    ``_flash_bwd_xla`` computes, in one pass over the whole [Sq, Sk]
    square instead of K/V chunks. P is recomputed from the saved lse and
    masked after the exp (a fully masked row, lse = -1e30, gives 0);
    ``ds = p * (dp - delta + dlse) * scale`` with ``delta = rowsum(do *
    o)``; a GQA group's dK/dV fold onto its kv head. ``dlse`` or ``do``
    may be None (that output unused). Returns (dq, dk, dv) in the dtypes
    of q, k, v. (``_kv_segment_ids``, a test hook, gives the key side
    other ids than the query side, to make fully masked rows.)"""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    qf, kf, vf = q.to(torch.float32), _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    dof = (torch.zeros_like(qf) if do is None else do.to(torch.float32))
    delta = (dof * o.to(torch.float32)).sum(-1).transpose(1, 2)  # [B,H,Sq]
    if dlse is not None:
        delta = delta - dlse.to(torch.float32)
    k_seg = _kv_segment_ids if _kv_segment_ids is not None else segment_ids
    mask = _plain_mask(sq, sk, causal, window, segment_ids, k_seg, q.device)
    # In place where it saves a [B, H, Sq, Sk] f32 temporary: this runs on
    # the card at training shapes as the kernels' reference.
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale)
    p = torch.where(mask, s.sub_(lse[..., None]).exp_(), 0.0)
    del s
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)  # dp
    ds.sub_(delta[..., None]).mul_(p).mul_(scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kv, n_rep, d).sum(3)
    dv = dv.reshape(b, sk, kv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _bwd_entries():
    """The built backward library and its typed C entry points: dK/dV
    with the GQA group split over ``n_split`` blocks (1: no split, no
    partials), dQ, and the split count."""
    from polyaxon_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    tail = [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fns = {}
    for name, n_ptrs, n_ints in (("flash_bwd_dkdv_split_bf16", 12, 7),
                                 ("flash_bwd_dq_bf16", 9, 6)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + tail
        fns[name] = fn
    split = lib.flash_bwd_dkdv_split
    split.restype = ctypes.c_int
    split.argtypes = [ctypes.c_int] * 5
    return lib, fns, split


def _bwd_launchers(q, k, v, segment_ids, o, lse, do, dlse, *,
                   causal: bool, scale: float, window: Optional[int] = None,
                   _kv_segment_ids: Optional[torch.Tensor] = None):
    """Check and prepare one backward call: returns
    ``(launch_dkdv, launch_dq, (dq, dk, dv))``, where each launcher
    runs its kernel once into the preallocated outputs on the current
    stream and raises on a CUDA error. ``delta - dlse`` is computed here
    in f32, as JAX computes delta in XLA outside its kernels. Where the
    dK/dV grid alone would not fill the card (``flash_bwd_dkdv_split``),
    the dK/dV launcher splits each GQA group's q heads over blocks into
    f32 partials allocated here, and sums them in a second kernel."""
    from polyaxon_tpu_torch.ops import _build

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if do is None:
        do = torch.zeros_like(o)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError(f"flash backward kernels take bf16 CUDA tensors; "
                            f"{name} is {t.dtype} on {t.device}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash backward kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash backward needs 16-byte aligned {name}")
    dd = (do.to(torch.float32) * o.to(torch.float32)).sum(-1).transpose(1, 2)
    if dlse is not None:
        dd = dd - dlse.to(torch.float32)
    dd = dd.contiguous()
    lse = lse.to(torch.float32).contiguous()
    qseg = kseg = None
    if segment_ids is not None:
        qseg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        kseg = qseg if _kv_segment_ids is None else _kv_segment_ids.to(
            device=q.device, dtype=torch.int32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib, fns, split_fn = _bwd_entries()
    n_split = split_fn(b, sk, h, kv, d)
    inputs = (q, k, v, do, lse, dd, qseg, kseg)  # held by the launchers
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sizes = (b, sq, sk, h, kv, d)
    flags = (float(scale), int(causal), int(window or 0), stream)

    def launch(name, outputs, *ints):
        ptrs = [t.data_ptr() if t is not None else None
                for t in (*inputs, *outputs)]
        _build.check(lib, fns[name](*ptrs, *sizes, *ints, *flags),
                     f"{name} launch")

    parts = (torch.empty((2, n_split, *k.shape), dtype=torch.float32,
                         device=q.device) if n_split > 1 else (None, None))
    return (functools.partial(launch, "flash_bwd_dkdv_split_bf16",
                              (parts[0], parts[1], dk, dv), n_split),
            functools.partial(launch, "flash_bwd_dq_bf16", (dq,)),
            (dq, dk, dv))


def flash_bwd_cuda(q, k, v, segment_ids, o, lse, do, dlse, *,
                   causal: bool, scale: float,
                   window: Optional[int] = None,
                   _kv_segment_ids: Optional[torch.Tensor] = None):
    """Launch ``flash_bwd.cu``'s dK/dV kernel, then its dQ kernel, on
    the current stream (no synchronise). Arguments as
    ``flash_bwd_plain``. Raises on anything the kernels do not take."""
    global bwd_dkdv_launches, bwd_dq_launches
    launch_dkdv, launch_dq, grads = _bwd_launchers(
        q, k, v, segment_ids, o, lse, do, dlse, causal=causal, scale=scale,
        window=window, _kv_segment_ids=_kv_segment_ids)
    launch_dkdv()
    bwd_dkdv_launches += 1
    launch_dq()
    bwd_dq_launches += 1
    return grads


class _FlashFn(torch.autograd.Function):
    """(o, lse), differentiable in both. Saves what JAX's forward rule
    saves (q, k, v, segments, o, lse). CUDA tensors run the kernels
    (the backward's plain version only when ``bwd_impl == "xla"``); CPU
    tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, window, bwd_impl):
        fwd = flash_fwd_cuda if q.is_cuda else flash_fwd_plain
        o, lse = fwd(q, k, v, causal=causal, scale=scale, window=window,
                     segment_ids=segment_ids)
        ctx.save_for_backward(q, k, v, segment_ids, o, lse)
        ctx.set_materialize_grads(False)
        ctx.args = (causal, scale, window, bwd_impl)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, segment_ids, o, lse = ctx.saved_tensors
        causal, scale, window, bwd_impl = ctx.args
        bwd = (flash_bwd_cuda if q.is_cuda and bwd_impl != "xla"
               else flash_bwd_plain)
        dq, dk, dv = bwd(q, k, v, segment_ids, o, lse, do, dlse,
                         causal=causal, scale=scale, window=window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KV, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    block_q: int | str = 512,
    block_k: int | str = 512,
    interpret: Optional[bool] = None,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    bwd_impl: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the row logsumexp
    ``[B, H, Sq]`` (f32), differentiable in both outputs (an lse
    cotangent enters ``ds`` additively).

    The argument list is the JAX package's. ``block_q``/``block_k`` and
    ``interpret`` are TPU tiling and Pallas knobs: they are validated and
    otherwise unused, because the Hopper kernels tile by 64 rows and
    never interpret. ``bwd_impl``: None or ``"pallas"`` = the backward
    kernels on CUDA tensors; ``"xla"`` = the plain backward on either
    device. Causal attention requires Sq == Sk (ValueError otherwise).

    Routing: CUDA tensors launch the kernels, and a CUDA call one cannot
    take (a head_dim outside ``KERNEL_HEAD_DIMS``, another dtype)
    raises; CPU tensors run ``flash_fwd_plain`` and ``flash_bwd_plain``.
    """
    _check_args(q, k, causal, window, segment_ids, bwd_impl,
                block_q, block_k)
    scale = (softmax_scale if softmax_scale is not None
             else q.shape[-1] ** -0.5)
    return _FlashFn.apply(q, k, v, segment_ids, causal, scale, window,
                          bwd_impl)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
    block_q: int | str = 512,
    block_k: int | str = 512,
    interpret: Optional[bool] = None,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    bwd_impl: Optional[str] = None,
) -> torch.Tensor:
    """``flash_attention_with_lse`` without the lse."""
    return flash_attention_with_lse(
        q, k, v, causal=causal, softmax_scale=softmax_scale,
        block_q=block_q, block_k=block_k, interpret=interpret,
        window=window, segment_ids=segment_ids, bwd_impl=bwd_impl)[0]
