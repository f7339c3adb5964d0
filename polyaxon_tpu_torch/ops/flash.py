"""Flash attention forward: the Hopper kernel and its plain version
(port of ``polyaxon_tpu/ops/flash.py``, forward only).

``flash_attention_with_lse`` keeps the JAX signature and the
``[B, S, H, D]`` layout. On CUDA tensors it launches
``csrc/flash_fwd.cu`` (bf16, head_dim 64, 128 or 256, any sequence
length, causal / sliding window / packed segments, GQA); on CPU tensors
it runs ``flash_fwd_plain``, the same function in plain PyTorch. There
is no fallback from the one to the other: a CUDA call the kernel cannot
take (another dtype or head_dim, unaligned pointers) raises.

The backward kernels belong to the training slice: the autograd
function's backward raises until they land.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from polyaxon_tpu_torch.ops.attention import NEG_INF

KERNEL_HEAD_DIMS = (64, 128, 256)

# Launches of the CUDA kernel (one per wrapper call that reached it).
launches = 0


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


def flash_fwd_plain(q, k, v, *, causal: bool, scale: float,
                    window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None):
    """The kernel's function in plain PyTorch: f32 logits and softmax,
    ``-1e30`` masking, a fully masked row gives o = 0 and
    lse = m + log(1). Returns (o [B, Sq, H, D] in q's dtype,
    lse [B, H, Sq] f32)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=2)
    vf = v.to(torch.float32).repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = rows >= cols
        if window:
            mask &= rows - cols < window
    mask = mask[None, None]
    if segment_ids is not None:
        mask = mask & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
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


class _FlashFn(torch.autograd.Function):
    """(o, lse) with the gradient the training slice will provide."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale, window):
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale,
                              window=window, segment_ids=segment_ids)

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash attention backward (_bwd_dkdv_kernel, _bwd_dq_kernel) "
            "belongs to the training slice: ROADMAP.md, Queue 2")


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
    ``[B, H, Sq]`` (f32).

    The argument list is the JAX package's. ``block_q``/``block_k`` and
    ``interpret`` are TPU tiling and Pallas knobs: they are validated and
    otherwise unused, because the Hopper kernel tiles by 64 rows and
    never interprets. ``bwd_impl`` is validated for the training slice.
    Causal attention requires Sq == Sk (ValueError otherwise).

    Routing: CUDA tensors launch the kernel, and a CUDA call it cannot
    take (a head_dim outside ``KERNEL_HEAD_DIMS``, another dtype) raises;
    CPU tensors run ``flash_fwd_plain``.
    """
    _check_args(q, k, causal, window, segment_ids, bwd_impl,
                block_q, block_k)
    scale = (softmax_scale if softmax_scale is not None
             else q.shape[-1] ** -0.5)
    if not q.is_cuda:
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale,
                               window=window, segment_ids=segment_ids)
    return _FlashFn.apply(q, k, v, segment_ids, causal, scale, window)


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
