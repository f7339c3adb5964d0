"""Paged decode attention: the Hopper kernel and its plain version
(port of ``polyaxon_tpu/ops/paged_attention.py``).

``paged_decode_attention`` keeps the JAX signature. On CUDA tensors it
launches ``csrc/paged_decode.cu``, which streams each row's pages
straight from the pool (holes and pages past the row's position are
never read); on CPU tensors it runs ``paged_decode_plain``, the gather
formulation of the same function. A CUDA call the kernel cannot take
(another dtype or head_dim) raises: there is no fallback. Any GQA ratio
H/KV is taken.
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


def paged_decode_plain(q, k_pages, v_pages, tables, pos):
    """Gather every row's pages, mask columns past ``pos``, holes and
    idle rows, and take an f32 softmax. Idle rows output 0, like the
    kernel. Returns [B, H, Hd] in q's dtype."""
    B, H, Hd = q.shape
    _, page, KV, _ = k_pages.shape
    maxp = tables.shape[1]
    n_rep = H // KV
    idx = tables.clamp(min=0).long()
    keys = k_pages[idx].reshape(B, maxp * page, KV, Hd).to(torch.float32)
    vals = v_pages[idx].reshape(B, maxp * page, KV, Hd).to(torch.float32)
    keys = keys.repeat_interleave(n_rep, dim=2)
    vals = vals.repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.to(torch.float32), keys) * Hd ** -0.5
    cols = torch.arange(maxp * page, device=q.device)[None, :]
    allocated = (tables >= 0).repeat_interleave(page, dim=1)
    valid = ((cols <= pos.clamp(min=0)[:, None]) & (pos[:, None] >= 0)
             & allocated)[:, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bht,bthd->bhd", p / l_safe, vals)
    return o.to(q.dtype)


@functools.cache
def _entry():
    """The built library and its typed C entry point (built on first
    use)."""
    from polyaxon_tpu_torch.ops import _build

    lib = _build.load("paged_decode")
    fn = lib.paged_decode_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib, fn


def paged_decode_cuda(q, k_pages, v_pages, tables, pos):
    """Launch ``paged_decode.cu`` on the current stream (no synchronise).
    Raises on anything the kernel does not take."""
    global launches
    from polyaxon_tpu_torch.ops import _build

    B, H, Hd = q.shape
    _, page, KV, _ = k_pages.shape
    maxp = tables.shape[1]
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise TypeError(f"paged decode kernel takes bf16 CUDA tensors; "
                            f"{name} is {t.dtype} on {t.device}")
    if Hd not in KERNEL_HEAD_DIMS or H % KV:
        raise ValueError(
            f"paged decode kernel takes head_dim in {KERNEL_HEAD_DIMS} and "
            f"H a multiple of KV; got head_dim {Hd}, H {H}, KV {KV}")
    q, k_pages, v_pages = (t.contiguous() for t in (q, k_pages, v_pages))
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged decode kernel needs 16-byte aligned "
                             f"{name}")
    tables = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib, fn = _entry()
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
              B, H, KV, Hd, page, maxp, float(Hd ** -0.5),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "paged_decode_bf16 launch")
    launches += 1
    return out


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, Hd] — the single decode position per row
    k_pages: torch.Tensor,  # [P, page, KV, Hd]
    v_pages: torch.Tensor,
    tables: torch.Tensor,  # [B, maxp] int32 (-1 = unallocated)
    pos: torch.Tensor,  # [B] int32 (-1 = idle row → zeros out)
    *,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Attention of each row's query against its pages (positions
    0..pos inclusive — the current step's K/V must already be in the
    pool). Returns [B, H, Hd]. ``interpret`` is the Pallas knob, kept in
    the signature and unused. CUDA tensors launch the kernel; CPU
    tensors run ``paged_decode_plain``."""
    if q.is_cuda:
        return paged_decode_cuda(q, k_pages, v_pages, tables, pos)
    return paged_decode_plain(q, k_pages, v_pages, tables, pos)
