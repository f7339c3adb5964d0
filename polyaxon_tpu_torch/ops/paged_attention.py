"""Paged decode attention: the Hopper kernel and its plain version
(port of ``polyaxon_tpu/ops/paged_attention.py``).

``paged_decode_attention`` keeps the JAX signature. On CUDA tensors it
launches ``csrc/paged_decode.cu``, which splits each row's live pages over
blocks and streams them straight from the pool (holes and pages past the
row's position are never read); on CPU tensors it runs
``paged_decode_plain``, the gather formulation of the same function. A
CUDA call the kernel cannot take (another dtype or head_dim) raises: there
is no fallback. Any GQA ratio H/KV is taken.

The split count comes from ``decode_splits``, on the host and without a
device sync; the kernel cuts each row's live tokens into tiles of
``TILE_TOKENS`` tokens and split ``s`` of ``n`` takes tiles
``[s * ntiles // n, (s + 1) * ntiles // n)``, then merges the splits'
partials in split order. The wrapper allocates partials with torch and
keeps one zeroed counter buffer per (device, stream), which the kernel
leaves zero: launches on one stream run in order and share it, launches
on two streams never do. A call can be captured in a CUDA graph (the
graph keeps its capture stream's buffer, so graphs captured on one stream
are replayed one at a time).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from polyaxon_tpu_torch.ops.attention import NEG_INF

KERNEL_HEAD_DIMS = (64, 128, 256)
# Tokens per tile, the unit in which the kernel splits a row (its
# ``Cfg<HD>::T`` at every head_dim; ``paged_decode_tile_tokens`` in the
# library says the same).
TILE_TOKENS = 32
# q heads of one kv head per block (the tensor-core product's M rows); a
# larger GQA group takes ceil(rep / GROUP_ROWS) blocks per kv head.
GROUP_ROWS = 16
# Blocks per SM the split count aims for (three of the kernel's blocks fit
# on an SM at head_dim 64 and 128, two at 256; more blocks than slots
# balance ragged rows better), the fewest tiles a split of a full-width
# row gets (the last block's merge reads every split's partial), and the
# most splits the kernel takes.
BLOCKS_PER_SM = 4
MIN_SPLIT_TILES = 8
MAX_SPLITS = 256

# Launches of the CUDA kernel (one per wrapper call that reached it).
launches = 0


def decode_splits(B: int, H: int, KV: int, page: int, maxp: int,
                  sms: int) -> int:
    """Splits per (row, kv head): 1 where rows x kv heads already give
    every SM ``BLOCKS_PER_SM`` blocks, else about that many blocks, with
    at least ``MIN_SPLIT_TILES`` tiles of the table's width per split and
    never more splits than the table has pages."""
    blocks = B * KV * -(-(H // KV) // GROUP_ROWS)
    tiles = -(-(maxp * page) // TILE_TOKENS)
    return max(1, min(BLOCKS_PER_SM * sms // blocks,
                      tiles // MIN_SPLIT_TILES, maxp, MAX_SPLITS))


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
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib, fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _counter_buffer(device: torch.device, stream: torch.cuda.Stream,
                    n: int) -> torch.Tensor:
    """Zeroed int32 counters for the last-block merge. The kernel's last
    block of a (row, kv head) is the one whose ``atomicAdd`` returns
    ``nsplit - 1``, so two launches in flight at once must not share a
    buffer: one buffer per (device, stream), reused by that stream's
    launches in order (every launch leaves it zero). Inside a CUDA-graph
    capture a buffer too small is allocated afresh (its zeroing is
    captured with the launch), never cached."""
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is not None and buf.numel() >= n:
        return buf
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(n, dtype=torch.int32, device=device)
    buf = _counters[key] = torch.zeros(
        max(n, 4096), dtype=torch.int32, device=device)
    return buf


def paged_decode_cuda(q, k_pages, v_pages, tables, pos, *,
                      splits: Optional[int] = None):
    """Launch ``paged_decode.cu`` on the current stream (no synchronise,
    no host sync). ``splits`` overrides ``decode_splits`` (tests force one
    or several). Raises on anything the kernel does not take."""
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
    dev = q.device
    n = splits or decode_splits(B, H, KV, page, maxp, _sm_count(dev.index))
    if not 1 <= n <= MAX_SPLITS:
        raise ValueError(f"paged decode kernel takes 1 to {MAX_SPLITS} "
                         f"splits, not {n}")
    tables = tables.to(device=dev, dtype=torch.int32).contiguous()
    pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev)
    op = mp = lp = counters = None
    if n > 1:
        op = torch.empty(B * H * n * Hd, dtype=torch.float32, device=dev)
        ml = torch.empty(2, B * H * n, dtype=torch.float32, device=dev)
        mp, lp = ml[0], ml[1]
        counters = _counter_buffer(dev, stream,
                                   B * KV * -(-(H // KV) // GROUP_ROWS))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib, fn = _entry()
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              tables.data_ptr(), pos.data_ptr(), out.data_ptr(), ptr(op),
              ptr(mp), ptr(lp), ptr(counters), B, H, KV, Hd, page, maxp, n,
              float(Hd ** -0.5), stream.cuda_stream)
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
