"""Attention ops with selectable implementations (port of
``polyaxon_tpu/ops/attention.py``).

``impl``:
- ``"xla"``   einsum attention with f32 softmax — the always-correct
  reference (the name is kept from the JAX package so configs carry
  over);
- ``"flash"`` the hand-written Hopper flash-forward kernel
  (``ops/flash.py``); on CPU tensors its plain PyTorch version;
- ``"auto"``  the flash kernel when the tensors are on CUDA, the einsum
  path on the CPU;
- ``"ring"`` / ``"ulysses"`` are not ported yet and raise.

All impls take [B, S, H, D] and GQA (n_kv_heads <= n_heads) layouts.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] for grouped-query attention."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def xla_attention_with_lse(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Einsum attention that also returns the row logsumexp
    ``[B, H, Sq]`` (f32). Causal masking is offset by ``sk - sq`` so a
    short query block attends as the last rows of the square; masked
    logits are ``-1e30`` (not ``-inf``), as in the JAX package."""
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not causal:
            raise ValueError("sliding window requires causal attention")
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        ones = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=sk - sq)
        if window is not None:
            mask &= torch.triu(ones, diagonal=sk - sq - window + 1)
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    if segment_ids is not None:
        seg_mask = (segment_ids[:, None, :, None]
                    == segment_ids[:, None, None, :])
        logits = torch.where(seg_mask, logits,
                             torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.exp(logits - m)
    denom = unnorm.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(denom))[..., 0]  # [B, H, Sq]
    probs = (unnorm / denom).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v), lse


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    return xla_attention_with_lse(
        q, k, v, causal=causal, segment_ids=segment_ids,
        softmax_scale=softmax_scale, window=window)[0]


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "xla",
    segment_ids: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
    window: Optional[int] = None,
    block_q: Optional[int] = None,   # flash tile knobs (see ops/flash.py)
    block_k: Optional[int] = None,
    bwd_impl: Optional[str] = None,
) -> torch.Tensor:
    flash_kwargs = {k_: v_ for k_, v_ in (
        ("block_q", block_q), ("block_k", block_k),
        ("bwd_impl", bwd_impl)) if v_ is not None}
    if impl == "auto":
        # The flash kernel where the tensors live on the card; the
        # einsum reference on the CPU. Flash knobs are tolerated here so
        # configs stay portable.
        impl = "flash" if q.is_cuda else "xla"
    elif flash_kwargs and impl != "flash":
        raise ValueError(
            f"flash tuning knobs {sorted(flash_kwargs)} require "
            f"impl='flash' (or 'auto'), got `{impl}`")
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                             window=window)
    if impl == "flash":
        from polyaxon_tpu_torch.ops.flash import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window,
                               segment_ids=segment_ids, **flash_kwargs)
    if segment_ids is not None:
        raise ValueError(
            f"segment_ids (packed sequences) only supported by "
            f"impl='xla'/'flash', got `{impl}`")
    if window is not None:
        raise ValueError(
            f"sliding window is supported by impl='xla'/'flash', got `{impl}`")
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"impl='{impl}' (context parallelism over a device mesh) is not "
            "ported yet: ROADMAP.md, Queue 1, 'The parallel layer'")
    raise ValueError(f"Unknown attention impl `{impl}`")
