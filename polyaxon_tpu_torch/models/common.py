"""Shared model numerics (port of ``polyaxon_tpu/models/common.py``).

The pieces the serving and training slices run: the ``ModelDef``
convention, RoPE, RMSNorm, the weight read at consumption, the
unquantized logits projection, the embedding gather, one-row sampling,
the random initializers, and the training losses (cross entropy, the
chunked LM loss, ``shift_right``). Parameters keep the JAX pytree's
names and layouts (``x @ w`` with ``[in, out]`` weights), so weights
move between the packages as an identity map.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Variables = dict[str, Any]  # {"params": dict of tensors, "state": dict}
Batch = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A model as the runtime sees it (the JAX package's convention,
    without ``logical_axes``: the port does not shard).

    - ``init(generator, device=...) -> Variables`` (f32 master weights);
    - ``apply(variables, batch, train, rng) -> (loss, metrics, state)``.
    """

    name: str
    init: Callable[..., Variables]
    apply: Callable[..., tuple[torch.Tensor, dict, Any]]
    # tokens (LM) or samples (vision) consumed per batch element.
    unit: str = "examples"
    config: Any = None


def truncated_normal_init(shape, generator: torch.Generator, *,
                          device, dtype=torch.float32,
                          stddev: float = 0.02) -> torch.Tensor:
    """``stddev`` × a standard normal truncated to [-2, 2]. Drawn in
    f32 (bf16 has too few bits for the inverse-CDF draw) and cast."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return out.mul_(stddev).to(dtype)


def scaled_init(shape, generator: torch.Generator, *, device,
                dtype=torch.float32,
                fan_in: Optional[int] = None) -> torch.Tensor:
    """LeCun-style scaling by fan-in (default: product of all but last
    axis)."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    stddev = 1.0 / math.sqrt(max(int(fan_in), 1))
    return truncated_normal_init(shape, generator, device=device,
                                 dtype=dtype, stddev=stddev)


def rope_frequencies(d_half: int, theta: float,
                     scaling: Optional[dict] = None,
                     device=None) -> torch.Tensor:
    """Inverse RoPE frequencies (f32), optionally Llama-3.1-style scaled:
    long wavelengths divided by ``factor``, short ones kept, the band in
    between interpolated in "smooth" space."""
    freqs = 1.0 / (theta ** (torch.arange(0, d_half, dtype=torch.float32,
                                          device=device) / d_half))
    if not scaling:
        return freqs
    factor = float(scaling.get("factor", 8.0))
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * math.pi / freqs
    smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
    return (1.0 - smooth) * (freqs / factor) + smooth * freqs


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: Optional[dict] = None) -> torch.Tensor:
    """Rotary embeddings on [B, S, H, D], split-half convention, f32
    trig; the result keeps x's dtype."""
    d_half = x.shape[-1] // 2
    freqs = rope_frequencies(d_half, theta, scaling, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in f32; ``offset`` 1 applies Gemma's ``(1 + w)`` gains."""
    x32 = x.to(torch.float32)
    normed = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (normed * (offset + weight.to(torch.float32))).to(x.dtype)


def _w(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Weight read at the point of consumption: cast to the compute
    dtype (a no-op when serving already stores ``cfg.dtype``)."""
    return w.to(dt)


def lm_logits(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype, *,
              transpose: bool = False) -> torch.Tensor:
    """``x [..., D] @ head → [..., V]``: the product in ``dt``, cast to
    f32, exactly as the JAX package computes its unquantized branch.
    ``transpose`` reads a tied [V, D] embedding table."""
    tab = (w.T if transpose else w).to(dt)
    return (x.to(dt) @ tab).to(torch.float32)


def _embed_rows(embed: torch.Tensor, tokens: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """Embedding gather in the compute dtype (gathering first, then
    casting, reads the same values as casting the table first)."""
    return embed[tokens].to(dt)


def sample_row(logits: torch.Tensor, generator: torch.Generator,
               temperature: float, top_p: float,
               top_k: int) -> torch.Tensor:
    """Temperature + nucleus (top-p) + top-k sampling for ONE row of
    logits [V]. ``top_p >= 1`` and ``top_k <= 0`` disable their filters;
    greedy (temperature 0) is the caller's branch. Sampling happens in
    descending-sorted space: nucleus keeps the minimal prefix whose
    exclusive mass stays below ``top_p`` (the first token always
    survives), top-k keeps the first ``k`` positions, and the drawn
    sorted index maps back through the sort permutation."""
    V = logits.shape[-1]
    scaled = logits.to(torch.float32) / max(float(temperature), 1e-6)
    sorted_l, sort_idx = torch.sort(scaled, descending=True)
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive prefix mass
    keep = cum < (math.inf if top_p >= 1.0 else float(top_p))
    keep &= torch.arange(V, device=logits.device) < (
        int(top_k) if top_k > 0 else V)
    masked = torch.where(keep, sorted_l, torch.full_like(sorted_l,
                                                         -math.inf))
    draw = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                             generator=generator)
    return sort_idx[draw[0]].to(torch.int32)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over unmasked positions (f32), plus accuracy. Labels < 0
    are masked out."""
    logits = logits.to(torch.float32)
    log_probs = F.log_softmax(logits, dim=-1)
    labels_clipped = labels.clamp(min=0).long()
    nll = -log_probs.gather(-1, labels_clipped[..., None])[..., 0]
    correct = (logits.argmax(-1) == labels_clipped).to(torch.float32)
    valid = (labels >= 0).to(torch.float32)
    mask = valid if mask is None else mask.to(torch.float32) * valid
    denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, (correct * mask).sum() / denom


def _chunk_stats(hc: torch.Tensor, head: torch.Tensor, yc: torch.Tensor,
                 mc: torch.Tensor) -> torch.Tensor:
    logits = (hc @ head).to(torch.float32)  # [B, chunk, V]
    log_probs = F.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, yc[..., None])[..., 0]
    correct = (logits.argmax(-1) == yc).to(torch.float32)
    return torch.stack([(nll * mc).sum(), (correct * mc).sum()])


def chunked_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE without materializing the [B, S, V] logits: the
    lm-head projection and log-softmax run one sequence chunk at a time
    under ``torch.utils.checkpoint``, so the backward recomputes each
    chunk's [B, chunk, V] f32 logits from the saved hidden slab. The
    chunk is ``pick_block(S, chunk)``, as in the JAX package; the numbers
    are those of ``cross_entropy_loss`` over full logits."""
    from polyaxon_tpu_torch.ops.flash import pick_block

    S = hidden.shape[1]
    chunk = pick_block(S, chunk)
    if mask is None:
        mask = labels >= 0
    mask = mask.to(torch.float32) * (labels >= 0).to(torch.float32)
    labels_clipped = labels.clamp(min=0).long()
    stats = None
    for start in range(0, S, chunk):
        part = slice(start, start + chunk)
        s = checkpoint(_chunk_stats, hidden[:, part], head,
                       labels_clipped[:, part], mask[:, part],
                       use_reentrant=False)
        stats = s if stats is None else stats + s
    denom = mask.sum().clamp(min=1.0)
    return stats[0] / denom, stats[1] / denom


def shift_right(tokens: torch.Tensor, bos_id: int = 0) -> torch.Tensor:
    """Next-token LM inputs: tokens shifted right with BOS at position 0."""
    return torch.cat([torch.full_like(tokens[:, :1], bos_id),
                      tokens[:, :-1]], dim=1)
