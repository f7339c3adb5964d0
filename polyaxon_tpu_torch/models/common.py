"""Shared model numerics (port of ``polyaxon_tpu/models/common.py``).

The pieces the model families share: the ``ModelDef`` convention, RoPE,
RMSNorm, LayerNorm, GELU, the weight read at consumption (plain or
int8), the logits projection, the embedding gather, sampling, the random
initializers, the numpy-to-tensor weight map, and the training losses
(cross entropy, the chunked LM loss, ``shift_right``). Parameters keep
the JAX pytree's names and layouts (``x @ w`` with ``[in, out]``
weights), so weights move between the packages as an identity map.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

Variables = dict[str, Any]  # {"params": dict of tensors, "state": dict}
Batch = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A model as the runtime sees it (the JAX package's convention).

    - ``init(generator, device=...) -> Variables`` (f32 master weights);
    - ``apply(variables, batch, train, rng) -> (loss, metrics, state)``;
    - ``logical_axes() -> Variables``-shaped tree of logical-axis tuples,
      which the rule tables map onto the mesh (``parallel/sharding.py``).
    """

    name: str
    init: Callable[..., Variables]
    apply: Callable[..., tuple[torch.Tensor, dict, Any]]
    # tokens (LM) or samples (vision) consumed per batch element.
    unit: str = "examples"
    config: Any = None
    # Metric keys that are mask-independent per-microbatch means (MoE
    # router aux): gradient accumulation averages them uniformly instead
    # of weighting them by valid tokens. A model with such a loss term
    # also returns it as the differentiable ``loss_unweighted`` metric,
    # so that the accumulated gradient stays exact.
    uniform_metrics: tuple = ()
    logical_axes: Optional[Callable[[], Variables]] = None
    # Top-level parameter keys holding stacked [L, ...] layers that the
    # model reads through ``unstack`` inside a ``remat_body``: a leaf
    # sharded over fsdp there is gathered one layer at a time, at use
    # (``parallel/fsdp.py``); elsewhere a sharded leaf is gathered whole.
    layer_stacks: tuple = ()
    # ``apply`` computes its sequence shard under a cp mesh axis above 1.
    context_parallel: bool = False
    # ``apply`` computes on its tp shards (``parallel/tensor.py``); a
    # family without it gathers them and computes replicated over tp.
    tensor_parallel: bool = False
    # ``apply`` runs its layers as a pipeline over the pp mesh axis.
    pipeline_parallel: bool = False
    # ``init`` takes ``take=`` (``parallel/sharding.py ShardTaker``) and
    # draws only this rank's shards; another family's init is drawn
    # whole and cut leaf by leaf.
    sharded_init: bool = False


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32 (biased variance); the result keeps x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def tree_from_numpy(tree: dict, *, device, param_dtype: torch.dtype,
                    f32_names=(), name: str = "") -> dict:
    """A JAX parameter (or state) tree as numpy arrays → port tensors
    under the same names and layouts (an identity map): leaves named in
    ``f32_names`` stay f32 (norm gains and the like), the rest take
    ``param_dtype``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device=device, param_dtype=param_dtype,
                                   f32_names=f32_names, name=k)
                for k, v in tree.items()}
    dt = torch.float32 if name in f32_names else param_dtype
    return torch.tensor(np.asarray(tree, np.float32), dtype=dt,
                        device=device)


def unstack(layers: dict):
    """Per-layer views of stacked ``[L, ...]`` tensors (one ``unbind``
    per tensor: its backward stacks the L layer gradients once). A
    ``parallel.fsdp.ShardedStack`` yields per-layer shards, gathered
    where the layer body starts."""
    per_layer = {name: t.unbind(0) for name, t in layers.items()}
    for i in range(len(next(iter(per_layer.values())))):
        yield {name: views[i] for name, views in per_layer.items()}


# remat="dots": keep the outputs of matrix products, recompute the rest
# (norms, RoPE, activations, attention) in the backward. JAX's
# `checkpoint_dots_with_no_batch_dims` keeps the projections; the flash
# kernels are invisible to the dispatcher, so attention is recomputed.
_SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_body(body, remat: str):
    """A per-layer function under the JAX package's remat policies
    (none | full | dots), mapped onto ``torch.utils.checkpoint``. Sharded
    layer weights are gathered inside the body, so a recomputed layer
    gathers again; the body runs under the mesh current at this call
    (``parallel.fsdp.gather_args``)."""
    from polyaxon_tpu_torch.parallel.fsdp import gather_args

    body = gather_args(body)
    if remat == "none":
        return body
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat `{remat}` (none | full | dots)")


def merged_weight(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """LoRA's ``W + scale·A@B`` in f32, cast back to W's dtype, over any
    leading stack dims; gradients reach A and B, not W. One fused
    product (``baddbmm``): under remat "dots" a separate ``A@B`` would be
    saved as a matrix product's output, a full f32 copy of every adapted
    weight per layer."""
    shape = w.shape
    w32 = w.detach().to(torch.float32).reshape(-1, *shape[-2:])
    a32 = a.to(torch.float32).reshape(-1, *a.shape[-2:])
    b32 = b.to(torch.float32).reshape(-1, *b.shape[-2:])
    return torch.baddbmm(w32, a32, b32, alpha=scale).reshape(shape).to(
        w.dtype)


class LoraWeight:
    """A LoRA-adapted projection read at its use (``models/lora.py``):
    ``_w`` merges it, ``W + (alpha/rank)·A@B``, one weight at a time;
    ``unbind(0)`` gives the per-layer weights of a stacked one (the
    models' layer loops unbind every ``[L, ...]`` leaf)."""

    __slots__ = ("w", "a", "b", "scale")

    def __init__(self, w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 scale: float):
        self.w, self.a, self.b, self.scale = w, a, b, scale

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self):
        return self.w.dtype

    def merged(self) -> torch.Tensor:
        return merged_weight(self.w, self.a, self.b, self.scale)

    def unbind(self, dim: int = 0) -> tuple["LoraWeight", ...]:
        if dim != 0:
            raise ValueError("LoraWeight unbinds its leading axis only")
        return tuple(LoraWeight(w, a, b, self.scale) for w, a, b in zip(
            self.w.unbind(0), self.a.unbind(0), self.b.unbind(0)))

    def reshape(self, shape) -> "LoraWeight":
        """New leading (layer) axes over the same matrices: the pipeline's
        ``[L, ...]`` → ``[stages, L/stages, ...]``."""
        lead = tuple(shape)[:len(shape) - 2]
        return LoraWeight(self.w.reshape(shape),
                          self.a.reshape(lead + tuple(self.a.shape[-2:])),
                          self.b.reshape(lead + tuple(self.b.shape[-2:])),
                          self.scale)

    def __getitem__(self, index) -> "LoraWeight":
        """A stage's (or a layer's) weights, along the leading axis."""
        return LoraWeight(self.w[index], self.a[index], self.b[index],
                          self.scale)


def is_quantized(w) -> bool:
    """An int8 ``QuantizedTensor`` (``serving/quantize.py``: int8 values
    ``q`` and their ``scale``)."""
    return not isinstance(w, torch.Tensor) and hasattr(w, "q")


def _w(w, dt: torch.dtype) -> torch.Tensor:
    """Weight read at the point of consumption: cast to the compute
    dtype (a no-op when serving already stores ``cfg.dtype``). An int8
    ``QuantizedTensor`` is dequantized here and a ``LoraWeight`` merged
    here, one weight at a time, never as a whole tree."""
    if isinstance(w, LoraWeight):
        return w.merged().to(dt)
    if is_quantized(w):
        return w.dequantize().to(dt)
    return w.to(dt)


def _lm_chunk_len(V: int, chunk: int) -> Optional[int]:
    """Largest power-of-two chunk <= min(chunk, V // 2), or None when V
    is too small to split."""
    cap = min(chunk, V // 2)
    if cap < 1:
        return None
    return 1 << (cap.bit_length() - 1)


def lm_logits(x: torch.Tensor, w, dt: torch.dtype, *,
              transpose: bool = False, chunk: int = 4096) -> torch.Tensor:
    """``x [..., D] @ head → [..., V]``: the product in ``dt``, cast to
    f32, exactly as the JAX package computes it. ``transpose`` reads a
    tied [V, D] embedding table. A quantized head is dequantized one
    vocab chunk at a time (the JAX package's loop over V-chunks); the
    column chunking does not reorder the contraction, so each column is
    the one-product value."""
    if not is_quantized(w):
        tab = (w.T if transpose else w).to(dt)
        return (x.to(dt) @ tab).to(torch.float32)
    q, scale = w.q, w.scale
    V = q.shape[0] if transpose else q.shape[1]
    c = _lm_chunk_len(V, chunk)
    if c is None:
        tab = w.dequantize().to(dt)
        return (x @ (tab.T if transpose else tab)).to(torch.float32)
    outs = []
    for start in range(0, V, c):
        if transpose:  # q [V, D], scale [1, D]
            tab = (q[start:start + c].to(torch.float32) * scale).to(dt).T
        else:  # q [D, V], scale [1, V]
            tab = (q[:, start:start + c].to(torch.float32)
                   * scale[:, start:start + c]).to(dt)
        outs.append((x @ tab).to(torch.float32))
    return torch.cat(outs, dim=-1)


def _embed_rows(embed, tokens: torch.Tensor,
                dt: torch.dtype) -> torch.Tensor:
    """Embedding gather in the compute dtype (gathering first, then
    casting, reads the same values as casting the table first). A
    quantized table gathers its int8 rows first and dequantizes only
    those."""
    if is_quantized(embed):
        return (embed.q[tokens].to(torch.float32) * embed.scale).to(dt)
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


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float, top_p: float = 1.0,
                  top_k: int = 0) -> torch.Tensor:
    """Batch sampling [B, V] → [B] int32 with shared knobs (the family
    ``generate`` path): one categorical draw per row from the
    temperature-scaled softmax, or ``sample_row`` per row when top-p or
    top-k filter. The draws come from ``generator``, so they differ from
    the JAX package's key stream; greedy is the caller's branch."""
    if top_p >= 1.0 and top_k <= 0:
        probs = torch.softmax(
            logits.to(torch.float32) / max(float(temperature), 1e-6), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    return torch.stack([sample_row(row, generator, temperature, top_p, top_k)
                        for row in logits])


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
                 mc: torch.Tensor, vocab_shard=None) -> torch.Tensor:
    logits = (hc @ head).to(torch.float32)  # [B, chunk, V]
    if vocab_shard is not None:
        from polyaxon_tpu_torch.parallel.tensor import vocab_parallel_ce

        nll, correct = vocab_parallel_ce(logits, yc, vocab_shard)
    else:
        log_probs = F.log_softmax(logits, dim=-1)
        nll = -log_probs.gather(-1, yc[..., None])[..., 0]
        correct = (logits.argmax(-1) == yc).to(torch.float32)
    return torch.stack([(nll * mc).sum(), (correct * mc).sum()])


def chunked_lm_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    chunk: int = 256, vocab_shard=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token CE without materializing the [B, S, V] logits: the
    lm-head projection and log-softmax run one sequence chunk at a time
    under ``torch.utils.checkpoint``, so the backward recomputes each
    chunk's [B, chunk, V] f32 logits from the saved hidden slab. The
    chunk is ``pick_block(S, chunk)``, as in the JAX package; the numbers
    are those of ``cross_entropy_loss`` over full logits. With
    ``vocab_shard`` (``parallel.tensor.vocab_shard``) ``head`` is this
    rank's vocab columns and the CE is vocab-parallel."""
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
                       labels_clipped[:, part], mask[:, part], vocab_shard,
                       use_reentrant=False)
        stats = s if stats is None else stats + s
    denom = mask.sum().clamp(min=1.0)
    return stats[0] / denom, stats[1] / denom


def shift_right(tokens: torch.Tensor, bos_id: int = 0) -> torch.Tensor:
    """Next-token LM inputs: tokens shifted right with BOS at position 0."""
    return torch.cat([torch.full_like(tokens[:, :1], bos_id),
                      tokens[:, :-1]], dim=1)
