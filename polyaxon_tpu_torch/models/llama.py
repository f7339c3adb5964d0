"""Llama-3-style decoder (port of ``polyaxon_tpu/models/llama.py``): the
training surface (``apply``, packed sequences, remat) and the serving
subset (the paged KV and suffix-prefill surfaces).

Parameters are a plain dict of tensors with the JAX pytree's names and
layouts: ``embed [V, D]``, ``lm_head [D, V]``, ``final_norm [D]`` and
the stacked ``layers`` tensors ``[L, ...]`` with ``[in, out]`` matrices
(``x @ w``). Serving stores matrices in ``cfg.dtype`` and norm gains in
f32; the JAX package casts every matrix to ``cfg.dtype`` at use, so the
numbers are the same.

The paged KV cache (``{"k", "v"}: [L, P, page, KV, Hd]``) is updated
IN PLACE (``index_put_``) rather than rebuilt per step as the JAX
functions do; every function that writes it still returns it so the
call shapes match. Page 0 is scratch: idle rows and unallocated
coordinates write there and masks keep it unread.

Training keeps f32 master weights and computes in ``cfg.dtype``; the
layers run as a Python loop over per-layer views of the stacked tensors
(``torch.unbind``, so each stacked tensor's gradient is assembled once,
not once per layer). ``remat`` maps JAX's per-layer checkpoint policies
onto ``torch.utils.checkpoint``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _embed_rows,
    _w,
    chunked_lm_loss,
    lm_logits,
    rms_norm,
    rope,
    scaled_init,
    shift_right,
    truncated_normal_init,
)
from polyaxon_tpu_torch.ops.attention import (
    NEG_INF,
    dot_product_attention,
    repeat_kv,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    # Llama-3.1-style context-extension scaling (common.rope_frequencies).
    rope_scaling: Optional[dict] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Gemma-convention knobs: (1 + w) norm gains, tanh-approx GeGLU,
    # sqrt(dim)-scaled embeddings.
    norm_offset: float = 0.0
    mlp_activation: str = "silu"  # silu | gelu_tanh
    scale_embeddings: bool = False
    sliding_window: Optional[int] = None
    dtype: Any = torch.bfloat16
    # "auto" = the flash kernel on CUDA tensors, einsum on the CPU (the
    # port's serving path runs the kernel by default); "xla" = einsum;
    # "flash" = the flash wrapper on either device.
    attention_impl: str = "auto"
    # Paged decode attention: "auto" = ops.paged_attention (the kernel on
    # CUDA tensors, its plain version on the CPU); "gather" = the gather
    # + masked-softmax formulation.
    paged_attention_impl: str = "auto"
    # Per-layer recompute: none | full | dots (save matmul outputs only).
    remat: str = "none"
    # Flash knobs (runtime keys flow here via model_overrides): tile
    # sizes (validated, unused by the Hopper kernels) and the backward
    # ("pallas" = the kernels on CUDA, "xla" = the plain backward).
    # Setting one with attention_impl="xla" is an error.
    flash_block_q: Optional[int | str] = None
    flash_block_k: Optional[int | str] = None
    flash_bwd_impl: Optional[str] = None
    # Chunked lm-head loss slab length (peak memory holds [B, chunk, V]).
    loss_chunk: int = 256
    # Pipeline parallelism is not ported; >1 raises.
    pipeline_stages: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


_LLAMA31_SCALING = {
    "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}

CONFIGS: dict[str, LlamaConfig] = {
    "llama3_8b": LlamaConfig(),
    "llama31_8b": LlamaConfig(max_seq_len=131_072,
                              rope_scaling=_LLAMA31_SCALING),
    "mistral_7b": LlamaConfig(
        vocab_size=32_000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        ffn_dim=14_336, max_seq_len=32_768, rope_theta=10_000.0,
        sliding_window=4096,
    ),
    "llama3_1b": LlamaConfig(
        vocab_size=128_256, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
        ffn_dim=8192, max_seq_len=8192,
    ),
    "llama_200m": LlamaConfig(
        vocab_size=32_000, dim=1024, n_layers=12, n_heads=16, n_kv_heads=8,
        ffn_dim=2816, max_seq_len=2048, rope_theta=10_000.0,
    ),
    "llama3_draft_200m": LlamaConfig(
        vocab_size=128_256, dim=768, n_layers=10, n_heads=12, n_kv_heads=4,
        ffn_dim=2048, max_seq_len=8192,
    ),
    "llama_tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, rope_theta=10_000.0,
    ),
    "llama_tiny_tied": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq_len=128, rope_theta=10_000.0,
        tie_embeddings=True,
    ),
    "gemma_2b": LlamaConfig(
        vocab_size=256_000, dim=2048, n_layers=18, n_heads=8, n_kv_heads=1,
        ffn_dim=16_384, max_seq_len=8192, rope_theta=10_000.0,
        tie_embeddings=True, norm_offset=1.0, mlp_activation="gelu_tanh",
        scale_embeddings=True, norm_eps=1e-6,
    ),
    "gemma_tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=1,
        ffn_dim=128, max_seq_len=128, rope_theta=10_000.0,
        tie_embeddings=True, norm_offset=1.0, mlp_activation="gelu_tanh",
        scale_embeddings=True, norm_eps=1e-6,
    ),
}

# Norm gains stay f32 in every parameter tree; matrices take param_dtype.
_GAINS = ("attn_norm", "mlp_norm", "final_norm")


def init(cfg: LlamaConfig, generator: torch.Generator, *, device,
         param_dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters from ``generator`` (same shapes, scales and
    truncation as the JAX ``init``; the draws differ, as torch and JAX
    streams do). Stacked tensors are drawn one layer at a time so the
    f32 draw never holds more than one layer's slab."""
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.ffn_dim
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def stacked(shape, fan_in):
        out = torch.empty((L, *shape), dtype=param_dtype, device=device)
        for i in range(L):
            out[i] = scaled_init(shape, generator, device=device,
                                 dtype=param_dtype, fan_in=fan_in)
        return out

    gain = torch.full((L, D), 1.0 - cfg.norm_offset, dtype=torch.float32,
                      device=device)
    params = {
        "embed": truncated_normal_init((cfg.vocab_size, D), generator,
                                       device=device, dtype=param_dtype),
        "layers": {
            "attn_norm": gain,
            "wq": stacked((D, H * Hd), D),
            "wk": stacked((D, KV * Hd), D),
            "wv": stacked((D, KV * Hd), D),
            "wo": stacked((H * Hd, D), H * Hd),
            "mlp_norm": gain.clone(),
            "w_gate": stacked((D, F_), D),
            "w_up": stacked((D, F_), D),
            "w_down": stacked((F_, D), F_),
        },
        "final_norm": torch.full((D,), 1.0 - cfg.norm_offset,
                                 dtype=torch.float32, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init(
            (D, cfg.vocab_size), generator, device=device, dtype=param_dtype)
    return {"params": params, "state": {}}


def params_from_numpy(cfg: LlamaConfig, tree: dict, *, device,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    """JAX parameters as numpy arrays (same names, same layouts) → port
    tensors: an identity map, matrices in ``param_dtype`` and norm gains
    in f32."""
    def convert(name, value):
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        dt = torch.float32 if name in _GAINS else param_dtype
        return torch.tensor(np.asarray(value, np.float32), dtype=dt,
                            device=device)

    out = convert("", tree)
    expected = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(out) != expected:
        raise ValueError(f"parameter tree has keys {sorted(out)}, "
                         f"expected {sorted(expected)}")
    return out


def _layers(params: dict):
    """Per-layer views of the stacked ``[L, ...]`` tensors (one
    ``unbind`` per tensor: its backward stacks the L layer gradients
    once)."""
    per_layer = {name: t.unbind(0) for name, t in params["layers"].items()}
    for i in range(len(per_layer["wq"])):
        yield {name: views[i] for name, views in per_layer.items()}


def _norm(cfg, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, weight, cfg.norm_eps,
                    offset=getattr(cfg, "norm_offset", 0.0))


def _act(cfg):
    """MLP gate activation: SwiGLU (silu) or Gemma's tanh-approx GeGLU."""
    kind = getattr(cfg, "mlp_activation", "silu")
    if kind == "silu":
        return F.silu
    if kind == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown mlp_activation `{kind}`")


def _embed(cfg, params: dict, tokens: torch.Tensor, dt) -> torch.Tensor:
    x = _embed_rows(params["embed"], tokens, dt)
    if getattr(cfg, "scale_embeddings", False):
        x = x * torch.tensor(cfg.dim ** 0.5, dtype=dt, device=x.device)
    return x


def _mlp(cfg, x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The gated-MLP residual block (norm → act(gate)·up → down)."""
    dt = cfg.dtype
    h = _norm(cfg, x, layer["mlp_norm"])
    gate = _act(cfg)(h @ _w(layer["w_gate"], dt))
    up = h @ _w(layer["w_up"], dt)
    return x + (gate * up) @ _w(layer["w_down"], dt)


def _qkv(cfg, layer: dict, x: torch.Tensor, positions: torch.Tensor):
    """Attention-norm → q/k/v projections → RoPE on q and k, for x
    [B, S, D] at ``positions`` [B, S]. The same body serves the prompt
    pass, decode and the suffix prefill."""
    dt = cfg.dtype
    B, S, _ = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _norm(cfg, x, layer["attn_norm"])
    q = (h @ _w(layer["wq"], dt)).reshape(B, S, H, Hd)
    k = (h @ _w(layer["wk"], dt)).reshape(B, S, KV, Hd)
    v = (h @ _w(layer["wv"], dt)).reshape(B, S, KV, Hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    return q, k, v


def _attention(cfg, q, k, v, segment_ids=None) -> torch.Tensor:
    """``dot_product_attention`` owns the impl support matrix; the flash
    knobs ride along as JAX's ``_layer`` passes them."""
    return dot_product_attention(q, k, v, causal=True,
                                 impl=cfg.attention_impl,
                                 segment_ids=segment_ids,
                                 window=cfg.sliding_window,
                                 block_q=cfg.flash_block_q,
                                 block_k=cfg.flash_block_k,
                                 bwd_impl=cfg.flash_bwd_impl)


def _layer(cfg: LlamaConfig, x: torch.Tensor, layer: dict,
           positions: torch.Tensor,
           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, layer, x, positions)
    attn = _attention(cfg, q, k, v, segment_ids)
    x = x + attn.reshape(B, S, -1) @ _w(layer["wo"], cfg.dtype)
    return _mlp(cfg, x, layer)


# remat="dots": keep the outputs of matrix products, recompute the rest
# (norms, RoPE, activations, attention) in the backward. JAX's
# `checkpoint_dots_with_no_batch_dims` keeps the projections; the flash
# kernels are invisible to the dispatcher, so attention is recomputed.
_SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer_body(cfg: LlamaConfig):
    """The per-layer function under ``cfg.remat``."""
    body = functools.partial(_layer, cfg)
    if cfg.remat == "none":
        return body
    if cfg.remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    raise ValueError(f"unknown remat `{cfg.remat}` (none | full | dots)")


def _positions(B: int, S: int, device, start=0) -> torch.Tensor:
    return (start + torch.arange(S, dtype=torch.int32, device=device)
            )[None].expand(B, S)


def segment_starts(segment_ids: torch.Tensor) -> torch.Tensor:
    """Boolean [..., S] marking the first position of each segment."""
    return torch.cat([torch.ones_like(segment_ids[..., :1], dtype=torch.bool),
                      segment_ids[..., 1:] != segment_ids[..., :-1]], dim=-1)


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Within-segment positions for packed rows: [0,0,0,1,1] → [0,1,2,0,1]."""
    S = segment_ids.shape[-1]
    idx = torch.arange(S, dtype=torch.int32, device=segment_ids.device)
    starts = torch.where(segment_starts(segment_ids), idx,
                         torch.zeros_like(idx))
    return idx - torch.cummax(starts, dim=-1).values


def _check_not_pipelined(cfg: LlamaConfig) -> None:
    if cfg.pipeline_stages > 1:
        raise NotImplementedError(
            f"pipeline_stages={cfg.pipeline_stages}: pipeline parallelism "
            "is not ported yet (ROADMAP.md, Queue 1, 'The parallel layer')")


def hidden_states(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token ids [B, S] → final-norm hidden states [B, S, D].

    ``segment_ids`` [B, S] enables packed-sequence training: attention
    stays within each segment and RoPE positions restart per segment
    (derived unless ``positions`` is given)."""
    _check_not_pipelined(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = (segment_positions(segment_ids)
                     if segment_ids is not None
                     else _positions(B, S, tokens.device))
    x = _embed(cfg, params, tokens, cfg.dtype)
    body = _layer_body(cfg)
    for layer in _layers(params):
        x = body(x, layer, positions, segment_ids)
    return _norm(cfg, x, params["final_norm"])


def lm_head(cfg: LlamaConfig, params: dict) -> torch.Tensor:
    """The [D, V] head table (the transposed embedding when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def decode_logits(cfg: LlamaConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """Hidden states [..., D] → f32 logits [..., V]."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return lm_logits(x, w, cfg.dtype, transpose=cfg.tie_embeddings)


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids → f32 logits [B, S, vocab]."""
    x = hidden_states(cfg, params, tokens, positions)
    return (x @ lm_head(cfg, params).to(cfg.dtype)).to(torch.float32)


def apply(cfg: LlamaConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    """Next-token LM loss of ``batch["tokens"]`` [B, S] (optional
    ``segments`` [B, S] for packed rows, ``mask`` [B, S]). Each packed
    segment starts from BOS 0, so no token leaks across a boundary.
    Returns (loss, {"loss", "accuracy"}, state)."""
    tokens = batch["tokens"]
    inputs = shift_right(tokens)
    segments = batch.get("segments")
    if segments is not None:
        inputs = torch.where(segment_starts(segments),
                             torch.zeros_like(inputs), inputs)
    params = variables["params"]
    x = hidden_states(cfg, params, inputs, segment_ids=segments)
    head = lm_head(cfg, params).to(cfg.dtype)
    loss, acc = chunked_lm_loss(x, head, tokens, batch.get("mask"),
                                chunk=cfg.loss_chunk)
    return loss, {"loss": loss, "accuracy": acc}, variables["state"]


def model_def(name: str, **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    _check_not_pipelined(cfg)
    return ModelDef(
        name=name,
        init=lambda generator, device: init(cfg, generator, device=device),
        apply=functools.partial(apply, cfg),
        unit="tokens",
        config=cfg,
    )


def _prompt_pass(cfg: LlamaConfig, params: dict, prompt: torch.Tensor):
    """The causal prompt sweep over [B, P] token ids → (final hidden x
    [B, P, D], k_all, v_all [L, B, P, KV, Hd])."""
    B, P = prompt.shape
    positions = _positions(B, P, prompt.device)
    x = _embed(cfg, params, prompt, cfg.dtype)
    ks, vs = [], []
    for layer in _layers(params):
        q, k, v = _qkv(cfg, layer, x, positions)
        attn = _attention(cfg, q, k, v)
        x = x + attn.reshape(B, P, -1) @ _w(layer["wo"], cfg.dtype)
        x = _mlp(cfg, x, layer)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------- continuous batching
def cb_validate(cfg, prompt_len: int, max_new: int, max_len: int) -> None:
    """Decoder-only budget rule: prompt and generation share the cache."""
    if prompt_len + max_new > max_len:
        raise ValueError(
            f"prompt {prompt_len} + max_new_tokens {max_new} exceeds "
            f"max_len {max_len}")


def cb_admission(prompt: list) -> tuple:
    """(start position, first decode token, prefill tokens): the last
    prompt token is the first decode input; the rest prefill the cache
    (none for single-token prompts)."""
    return (len(prompt) - 1, prompt[-1],
            list(prompt[:-1]) if len(prompt) > 1 else None)


# ------------------------------------------------------- paged KV decode
def check_kernel_shapes(cfg: LlamaConfig, device, *,
                        training: bool = False) -> None:
    """On a CUDA device, raise if a kernel this config's serving path (or,
    with ``training``, its training path) launches cannot take its
    head_dim: at construction, not inside every step. The CPU runs the
    plain versions, which take any shape."""
    if torch.device(device).type != "cuda":
        return
    from polyaxon_tpu_torch.ops import flash, paged_attention

    kernels = []
    if cfg.attention_impl in ("auto", "flash"):
        kernels.append(("flash_fwd", flash.KERNEL_HEAD_DIMS))
        if training and cfg.flash_bwd_impl != "xla":
            kernels.append(("flash_bwd", flash.KERNEL_HEAD_DIMS))
    if not training and cfg.paged_attention_impl == "auto":
        kernels.append(("paged_decode", paged_attention.KERNEL_HEAD_DIMS))
    for name, dims in kernels:
        if cfg.head_dim not in dims:
            raise ValueError(
                f"the {name} kernel takes head_dim in {dims}; this config "
                f"has {cfg.head_dim}")


def paged_init_cache(cfg: LlamaConfig, n_pages: int, page_size: int, *,
                     device) -> dict:
    if cfg.sliding_window is not None:
        raise ValueError(
            "paged KV does not support sliding_window yet — the ring "
            "buffer already bounds that cache; use kv='dense'")
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def paged_coords(pos: torch.Tensor, tables: torch.Tensor, page: int):
    """Per-row positions [B] (-1 = idle) + block tables [B, maxp] →
    (positions [B, 1] for RoPE, write_page [B], write_off [B], mask
    [B, 1, 1, maxp*page]). Idle/unallocated writes land on scratch page
    0; the mask admits exactly positions 0..pos through allocated
    pages."""
    B, maxp = tables.shape
    pos_safe = pos.clamp(min=0)
    rows = torch.arange(B, device=pos.device)
    slot = (pos_safe // page).clamp(max=maxp - 1)
    write_page = torch.where(pos >= 0, tables[rows, slot],
                             torch.zeros_like(pos)).clamp(min=0)
    write_off = pos_safe % page
    j = torch.arange(maxp * page, device=pos.device)[None, :]
    allocated = (tables >= 0).repeat_interleave(page, dim=1)
    valid = ((j <= pos_safe[:, None]) & (pos[:, None] >= 0)
             & allocated)[:, None, None, :]
    return pos_safe[:, None], write_page, write_off, valid


def paged_kernel_args(positions: torch.Tensor, tables: torch.Tensor,
                      valid: torch.Tensor):
    """What the decode kernel takes, the same in every layer of a step:
    (tables as int32, pos [B] int32 with -1 for a row the mask leaves
    empty)."""
    live = valid[:, 0, 0, :].any(dim=-1)
    pos = torch.where(live, positions[:, 0],
                      torch.full_like(positions[:, 0], -1))
    return tables.to(torch.int32), pos.to(torch.int32)


def paged_attn_step(cfg, layer: dict, x: torch.Tensor,
                    k_pages: torch.Tensor, v_pages: torch.Tensor,
                    positions: torch.Tensor, write_page: torch.Tensor,
                    write_off: torch.Tensor, tables: torch.Tensor,
                    valid: torch.Tensor, kernel_args):
    """Writes this step's K/V into each row's current page slot (in
    place) and attends over the row's pages. ``tables`` [B, maxp]
    (-1 = not allocated), ``valid`` [B, 1, 1, maxp*page] masks real
    positions; ``kernel_args`` is ``paged_kernel_args``'s result (for
    ``paged_attention_impl="auto"``), computed once per step by the
    caller. Returns (x after the attention residual, k_pages,
    v_pages)."""
    dt = cfg.dtype
    B = x.shape[0]
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, layer, x, positions)
    k_pages[write_page, write_off] = k[:, 0]
    v_pages[write_page, write_off] = v[:, 0]

    impl = getattr(cfg, "paged_attention_impl", "gather")
    if impl == "auto":
        from polyaxon_tpu_torch.ops.paged_attention import (
            paged_decode_attention,
        )

        attn = paged_decode_attention(
            q[:, 0], k_pages, v_pages, *kernel_args).to(dt)[:, None]
    elif impl == "gather":
        idx = tables.clamp(min=0).long()
        keys = repeat_kv(k_pages[idx].reshape(B, -1, KV, Hd), H // KV)
        vals = repeat_kv(v_pages[idx].reshape(B, -1, KV, Hd), H // KV)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, keys).to(torch.float32)
        logits = logits * (Hd ** -0.5)
        logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, vals)
    else:
        raise ValueError(f"unknown paged_attention_impl `{impl}` "
                         "(expected 'auto' or 'gather')")
    return (x + attn.reshape(B, 1, H * Hd) @ _w(layer["wo"], dt),
            k_pages, v_pages)


def decode_step_paged(cfg: LlamaConfig, params: dict, cache: dict,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      tables: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step for every row over the paged pool: tokens [B],
    pos [B] (-1 idle), tables [B, maxp]. Returns (logits [B, V] f32,
    cache), the cache updated in place."""
    page = cache["k"].shape[2]
    positions, write_page, write_off, valid = paged_coords(pos, tables, page)
    kernel_args = (paged_kernel_args(positions, tables, valid)
                   if cfg.paged_attention_impl == "auto" else None)
    x = _embed(cfg, params, tokens, cfg.dtype)[:, None, :]
    for i, layer in enumerate(_layers(params)):
        x, _, _ = paged_attn_step(
            cfg, layer, x, cache["k"][i], cache["v"][i], positions,
            write_page, write_off, tables, valid, kernel_args)
        x = _mlp(cfg, x, layer)
    x = _norm(cfg, x, params["final_norm"])
    return decode_logits(cfg, params, x[:, 0]), cache


def paged_prefill_kv(cfg: LlamaConfig, params: dict, prompt: torch.Tensor):
    """Prompt pass returning raw per-position KV for a single row
    [1, P]: (k_all, v_all) [L, P, KV, Hd]."""
    _, k_all, v_all = _prompt_pass(cfg, params, prompt)
    return k_all[:, 0], v_all[:, 0]


def paged_insert_prefill(cache: dict, k_all: torch.Tensor,
                         v_all: torch.Tensor, page_ids: torch.Tensor,
                         page_size: int) -> dict:
    """Scatter a prefilled row's KV ([L, P, KV, Hd]) into its pages, in
    place. ``page_ids`` [maxp] (-1 beyond the row's pages)."""
    P = k_all.shape[1]
    t = torch.arange(P, device=k_all.device)
    pidx = page_ids.to(k_all.device).long()[t // page_size].clamp(min=0)
    off = t % page_size
    cache["k"][:, pidx, off] = k_all
    cache["v"][:, pidx, off] = v_all
    return cache


def suffix_attn_step(cfg, layer: dict, x: torch.Tensor,
                     k_prefix: torch.Tensor, v_prefix: torch.Tensor,
                     positions: torch.Tensor, valid: torch.Tensor):
    """One attention sublayer for a prefill SUFFIX [B, S] whose prefix
    KV already exists (radix-cache hit): queries at absolute
    ``positions`` attend [prefix; suffix]. The prefix K is already roped.
    ``valid`` [B, 1, S, Mpad+S]. Returns (x, k_suffix, v_suffix)."""
    dt = cfg.dtype
    B, S = positions.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, layer, x, positions)
    keys = repeat_kv(torch.cat([k_prefix, k], dim=1), H // KV)
    vals = repeat_kv(torch.cat([v_prefix, v], dim=1), H // KV)
    s = torch.einsum("bqhd,bkhd->bhqk", q, keys).to(torch.float32)
    s = s * (Hd ** -0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(dt)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, vals)
    return x + attn.reshape(B, S, H * Hd) @ _w(layer["wo"], dt), k, v


def _suffix_mask(S: int, m_pad: int, m: int, device=None) -> torch.Tensor:
    """[1, 1, S, m_pad+S] validity for a suffix prefill: prefix column j
    is real iff j < m; suffix columns are causal."""
    pref_ok = (torch.arange(m_pad, device=device)[None, :] < m).expand(
        S, m_pad)
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=device))
    return torch.cat([pref_ok, tri], dim=1)[None, None]


def paged_prefill_suffix_kv(cfg: LlamaConfig, params: dict,
                            suffix: torch.Tensor, k_prefix: torch.Tensor,
                            v_prefix: torch.Tensor, m: int):
    """Prefill only the novel tail of a prompt whose first ``m`` tokens
    hit the radix prefix cache: ``suffix`` [1, S] at absolute positions
    m..m+S-1, ``k_prefix``/``v_prefix`` [L, Mpad, KV, Hd] the matched
    pages in chain order (columns past m are masked). Returns (k_suf,
    v_suf) [L, S, KV, Hd]."""
    B, S = suffix.shape
    m_pad = k_prefix.shape[1]
    positions = _positions(B, S, suffix.device, start=int(m))
    valid = _suffix_mask(S, m_pad, int(m), device=suffix.device)
    x = _embed(cfg, params, suffix, cfg.dtype)
    ks, vs = [], []
    for i, layer in enumerate(_layers(params)):
        x, k, v = suffix_attn_step(cfg, layer, x, k_prefix[i][None],
                                   v_prefix[i][None], positions, valid)
        x = _mlp(cfg, x, layer)
        ks.append(k[0])
        vs.append(v[0])
    return torch.stack(ks), torch.stack(vs)


def paged_insert_suffix(cache: dict, k_suf: torch.Tensor,
                        v_suf: torch.Tensor, page_ids: torch.Tensor,
                        start: int, page_size: int,
                        real_len: Optional[int] = None) -> dict:
    """Scatter suffix KV ([L, S, KV, Hd]) into the row's pages at
    absolute positions start..start+S-1, in place. Positions at or past
    ``real_len`` are bucket padding: they go to scratch page 0. The page
    lookup clips to the table explicitly, so a padded tail never lands
    on the table's last (real) entry."""
    S = k_suf.shape[1]
    idx = torch.arange(S, device=k_suf.device)
    t = int(start) + idx
    ids = page_ids.to(k_suf.device).long()
    slot = (t // page_size).clamp(max=ids.shape[0] - 1)
    pidx = ids[slot].clamp(min=0)
    if real_len is not None:
        pidx = torch.where(idx < int(real_len), pidx, torch.zeros_like(pidx))
    off = t % page_size
    cache["k"][:, pidx, off] = k_suf
    cache["v"][:, pidx, off] = v_suf
    return cache
