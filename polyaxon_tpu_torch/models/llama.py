"""Llama-3-style decoder (port of ``polyaxon_tpu/models/llama.py``): the
training surface (``apply``, packed sequences, remat) and the serving
surfaces: the dense ring-buffer cache (``prefill``, ``decode_step``,
``decode_step_ragged``, the continuous-batching hooks, ``decode_chunk``
and ``generate``), the paged KV cache and the suffix prefill.

Parameters are a plain dict of tensors with the JAX pytree's names and
layouts: ``embed [V, D]``, ``lm_head [D, V]``, ``final_norm [D]`` and
the stacked ``layers`` tensors ``[L, ...]`` with ``[in, out]`` matrices
(``x @ w``). Serving stores matrices in ``cfg.dtype`` and norm gains in
f32; the JAX package casts every matrix to ``cfg.dtype`` at use, so the
numbers are the same.

The dense cache (``{"k", "v"}: [L, B, C, KV, Hd]``, C = ``cache_len``)
and the paged cache (``[L, P, page, KV, Hd]``) are updated IN PLACE
(``index_put_``) rather than rebuilt per step as the JAX functions do;
every function that writes one still returns it so the call shapes
match. In the paged pool page 0 is scratch: idle rows and unallocated
coordinates write there and masks keep it unread. The attention of a
dense decode step (and of ``decode_chunk``) is plain PyTorch, as the JAX
package computes it in XLA outside any Pallas kernel; every prompt pass
goes through ``dot_product_attention``, i.e. the flash kernel on CUDA.

Serving weights may be int8 ``QuantizedTensor`` leaves
(``serving/quantize.py``): ``_w``, ``_embed_rows``, ``lm_head`` and
``decode_logits`` dequantize each at its use.

Training keeps f32 master weights and computes in ``cfg.dtype``; the
layers run as a Python loop over per-layer views of the stacked tensors
(``torch.unbind``, so each stacked tensor's gradient is assembled once,
not once per layer). ``remat`` maps JAX's per-layer checkpoint policies
onto ``torch.utils.checkpoint``.

Under a mesh with ``tp`` above 1 each rank computes on its shards
(``parallel/tensor.py``): column-parallel ``wq``/``wk``/``wv``/
``w_gate``/``w_up`` (its heads and its ``mlp`` slice, attention on its
local heads), row-parallel ``wo``/``w_down`` followed by *reduce*, the
vocab-parallel embedding, head and cross entropy. Where the KV heads do
not split over tp (gemma's one KV head), every rank computes K and V
whole and takes its query heads' group, which is what GSPMD computes
when it splits ``kv_heads·head_dim``. The serving steps compute the
same way (``serving/gang.py``): a rank's KV cache holds its local KV
heads (``local_kv_heads``), each attention and MLP output is summed
over tp, and the logits come out whole (``_vocab_whole``); fsdp shards
are gathered layer by layer (``_serving_layers``). With
``pipeline_stages`` above 1 the layers run as a GPipe schedule over the
``pp`` axis (``parallel/pipeline.py``); the head and the loss run on the
last stage.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F

from polyaxon_tpu_torch.models.common import (
    ModelDef,
    Variables,
    _embed_rows,
    _w,
    chunked_lm_loss,
    is_quantized,
    lm_logits,
    remat_body,
    rms_norm,
    rope,
    scaled_init,
    shift_right,
    tree_from_numpy,
    truncated_normal_init,
    unstack,
)
from polyaxon_tpu_torch.ops.attention import (
    NEG_INF,
    dot_product_attention,
    repeat_kv,
)
from polyaxon_tpu_torch.parallel.mesh import current_mesh, seq_shard
from polyaxon_tpu_torch.parallel.sharding import WHOLE, ShardTaker
from polyaxon_tpu_torch.parallel.tensor import (copy_to_tp, gather_from_tp,
                                                reduce_from_tp, tp_axis,
                                                vocab_embed, vocab_shard)


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
    # Vocab-chunk length for quantized decode logits (common.lm_logits):
    # bounds the bf16 copy of the int8 head that a decode step makes. A
    # field, not a constant, so that the reference's configs and
    # model_overrides are taken as they are.
    lm_logits_chunk: int = 4096
    # Pipeline parallelism over the `pp` mesh axis (parallel/pipeline.py):
    # >1 splits the layer stack into that many stages, each batch into
    # `pipeline_microbatches`; the double-buffered schedule sends each
    # tick's PREVIOUS output (the same per-microbatch outputs).
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    pipeline_double_buffer: bool = True

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
         param_dtype: torch.dtype = torch.float32,
         take: ShardTaker = WHOLE) -> dict:
    """Random parameters from ``generator`` (same shapes, scales and
    truncation as the JAX ``init``; the draws differ, as torch and JAX
    streams do). Stacked tensors are drawn one layer at a time so the
    f32 draw never holds more than one layer's slab; with a ``take``
    over a mesh (``parallel/sharding.py ShardTaker``) each rank keeps its
    piece of every slab, so it holds only its shards of the same
    draw."""
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.ffn_dim
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def stacked(name, shape, fan_in):
        leaf = take.leaf(("layers", name), (L, *shape))
        out = torch.empty(leaf.shape, dtype=param_dtype, device=device)
        for i in range(L):
            where, piece = leaf.take(scaled_init(
                shape, generator, device=device, dtype=param_dtype,
                fan_in=fan_in), i)
            out[where] = piece
        return out

    def whole(path, t):
        return take.whole(path, t)

    def gain(name):
        return whole(("layers", name), torch.full(
            (L, D), 1.0 - cfg.norm_offset, dtype=torch.float32,
            device=device))

    params = {
        "embed": whole(("embed",), truncated_normal_init(
            (cfg.vocab_size, D), generator, device=device,
            dtype=param_dtype)),
        "layers": {
            "attn_norm": gain("attn_norm"),
            "wq": stacked("wq", (D, H * Hd), D),
            "wk": stacked("wk", (D, KV * Hd), D),
            "wv": stacked("wv", (D, KV * Hd), D),
            "wo": stacked("wo", (H * Hd, D), H * Hd),
            "mlp_norm": gain("mlp_norm"),
            "w_gate": stacked("w_gate", (D, F_), D),
            "w_up": stacked("w_up", (D, F_), D),
            "w_down": stacked("w_down", (F_, D), F_),
        },
        "final_norm": whole(("final_norm",), torch.full(
            (D,), 1.0 - cfg.norm_offset, dtype=torch.float32,
            device=device)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = whole(("lm_head",), truncated_normal_init(
            (D, cfg.vocab_size), generator, device=device,
            dtype=param_dtype))
    return {"params": params, "state": {}}


def params_from_numpy(cfg: LlamaConfig, tree: dict, *, device,
                      param_dtype: torch.dtype = torch.float32) -> dict:
    """JAX parameters as numpy arrays (same names, same layouts) → port
    tensors: an identity map, matrices in ``param_dtype`` and norm gains
    in f32."""
    out = tree_from_numpy(tree, device=device, param_dtype=param_dtype,
                          f32_names=_GAINS)
    expected = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(out) != expected:
        raise ValueError(f"parameter tree has keys {sorted(out)}, "
                         f"expected {sorted(expected)}")
    return out


def logical_axes(cfg: LlamaConfig) -> Variables:
    params = {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ("embed", "vocab")
    return {"params": params, "state": {}}


def _layers(params: dict):
    """Per-layer views of ``params["layers"]``."""
    return unstack(params["layers"])


def _serving_layers(params: dict):
    """Per-layer views for a serving pass: under fsdp, each layer's
    shards gathered where its turn comes (``parallel/fsdp.py``; a
    training layer gathers inside its ``remat_body`` instead)."""
    from polyaxon_tpu_torch.parallel.fsdp import gathered

    return (gathered(layer) for layer in _layers(params))


def local_kv_heads(cfg) -> int:
    """The KV heads a serving cache holds on this tp rank: its shard of
    them, or, where they do not split over tp (``whole_kv``), the group
    its query heads read (``_local_kv_group``)."""
    n, idx, _ = tp_axis()
    if cfg.n_kv_heads % n == 0:
        return cfg.n_kv_heads // n
    k = torch.zeros((1, 1, cfg.n_kv_heads, 1))
    return _local_kv_group(cfg, k, k, n, idx)[0].shape[2]


def _vocab_whole(cfg, logits: torch.Tensor) -> torch.Tensor:
    """Logits [..., V] from a vocab-parallel head's columns [..., V/tp]
    (gathered over tp), or as they are when the head is whole."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return gather_from_tp(logits, -1)


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
    table = params["embed"]
    shard = vocab_shard(cfg.vocab_size, table.shape[0])
    x = (_embed_rows(table, tokens, dt) if shard is None
         else vocab_embed(table, tokens, dt, shard))
    if getattr(cfg, "scale_embeddings", False):
        x = x * torch.tensor(cfg.dim ** 0.5, dtype=dt, device=x.device)
    return x


def _mlp_out(cfg, x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The gated MLP's output (norm → act(gate)·up → down): under tp,
    this rank's partial of it."""
    dt = cfg.dtype
    h = copy_to_tp(_norm(cfg, x, layer["mlp_norm"]))
    gate = _act(cfg)(h @ _w(layer["w_gate"], dt))
    up = h @ _w(layer["w_up"], dt)
    return (gate * up) @ _w(layer["w_down"], dt)


def _mlp(cfg, x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The gated-MLP residual block, the tp partials summed."""
    return x + reduce_from_tp(_mlp_out(cfg, x, layer))


def _qkv(cfg, layer: dict, x: torch.Tensor, positions: torch.Tensor):
    """Attention-norm → q/k/v projections → RoPE on q and k, for x
    [B, S, D] at ``positions`` [B, S]. The same body serves the prompt
    pass, decode and the suffix prefill."""
    dt = cfg.dtype
    B, S, _ = x.shape
    Hd = cfg.head_dim
    n, idx, _ = tp_axis()
    whole_kv = n > 1 and cfg.n_kv_heads % n != 0
    if n > 1 and cfg.n_heads % n:
        raise ValueError(f"{cfg.n_heads} heads do not split over tp={n}")
    h = copy_to_tp(_norm(cfg, x, layer["attn_norm"]))
    wk, wv = _w(layer["wk"], dt), _w(layer["wv"], dt)
    if whole_kv:
        wk, wv = gather_from_tp(wk, -1), gather_from_tp(wv, -1)
    # -1: the heads this rank holds (all of them without tp).
    q = (h @ _w(layer["wq"], dt)).reshape(B, S, -1, Hd)
    k = (h @ wk).reshape(B, S, -1, Hd)
    v = (h @ wv).reshape(B, S, -1, Hd)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    if whole_kv:
        k, v = _local_kv_group(cfg, k, v, n, idx)
    return q, k, v


def _local_kv_group(cfg, k, v, n: int, idx: int):
    """The K/V heads that tp rank ``idx``'s query heads read, from whole
    K/V [B, S, KV, Hd]: their groups as they are when the rank's heads
    map onto them evenly, else K/V repeated to one head per query head
    (a plain multi-head block)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    local, rep = H // n, H // KV
    first = idx * local
    lo, hi = first // rep, (first + local - 1) // rep + 1
    group = local // (hi - lo) if local % (hi - lo) == 0 else 0
    if group and all((first + i) // rep - lo == i // group
                     for i in range(local)):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    return (repeat_kv(k, rep)[:, :, first:first + local],
            repeat_kv(v, rep)[:, :, first:first + local])


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


def _attn_out(cfg, x: torch.Tensor, layer: dict, positions: torch.Tensor,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention block's output projection: under tp, this rank's
    heads and its row-parallel ``wo`` partial."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, layer, x, positions)
    attn = _attention(cfg, q, k, v, segment_ids)
    return attn.reshape(B, S, -1) @ _w(layer["wo"], cfg.dtype)


def _attn_residual(cfg, x: torch.Tensor, layer: dict,
                   positions: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The attention residual block of a training layer (the llama and
    MoE blocks share it), the tp partials summed."""
    return x + reduce_from_tp(_attn_out(cfg, x, layer, positions,
                                        segment_ids))


def _layer(cfg: LlamaConfig, x: torch.Tensor, layer: dict,
           positions: torch.Tensor,
           segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _mlp(cfg, _attn_residual(cfg, x, layer, positions, segment_ids),
                layer)


def _layer_body(cfg: LlamaConfig):
    """The per-layer function under ``cfg.remat``."""
    return remat_body(functools.partial(_layer, cfg), cfg.remat)


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


def _pipelined_layers(cfg: LlamaConfig, body, layer_params: dict,
                      x: torch.Tensor, start: int = 0):
    """The layer stack as a ``pp`` pipeline (``parallel/pipeline.py``):
    (the last stage's output, None on the other stages; the schedule's
    tail). Positions are contiguous from ``start`` (0, or a cp shard's
    first position: the pretraining case): each microbatch rebuilds them
    instead of sending them down the chain. A stage's layers compute on
    the shards of the other axes as an unpipelined layer does: fsdp
    gathers at use, tp and sp shards, cp's ring over this rank's cp
    group."""
    from polyaxon_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                      stack_stages)

    mesh = current_mesh()
    if mesh is None or "pp" not in mesh.axis_names:
        raise ValueError(
            f"pipeline_stages={cfg.pipeline_stages} needs a mesh with a "
            "`pp` axis in context (`parallel.mesh.use_mesh`)")
    return pipeline_forward(mesh, stage_fn(body, start),
                            stack_stages(layer_params, cfg.pipeline_stages),
                            x, n_microbatches=cfg.pipeline_microbatches,
                            double_buffer=cfg.pipeline_double_buffer)


def stage_fn(body, start: int = 0):
    """A pipeline stage: ``body`` over its layers, at contiguous
    positions from ``start``."""

    def run(local_layers, x_mb):
        mb, S, _ = x_mb.shape
        positions = _positions(mb, S, x_mb.device, start)
        for layer in unstack(local_layers):
            x_mb = body(x_mb, layer, positions, None)
        return x_mb

    return run


def _check_pipelined_inputs(cfg: LlamaConfig, positions, segment_ids
                            ) -> None:
    if cfg.pipeline_stages > 1 and (positions is not None
                                    or segment_ids is not None):
        raise ValueError(
            "the pipelined path assumes contiguous positions 0..S-1 and "
            "cannot honor explicit `positions`/`segment_ids` (packed "
            "sequences / decode offsets); use pipeline_stages=1 for those")


def _pipelined_hidden(cfg: LlamaConfig, params: dict,
                      tokens: torch.Tensor, start: int = 0):
    """Pipelined ``hidden_states`` at contiguous positions from
    ``start``: (the final-norm hidden states on the last stage, None
    elsewhere; the schedule's tail)."""
    x = _embed(cfg, params, tokens, cfg.dtype)
    out, tail = _pipelined_layers(cfg, _layer_body(cfg), params["layers"],
                                  x, start)
    if out is not None:
        out = _norm(cfg, out, params["final_norm"])
    return out, tail


def hidden_states(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  segment_ids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Token ids [B, S] → final-norm hidden states [B, S, D].

    ``segment_ids`` [B, S] enables packed-sequence training: attention
    stays within each segment and RoPE positions restart per segment
    (derived unless ``positions`` is given). Pipelined, the last stage's
    hidden states reach every stage of the pp group."""
    _check_pipelined_inputs(cfg, positions, segment_ids)
    B, S = tokens.shape
    if cfg.pipeline_stages > 1:
        from polyaxon_tpu_torch.parallel.pipeline import from_last_stage

        out, tail = _pipelined_hidden(cfg, params, tokens)
        return from_last_stage(out, tail, (B, S, cfg.dim), cfg.dtype,
                               tokens.device, current_mesh())
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
    """The [D, V] head table (the transposed embedding when tied),
    dequantized whole if it is int8: for a prompt pass or training, not
    a decode step (``decode_logits`` reads it in vocab chunks)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if is_quantized(w):
        w = w.dequantize()
    return w.T if cfg.tie_embeddings else w


def decode_logits(cfg: LlamaConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """Hidden states [..., D] → f32 logits [..., V] (a vocab-parallel
    head's columns gathered over tp)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return _vocab_whole(cfg, lm_logits(x, w, cfg.dtype,
                                       transpose=cfg.tie_embeddings,
                                       chunk=cfg.lm_logits_chunk))


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids → f32 logits [B, S, vocab] (under tp, this rank's vocab
    columns; pipelined, the last stage's logits on every stage)."""
    if cfg.pipeline_stages > 1:
        from polyaxon_tpu_torch.parallel.pipeline import from_last_stage

        _check_pipelined_inputs(cfg, positions, None)
        B, S = tokens.shape
        x, tail = _pipelined_hidden(cfg, params, tokens)
        logits = None if x is None else (
            x @ lm_head(cfg, params).to(cfg.dtype)).to(torch.float32)
        return from_last_stage(logits, tail, (B, S, cfg.vocab_size),
                               torch.float32, tokens.device, current_mesh())
    x = hidden_states(cfg, params, tokens, positions)
    return (x @ lm_head(cfg, params).to(cfg.dtype)).to(torch.float32)


def apply(cfg: LlamaConfig, variables: Variables, batch: dict,
          train: bool = True, rng=None):
    """Next-token LM loss of ``batch["tokens"]`` [B, S] (optional
    ``segments`` [B, S] for packed rows, ``mask`` [B, S]). Each packed
    segment starts from BOS 0, so no token leaks across a boundary.
    Returns (loss, {"loss", "accuracy"}, state).

    Under a mesh with ``cp`` > 1 the batch holds whole rows and this rank
    computes its contiguous sequence shard (``parallel.mesh.seq_shard``):
    the shift happens on the whole row first (the shard's first input is
    the previous shard's last token), RoPE positions stay global, and
    attention must be ``ring`` or ``ulysses``. The loss is the shard's
    mean; the train step weights the ranks into the global mean."""
    tokens = batch["tokens"]
    inputs = shift_right(tokens)
    segments = batch.get("segments")
    if segments is not None:
        inputs = torch.where(segment_starts(segments),
                             torch.zeros_like(inputs), inputs)
    mask = batch.get("mask")
    positions = None
    shard = seq_shard(tokens.shape[1])
    if shard is not None:
        if cfg.attention_impl not in ("ring", "ulysses"):
            raise ValueError(
                "a cp mesh axis above 1 needs attention_impl 'ring' or "
                f"'ulysses', got `{cfg.attention_impl}`")
        B, S = tokens.shape
        positions = (segment_positions(segments) if segments is not None
                     else _positions(B, S, tokens.device))[:, shard]
        inputs, tokens = inputs[:, shard], tokens[:, shard]
        segments = segments[:, shard] if segments is not None else None
        mask = mask[:, shard] if mask is not None else None
    params = variables["params"]
    if cfg.pipeline_stages > 1:
        from polyaxon_tpu_torch.parallel.pipeline import from_last_stage

        # A cp shard's positions are contiguous from its first.
        _check_pipelined_inputs(cfg, None, segments)
        x, tail = _pipelined_hidden(cfg, params, inputs,
                                    shard.start if shard is not None else 0)
        stats = None if x is None else torch.stack(lm_loss(
            cfg, lm_head(cfg, params).to(cfg.dtype), x, tokens, mask))
        loss, acc = from_last_stage(stats, tail, (2,), torch.float32,
                                    tokens.device, current_mesh()).unbind(0)
    else:
        x = hidden_states(cfg, params, inputs, positions=positions,
                          segment_ids=segments)
        loss, acc = lm_loss(cfg, lm_head(cfg, params).to(cfg.dtype), x,
                            tokens, mask)
    return loss, {"loss": loss, "accuracy": acc}, variables["state"]


def lm_loss(cfg, head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor]):
    """(mean CE, accuracy) of final hidden states ``x`` against
    ``labels`` through ``head`` [D, V] (compute dtype), by the chunked
    loss; vocab-parallel when the head is a tp shard (the llama and MoE
    families share it)."""
    shard = vocab_shard(cfg.vocab_size, head.shape[1])
    if shard is not None:
        x = copy_to_tp(x)
    return chunked_lm_loss(x, head, labels, mask, chunk=cfg.loss_chunk,
                           vocab_shard=shard)


def model_def(name: str, **overrides) -> ModelDef:
    cfg = dataclasses.replace(CONFIGS[name], **overrides)
    return ModelDef(
        name=name,
        init=lambda generator, device, take=WHOLE: init(
            cfg, generator, device=device, take=take),
        apply=functools.partial(apply, cfg),
        unit="tokens",
        config=cfg,
        logical_axes=functools.partial(logical_axes, cfg),
        layer_stacks=("layers",),
        sharded_init=True,
        context_parallel=True,
        tensor_parallel=True,
        pipeline_parallel=cfg.pipeline_stages > 1,
    )


def _prompt_pass(cfg: LlamaConfig, params: dict, prompt: torch.Tensor):
    """The causal prompt sweep over [B, P] token ids → (final hidden x
    [B, P, D], k_all, v_all [L, B, P, KV, Hd])."""
    B, P = prompt.shape
    positions = _positions(B, P, prompt.device)
    x = _embed(cfg, params, prompt, cfg.dtype)
    ks, vs = [], []
    for layer in _serving_layers(params):
        q, k, v = _qkv(cfg, layer, x, positions)
        attn = _attention(cfg, q, k, v)
        x = x + reduce_from_tp(attn.reshape(B, P, -1)
                               @ _w(layer["wo"], cfg.dtype))
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


# ------------------------------------------------------------ dense decode
def cache_len(cfg: LlamaConfig, max_len: int) -> int:
    """KV-cache length: with a sliding window the cache is a ring buffer
    of ``sliding_window`` slots; otherwise the full sequence length."""
    if cfg.sliding_window is not None:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, *,
               device) -> dict:
    """Dense KV cache [L, B, C, KV, Hd] per tensor (C = cache_len; KV the
    heads this tp rank holds: ``local_kv_heads``)."""
    shape = (cfg.n_layers, batch, cache_len(cfg, max_len),
             local_kv_heads(cfg), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def ragged_cache_coords(pos: torch.Tensor, C: int):
    """Per-row ring-buffer addressing: for rows at positions ``pos`` [B]
    (-1 = idle) over a C-slot ring, (positions [B, 1] for RoPE, slot [B]
    to write, valid [B, 1, 1, C]). Slot s holds position
    pos - ((pos - s) mod C) after this write; negative = never written.
    A sliding window needs no extra mask: C <= window by ``cache_len``."""
    pos_safe = pos.clamp(min=0)
    slot = pos_safe % C
    delta = (pos_safe[:, None]
             - torch.arange(C, device=pos.device)[None, :]) % C
    stored = pos_safe[:, None] - delta
    valid = ((stored >= 0) & (pos[:, None] >= 0))[:, None, None, :]
    return pos_safe[:, None], slot, valid


def _cached_attention(cfg, q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax attention of q [B, c, H, Hd] over a dense cache row
    [B, C, KV, Hd] (``valid`` [B, 1, c, C]), f32 logits and softmax, the
    products in the compute dtype: the JAX package's einsums, with each
    query head's group read from its KV head instead of repeating the
    cache. Returns [B, c, H * Hd]."""
    dt = cfg.dtype
    B, c, H, Hd = q.shape
    KV = k_cache.shape[2]
    C = k_cache.shape[1]
    qg = q.reshape(B, c, KV, H // KV, Hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache).to(torch.float32)
    s = s.reshape(B, H, c, C) * (Hd ** -0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(dt).reshape(B, KV, H // KV, c, C)
    attn = torch.einsum("bgrqk,bkgd->bqgrd", probs, v_cache)
    return attn.reshape(B, c, H * Hd)


def cached_attn_step(cfg, layer: dict, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     positions: torch.Tensor, slot: torch.Tensor,
                     valid: torch.Tensor):
    """One cached-attention sublayer for ragged decode: q/k/v of x
    [B, 1, D], this step's K/V written into each row's ``slot`` (in
    place), masked softmax over the row's cache. Returns (x after the
    attention residual, k_cache, v_cache)."""
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    q, k, v = _qkv(cfg, layer, x, positions)
    k_cache[rows, slot] = k[:, 0]
    v_cache[rows, slot] = v[:, 0]
    attn = _cached_attention(cfg, q, k_cache, v_cache, valid)
    return (x + reduce_from_tp(attn @ _w(layer["wo"], cfg.dtype)), k_cache,
            v_cache)


def decode_step_ragged(cfg: LlamaConfig, params: dict, cache: dict,
                       tokens: torch.Tensor,
                       pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One autoregressive step with per-row positions (the step under
    continuous batching): tokens [B], pos [B] (-1 = idle; an idle row
    writes only its own slot 0, which the next admission's insert
    replaces). Returns (logits [B, V] f32, cache), the cache updated in
    place. A row at position p matches ``decode_step`` at p exactly."""
    C = cache["k"].shape[2]
    positions, slot, valid = ragged_cache_coords(pos, C)
    x = _embed(cfg, params, tokens, cfg.dtype)[:, None, :]
    for i, layer in enumerate(_serving_layers(params)):
        x, _, _ = cached_attn_step(cfg, layer, x, cache["k"][i],
                                   cache["v"][i], positions, slot, valid)
        x = _mlp(cfg, x, layer)
    x = _norm(cfg, x, params["final_norm"])
    return decode_logits(cfg, params, x[:, 0]), cache


def decode_step(cfg: LlamaConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One step with every row at the scalar position ``pos`` (slot
    ``pos % C``: a plain index with a full-length cache, a ring with a
    sliding window)."""
    B = tokens.shape[0]
    return decode_step_ragged(
        cfg, params, cache, tokens,
        torch.full((B,), int(pos), dtype=torch.long, device=tokens.device))


def prefill(cfg: LlamaConfig, params: dict, prompt: torch.Tensor,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """One batched causal pass over the prompt [B, P], filling a dense
    cache: returns (last-position logits [B, V] f32, cache). Position p
    lands in slot p % C; with a sliding-window ring only the last C
    prompt positions are kept (older ones can never be attended
    again)."""
    dt = cfg.dtype
    B, P = prompt.shape
    x, k_all, v_all = _prompt_pass(cfg, params, prompt)
    C = cache_len(cfg, max_len)
    if cfg.sliding_window is None and P > max_len:
        raise ValueError(
            f"prompt length {P} exceeds cache length {max_len} "
            "(full attention cannot drop prompt positions)")
    if cfg.sliding_window is not None and C < min(P, cfg.sliding_window):
        raise ValueError(
            f"cache length {C} (max_len {max_len}) cannot hold the last "
            f"min(P={P}, window={cfg.sliding_window}) prompt positions "
            "that remain attendable — raise max_len")
    cache = init_cache(cfg, B, max_len, device=prompt.device)
    keep = min(P, C)
    if P <= C:
        cache["k"][:, :, :P] = k_all
        cache["v"][:, :, :P] = v_all
    else:
        slots = torch.arange(P - keep, P, device=prompt.device) % C
        cache["k"][:, :, slots] = k_all[:, :, P - keep:]
        cache["v"][:, :, slots] = v_all[:, :, P - keep:]
    x = _norm(cfg, x, params["final_norm"])
    logits = (x[:, -1] @ lm_head(cfg, params).to(dt)).to(torch.float32)
    return _vocab_whole(cfg, logits), cache


def cb_init_cache(cfg, slots: int, max_len: int, *, device) -> dict:
    return init_cache(cfg, slots, max_len, device=device)


def cb_prefill(cfg, params: dict, prompt: torch.Tensor, max_len: int) -> dict:
    return prefill(cfg, params, prompt, max_len)[1]


def insert_cache_row(cache: dict, row: dict, b: int) -> dict:
    """Copy a one-row cache into row ``b`` of the pool cache, in place."""
    for key in ("k", "v"):
        cache[key][:, b] = row[key][:, 0]
    return cache


def chunk_attn_step(cfg, layer: dict, x: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    positions: torch.Tensor, valid: torch.Tensor):
    """One cached-attention sublayer for a c-token chunk: ``positions``
    [B, c], ``valid`` [B, 1, c, C]; writes slot == position. A write
    past the cache's end (only a padded prompt tail makes one) lands on
    the last slot: the JAX scatter drops it, and here no real position
    reaches that slot before decode rewrites it."""
    B, c = positions.shape
    C = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)[:, None]
    q, k, v = _qkv(cfg, layer, x, positions)
    idx = positions.clamp(max=C - 1)
    k_cache[rows, idx] = k
    v_cache[rows, idx] = v
    attn = _cached_attention(cfg, q, k_cache, v_cache, valid)
    return (x + reduce_from_tp(attn @ _w(layer["wo"], cfg.dtype)), k_cache,
            v_cache)


def decode_chunk(cfg: LlamaConfig, params: dict, cache: dict,
                 tokens: torch.Tensor,
                 pos0: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Cached forward over a short chunk of c tokens per row (the
    speculative verify step, and chunked prefill): writes their KV at
    positions pos0..pos0+c-1 and returns logits [B, c, V] (logits[:, i]
    predicts position pos0+i+1). Requires a full-length cache (slot ==
    position), which makes acceptance rollback-free: entries written
    past the accepted prefix sit at positions the next chunk rewrites
    before anything attends them."""
    if cfg.sliding_window is not None:
        raise ValueError("speculative decode_chunk requires a full-length "
                         "cache (no sliding_window)")
    B, c = tokens.shape
    C = cache["k"].shape[2]
    dev = tokens.device
    positions = pos0.to(dev).long()[:, None] + torch.arange(c, device=dev)
    valid = (torch.arange(C, device=dev)[None, None, :]
             <= positions[:, :, None])[:, None]
    x = _embed(cfg, params, tokens, cfg.dtype)
    for i, layer in enumerate(_serving_layers(params)):
        x, _, _ = chunk_attn_step(cfg, layer, x, cache["k"][i],
                                  cache["v"][i], positions, valid)
        x = _mlp(cfg, x, layer)
    x = _norm(cfg, x, params["final_norm"])
    return decode_logits(cfg, params, x), cache


def generate(cfg: LlamaConfig, params: dict, prompt: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_p: float = 1.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled continuation of prompt [B, P]:
    [B, max_new] int. One prefill, then a Python loop of decode steps
    (the JAX package's ``lax.scan``); sampled draws come from
    ``generator``."""
    from polyaxon_tpu_torch.models.common import sample_logits

    B, P = prompt.shape
    sampling = temperature > 0
    if sampling and generator is None:
        raise ValueError("sampling (temperature > 0) needs a generator")
    logits, cache = prefill(cfg, params, prompt, P + max_new_tokens)
    out = []
    for t in range(max_new_tokens):
        token = (sample_logits(logits, generator, temperature, top_p, top_k)
                 if sampling else logits.argmax(dim=-1))
        token = token.to(torch.long)
        out.append(token)
        if t + 1 < max_new_tokens:
            logits, cache = decode_step(cfg, params, cache, token, P + t)
    return torch.stack(out, dim=1)


# ------------------------------------------------------- paged KV decode
def check_kernel_shapes(cfg: LlamaConfig, device, *,
                        training: bool = False, paged: bool = True) -> None:
    """On a CUDA device, raise if a kernel this config's serving path (or,
    with ``training``, its training path) launches cannot take its
    head_dim: at construction, not inside every step. ``paged=False``
    leaves out the paged decode kernel (a dense-cache engine). The CPU
    runs the plain versions, which take any shape."""
    if torch.device(device).type != "cuda":
        return
    from polyaxon_tpu_torch.ops import flash, paged_attention

    kernels = []
    if cfg.attention_impl in ("auto", "flash"):
        kernels.append(("flash_fwd", flash.KERNEL_HEAD_DIMS))
        if training and cfg.flash_bwd_impl != "xla":
            kernels.append(("flash_bwd", flash.KERNEL_HEAD_DIMS))
    if not training and paged and cfg.paged_attention_impl == "auto":
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
    shape = (cfg.n_layers, n_pages, page_size, local_kv_heads(cfg),
             cfg.head_dim)
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
    q, k, v = _qkv(cfg, layer, x, positions)
    # This tp rank's heads (all of them without tp).
    H, KV, Hd = q.shape[2], k.shape[2], cfg.head_dim
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
    return (x + reduce_from_tp(attn.reshape(B, 1, H * Hd)
                               @ _w(layer["wo"], dt)), k_pages, v_pages)


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
    for i, layer in enumerate(_serving_layers(params)):
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
    q, k, v = _qkv(cfg, layer, x, positions)
    H, KV, Hd = q.shape[2], k.shape[2], cfg.head_dim  # this tp rank's
    keys = repeat_kv(torch.cat([k_prefix, k], dim=1), H // KV)
    vals = repeat_kv(torch.cat([v_prefix, v], dim=1), H // KV)
    s = torch.einsum("bqhd,bkhd->bhqk", q, keys).to(torch.float32)
    s = s * (Hd ** -0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(dt)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, vals)
    return (x + reduce_from_tp(attn.reshape(B, S, H * Hd)
                               @ _w(layer["wo"], dt)), k, v)


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
    for i, layer in enumerate(_serving_layers(params)):
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
