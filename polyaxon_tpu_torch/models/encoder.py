"""Bidirectional transformer encoder block shared by ViT, BERT and T5's
encoder (port of ``polyaxon_tpu/models/encoder.py``): pre-LayerNorm,
fused QKV, non-causal attention, a GELU MLP with biases; the stacked
``[L, ...]`` parameters run as a loop over per-layer views.

``attention_impl`` defaults to ``"xla"`` (einsum attention), as in the
reference: BERT and ViT never pass another, so they never reach the flash
kernel in either package. T5 forwards its own (the port's ``"auto"``), so
its encoder runs the non-causal flash forward and backward on CUDA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from polyaxon_tpu_torch.models.common import (
    _w,
    gelu,
    layer_norm,
    remat_body,
    scaled_init,
    unstack,
)
from polyaxon_tpu_torch.ops.attention import dot_product_attention

# Leaves kept f32 in a serving tree (LayerNorm gains and biases).
GAINS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    dim: int
    n_layers: int
    n_heads: int
    ffn_dim: int
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: str = "none"
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def layers_logical_axes() -> dict:
    return {
        "ln1_scale": ("layers", "embed"),
        "ln1_bias": ("layers", "embed"),
        "wqkv": ("layers", "embed", "heads"),
        "wo": ("layers", "heads", "embed"),
        "ln2_scale": ("layers", "embed"),
        "ln2_bias": ("layers", "embed"),
        "w_up": ("layers", "embed", "mlp"),
        "b_up": ("layers", "mlp"),
        "w_down": ("layers", "mlp", "embed"),
        "b_down": ("layers", "embed"),
    }


def init_layers(cfg: EncoderConfig, generator: torch.Generator, *, device,
                param_dtype: torch.dtype = torch.float32) -> dict:
    """The stacked layer parameters (the JAX ``init_layers``' shapes and
    scales; each layer drawn on its own)."""
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.ffn_dim

    def stacked(shape, fan_in):
        out = torch.empty((L, *shape), dtype=param_dtype, device=device)
        for i in range(L):
            out[i] = scaled_init(shape, generator, device=device,
                                 dtype=param_dtype, fan_in=fan_in)
        return out

    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln1_scale": torch.ones((L, D), **f32),
        "ln1_bias": torch.zeros((L, D), **f32),
        "wqkv": stacked((D, 3 * D), D),
        "wo": stacked((D, D), D),
        "ln2_scale": torch.ones((L, D), **f32),
        "ln2_bias": torch.zeros((L, D), **f32),
        "w_up": stacked((D, F_), D),
        "b_up": torch.zeros((L, F_), dtype=param_dtype, device=device),
        "w_down": stacked((F_, D), F_),
        "b_down": torch.zeros((L, D), dtype=param_dtype, device=device),
    }


def _layer(cfg: EncoderConfig, x: torch.Tensor, layer: dict) -> torch.Tensor:
    B, S, D = x.shape
    H, Hd = cfg.n_heads, cfg.head_dim
    dt = cfg.dtype
    h = layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], cfg.norm_eps)
    q, k, v = (h @ _w(layer["wqkv"], dt)).chunk(3, dim=-1)
    attn = dot_product_attention(q.reshape(B, S, H, Hd),
                                 k.reshape(B, S, H, Hd),
                                 v.reshape(B, S, H, Hd), causal=False,
                                 impl=cfg.attention_impl)
    x = x + attn.reshape(B, S, D) @ _w(layer["wo"], dt)
    h = layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], cfg.norm_eps)
    h = gelu(h @ _w(layer["w_up"], dt) + _w(layer["b_up"], dt))
    return x + (h @ _w(layer["w_down"], dt) + _w(layer["b_down"], dt))


def encode(cfg: EncoderConfig, layers: dict, x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] → [B, S, D] through the stacked encoder."""
    body = remat_body(functools.partial(_layer, cfg), cfg.remat)
    for layer in unstack(layers):
        x = body(x, layer)
    return x
