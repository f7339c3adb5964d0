"""Int8 weight-only quantization for serving (port of
``polyaxon_tpu/serving/quantize.py``).

Scheme: symmetric per-channel quantization over the contraction axis.
Weights are laid out ``[..., in, out]`` (activations contract the
second-to-last axis), so the scale reduces over ``axis=-2`` only:
stacked-layer weights ``[L, in, out]`` keep per-layer per-out-channel
scales ``[L, 1, out]``. 1-D leaves and the leaves named like norm gains,
biases, routers and positional tables stay full precision.

The contract is the JAX package's: engines pass a quantized tree through
whole, and the model unwraps each weight where it is used (``models/
common.py`` ``_w``, ``_embed_rows``, ``lm_logits``), duck-typed on
``.q`` (``is_quantized``); the tree is never dequantized whole on the serving
path. Here that read materializes a compute-dtype copy of each weight
per use, so on the card int8 saves weight memory but not time (a fused
int8 matrix-vector kernel is ROADMAP.md, Queue 2).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

_QMAX = 127.0
# The JAX package quantizes under jit, where XLA turns the division by
# 127 into a product with its f32 reciprocal; the scale here is computed
# the same way, so both packages give the same bits.
_INV_QMAX = float(torch.tensor(1.0) / _QMAX)


class QuantizedTensor:
    """An int8 weight ``q`` and its broadcastable f32 ``scale``;
    ``dtype`` is the dtype ``dequantize`` returns (the original
    weight's)."""

    __slots__ = ("q", "scale", "dtype")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype):
        self.q = q
        self.scale = scale
        self.dtype = dtype

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return int(self.q.numel() * self.q.element_size()
                   + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        return (self.q.to(torch.float32) * self.scale).to(self.dtype)

    def unbind(self, dim: int = 0) -> tuple["QuantizedTensor", ...]:
        """Per-layer views of a stacked weight (the model's layer loop
        unbinds every ``[L, ...]`` leaf)."""
        if dim != 0:
            raise ValueError("QuantizedTensor unbinds its leading axis only")
        return tuple(QuantizedTensor(q, s, self.dtype)
                     for q, s in zip(self.q.unbind(0), self.scale.unbind(0)))

    def narrow(self, dim: int, start: int, length: int) -> "QuantizedTensor":
        """A slice along ``dim`` (a tp rank's share of a weight the rules
        leave whole over tp, ``parallel/fsdp.py _tp_share``), its scales
        sliced with it where they vary along ``dim``."""
        scale = (self.scale if self.scale.shape[dim] == 1
                 else self.scale.narrow(dim, start, length))
        return QuantizedTensor(self.q.narrow(dim, start, length), scale,
                               self.dtype)

    def __repr__(self):
        return (f"QuantizedTensor(shape={tuple(self.q.shape)}, "
                f"dtype={self.dtype})")


# Leaf-name fragments that mark non-matmul per-layer tensors (norm gains,
# biases, layer-norm pairs, MoE routers, positional tables): kept full
# precision by name, since stacked per-layer vectors are 2-D ([L, D]) and
# a rank rule cannot tell them from a matrix.
_SKIP_FRAGMENTS = ("norm", "bias", "scale", "ln1", "ln2", "router", "pos")


def _eligible(path: tuple, leaf: Any) -> bool:
    segments = [str(k).lower() for k in path]
    if any(frag in seg for seg in segments for frag in _SKIP_FRAGMENTS):
        return False
    if segments and segments[-1].startswith("b_"):
        return False
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
            and leaf.is_floating_point())


def quantize_leaf(w: torch.Tensor, groups=()) -> QuantizedTensor:
    """int8 values and f32 scales of one weight, computed as the JAX
    package computes them (so both give the same bits). ``w`` may be a
    rank's piece of a sharded weight: ``groups`` are the process groups
    that shard its contraction axis, over which each channel's maximum
    is all-reduced, so the piece's scales are the whole weight's."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2, keepdim=True)
    for group in groups:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax.clamp(min=1e-12) * _INV_QMAX  # zero channels stay finite
    q = torch.clamp(torch.round(w32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return QuantizedTensor(q, scale, w.dtype)


def _map(tree: Any, fn, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def quantize_tree(params: Any, *, mode: str = "int8",
                  groups=lambda path, dim: ()) -> Any:
    """Quantize every matmul-shaped leaf (ndim >= 2, floating, not named
    like a norm or bias) of a params tree to int8 + per-channel scales.
    A tree of a rank's pieces passes ``groups(path, dim)``: the process
    groups that shard dimension ``dim`` of the leaf at ``path``."""
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r} "
                         "(supported: 'int8')")
    return _map(params, lambda p, w: quantize_leaf(
        w, groups(p, w.ndim - 2)) if _eligible(p, w) else w)


def dequantize_tree(params: Any) -> Any:
    """Identity on plain trees; full-precision copies of quantized
    leaves. Not used on the serving path (models dequantize at use);
    kept for tests and export."""
    return _map(params, lambda _, leaf: leaf.dequantize()
                if isinstance(leaf, QuantizedTensor) else leaf)


def tree_bytes(params: Any) -> int:
    """Bytes of a (possibly quantized) params tree."""
    total = 0

    def add(_, leaf):
        nonlocal total
        if isinstance(leaf, QuantizedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf

    _map(params, add)
    return total
