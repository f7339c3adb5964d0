"""LoRA fine-tuning as a ``ModelDef`` wrapper (port of
``polyaxon_tpu/models/lora.py``).

The wrapped parameters are ``{"base": <frozen tree>, "lora": {path:
{"a", "b"}, "_meta": {"alpha", "rank"}}}``, keyed and initialized as in
the JAX package (A ~ N(0, 1/rank), B = 0, so training starts at the base
model; ``_meta`` makes a checkpoint self-describing for serving).

- ``apply`` computes ``W_eff = W + (alpha/rank)·A@B`` for each adapted
  projection where the model reads it (``LoraWeight``, read through
  ``models/common.py``'s ``_w`` one layer at a time), not as a whole
  tree: the arithmetic is the reference's merge, while an eager
  whole-tree merge would hold an f32 copy of every adapted matrix (about
  28 GB at llama3_8b). Any other target the spec's regexes match (an
  embedding, ``lm_head``, a norm gain) is merged before the model runs.
- The base is frozen (``requires_grad=False``), so the backward computes
  no base weight gradients; ``wrap_optimizer`` is ``optax.masked`` over
  the adapters, so optimizer state exists only for them.
- ``merge_saved`` folds a checkpoint's adapters into dense weights for
  serving, with alpha and rank from its ``_meta``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from polyaxon_tpu_torch.models.common import (LoraWeight, ModelDef,
                                              merged_weight)
from polyaxon_tpu_torch.runtime.optim import Masked, Optimizer

# Matmul weights adapted by default: attention and MLP projections of the
# decoder families (embeddings, norms and lm_head stay frozen).
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# T5 adds the fused encoder QKV and the cross-attention projections.
T5_TARGETS = DEFAULT_TARGETS + ("wqkv", "xq", "xkv", "xo")
# The projections every family reads through ``models/common.py``'s
# ``_w``, which merges a ``LoraWeight`` at its use.
READ_AT_USE = frozenset(T5_TARGETS + ("router",))


def _flatten(tree: dict, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _map(tree: dict, fn, prefix: tuple = ()) -> dict:
    return {k: (_map(v, fn, prefix + (str(k),)) if isinstance(v, dict)
                else fn(prefix + (str(k),), v)) for k, v in tree.items()}


def _match(path: tuple, targets) -> bool:
    return any(re.fullmatch(t, path[-1]) for t in targets)


def init_lora(params: dict, rank: int, targets, generator: torch.Generator
              ) -> dict:
    """A/B adapters for every eligible leaf (ndim >= 2, name matching
    ``targets``), keyed by the '/'-joined path."""
    lora: dict[str, dict] = {}
    for path, leaf in _flatten(params):
        if leaf.ndim < 2 or not _match(path, targets):
            continue
        *stack, d_in, d_out = leaf.shape
        a = torch.randn((*stack, d_in, rank), generator=generator,
                        dtype=torch.float32, device=leaf.device
                        ) * (rank ** -0.5)
        lora["/".join(path)] = {
            "a": a.to(leaf.dtype),
            "b": torch.zeros((*stack, rank, d_out), dtype=leaf.dtype,
                             device=leaf.device)}
    if not lora:
        raise ValueError(
            f"no params matched lora targets {tuple(targets)}: check the "
            "target names against the model's param tree")
    return lora


def with_meta(lora: dict, rank: int, alpha: float) -> dict:
    """The merge hyperparameters inside the lora tree (f32 scalars that
    the optimizer never updates)."""
    device = next(iter(lora.values()))["a"].device
    return {**lora, "_meta": {
        "alpha": torch.tensor(float(alpha), dtype=torch.float32,
                              device=device),
        "rank": torch.tensor(float(rank), dtype=torch.float32,
                             device=device)}}


def split_meta(lora: dict) -> tuple[dict, Optional[dict]]:
    adapters = {k: v for k, v in lora.items() if k != "_meta"}
    return adapters, lora.get("_meta")


def merge_lazy(base: dict, lora: dict, alpha: float, rank: int) -> dict:
    """``base`` with each adapted leaf merged: a ``LoraWeight`` (merged
    where the model reads it) for the projections in ``READ_AT_USE``,
    and ``W + (alpha/rank)·A@B`` as a dense tensor for any other target
    (an embedding, a head, a norm gain)."""
    scale = alpha / rank

    def rebuild(path, leaf):
        ab = lora.get("/".join(path))
        if ab is None:
            return leaf
        if path[-1] in READ_AT_USE:
            return LoraWeight(leaf, ab["a"], ab["b"], scale)
        return merged_weight(leaf, ab["a"], ab["b"], scale)

    return _map(base, rebuild)


def merge(base: dict, lora: dict, alpha: float, rank: int) -> dict:
    """``W + (alpha/rank)·A@B`` for adapted leaves, as dense tensors (the
    reference's ``merge``); the rest as they are."""
    return _map(merge_lazy(base, lora, alpha, rank),
                lambda _, leaf: leaf.merged()
                if isinstance(leaf, LoraWeight) else leaf)


def _adapters_by_path(tree: dict, prefix: tuple = ()) -> dict:
    """Adapters keyed by their '/'-joined leaf path, whether the tree is
    flat (as ``init_lora`` builds it) or nested on '/' (as the port's
    checkpoint store reads it back)."""
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if set(value) == {"a", "b"}:
            out["/".join(path)] = value
        else:
            out.update(_adapters_by_path(value, path))
    return out


def merge_saved(base: dict, lora: dict, alpha: Optional[float] = None,
                rank: Optional[int] = None, *, device=None,
                dtype: Optional[torch.dtype] = None) -> dict:
    """Fold saved adapters into dense weights (serving a fine-tune).
    Alpha and rank come from the checkpoint's ``_meta`` when present;
    the arguments are fallbacks for a tree without one. Each adapted
    leaf is merged on ``device`` (its own when None) and cast to
    ``dtype`` (its own when None), one at a time."""
    lora, meta = split_meta(lora)
    lora = _adapters_by_path(lora)
    if meta is not None:
        alpha = float(meta["alpha"])
        rank = int(float(meta["rank"]))
    if alpha is None:
        raise ValueError("checkpoint has no lora _meta; pass alpha= "
                         "explicitly (must match training)")
    if rank is None:
        rank = int(next(iter(lora.values()))["a"].shape[-1])
    scale = alpha / rank

    def rebuild(path, leaf):
        ab = lora.get("/".join(path))
        if ab is None:
            return leaf
        dev = device if device is not None else leaf.device
        merged = merged_weight(leaf.to(dev), ab["a"].to(dev), ab["b"].to(dev),
                         scale)
        return merged.to(dtype) if dtype is not None else merged

    with torch.no_grad():
        return _map(base, rebuild)


def _lora_logical_axes(base_logical: dict, targets) -> dict:
    """Adapter axes from the base leaf's logical axes (the JAX
    package's rule): A keeps the row axis, B the column axis, the rank
    axis is unsharded; ``_meta``'s scalars are replicated."""
    out = {}
    for path, axes in _flatten(base_logical):
        if len(axes) < 2 or not _match(path, targets):
            continue
        *stack, row, col = axes
        out["/".join(path)] = {"a": tuple(stack) + (row, None),
                               "b": tuple(stack) + (None, col)}
    out["_meta"] = {"alpha": (), "rank": ()}
    return out


def _tp_summed(adapters: dict, logical_axes) -> dict:
    """Under tp, each adapter factor that is whole on every tp rank while
    its partner is a tp shard passes through *copy* (``parallel/
    tensor.py``): a rank's merged shard ``W_j + s·A@B_j`` (or
    ``A_j@B``) gives that factor only this rank's part of its gradient,
    and the backward's all-reduce sums the parts, so every rank holds
    the whole gradient its Replicate placement says. A factor computes
    on its tp share wherever ``TP_RULES`` shards one of its axes, placed
    so or taken at use (``parallel/fsdp.py _tp_share``). Without tp, as
    they are."""
    from polyaxon_tpu_torch.parallel.mesh import current_mesh
    from polyaxon_tpu_torch.parallel.sharding import TP_RULES
    from polyaxon_tpu_torch.parallel.tensor import copy_to_tp, tp_axis

    if tp_axis()[0] == 1 or current_mesh() is None:
        return adapters
    axes, _ = split_meta(logical_axes()["params"]["lora"])
    tp_names = {name for name, target in TP_RULES if target == "tp"}

    def on_tp(logical):
        return any(name in tp_names for name in logical)

    out = {}
    for path, ab in adapters.items():
        a_tp, b_tp = on_tp(axes[path]["a"]), on_tp(axes[path]["b"])
        out[path] = {"a": copy_to_tp(ab["a"]) if b_tp and not a_tp
                     else ab["a"],
                     "b": copy_to_tp(ab["b"]) if a_tp and not b_tp
                     else ab["b"]}
    return out


def lora_model_def(model_def: ModelDef, rank: int, alpha: float,
                   targets: Optional[tuple] = None) -> ModelDef:
    """Wrap a ModelDef for LoRA: the same step, loop and checkpoint
    machinery over ``{base (frozen), lora (trained)}``."""
    targets = tuple(targets or DEFAULT_TARGETS)

    def init(generator: torch.Generator, device):
        variables = model_def.init(generator, device)
        base = variables["params"]
        lora = with_meta(init_lora(base, rank, targets, generator), rank,
                         alpha)
        return {**variables, "params": {"base": base, "lora": lora}}

    def apply(variables, batch, train=True, rng=None):
        p = variables["params"]
        adapters, _ = split_meta(p["lora"])
        if model_def.tensor_parallel:
            adapters = _tp_summed(adapters, logical_axes)
        merged = merge_lazy(p["base"], adapters, alpha, rank)
        return model_def.apply({**variables, "params": merged}, batch, train,
                               rng)

    def logical_axes():
        logical = model_def.logical_axes()
        base = logical["params"]
        return {**logical, "params": {
            "base": base, "lora": _lora_logical_axes(base, targets)}}

    # The adapted projections are merged where the model reads them
    # (``LoraWeight``), so sharded base leaves are gathered whole.
    return dataclasses.replace(
        model_def, name=f"{model_def.name}+lora{rank}", init=init,
        apply=apply, layer_stacks=(), sharded_init=False,
        logical_axes=logical_axes if model_def.logical_axes else None)


def lora_optimizer_mask(params: dict) -> dict:
    """True (train) for the adapters; False for the base and ``_meta``."""
    return {
        "base": _map(params["base"], lambda *_: False),
        "lora": {k: _map(v, lambda *_, k=k: k != "_meta")
                 for k, v in params["lora"].items()},
    }


def wrap_optimizer(optimizer: Optimizer) -> Masked:
    """Optimizer state and updates only for the adapters."""
    return Masked(optimizer, lora_optimizer_mask)

