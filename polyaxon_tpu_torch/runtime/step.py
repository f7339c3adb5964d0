"""Train and eval steps (port of ``polyaxon_tpu/runtime/step.py``).

One device, no sharding: a step is eager PyTorch. Gradients accumulate
in each parameter's ``.grad`` (f32, like the master weights) across
microbatches, with the JAX package's exact weighting (the masked and
the ``loss_unweighted`` parts of the loss apart), and the optimizer
updates the parameters in place. The model's mutable ``state`` (ResNet's
batch statistics) is threaded from microbatch to microbatch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from polyaxon_tpu_torch.models.common import ModelDef
from polyaxon_tpu_torch.runtime.optim import Optimizer, global_norm, tree_leaves

TrainState = dict[str, Any]  # {"params", "state", "opt_state", "step"}


def build_init(model_def: ModelDef, optimizer: Optimizer, *, device,
               params: Optional[dict] = None,
               state: Optional[dict] = None
               ) -> Callable[[int], TrainState]:
    """``init_fn(seed)``: f32 parameters (and the model's mutable
    ``state``, e.g. ResNet's batch statistics) from a generator seeded
    with ``seed`` on ``device``, or the given ``params`` and ``state``
    (e.g. the JAX package's initial weights through a family's
    ``params_from_numpy``), and a fresh optimizer state. The leaves the
    optimizer trains (all, or its ``mask``'s, e.g. LoRA's adapters)
    require grad; the rest are frozen."""

    def init_fn(seed: int) -> TrainState:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            variables = model_def.init(gen, device)
            p, mutable = variables["params"], variables.get("state", {})
        else:
            p, mutable = params, state or {}
        mask = getattr(optimizer, "mask", None)
        flags = (tree_leaves(mask(p)) if mask is not None
                 else [True] * len(tree_leaves(p)))
        for t, train in zip(tree_leaves(p), flags):
            t.requires_grad_(bool(train))
        return {"params": p, "state": mutable, "opt_state": optimizer.init(p),
                "step": 0}

    return init_fn


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def build_train_step(model_def: ModelDef, optimizer: Optimizer,
                     accum_steps: int = 1
                     ) -> Callable[..., tuple[TrainState, dict]]:
    """One optimizer update per call. With ``accum_steps > 1`` the batch
    (the full per-update batch) is split into that many microbatches and
    their gradients accumulate. Each microbatch's loss is scaled BEFORE
    the backward (grad is linear), as the JAX package's ``grads_of``
    does: its masked part by the microbatch's share ``w / W`` of valid
    tokens (``W`` clamped to 1, so a fully masked batch gives zero
    grads, not NaN), and its mask-independent part (the
    ``loss_unweighted`` metric, e.g. MoE's router aux) by ``1 / k``, so
    the accumulated gradient is exactly the full batch's. Metrics are
    reported with the same weights: mask-weighted means, plain means for
    ``uniform_metrics``, and ``loss`` recombined from its two parts;
    ``grad_norm`` is the global norm of the unclipped grads. Only the
    leaves that require grad are updated (LoRA freezes the base).
    Returns ``train_step(state, batch, rng=None) -> (state, metrics)``,
    the state updated in place; metrics stay on the device."""
    uniform_keys = set(model_def.uniform_metrics) | {"loss_unweighted"}

    def backward(state, batch, scales=None) -> dict:
        loss, metrics, new_mutable = model_def.apply(
            {"params": state["params"], "state": state["state"]}, batch,
            True, None)
        if scales is None:
            loss_out = loss
        else:
            masked_scale, unmasked_scale = scales
            unweighted = metrics.get("loss_unweighted")
            if unweighted is None:
                if model_def.uniform_metrics:
                    raise ValueError(
                        f"model `{model_def.name}` declares "
                        f"uniform_metrics={model_def.uniform_metrics} but "
                        "its apply() does not return the differentiable "
                        "`loss_unweighted` metric required for exact "
                        "gradient accumulation")
                loss_out = masked_scale * loss
            else:
                loss_out = (masked_scale * (loss - unweighted)
                            + unmasked_scale * unweighted)
        loss_out.backward()
        state["state"] = _detached(new_mutable)
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: dict, rng=None):
        if accum_steps == 1:
            metrics = backward(state, batch)
        else:
            micro = [{k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum_steps)]
            mask = batch.get("mask")
            if mask is not None:
                w_micro = mask.reshape(accum_steps, -1).to(
                    torch.float32).sum(1)
            else:
                device = next(iter(batch.values())).device
                w_micro = torch.ones(accum_steps, dtype=torch.float32,
                                     device=device)
            w_total = w_micro.sum().clamp(min=1.0)
            seq = [backward(state, mb, (w_micro[i] / w_total,
                                        1.0 / accum_steps))
                   for i, mb in enumerate(micro)]
            stacked = {k: torch.stack([m[k] for m in seq]) for k in seq[0]}

            def agg_masked(v):
                return (w_micro * v).sum() / w_total

            metrics = {k: agg_masked(v) for k, v in stacked.items()}
            unweighted = stacked.get("loss_unweighted")
            if unweighted is not None:
                for key in uniform_keys & set(stacked):
                    metrics[key] = stacked[key].mean()
                metrics["loss"] = (agg_masked(stacked["loss"] - unweighted)
                                   + unweighted.mean())

        leaves = [p for p in tree_leaves(state["params"]) if p.requires_grad]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        grad_norm = global_norm(grads)
        optimizer.update(state["params"], grads, state["opt_state"],
                         grad_norm=grad_norm)
        for p in leaves:
            p.grad = None
        metrics["grad_norm"] = grad_norm
        state["step"] += 1
        return state, metrics

    return train_step


def build_eval_step(model_def: ModelDef) -> Callable[[TrainState, dict],
                                                     dict]:
    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        _, metrics, _ = model_def.apply(
            {"params": state["params"], "state": state["state"]}, batch,
            False, None)
        return metrics

    return eval_step
