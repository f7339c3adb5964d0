"""Train and eval steps (port of ``polyaxon_tpu/runtime/step.py``).

One device, no sharding: a step is eager PyTorch. Gradients accumulate
in each parameter's ``.grad`` (f32, like the master weights) across
microbatches, with the JAX package's exact weighting, and the optimizer
updates the parameters in place.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from polyaxon_tpu_torch.models.common import ModelDef
from polyaxon_tpu_torch.runtime.optim import Optimizer, global_norm, tree_leaves

TrainState = dict[str, Any]  # {"params", "state", "opt_state", "step"}


def build_init(model_def: ModelDef, optimizer: Optimizer, *, device,
               params: Optional[dict] = None
               ) -> Callable[[int], TrainState]:
    """``init_fn(seed)``: f32 parameters from a generator seeded with
    ``seed`` on ``device``, or the given ``params`` (e.g. the JAX
    package's initial weights through ``llama.params_from_numpy``), and
    a fresh optimizer state."""

    def init_fn(seed: int) -> TrainState:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            variables = model_def.init(gen, device)
            p, mutable = variables["params"], variables.get("state", {})
        else:
            p, mutable = params, {}
        for t in tree_leaves(p):
            t.requires_grad_(True)
        return {"params": p, "state": mutable, "opt_state": optimizer.init(p),
                "step": 0}

    return init_fn


def build_train_step(model_def: ModelDef, optimizer: Optimizer,
                     accum_steps: int = 1
                     ) -> Callable[..., tuple[TrainState, dict]]:
    """One optimizer update per call. With ``accum_steps > 1`` the batch
    (the full per-update batch) is split into that many microbatches and
    their gradients accumulate. Each microbatch's loss is scaled BEFORE
    the backward (grad is linear) by its share ``w / W`` of valid tokens
    (``W`` clamped to 1, so a fully masked batch gives zero grads, not
    NaN), so the accumulated gradient is exactly the full batch's. The
    port's models have only masked loss terms: the JAX package's
    ``loss_unweighted`` split (MoE router losses) comes with the first
    MoE model. Metrics are reported with the same weights; ``grad_norm``
    is the global norm of the unclipped grads. Returns
    ``train_step(state, batch, rng=None) -> (state, metrics)``, the state
    updated in place; metrics stay on the device."""

    def backward(state, batch, scale=None) -> dict:
        loss, metrics, new_mutable = model_def.apply(
            {"params": state["params"], "state": state["state"]}, batch,
            True, None)
        (loss if scale is None else scale * loss).backward()
        state["state"] = new_mutable
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
                w_micro = torch.ones(accum_steps, dtype=torch.float32,
                                     device=batch["tokens"].device)
            w_total = w_micro.sum().clamp(min=1.0)
            seq = [backward(state, mb, w_micro[i] / w_total)
                   for i, mb in enumerate(micro)]
            metrics = {k: (w_micro * torch.stack([m[k] for m in seq])).sum()
                       / w_total for k in seq[0]}

        leaves = tree_leaves(state["params"])
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
