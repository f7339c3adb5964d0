"""Train and eval steps (port of ``polyaxon_tpu/runtime/step.py``).

A step is eager PyTorch. Gradients accumulate in each parameter's
``.grad`` (f32, like the master weights) across microbatches, with the
JAX package's exact weighting (the masked and the ``loss_unweighted``
parts of the loss apart), and the optimizer updates the parameters in
place. The model's mutable ``state`` (ResNet's batch statistics) is
threaded from microbatch to microbatch.

With a ``mesh`` the parameters are DTensors placed by the model's
logical axes and the mesh's rules (``state_placements``, the JAX
package's ``state_shardings``); the optimizer's moments follow them.
The model computes on ``parallel.fsdp.model_view`` (plain tensors,
fsdp leaves gathered at use, tp and ep shards local where the family
computes on them). A rank's batch piece — its rows along the batch axes
(dp, fsdp, ep), and under ``cp`` its sequence shard — is one more
microbatch of the global batch; the ranks of a replica axis (tp, sp, pp)
hold the same piece. Its masked loss is scaled by its share of the
global valid tokens (an all-reduce over the piece axes), its
``loss_unweighted`` part by one over the number of pieces, and the
gradients, summed by ``reduce_grads`` over the piece axes (and over pp,
whose stages hold disjoint gradients) and not over the replica axes, are
exactly the global batch's. The global norm and clipping use the full
reduction; the optimizer runs on the local shards; metrics are reduced
over the pieces with the same weights and are equal along the replica
axes (a pipelined model broadcasts its last stage's). An update that
spans whole leaves (adafactor's factored moments and RMS) reduces its
sums over the shards (``parallel/fsdp.py shard_layout``), and a model's
batch statistics are the global batch's (``parallel/mesh.py
block_mean``), so every rank keeps the same running state.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from polyaxon_tpu_torch.models.common import ModelDef
from polyaxon_tpu_torch.parallel import fsdp
from polyaxon_tpu_torch.parallel.compat import PIECE_AXES, batch_pieces
from polyaxon_tpu_torch.parallel.mesh import all_reduce_over, row_block
from polyaxon_tpu_torch.parallel.sharding import (Rules, ShardTaker,
                                                  distribute,
                                                  distribute_local,
                                                  rules_for_mesh,
                                                  tree_placements)
from polyaxon_tpu_torch.runtime.optim import Optimizer, global_norm, tree_leaves

TrainState = dict[str, Any]  # {"params", "state", "opt_state", "step"}


def state_placements(model_def: ModelDef, mesh, rules: Rules) -> dict:
    """DTensor placements of the parameters and the mutable state."""
    if model_def.logical_axes is None:
        raise ValueError(f"model `{model_def.name}` declares no logical "
                         "axes, so it cannot be placed on a mesh")
    logical = model_def.logical_axes()
    return {"params": tree_placements(logical["params"], mesh, rules),
            "state": tree_placements(logical.get("state", {}), mesh,
                                     rules)}


def build_init(model_def: ModelDef, optimizer: Optimizer, *, device,
               params: Optional[dict] = None,
               state: Optional[dict] = None, mesh=None,
               rules: Optional[Rules] = None
               ) -> Callable[[int], TrainState]:
    """``init_fn(seed)``: f32 parameters (and the model's mutable
    ``state``, e.g. ResNet's batch statistics) from a generator seeded
    with ``seed`` on ``device``, or the given ``params`` and ``state``
    (e.g. the JAX package's initial weights through a family's
    ``params_from_numpy``), and a fresh optimizer state. The leaves the
    optimizer trains (all, or its ``mask``'s, e.g. LoRA's adapters)
    require grad; the rest are frozen. With a ``mesh``, each rank draws
    only its pieces of the parameters (``draw``), placed as DTensors,
    and the optimizer state follows them; the mutable state stays
    replicated."""

    def init_fn(seed: int) -> TrainState:
        rule_set = (None if mesh is None else
                    rules if rules is not None else rules_for_mesh(mesh))
        pieces = mesh is not None and params is None
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            variables = draw(model_def, gen, device, mesh, rule_set)
            p, mutable = variables["params"], variables.get("state", {})
        else:
            p, mutable = params, state or {}
        mask = getattr(optimizer, "mask", None)
        flags = (tree_leaves(mask(p)) if mask is not None
                 else [True] * len(tree_leaves(p)))
        for t, train in zip(tree_leaves(p), flags):
            t.requires_grad_(bool(train))
        fresh = {"params": p, "state": mutable, "step": 0}
        if mesh is not None:
            return place_state(fresh, model_def, optimizer, mesh, rule_set,
                               pieces=pieces)
        return {**fresh, "opt_state": optimizer.init(p)}

    return init_fn


def draw(model_def: ModelDef, generator: torch.Generator, device,
         mesh=None, rules: Optional[Rules] = None) -> dict:
    """``model_def``'s random variables; with a ``mesh``, only this
    rank's pieces of its parameters by ``rules`` (the mesh's by
    default): a family with ``sharded_init`` draws each slab and keeps
    its piece, another family's whole leaves are cut one at a time.
    Every rank draws the same stream, so the pieces are one global
    draw's."""
    if mesh is None:
        return model_def.init(generator, device)
    taker = ShardTaker(model_def.logical_axes()["params"], mesh,
                       rules if rules is not None else rules_for_mesh(mesh))
    if model_def.sharded_init:
        return model_def.init(generator, device, take=taker)
    variables = model_def.init(generator, device)
    return {**variables, "params": taker.tree(variables["params"])}


def place_state(state: TrainState, model_def: ModelDef,
                optimizer: Optimizer, mesh,
                rules: Optional[Rules] = None, *,
                pieces: bool = False) -> TrainState:
    """A fresh state's parameters placed on ``mesh`` as DTensors by
    ``rules`` (the mesh's, by default) and the optimizer state built on
    them, so its moments follow their placements: each rank keeps its
    chunk of the same full tensors, or, with ``pieces``, the parameters
    are already this rank's pieces (``draw``). The mutable state stays
    replicated."""
    rules = rules if rules is not None else rules_for_mesh(mesh)
    placements = state_placements(model_def, mesh, rules)["params"]
    params = (distribute_local if pieces else distribute)(
        state["params"], placements, mesh)
    return {**state, "params": params, "opt_state": optimizer.init(params)}


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _piece_weights(model_def: ModelDef, batch: dict, k: int, mesh
                   ) -> torch.Tensor:
    """Valid tokens of each of this rank's ``k`` microbatches (its cp
    sequence shard of the mask, for a model that shards sequences), or
    ones without a mask."""
    mask = batch.get("mask")
    if mask is None:
        device = next(iter(batch.values())).device
        return torch.ones(k, dtype=torch.float32, device=device)
    if mesh is not None and model_def.context_parallel:
        from polyaxon_tpu_torch.parallel.mesh import seq_shard

        shard = seq_shard(mask.shape[1], mesh=mesh)
        if shard is not None:
            mask = mask[:, shard]
    return mask.reshape(k, -1).to(torch.float32).sum(1)


def _sum_pieces(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the ranks that hold different batch pieces (in
    place; as it is without a mesh)."""
    return t if mesh is None else all_reduce_over(t, mesh, PIECE_AXES)


def rank_rows(batch: dict, mesh, accum_steps: int,
              local_blocks: int = 1) -> dict:
    """This rank's rows of a step, from the rows every plan process draws
    alike (``batch``: the JAX loop's per-process rows, of which the
    global batch holds one copy per process; its process's ranks hold
    ``local_blocks`` different row blocks), laid out so that its m-th
    microbatch is its row block of the global batch's m-th contiguous
    slice, as the JAX step cuts microbatches: with ``n`` row blocks of
    ``R = L / local_blocks`` rows (``L`` rows drawn), this rank's block
    ``r`` and ``A`` microbatches, row ``m·n·R/A + r·R/A + j`` of the
    global batch is ``batch`` row that number mod ``L``. Without
    accumulation or row blocks, ``batch`` as it is."""
    n, r = row_block(mesh)
    if n == 1 or (accum_steps == 1 and local_blocks == 1):
        return batch
    L = len(next(iter(batch.values())))
    per = L // (local_blocks * accum_steps)
    rows = n * L // local_blocks
    idx = [(m * rows // accum_steps + r * per + j) % L
           for m in range(accum_steps) for j in range(per)]
    return {k: v[idx] for k, v in batch.items()}


def build_train_step(model_def: ModelDef, optimizer: Optimizer,
                     accum_steps: int = 1, *, mesh=None
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
    leaves that require grad are updated (LoRA freezes the base). With a
    ``mesh`` of more than one rank, the ranks' pieces join the
    microbatches (module docstring). Returns ``train_step(state, batch,
    rng=None) -> (state, metrics)``, the state updated in place; metrics
    stay on the device."""
    uniform_keys = set(model_def.uniform_metrics) | {"loss_unweighted"}
    pieces = batch_pieces(mesh)
    replicas = fsdp.replica_axes(model_def)

    def params_view(state):
        if mesh is None:
            return state["params"]
        return fsdp.model_view(model_def, state["params"], mesh)

    def backward(state, batch, scales=None) -> dict:
        loss, metrics, new_mutable = model_def.apply(
            {"params": params_view(state), "state": state["state"]}, batch,
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

    def microbatches(batch):
        """This rank's rows cut into ``accum_steps`` contiguous
        microbatches (a loop lays its rows out with ``rank_rows`` so
        that microbatch m is its block of the global batch's m-th
        slice)."""
        if accum_steps == 1:
            return [batch]
        return [{k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                              *v.shape[1:])[i]
                 for k, v in batch.items()} for i in range(accum_steps)]

    def metrics_of(state, batch) -> dict:
        micro = microbatches(batch)
        w_micro = _piece_weights(model_def, batch, accum_steps, mesh)
        w_total = _sum_pieces(w_micro.sum(), mesh).clamp(min=1.0)
        n_pieces = accum_steps * pieces
        seq = [backward(state, mb, (w_micro[i] / w_total, 1.0 / n_pieces))
               for i, mb in enumerate(micro)]
        stacked = {k: torch.stack([m[k] for m in seq]) for k in seq[0]}
        share = w_micro / w_total  # exactly 1 for one unmasked piece
        keys = list(stacked)

        def part(k):
            if k in uniform_keys:
                return stacked[k].sum() / n_pieces
            out = (share * stacked[k]).sum()
            if k == "loss" and "loss_unweighted" in stacked:
                # sum(share·(loss - unweighted)) + sum(unweighted) / n,
                # written so that one piece reports its loss as it is.
                out = out + ((1.0 / n_pieces - share)
                             * stacked["loss_unweighted"]).sum()
            return out

        parts = _sum_pieces(torch.stack([part(k) for k in keys]), mesh)
        return dict(zip(keys, parts.unbind(0)))

    def train_step(state: TrainState, batch: dict, rng=None):
        metrics = metrics_of(state, batch)
        leaves = [p for p in tree_leaves(state["params"]) if p.requires_grad]
        grads = fsdp.reduce_grads(leaves, mesh, replicas)
        sharded = mesh is not None and mesh.size > 1
        grad_norm = (fsdp.global_norm(leaves, grads, mesh) if sharded
                     else global_norm(grads))
        # The optimizer updates the local tensors in place (an update that
        # spans whole leaves reduces over their shards: ``layout``); its
        # step count comes back on the local tree.
        opt_state = fsdp.local_tree(state["opt_state"])
        optimizer.update(fsdp.local_tree(state["params"]), grads, opt_state,
                         grad_norm=grad_norm,
                         layout=(fsdp.shard_layout(leaves, mesh) if sharded
                                 else None))
        state["opt_state"].update(
            {k: v for k, v in opt_state.items()
             if not isinstance(v, (dict, list, torch.Tensor))})
        for p in leaves:
            p.grad = None
        metrics["grad_norm"] = grad_norm
        state["step"] += 1
        return state, metrics

    return train_step


def build_eval_step(model_def: ModelDef, *, mesh=None
                    ) -> Callable[[TrainState, dict], dict]:
    """Metrics of one batch, each rank's piece weighted by its valid
    tokens over the piece axes, as the train step weights them (one
    piece: its own metrics)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        params = (state["params"] if mesh is None else fsdp.model_view(
            model_def, state["params"], mesh))
        _, metrics, _ = model_def.apply(
            {"params": params, "state": state["state"]}, batch, False, None)
        w = _piece_weights(model_def, batch, 1, mesh)[0]
        share = w / _sum_pieces(w.clone(), mesh).clamp(min=1.0)
        keys = list(metrics)
        parts = _sum_pieces(torch.stack(
            [metrics[k].to(torch.float32) * share for k in keys]), mesh)
        return dict(zip(keys, parts.unbind(0)))

    return eval_step
