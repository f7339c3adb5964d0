"""Per-rank bodies of the port's multi-process CPU tests, run by
``tests/torch_dist.py`` in spawned gloo ranks (this module imports no
JAX, so the ranks never load it). Each takes numpy inputs and returns
numpy results; the test files hold them against the JAX package."""

from __future__ import annotations

import warnings

import numpy as np

from polyaxon_tpu_torch.parallel.compat import axis_size


def _shard_rows_seq(mesh, rank: int, x: np.ndarray, seq: bool = True):
    """This rank's [dp rows, cp sequence] block of a [B, S, ...] array."""
    import torch

    coords = mesh.coords(rank)
    dp, cp = axis_size(mesh, "dp"), axis_size(mesh, "cp")
    b = x.shape[0] // dp
    i = coords.get("dp", 0)
    x = x[i * b:(i + 1) * b]
    if seq:
        s = x.shape[1] // cp
        j = coords.get("cp", 0)
        x = x[:, j * s:(j + 1) * s]
    return torch.from_numpy(np.ascontiguousarray(x))


def attention_cases(rank: int, world: int, axes: dict, cases: dict,
                    llama: dict | None = None) -> dict:
    """Ring and Ulysses attention on this rank's shard of each case's
    q/k/v: the output shard, and with ``grad`` the gradients of
    ``sum(out ** 2)``; the number of point-to-point exchanges of a ring
    call forward and backward; the warnings each case raised. With
    ``llama``, the llama_tiny forward (``attention_impl="ring"``) of this
    rank's token shard at its global positions."""
    import torch

    from polyaxon_tpu_torch.ops import ring
    from polyaxon_tpu_torch.ops.attention import dot_product_attention
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh

    mesh = build_mesh(axes=axes)
    exchanges = [0]
    p2p = ring._p2p

    def counting(*args, **kwargs):
        exchanges[0] += 1
        return p2p(*args, **kwargs)

    ring._p2p = counting
    out: dict = {}
    with use_mesh(mesh):
        for name, case in cases.items():
            q, k, v = (_shard_rows_seq(mesh, rank, case[x]).requires_grad_()
                       for x in "qkv")
            exchanges[0] = 0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if case["kind"] == "inside":
                    o = ring._ring_attention_sharded(
                        q, k, v, causal=True, scale=q.shape[-1] ** -0.5,
                        axis=ring._Axis(mesh, "cp"))
                else:
                    o = dot_product_attention(q, k, v, causal=case["causal"],
                                              impl=case["kind"])
            res = {"out": o.detach().numpy(), "fwd_exchanges": exchanges[0],
                   "warnings": [str(w.message) for w in caught
                                if w.category is RuntimeWarning]}
            if case.get("grad"):
                exchanges[0] = 0
                (o ** 2).sum().backward()
                res.update(dq=q.grad.numpy(), dk=k.grad.numpy(),
                           dv=v.grad.numpy(), bwd_exchanges=exchanges[0])
            out[name] = res
        if llama is not None:
            import dataclasses

            from polyaxon_tpu_torch.models import llama as tllama

            cfg = dataclasses.replace(
                tllama.CONFIGS["llama_tiny"], max_seq_len=256,
                dtype=torch.float32, attention_impl="ring")
            params = tllama.params_from_numpy(cfg, llama["params"],
                                              device="cpu")
            tokens = llama["tokens"]
            local = _shard_rows_seq(mesh, rank, tokens)
            positions = _shard_rows_seq(
                mesh, rank, np.broadcast_to(
                    np.arange(tokens.shape[1], dtype=np.int32),
                    tokens.shape))
            with torch.no_grad():
                out["llama"] = tllama.forward(cfg, params, local.long(),
                                              positions).numpy()
    ring._p2p = p2p
    return out


def stitch(results: list, axes: dict, key) -> np.ndarray:
    """The global [B, S, ...] array from each rank's block (``key`` picks
    the block out of a rank's result)."""
    from polyaxon_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(axes=axes, devices=range(len(results)))
    dp, cp = axis_size(mesh, "dp"), axis_size(mesh, "cp")
    rows = []
    for i in range(dp):
        cols = []
        for j in range(cp):
            coords = {"dp": i, "cp": j}
            index = tuple(coords.get(a, 0) for a in mesh.axis_names)
            cols.append(key(results[int(mesh.devices[index])]))
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


# ------------------------------------------------------------- training
def _job(axes: dict, steps: int, **runtime) -> dict:
    return {"kind": "jaxjob", "mesh": {"axes": axes},
            "runtime": {"model": "llama_tiny", "dataset": "lm_synthetic",
                        "steps": steps, "seq_len": 64, "log_every": 1,
                        "learning_rate": 3e-3, "warmup_steps": 0,
                        "lr_schedule": "constant", "optimizer": "adamw",
                        "grad_clip_norm": 1.0, "dtype": "float32",
                        "prefetch": 0, **runtime}}


def _numpy_tree(tree):
    from polyaxon_tpu_torch.parallel.fsdp import local

    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    if hasattr(tree, "full_tensor"):
        return tree.full_tensor().detach().numpy()
    return local(tree).detach().numpy() if hasattr(tree, "numpy") else tree


def train_steps(rank: int, world: int, axes: dict, params0: dict,
                batches: list, impl: str) -> dict:
    """The port's train step over ``axes`` from ``params0`` (JAX's
    names), each rank on ``batches`` (this process's rows, equal on
    every rank as the reference draws them): the losses and grad norms
    of each step and the full parameters after the last."""
    import torch

    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.models import llama as tllama
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.parallel.sharding import rules_for_mesh
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

    spec = _job(axes, len(batches))["runtime"]
    mesh = build_mesh(axes=axes)
    rules = rules_for_mesh(mesh)
    model_def = get_model("llama_tiny", dtype=torch.float32,
                          attention_impl=impl, loss_chunk=16)
    opt = build_optimizer(RuntimeConfig.from_dict(spec))
    params = tllama.params_from_numpy(model_def.config, params0,
                                      device="cpu")
    out = {"loss": [], "grad_norm": []}
    with use_mesh(mesh):
        state = build_init(model_def, opt, device="cpu", params=params,
                           mesh=mesh, rules=rules)(0)
        step = build_train_step(model_def, opt, mesh=mesh)
        for batch in batches:
            state, metrics = step(state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
        out["params"] = _numpy_tree(state["params"])
    return out


def run_job(rank: int, world: int, job: dict, artifacts_dir: str) -> dict:
    """``run_torchjob`` on this rank (the loop of every gang process):
    the emitted losses (rank 0 emits), the steps, the step restored
    from and the units a step trains."""
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    losses: dict = {}
    result = run_torchjob(job, artifacts_dir=artifacts_dir, device="cpu",
                          on_metrics=lambda s, v: losses.__setitem__(
                              s, v["loss"]) if "loss" in v else None)
    return {"losses": losses, "steps": result.steps,
            "restored_from_step": result.restored_from_step,
            "units_per_step": result.units_per_step,
            "final_metrics": result.final_metrics}


def replaced_run(rank: int, world: int, axes_a: dict, axes_b: dict,
                 split: int, steps: int) -> dict:
    """The uninterrupted counterpart of a checkpoint that moves meshes:
    the loop's first ``split`` steps over ``axes_a``, the state gathered
    and placed over ``axes_b`` in memory, and the rest of the steps
    there; the full parameters and moments at the end."""
    import torch

    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.parallel.sharding import (distribute,
                                                      rules_for_mesh)
    from polyaxon_tpu_torch.runtime import data as data_lib
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.loop import _dataset_kwargs
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import (build_init,
                                                 build_train_step,
                                                 state_placements)

    cfg = RuntimeConfig.from_dict(_job(axes_a, steps)["runtime"])
    model_def = get_model("llama_tiny", dtype=torch.float32)
    opt = build_optimizer(cfg)
    per_host = (cfg.global_batch_size or 8 * world) // world
    batches = data_lib.get_dataset(
        "lm_synthetic", start_batch=0,
        **_dataset_kwargs(cfg, model_def.config, per_host))

    def place(state, mesh):
        rules = rules_for_mesh(mesh)
        pl = state_placements(model_def, mesh, rules)["params"]
        full = _torch_tree(state)
        params = distribute(full["params"], pl, mesh)
        opt_state = {k: ([distribute(t, p, mesh) for t, p in zip(
            v, _leaves(pl))] if isinstance(v, list) else v)
            for k, v in full["opt_state"].items()}
        return {**state, "params": params, "opt_state": opt_state}

    mesh = build_mesh(axes=axes_a)
    with use_mesh(mesh):
        state = build_init(model_def, opt, device="cpu", mesh=mesh,
                           rules=rules_for_mesh(mesh))(cfg.seed)
        step = build_train_step(model_def, opt, mesh=mesh)
        for _ in range(split):
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in next(batches).items()})
    mesh = build_mesh(axes=axes_b)
    with use_mesh(mesh):
        state = place(state, mesh)
        step = build_train_step(model_def, opt, mesh=mesh)
        for _ in range(split, steps):
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in next(batches).items()})
    return {"params": _numpy_tree(state["params"]),
            "opt_state": _numpy_tree(state["opt_state"])}


def _leaves(tree):
    from polyaxon_tpu_torch.runtime.optim import tree_leaves

    return tree_leaves(tree)


def _torch_tree(state):
    """A placed state's tensors gathered whole (requires_grad kept)."""
    import torch

    def full(t):
        if hasattr(t, "full_tensor"):
            return t.full_tensor().detach().requires_grad_(t.requires_grad)
        return t

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return full(tree) if isinstance(tree, torch.Tensor) else tree

    return walk(state)


# ----------------------------------------------------------------- gangs
ENV_START_PARAMS = "POLYAXON_TEST_START_PARAMS"

# A gang process's command in the CPU tests: the launcher on the CPU (the
# plan's own command runs on the card).
CPU_LAUNCHER = "from tests.torch_dist_cases import cpu_launch; cpu_launch()"


def cpu_launch() -> None:
    """``launch.main(device="cpu")``; with ``POLYAXON_TEST_START_PARAMS``
    (a pickle of JAX's initial llama weights as numpy) the loop starts
    from those weights, as ``run_jaxjob`` does from its own draw."""
    import os
    import pickle
    import sys

    from polyaxon_tpu_torch.runtime import launch

    path = os.environ.get(ENV_START_PARAMS)
    if path:
        from polyaxon_tpu_torch.models import llama
        from polyaxon_tpu_torch.runtime import loop, step

        with open(path, "rb") as fh:
            params0 = pickle.load(fh)

        def build_init(model_def, optimizer, *, device, **kwargs):
            return step.build_init(model_def, optimizer, device=device,
                                   params=llama.params_from_numpy(
                                       model_def.config, params0,
                                       device=device), **kwargs)

        loop.build_init = build_init
    sys.exit(launch.main(device="cpu"))


# ------------------------------------------------------ model parallelism
class _Recording:
    """An optimizer that keeps the (reduced, local) gradients of its last
    update and otherwise is ``inner``."""

    def __init__(self, inner):
        self.inner = inner
        self.grads = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state, **kwargs):
        self.grads = [g.clone() for g in grads]
        return self.inner.update(params, grads, state, **kwargs)


def _with_lora(model_def, opt, base: dict, spec: dict):
    """LoRA over ``model_def`` (``spec``: rank, alpha, targets and the
    adapters as numpy, keyed by path): the wrapped model, the masked
    optimizer and the {base, lora} parameters."""
    import torch

    from polyaxon_tpu_torch.models import lora

    adapters = {k: {n: torch.tensor(v) for n, v in ab.items()}
                for k, ab in spec["adapters"].items()}
    return (lora.lora_model_def(model_def, spec["rank"], spec["alpha"],
                                spec["targets"]),
            lora.wrap_optimizer(opt),
            {"base": base, "lora": lora.with_meta(adapters, spec["rank"],
                                                  spec["alpha"])})


def _named_leaves(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _named_leaves(value, path)
        else:
            yield path, value


def _full(t, like):
    """The whole tensor of a local piece ``t`` of DTensor ``like``'s
    placements."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride()).full_tensor()


def _tensor_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return torch.tensor(tree)


class _CountingReduces:
    """Around ``fsdp.reduce_grads``: for each leaf, the mesh axes that
    shard it and the axes its gradient was all-reduced over, in order (a
    guard that no axis sums a gradient twice)."""

    def __init__(self, mesh):
        self.mesh, self.per_leaf = mesh, None

    def __enter__(self):
        import torch.distributed as dist

        from polyaxon_tpu_torch.parallel import fsdp

        groups = {self.mesh.group(n).group_name: n
                  for n in self.mesh.axis_names if self.mesh.shape[n] > 1}
        inner, reduce_grads = dist.all_reduce, fsdp.reduce_grads
        counting = self

        def reduce_once(params, mesh, replicas):
            per_leaf, seen = [], []

            def all_reduce(t, *args, group=None, **kwargs):
                seen.append("world" if group is None
                            else groups.get(group.group_name, "other"))
                return inner(t, *args, group=group, **kwargs)

            dist.all_reduce = all_reduce
            try:
                out = []
                for p in params:
                    seen.clear()
                    out.extend(reduce_grads([p], mesh, replicas))
                    sharded = [n for n, pl in zip(mesh.axis_names,
                                                  getattr(p, "placements",
                                                          ()))
                               if pl.is_shard()]
                    per_leaf.append((sharded, list(seen)))
            finally:
                dist.all_reduce = inner
            if counting.per_leaf is None:
                counting.per_leaf = per_leaf
            return out

        self._restore = (fsdp, reduce_grads)
        fsdp.reduce_grads = reduce_once
        return self

    def __exit__(self, *exc):
        fsdp, reduce_grads = self._restore
        fsdp.reduce_grads = reduce_grads


def _overrides(case: dict) -> dict:
    import torch

    out = dict(case.get("overrides", {}))
    out["dtype"] = getattr(torch, out.get("dtype", "float32"))
    return out


def parallel_steps(rank: int, world: int, cases: list) -> dict:
    """Each case by its ``kind`` (default ``"steps"``): ``"steps"``, the
    port's train step over the case's mesh (``axes``, all the ranks)
    from ``params0`` (JAX's names, numpy) on ``batches`` (this process's
    rows, numpy; ``rank_batches`` gives each rank its own): the losses
    and grad norms, the first step's reduced gradients and the
    parameters after the last step, whole, by leaf path (a ``"lora"``
    entry trains adapters over the model: ``_with_lora``); ``"job"``,
    ``run_job`` of the case's ``job``; ``"vocab_ce"``, ``"pipeline"``
    and ``"moe_forward"``, the functions of those names below."""
    import torch

    from polyaxon_tpu_torch.models import family_of, get_model
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.parallel.sharding import rules_for_mesh
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

    out = {}
    for case in cases:
        kind = case.get("kind", "steps")
        if kind == "job":
            out[case["name"]] = run_job(rank, world, case["job"],
                                        case["artifacts"])
            continue
        if kind in ("vocab_ce", "pipeline", "moe_forward", "init"):
            body = {"vocab_ce": vocab_ce_case, "pipeline": pipeline_case,
                    "moe_forward": moe_forward_case,
                    "init": sharded_init_case}[kind]
            out[case["name"]] = body(rank, world, case)
            continue
        mesh = build_mesh(axes=case["axes"])
        model_def = get_model(case["model"], **_overrides(case))
        family = family_of(case["model"])
        opt = build_optimizer(RuntimeConfig.from_dict(
            _job(case["axes"], 1, model=case["model"],
                 **case.get("runtime", {}))["runtime"]))
        params = family.params_from_numpy(model_def.config,
                                          case["params0"], device="cpu")
        if "lora" in case:
            model_def, opt, params = _with_lora(model_def, opt, params,
                                                case["lora"])
        res = {"loss": [], "grad_norm": []}
        accum = case.get("accum", 1)
        state0 = (_tensor_tree(case["state0"]) if "state0" in case
                  else None)
        counting = _CountingReduces(mesh)
        with use_mesh(mesh), counting:
            opt = _Recording(opt)
            state = build_init(model_def, opt, device="cpu", params=params,
                               state=state0, mesh=mesh,
                               rules=rules_for_mesh(mesh))(0)
            step = build_train_step(model_def, opt, mesh=mesh,
                                    accum_steps=accum)
            batches = (case["rank_batches"][rank] if "rank_batches" in case
                       else case["batches"])
            if case.get("loop_rows"):  # the loop's layout of its rows
                from polyaxon_tpu_torch.runtime.step import rank_rows

                batches = [rank_rows(b, mesh, accum) for b in batches]
            for i, batch in enumerate(batches):
                state, metrics = step(state, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
                res["loss"].append(float(metrics["loss"]))
                res["grad_norm"].append(float(metrics["grad_norm"]))
                if "router_aux" in metrics:
                    res.setdefault("router_aux", []).append(
                        float(metrics["router_aux"]))
                if i == 0:
                    leaves = [(name, p) for name, p in
                              _named_leaves(state["params"])
                              if p.requires_grad]
                    res["grads"] = {
                        name: _full(g, p).detach().numpy()
                        for (name, p), g in zip(leaves, opt.grads)}
            res["params"] = {name: _numpy_tree({"x": p})["x"] for name, p
                             in _named_leaves(state["params"])}
            res["state"] = {name: t.numpy() for name, t
                            in _named_leaves(state["state"])}
        res["reduced"] = counting.per_leaf
        out[case["name"]] = res
    return out


def vocab_ce_case(rank: int, world: int, case: dict) -> dict:
    """``parallel.tensor.vocab_parallel_ce`` on this rank's vocab columns
    of ``logits`` [N, V] over a tp mesh of every rank: the mean loss and
    accuracy over the masked positions, and the gradient of the mean
    loss with respect to this rank's columns."""
    import torch

    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.parallel.tensor import (vocab_parallel_ce,
                                                    vocab_shard)

    mesh = build_mesh(axes={"tp": world})
    logits = torch.from_numpy(case["logits"])
    per = logits.shape[-1] // world
    local = logits[:, rank * per:(rank + 1) * per].clone().requires_grad_()
    labels = torch.from_numpy(case["labels"]).long()
    mask = torch.from_numpy(case["mask"]).float()
    with use_mesh(mesh):
        nll, correct = vocab_parallel_ce(
            local, labels, vocab_shard(logits.shape[-1], per))
    loss = (nll * mask).sum() / mask.sum()
    loss.backward()
    return {"loss": float(loss),
            "accuracy": float((correct * mask).sum() / mask.sum()),
            "grad": local.grad.numpy()}


def pipeline_case(rank: int, world: int, case: dict) -> dict:
    """llama_tiny pipelined over ``axes`` (a pp axis), parameters plain
    tensors from ``params0`` on every rank: for each schedule
    (``double_buffer`` False, True) the forward logits of ``tokens`` (on
    every rank: the last stage's, broadcast) and this rank's gradients
    of ``sum(forward(grad_tokens) ** 2) / 1e4`` at ``grad_micro``
    microbatches (each stage's leaves; the stages' sum is the whole)."""
    import dataclasses

    import torch

    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh

    mesh = build_mesh(axes=case["axes"])
    base = dataclasses.replace(llama.CONFIGS["llama_tiny"],
                               dtype=torch.float32, **case["overrides"])
    out = {}
    with use_mesh(mesh):
        for db in (False, True):
            cfg = dataclasses.replace(base, pipeline_double_buffer=db)
            params = llama.params_from_numpy(cfg, case["params0"],
                                             device="cpu")
            with torch.no_grad():
                logits = llama.forward(cfg, params, torch.from_numpy(
                    case["tokens"]).long())
            cfg = dataclasses.replace(
                cfg, pipeline_microbatches=case["grad_micro"])
            for t in _named_leaves(params):
                t[1].requires_grad_()
            loss = (llama.forward(cfg, params, torch.from_numpy(
                case["grad_tokens"]).long()) ** 2).sum() / 1e4
            loss.backward()
            out[db] = {"logits": logits.numpy(), "loss": float(loss),
                       "grads": {name: (t.grad.numpy() if t.grad is not None
                                        else np.zeros(t.shape, np.float32))
                                 for name, t in _named_leaves(params)}}
    return out


def moe_forward_case(rank: int, world: int, case: dict) -> dict:
    """moe_tiny's forward (the ragged dispatch) of this rank's rows of
    ``tokens`` over ``axes`` (batch over dp and ep, in rank order), the
    parameters from ``params0`` placed by the rules and viewed as the
    train step views them: this rank's logits and the router aux."""
    import dataclasses

    import torch

    from polyaxon_tpu_torch.models import moe
    from polyaxon_tpu_torch.parallel import fsdp
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.parallel.sharding import (distribute,
                                                      rules_for_mesh,
                                                      tree_placements)

    mesh = build_mesh(axes=case["axes"])
    overrides = dict(case["overrides"], dtype=torch.float32)
    cfg = dataclasses.replace(moe.CONFIGS["moe_tiny"], **overrides)
    params = moe.params_from_numpy(cfg, case["params0"], device="cpu")
    placed = distribute(params, tree_placements(
        moe.logical_axes(cfg)["params"], mesh, rules_for_mesh(mesh)), mesh)
    tokens = case["tokens"]
    per = tokens.shape[0] // world
    local = torch.from_numpy(tokens[rank * per:(rank + 1) * per]).long()
    with use_mesh(mesh), torch.no_grad():
        view = fsdp.model_view(moe.model_def("moe_tiny", **overrides),
                               placed, mesh)
        logits, aux = moe.forward(cfg, view, local)
    return {"logits": logits.numpy(), "aux": float(aux)}


# ------------------------------------------------------- sharded serving
def _post(url: str, payload: dict) -> dict:
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/v1/generate", method="POST",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return json.load(resp)
    except urllib.error.HTTPError as exc:
        raise AssertionError(exc.read().decode()) from exc


def _stream(url: str, payload: dict) -> list:
    """The tokens of each row of a streamed request, from its events."""
    import json
    import urllib.request

    req = urllib.request.Request(url + "/v1/generate", method="POST",
                                 data=json.dumps(dict(payload, stream=True))
                                 .encode(),
                                 headers={"Content-Type": "application/json"})
    rows: dict = {}
    with urllib.request.urlopen(req, timeout=300) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                event = json.loads(line[len("data: "):])
                if "token" in event:
                    rows.setdefault(event["index"], []).append(event["token"])
    return [rows[i] for i in sorted(rows)]


def serving_cases(rank: int, world: int, cases: list) -> dict:
    """Each case a ``ServingServer`` over ``axes`` (every rank of the
    gang) on the case's model and checkpoint, its ``server`` keyword
    arguments, on the CPU: rank 0 answers the case's ``requests`` (name
    → payload; ``"stream"`` in the name streams it) and, with
    ``logits``, the sharded prefill of that prompt and its first decode
    step through the gang (both logits, whole); the other ranks follow.
    Returns, on rank 0, each case's answers; the gang's model calls and
    the bytes of this rank's parameters, on every rank."""
    import dataclasses

    import torch

    from polyaxon_tpu_torch.serving.gang import ParamsRef
    from polyaxon_tpu_torch.serving.quantize import tree_bytes
    from polyaxon_tpu_torch.serving.server import ServingServer

    out = {}
    for case in cases:
        for model in case.get("f32", ()):  # serve these configs in f32
            from polyaxon_tpu_torch.models import family_of

            configs = family_of(model).CONFIGS
            configs[model] = dataclasses.replace(configs[model],
                                                 dtype=torch.float32)
        server = ServingServer(case["model"], case.get("checkpoint"),
                               mesh_axes=case["axes"], device="cpu",
                               **case.get("server", {}))
        family, cfg, params, _ = server.gang.worker.roles["target"]
        res: dict = {"param_bytes": tree_bytes(params)}
        if not server.is_leader:
            server.follow()
            res["calls"] = server.gang.calls
            out[case["name"]] = res
            continue
        with server:
            for name, payload in case.get("requests", {}).items():
                res[name] = (_stream(server.url, payload) if "stream" in name
                             else _post(server.url, payload)["tokens"])
            if "logits" in case:
                fam = server.gang.family("target", family)
                prompt = torch.tensor([case["logits"]], dtype=torch.long)
                logits, cache = fam.prefill(cfg, ParamsRef("target"),
                                            prompt, 32)
                step, _ = fam.decode_step(cfg, ParamsRef("target"), cache,
                                          logits.argmax(-1),
                                          prompt.shape[1])
                res["prefill_logits"] = logits.numpy()
                res["decode_logits"] = step.numpy()
        res["calls"] = server.gang.calls
        out[case["name"]] = res
    return out


def sharded_init_case(rank: int, world: int, case: dict) -> dict:
    """``build_init`` of ``model`` (with ``overrides``) from seed 0 over
    ``axes`` (every rank): the bytes of this rank's parameters against
    the bytes of its shards by the rules, the largest tensor any
    operation made meanwhile, and the parameters gathered whole."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh
    from polyaxon_tpu_torch.parallel.sharding import (rules_for_mesh,
                                                      tree_placements)
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import build_init

    class Largest(TorchDispatchMode):
        largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                # A DTensor's own storage is its local tensor's, which
                # its local operation made.
                if isinstance(t, torch.Tensor) and not isinstance(t,
                                                                  DTensor):
                    Largest.largest = max(Largest.largest,
                                          t.numel() * t.element_size())
            return out

    mesh = build_mesh(axes=case["axes"])
    model_def = get_model(case["model"], dtype=torch.float32,
                          **case.get("overrides", {}))
    opt = build_optimizer(RuntimeConfig.from_dict(_job(case["axes"], 1)[
        "runtime"]))
    with use_mesh(mesh), Largest():
        state = build_init(model_def, opt, device="cpu", mesh=mesh,
                           rules=rules_for_mesh(mesh))(0)
    placements = tree_placements(model_def.logical_axes()["params"], mesh,
                                 rules_for_mesh(mesh))
    shard_bytes = 0
    for (_, p), (_, pl) in zip(_named_leaves(state["params"]),
                               _named_leaves(placements)):
        n = p.numel() * p.element_size()
        for name, one in zip(mesh.axis_names, pl):
            if one.is_shard():
                n //= mesh.shape[name]
        shard_bytes += n
    return {"local_bytes": sum(p.to_local().numel() * p.element_size()
                               for _, p in _named_leaves(state["params"])),
            "shard_bytes": shard_bytes, "largest": Largest.largest,
            "params": {name: p.full_tensor().detach().numpy()
                       for name, p in _named_leaves(state["params"])}}
