"""The shared body of the axis-pair test files
(``tests/test_torch_axis_pairs.py``, ``test_torch_axis_pairs_moe.py``):
the port's train step over a mesh of two model-parallel axes (and dp) in
gloo gangs, against the JAX package's train step on its CPU mesh.

A file names its cases, ``name: (model, overrides, port axes, instead)``
where ``instead`` is None or the (axes, overrides) of the reference's
step where it cannot run the port's mesh; ``forward`` names the cases
whose forward logits are held too (``torch_dist_cases.moe_forward_case``)
and ``lora`` the cases that train LoRA adapters (spec: rank, alpha,
targets). Each case takes STEPS adamw steps (f32, clipping on) from the
same weights on the same rows: every rank's losses and first grad norm
to rel 1e-5, the first step's reduced gradient of every leaf to rel
1e-4 as a whole (``torch_jax_ref.assert_matches``), against the
reference's steps and the gradient of its ``apply`` on one device of
the first global batch. Every process draws the same rows, and the
reference's global batch holds one copy per batch-axis rank. Each rank
also records the axes ``reduce_grads`` summed each leaf's gradient
over (``torch_dist_cases._CountingReduces``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from tests import torch_dist
from tests import torch_jax_ref as ref
from tests.torch_dist_cases import _job, parallel_steps

PER_HOST, SEQ, STEPS = 2, 32, 3
BATCH_AXES = ("dp", "fsdp", "ep")
# A gang that deadlocks fails its tests instead of hanging them.
GANG_SECONDS = 600


def world(axes: dict) -> int:
    return int(np.prod(list(axes.values())))


def batch_ranks(axes: dict) -> int:
    return int(np.prod([axes.get(a, 1) for a in BATCH_AXES]))


def _weights_key(model: str, overrides: dict) -> tuple:
    return model, overrides.get("n_layers"), overrides.get("image_size")


def _init_overrides(overrides: dict) -> dict:
    """The overrides that shape the weights."""
    return {k: v for k, v in overrides.items()
            if k in ("n_layers", "image_size")}


def _host(model: str, overrides: dict) -> list:
    if model == "vit_tiny":
        from polyaxon_tpu.runtime import data as jdata

        it = jdata.get_dataset("imagenet_synthetic", batch_size=PER_HOST,
                               image_size=overrides["image_size"],
                               num_classes=10, seed=0)
        return [next(it) for _ in range(STEPS)]
    return ref.host_batches(model, PER_HOST, SEQ, STEPS)


def _runtime(model: str) -> dict:
    extra = {"dataset": "seq2seq_synthetic"} if model == "t5_tiny" else {}
    return _job({}, STEPS, model=model, **extra)["runtime"]


def _adapters(base: dict, spec: dict) -> dict:
    """``spec``'s adapters of ``base`` as numpy, B drawn nonzero (at
    ``init_lora``'s zero B, A's gradient would be zero)."""
    from polyaxon_tpu.models import lora as jlora

    shapes = jax.eval_shape(lambda b, k: jlora.init_lora(
        b, spec["rank"], spec["targets"], k),
        jax.tree.map(jnp.asarray, base), jax.random.key(1))
    rng = np.random.default_rng(5)
    return {k: {"a": rng.standard_normal(v["a"].shape).astype(np.float32)
                * spec["rank"] ** -0.5,
                "b": 0.1 * rng.standard_normal(v["b"].shape).astype(
                    np.float32)}
            for k, v in sorted(shapes.items())}


def make_inputs(cases: dict, lora: dict) -> dict:
    """The weights and rows of each case's model, the tokens of the
    forward cases, and each LoRA case's adapters."""
    out = {}
    for model, ov, _, _ in cases.values():
        key = _weights_key(model, ov)
        if key not in out:
            out[key] = (ref.drawn_params(model, _init_overrides(ov)),
                        _host(model, ov))
    rng = np.random.default_rng(7)
    out["tokens"] = rng.integers(0, 256, (8, 16)).astype(np.int32)
    for name, spec in lora.items():
        model, ov, _, _ = cases[name]
        out[name] = dict(spec, adapters=_adapters(
            out[_weights_key(model, ov)][0], spec))
    return out


def start_gangs(cases: dict, forward, lora: dict, inputs: dict):
    """One gang per world size, started in threads: every case of that
    size in one launch. Returns (the pool, the futures by world size)."""
    from concurrent.futures import ThreadPoolExecutor

    by_world: dict = {}
    for name, (model, ov, axes, _) in cases.items():
        params0, host = inputs[_weights_key(model, ov)]
        case = {"name": name, "axes": axes, "model": model, "overrides": ov,
                "params0": params0, "batches": host,
                "runtime": {k: v for k, v in _runtime(model).items()
                            if k == "dataset"}}
        if name in lora:
            case["lora"] = inputs[name]
        by_world.setdefault(world(axes), []).append(case)
        if name in forward:
            by_world[world(axes)].append(
                {"name": f"{name}/fwd", "kind": "moe_forward", "axes": axes,
                 "overrides": ov, "params0": params0,
                 "tokens": inputs["tokens"]})
    pool = ThreadPoolExecutor(len(by_world))
    return pool, {w: pool.submit(torch_dist.run, parallel_steps, w, batch)
                  for w, batch in by_world.items()}


def _jax_forward(axes, overrides, params0, tokens):
    from polyaxon_tpu.models import moe as jmoe
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings

    cfg = dataclasses.replace(jmoe.CONFIGS["moe_tiny"], dtype=jnp.float32,
                              **overrides)
    mesh = ref.jax_mesh(axes)
    with mesh:
        params = jax.device_put(params0, tree_shardings(
            jmoe.logical_axes(cfg)["params"], mesh, jrules(mesh)))
        logits, aux = jax.jit(lambda p, t: jmoe.forward(cfg, p, t))(
            params, jnp.asarray(tokens))
    return np.asarray(logits), float(aux)


def compute_reference(cases: dict, forward, lora: dict,
                      inputs: dict) -> dict:
    """Per case, the reference's steps (over the port's mesh, or the
    case's ``instead``) and the gradient of its ``apply`` on one device
    (shared by the cases that compute the same function); the forward
    cases' logits and router aux."""
    out, one_device = {}, {}
    for name, (model, ov, axes, instead) in cases.items():
        params0, host = inputs[_weights_key(model, ov)]
        jaxes, jov = instead if instead is not None else (axes, ov)
        spec = inputs.get(name) if name in lora else None

        def start():  # the train step donates the arrays it is given
            return (params0 if spec is None
                    else ref.lora_params(params0, spec))

        out[name] = ref.jax_steps(model, jov, jaxes, start(),
                                  ref.copies(host, batch_ranks(axes)),
                                  _runtime(model), lora=spec)
        # No pipeline and no ring on one device; the first global batch,
        # whose copies compete for the experts' capacity.
        one = {k: v for k, v in jov.items()
               if k not in ("pipeline_stages", "pipeline_microbatches",
                            "attention_impl")}
        key = (model, tuple(sorted(one.items())), batch_ranks(axes),
               name in lora)
        if key not in one_device:
            one_device[key] = ref.jax_grads(
                model, one, start(), ref.copies(host, batch_ranks(axes))[0],
                lora=spec)
        grads = one_device[key]
        out[name, "grads"] = grads if spec is None else {
            k: v for k, v in grads.items()
            if k.startswith("lora/") and "/_meta/" not in k}
        if name in forward:
            out[name, "fwd"] = _jax_forward(axes, ov, params0,
                                            inputs["tokens"])
    return out


def check_steps(name: str, cases: dict, gangs: dict,
                reference: dict) -> None:
    """Rank 0's steps against the reference's; every rank reports the
    same metrics and holds the same parameters."""
    ranks = gangs[world(cases[name][2])].result(timeout=GANG_SECONDS)
    got = ranks[0][name]
    ref.assert_matches(got, reference[name], reference[name, "grads"])
    for r in ranks[1:]:
        other = r[name]
        np.testing.assert_allclose(other["loss"], got["loss"], rtol=1e-6)
        np.testing.assert_allclose(other["grad_norm"], got["grad_norm"],
                                   rtol=1e-6)
        for leaf, p in got["params"].items():
            np.testing.assert_allclose(other["params"][leaf], p, rtol=1e-5,
                                       atol=1e-7, err_msg=leaf)


def check_reduced_once(name: str, cases: dict, gangs: dict) -> None:
    """No leaf's gradient is summed twice over one axis (a gradient that
    autograd already reduced, summed again, would be off by the axis's
    size), none over an axis that shards it, and every rank reduces the
    same leaves."""
    ranks = gangs[world(cases[name][2])].result(timeout=GANG_SECONDS)
    first = ranks[0][name]["reduced"]
    assert first
    for r in ranks:
        reduced = r[name]["reduced"]
        assert [s for s, _ in reduced] == [s for s, _ in first]
        for sharded, over in reduced:
            assert len(over) == len(set(over)), over
            assert not set(sharded) & set(over), (sharded, over)


def check_forward(name: str, cases: dict, gangs: dict,
                  reference: dict) -> None:
    """Each rank's rows' logits and the router aux against the
    reference's forward on the same mesh."""
    ranks = gangs[world(cases[name][2])].result(timeout=GANG_SECONDS)
    logits = np.concatenate([r[f"{name}/fwd"]["logits"] for r in ranks])
    want_logits, want_aux = reference[name, "fwd"]
    np.testing.assert_allclose(logits, want_logits, atol=1e-5, rtol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/fwd"]["aux"], want_aux,
                                   rtol=ref.LOSS_RTOL, atol=1e-7)
