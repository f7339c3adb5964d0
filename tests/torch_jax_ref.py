"""The JAX side of the port's multi-rank CPU tests: weights, rows, and
the reference's train step and gradients on its 8-device CPU mesh.

The weights are drawn by the port's ``init`` from a seed and handed to
both packages as numpy (compiling a JAX init costs seconds per config);
the rows come from the reference's own datasets. Each gloo rank of a
gang trains on the rows every process of the reference draws (the same
rows: ROADMAP.md, Queue 3), so the JAX step gets the global batch those
processes assemble, one copy per process.

Tolerances of the callers: loss and grad norm to rel 1e-5; each leaf's
gradient to rel 1e-4 as a whole (``assert_leaf_close``: the norm of the
difference over the norm of the leaf, so that elements near zero do not
count alone).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def flat(tree, prefix="") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flat(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def drawn_params(model: str, overrides: dict, seed: int = 0) -> dict:
    """The port's f32 initial parameters of ``model`` as numpy, held to
    the JAX init's tree and shapes."""
    import torch

    from polyaxon_tpu.models import get_model as jget
    from polyaxon_tpu_torch.models import family_of, get_model

    tdef = get_model(model, dtype=torch.float32, **overrides)
    got = family_of(model).init(tdef.config,
                                torch.Generator().manual_seed(seed),
                                device="cpu")["params"]
    got = jax.tree.map(lambda t: t.numpy(), got)
    jdef = jget(model, dtype=jnp.float32, **overrides)
    want = jax.eval_shape(jdef.init, jax.random.key(0))["params"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [g.shape for g in jax.tree.leaves(got)] == [
        w.shape for w in jax.tree.leaves(want)]
    return got


def host_batches(model: str, per_host: int, seq_len: int, steps: int,
                 seed: int = 0) -> list:
    """``steps`` batches of ``per_host`` rows from the reference's
    dataset for ``model``."""
    from polyaxon_tpu.runtime import data as jdata

    it = jdata.get_dataset(jdata.dataset_for_model(model),
                           batch_size=per_host, seq_len=seq_len,
                           vocab_size=256, seed=seed)
    return [next(it) for _ in range(steps)]


def jax_mesh(axes: dict) -> Mesh:
    names = tuple(axes)
    world = int(np.prod([axes[a] for a in names]))
    return Mesh(np.array(jax.devices()[:world]).reshape(
        [axes[a] for a in names]), names)


def _model_def(model: str, overrides: dict, lora: dict | None):
    """The reference's model, wrapped for LoRA when ``lora`` (rank,
    alpha, targets) is given."""
    from polyaxon_tpu.models import get_model as jget
    from polyaxon_tpu.models import lora as jlora

    mdef = jget(model, dtype=jnp.float32, **overrides)
    if lora is None:
        return mdef
    return jlora.lora_model_def(mdef, lora["rank"], lora["alpha"],
                                lora["targets"])


def lora_params(base: dict, lora: dict) -> dict:
    """The reference's {base, lora} tree from numpy ``base`` and the
    adapters of ``lora`` (rank, alpha, adapters)."""
    from polyaxon_tpu.models import lora as jlora

    return jax.tree.map(jnp.asarray, {
        "base": base, "lora": jlora.with_meta(lora["adapters"], lora["rank"],
                                              lora["alpha"])})


def jax_steps(model: str, overrides: dict, axes: dict, params0: dict,
              global_batches: list, runtime: dict,
              lora: dict | None = None, accum: int = 1,
              state0: dict | None = None) -> dict:
    """The reference's train step over ``axes`` (with LoRA adapters when
    ``lora`` is given: its masked optimizer, ``params0`` the {base,
    lora} tree; ``accum`` microbatches; ``state0`` the model's mutable
    state): losses and grad norms of each step (and the router aux of a
    model that reports it), the parameters and the mutable state after
    the last (flat)."""
    from polyaxon_tpu.models import lora as jlora
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
    from polyaxon_tpu.runtime.step import build_train_step as jstep

    mdef = _model_def(model, overrides, lora)
    opt = jbuild(JCfg(**runtime))
    if lora is not None:
        opt = jlora.wrap_optimizer(opt)
    mesh = jax_mesh(axes)
    out = {"loss": [], "grad_norm": []}
    with mesh:
        rules = jrules(mesh)
        params = jax.device_put(params0, tree_shardings(
            mdef.logical_axes()["params"], mesh, rules))
        state = {"params": params,
                 "state": jax.tree.map(jnp.asarray, state0 or {}),
                 "opt_state": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        train = jstep(mdef, opt, mesh, rules, accum_steps=accum)
        for b in global_batches:
            state, m = train(state, jax.tree.map(jnp.asarray, b),
                             jax.random.key(1))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if "router_aux" in m:
                out.setdefault("router_aux", []).append(
                    float(m["router_aux"]))
        out["params"] = flat(jax.tree.map(np.asarray, state["params"]))
        out["state"] = flat(jax.tree.map(np.asarray, state["state"]))
    return out


def jax_grads(model: str, overrides: dict, params0: dict, batch: dict,
              axes: dict | None = None, lora: dict | None = None) -> dict:
    """The gradient of the reference's ``apply`` loss on ``batch`` (over
    ``axes``' mesh, its parameters placed by the rules, when given; of
    the LoRA model when ``lora`` is given)."""
    mdef = _model_def(model, overrides, lora)
    b = jax.tree.map(jnp.asarray, batch)

    def loss(p):
        return mdef.apply({"params": p, "state": {}}, b, True, None)[0]

    if axes is None:
        return flat(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            params0)))
    from polyaxon_tpu.parallel import rules_for_mesh as jrules
    from polyaxon_tpu.parallel.sharding import tree_shardings

    mesh = jax_mesh(axes)
    with mesh:
        params = jax.device_put(params0, tree_shardings(
            mdef.logical_axes()["params"], mesh, jrules(mesh)))
        return flat(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
            params)))


def copies(batches: list, n: int) -> list:
    """Each batch's rows ``n`` times over (what ``n`` processes that drew
    the same rows assemble)."""
    return [{k: np.concatenate([v] * n) for k, v in b.items()}
            for b in batches]


def assert_leaf_close(got: np.ndarray, want: np.ndarray, rtol: float,
                      name: str) -> None:
    err = float(np.linalg.norm(got.astype(np.float64) - want))
    scale = float(np.linalg.norm(want.astype(np.float64)))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert err <= rtol * scale + 1e-12, (
        f"{name}: |got - want| = {err:.3e} > {rtol} x |want| = {scale:.3e}")


def assert_matches(port: dict, ref: dict, grads: dict, n_steps=None) -> None:
    """A rank's ``parallel_steps`` result against the reference's steps
    and gradients."""
    n = n_steps or len(ref["loss"])
    np.testing.assert_allclose(port["loss"][:n], ref["loss"][:n],
                               rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(port["grad_norm"][:1], ref["grad_norm"][:1],
                               rtol=LOSS_RTOL, atol=0)
    assert set(port["grads"]) == set(grads)
    for name, want in grads.items():
        assert_leaf_close(port["grads"][name], want, GRAD_RTOL, name)
