"""The port's LoRA (``polyaxon_tpu_torch/models/lora.py``) against the
JAX package's on the CPU, at ``llama_tiny`` in f32.

What is held: the adapter tree's keys and shapes, the merge (``W +
(alpha/rank)·A@B``) and ``merge_saved`` with a checkpoint's ``_meta``,
with TARGETS (the default projections, which merge where the model
reads them, and ``lm_head``, ``embed`` and the ``attn_norm`` gains, which
merge before it runs); the loss and every adapter's gradient with
TARGETS against JAX's ``lora_model_def`` (loss to 1e-5, gradients to
atol 1e-5, rtol 1e-4); the frozen base (no gradient, no optimizer
state, not moved by a step) and two masked adamw steps against JAX's
``lora_model_def`` + ``wrap_optimizer`` train step from the same weights
(the default targets; loss to 1e-5, adapters to atol 1e-5, rtol 1e-4);
and ``run_torchjob`` with ``lora_rank`` saving a checkpoint that
``load_params`` merges for serving. The weights are drawn by the port's init and numpy (held to
the JAX init's tree): compiling the JAX inits would cost seconds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.models import lora as jlora
from polyaxon_tpu_torch.models import get_model
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.models import lora as tlora
from polyaxon_tpu_torch.runtime import optim as toptim
from polyaxon_tpu_torch.runtime.config import RuntimeConfig
from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
RANK, ALPHA = 4, 8.0
TARGETS = tlora.DEFAULT_TARGETS + ("lm_head", "embed", "attn_norm")

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x, np.float32)),
                        tree)


@pytest.fixture(scope="module")
def trees():
    """llama_tiny weights and TARGETS' adapters (B drawn nonzero so the
    merge moves the weights) as JAX arrays, and their port copies."""
    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                               dtype=torch.float32)
    base = jax.tree.map(lambda t: t.numpy(), tllama.init(
        tcfg, torch.Generator().manual_seed(0), device="cpu")["params"])
    want = jax.eval_shape(lambda k: jllama.init(jcfg, k)["params"],
                          jax.random.key(0))
    assert jax.tree.structure(base) == jax.tree.structure(want)
    shapes = jax.eval_shape(lambda b, k: jlora.init_lora(
        b, RANK, TARGETS, k), base, jax.random.key(1))
    rng = np.random.default_rng(2)
    lora = {k: {"a": jnp.asarray(rng.standard_normal(
                    v["a"].shape, np.float32) * RANK ** -0.5),
                "b": jnp.asarray(0.1 * rng.standard_normal(
                    v["b"].shape, np.float32))}
            for k, v in sorted(shapes.items())}
    tbase = tllama.params_from_numpy(tcfg, base, device="cpu")
    return jax.tree.map(jnp.asarray, base), lora, tbase, _to_torch(lora)


def test_adapters_merge_and_meta_match_jax(trees):
    base, lora, tbase, tl = trees
    fresh = tlora.init_lora(tbase, RANK, TARGETS,
                            torch.Generator().manual_seed(0))
    assert sorted(fresh) == sorted(lora)
    for key, ab in fresh.items():
        assert tuple(ab["a"].shape) == lora[key]["a"].shape
        assert tuple(ab["b"].shape) == lora[key]["b"].shape
        assert not ab["b"].any()  # B = 0: training starts at the base
    want = jlora.merge(base, lora, ALPHA, RANK)
    got = dict(_flat(tlora.merge(tbase, tl, ALPHA, RANK)))
    for key, w in _flat(want):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   atol=1e-6, rtol=1e-6, err_msg=key)
    # merge_saved reads alpha and rank from _meta (the arguments are
    # fallbacks), like the reference's.
    saved = tlora.with_meta(tl, RANK, ALPHA)
    jsaved = jlora.merge_saved(base, jlora.with_meta(lora, RANK, ALPHA),
                               alpha=1.0, host=True)
    got = dict(_flat(tlora.merge_saved(tbase, saved, alpha=1.0)))
    for key, w in _flat(jsaved):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w),
                                   atol=1e-6, rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="alpha"):
        tlora.merge_saved(tbase, tl)
    with pytest.raises(ValueError, match="no params matched"):
        tlora.init_lora(tbase, RANK, ("nope",), torch.Generator())


def _spec(**kw):
    return dict(dict(model="llama_tiny", optimizer="adamw",
                     learning_rate=1e-2, lr_schedule="constant",
                     grad_clip_norm=1.0, weight_decay=0.01, steps=2), **kw)


def _default_targets(lora):
    return {k: v for k, v in lora.items()
            if k.split("/")[-1] in tlora.DEFAULT_TARGETS}


def test_other_targets_match_jax_loss_and_grads(trees):
    """TARGETS adapted: the projections merge where the model reads them
    (``LoraWeight``), the head, the embedding and the norm gains before
    it runs. The loss and every adapter's gradient against JAX's
    ``lora_model_def`` apply on the same weights and tokens."""
    base, lora, tbase, tl = trees
    tokens = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(
        np.int32)
    jmodel = jlora.lora_model_def(
        jllama.model_def("llama_tiny", dtype=jnp.float32, loss_chunk=16),
        RANK, ALPHA, TARGETS)

    def jloss(adapters):
        params = {"base": base, "lora": jlora.with_meta(adapters, RANK,
                                                        ALPHA)}
        return jmodel.apply({"params": params, "state": {}},
                            {"tokens": jnp.asarray(tokens)})[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(lora)
    model_def = tlora.lora_model_def(
        get_model("llama_tiny", dtype=torch.float32, loss_chunk=16,
                  attention_impl="xla"), RANK, ALPHA, TARGETS)
    adapters = jax.tree.map(lambda t: t.clone().requires_grad_(True), tl)
    merged = tlora.merge_lazy(tbase, adapters, ALPHA, RANK)
    assert isinstance(merged["layers"]["wq"], tlora.LoraWeight)
    assert isinstance(merged["lm_head"], torch.Tensor)
    loss = model_def.apply({"params": {
        "base": tbase, "lora": tlora.with_meta(adapters, RANK, ALPHA)},
        "state": {}}, {"tokens": torch.from_numpy(tokens).long()})[0]
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), abs=1e-5, rel=1e-5)
    got = dict(_flat(adapters))
    for key, g in _flat(jg):
        np.testing.assert_allclose(got[key].grad.numpy(), np.asarray(g),
                                   err_msg=key, **GRAD_TOL)


def test_train_steps_match_jax_with_frozen_base(trees, cpu_devices):
    """Two masked adamw steps: the port's against JAX's on a 1-device
    mesh from the same base and adapters. The base requires no grad,
    has no optimizer state and does not move; ``_meta`` does not move."""
    from polyaxon_tpu.parallel import build_mesh, rules_for_mesh
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
    from polyaxon_tpu.runtime.step import build_train_step as jstep

    base, lora, tbase, tl = trees
    lora, tl = _default_targets(lora), _default_targets(tl)
    batches = [np.random.default_rng(i).integers(0, 256, (2, 16)).astype(
        np.int32) for i in range(2)]
    mesh = build_mesh(axes={"dp": 1}, devices=cpu_devices[:1])
    rules = rules_for_mesh(mesh)
    jmodel = jlora.lora_model_def(
        jllama.model_def("llama_tiny", dtype=jnp.float32, loss_chunk=16),
        RANK, ALPHA)
    jopt = jlora.wrap_optimizer(jbuild(JCfg(**_spec())))
    jparams = jax.tree.map(jnp.array, {
        "base": base, "lora": jlora.with_meta(lora, RANK, ALPHA)})
    with mesh:
        # On the mesh from the start, as the step's outputs are: one
        # compile for both steps.
        jstate = jax.device_put(
            {"params": jparams, "state": {}, "opt_state": jopt.init(jparams),
             "step": jnp.zeros((), jnp.int32)},
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
        train = jstep(jmodel, jopt, mesh, rules)
        want = []
        for b in batches:
            jstate, m = train(jstate, {"tokens": jnp.asarray(b)},
                              jax.random.key(3))
            want.append(float(m["loss"]))

    model_def = tlora.lora_model_def(
        get_model("llama_tiny", dtype=torch.float32, loss_chunk=16,
                  attention_impl="xla"), RANK, ALPHA)
    opt = tlora.wrap_optimizer(toptim.build_optimizer(
        RuntimeConfig.from_dict(_spec())))
    params = {"base": jax.tree.map(lambda t: t.clone(), tbase),
              "lora": tlora.with_meta(jax.tree.map(lambda t: t.clone(), tl),
                                      RANK, ALPHA)}
    state = build_init(model_def, opt, device="cpu", params=params)(0)
    assert not any(t.requires_grad for t in toptim.tree_leaves(
        state["params"]["base"]))
    adapters = toptim.tree_leaves(tlora.split_meta(state["params"]["lora"])[0])
    assert all(t.requires_grad for t in adapters)
    moments = state["opt_state"]["mu"]
    assert [m.shape for m in moments] == [t.shape for t in adapters]
    step = build_train_step(model_def, opt)
    for b, loss in zip(batches, want):
        state, m = step(state, {"tokens": torch.from_numpy(b).long()})
        assert float(m["loss"]) == pytest.approx(loss, abs=1e-5, rel=1e-5)
    for key, t in _flat(state["params"]["base"]):
        assert torch.equal(t, dict(_flat(tbase))[key]), key
    got = dict(_flat(state["params"]["lora"]))
    for key, w in _flat(jstate["params"]["lora"]):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(w), err_msg=key, **GRAD_TOL)


def test_run_torchjob_checkpoint_is_served_merged(tmp_path):
    """``run_torchjob`` with ``lora_rank`` saves {base, lora with _meta};
    ``load_params`` folds the adapters in (alpha and rank from _meta)."""
    from polyaxon_tpu_torch.runtime import checkpoint as ck
    from polyaxon_tpu_torch.runtime.loop import run_torchjob
    from polyaxon_tpu_torch.serving.server import load_params

    runtime = dict(model="llama_tiny", dataset="lm_synthetic", seq_len=16,
                   global_batch_size=2, steps=2, lora_rank=RANK,
                   lora_alpha=ALPHA, attention_impl="xla", dtype="float32",
                   learning_rate=1e-2)
    run_torchjob({"kind": "jaxjob", "runtime": runtime,
                  "checkpointing": {"enabled": True, "intervalSteps": 1,
                                    "asyncSave": False}},
                 artifacts_dir=str(tmp_path), device="cpu")
    _, tree = ck.load_tree(str(tmp_path / "checkpoints"), only="params")
    saved = tree["params"]
    assert set(saved) == {"base", "lora"}
    assert float(saved["lora"]["_meta"]["alpha"]) == ALPHA
    assert float(saved["lora"]["_meta"]["rank"]) == RANK
    adapters = tlora._adapters_by_path(tlora.split_meta(saved["lora"])[0])
    assert sorted(adapters) == sorted(
        f"layers/{t}" for t in tlora.DEFAULT_TARGETS)
    assert all(ab["b"].any() for ab in adapters.values())
    cfg, served = load_params("llama_tiny", str(tmp_path / "checkpoints"),
                              device="cpu", lora_alpha=1.0)
    want = dict(_flat(tlora.merge_saved(saved["base"], saved["lora"])))
    for key, t in _flat(served):
        assert torch.equal(t, want[key].to(t.dtype)), key
