"""The port's MoE decoder (``polyaxon_tpu_torch/models/moe.py``) against
the JAX package's on the CPU: the same f32 ``moe_tiny`` weights (drawn
by the port's init, held to the JAX init's tree, moved through numpy) and numpy-seeded tokens.

Tolerances, as in ``tests/test_torch_train.py``:
- forwards (loss, its parts, logits, KV) to atol = rtol = 1e-5;
- gradients and one optimizer step to atol 1e-5, rtol 1e-4 (sums over
  every token, taken in different orders);
- greedy tokens equal.

Routing is a discrete choice, and ``torch.topk`` gives no tie order
where ``jax.lax.top_k`` puts the lower index first: every batch here
asserts a margin between each token's K-th and (K+1)-th router
probability at layer 0, so that a tie cannot make a test unsteady.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import moe as jmoe
from polyaxon_tpu_torch.models import moe as tmoe

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
APPROX = dict(abs=1e-5, rel=1e-5)
ROUTER_MARGIN = 1e-4

torch.set_num_threads(1)


def _cfgs(**overrides):
    return (dataclasses.replace(jmoe.CONFIGS["moe_tiny"], dtype=jnp.float32,
                                **overrides),
            dataclasses.replace(tmoe.CONFIGS["moe_tiny"],
                                dtype=torch.float32, **overrides))


def _drawn(jmod, jcfg, tmod, tcfg, seed=0):
    """Variables drawn by the port's ``init`` from ``seed`` as numpy (the
    JAX init's shapes and scales; compiling the JAX init would cost
    seconds per config), held to the JAX init's tree and shapes."""
    want = jax.eval_shape(lambda k: jmod.init(jcfg, k), jax.random.key(0))
    got = jax.tree.map(lambda t: t.numpy(), tmod.init(
        tcfg, torch.Generator().manual_seed(seed), device="cpu"))
    for part in want:
        assert jax.tree.structure(got[part]) == jax.tree.structure(
            want[part])
        assert [g.shape for g in jax.tree.leaves(got[part])] == [
            w.shape for w in jax.tree.leaves(want[part])]
    return got


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    params = _drawn(jmoe, jcfg, tmoe, tcfg)["params"]
    return (jax.tree.map(jnp.asarray, params),
            tmoe.params_from_numpy(tcfg, params, device="cpu"))


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _assert_router_margin(tp, tokens):
    """Layer 0's router over these tokens' embeddings (the first router
    input is the normed embedding): the K-th and (K+1)-th probabilities
    of every token stand apart."""
    _, tcfg = _cfgs()
    x = tp["embed"][torch.as_tensor(tokens, dtype=torch.long)]
    h = tmoe.rms_norm(x, tp["layers"]["moe_norm"][0], tcfg.norm_eps)
    probs = torch.softmax(h @ tp["layers"]["router"][0], dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    k = tcfg.experts_per_token
    assert float((top[..., k - 1] - top[..., k]).min()) > ROUTER_MARGIN


def _apply_pair(jp, tp, tokens, **overrides):
    jcfg, tcfg = _cfgs(**overrides)
    jl, jm, _ = jax.jit(lambda p, t: jmoe.apply(
        jcfg, {"params": p, "state": {}}, {"tokens": t}))(
            jp, jnp.asarray(tokens))
    tl, tm, _ = tmoe.apply(tcfg, {"params": tp, "state": {}},
                           {"tokens": torch.as_tensor(tokens).long()})
    return (float(jl), {k: float(v) for k, v in jm.items()},
            float(tl), {k: float(v) for k, v in tm.items()})


@pytest.mark.parametrize("dispatch,router,capacity_factor", [
    ("ragged", "top_k", 0.5),   # drops tokens (the spare-row scatter)
    ("dense", "top_k", 1.25),
    ("dense", "expert_choice", 1.25),
])
def test_forward_matches_jax(weights, dispatch, router, capacity_factor):
    jp, tp = weights
    tokens = _tokens((2, 24))
    _assert_router_margin(tp, tokens)
    jl, jm, tl, tm = _apply_pair(jp, tp, tokens, dispatch=dispatch,
                                 router=router,
                                 capacity_factor=capacity_factor)
    assert tl == pytest.approx(jl, **APPROX)
    assert set(tm) == set(jm)
    for key, want in jm.items():
        assert tm[key] == pytest.approx(want, abs=1e-5, rel=1e-5), key
    if capacity_factor < 1:
        # The drops change the function: a no-drop capacity gives another
        # loss (so this batch does drop tokens).
        _, tcfg = _cfgs(dispatch=dispatch, capacity_factor=2.0)
        no_drop = float(tmoe.apply(
            tcfg, {"params": tp, "state": {}},
            {"tokens": torch.as_tensor(tokens).long()})[0])
        assert abs(no_drop - tl) > 1e-4


def test_ragged_equals_dense_at_no_drop_capacity(weights):
    """At capacity_factor = E / K the capacity is T: neither dispatch
    drops, and the two compute the same function."""
    _, tp = weights
    tokens = _tokens((2, 16), seed=3)
    _assert_router_margin(tp, tokens)
    out = {}
    for dispatch in ("ragged", "dense"):
        _, tcfg = _cfgs(dispatch=dispatch, capacity_factor=2.0)
        out[dispatch] = float(tmoe.apply(
            tcfg, {"params": tp, "state": {}},
            {"tokens": torch.as_tensor(tokens).long()})[0])
    assert out["ragged"] == pytest.approx(out["dense"], **APPROX)


@pytest.mark.parametrize("dispatch", ["ragged", "dense"])
def test_gradients_match_jax(weights, dispatch):
    jp, tp = weights
    tokens = _tokens((2, 16), seed=4)
    _assert_router_margin(tp, tokens)
    jcfg, tcfg = _cfgs(dispatch=dispatch, capacity_factor=0.75)

    def jloss(p):
        return jmoe.apply(jcfg, {"params": p, "state": {}},
                          {"tokens": jnp.asarray(tokens)})[0]

    jg = jax.jit(jax.grad(jloss))(jp)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    loss, _, _ = tmoe.apply(tcfg, {"params": tp, "state": {}},
                            {"tokens": torch.as_tensor(tokens).long()})
    loss.backward()
    for key in ("embed", "lm_head", "final_norm"):
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(jg[key]),
                                   err_msg=key, **GRAD_TOL)
    for key, g in jg["layers"].items():
        np.testing.assert_allclose(tp["layers"][key].grad.numpy(),
                                   np.asarray(g), err_msg=key, **GRAD_TOL)


def test_grad_accumulation_exact(weights, cpu_devices):
    """The mirror of ``tests/test_runtime.py::
    test_moe_grad_accumulation_exact``: MoE mixes a mask-weighted CE with
    a mask-independent router aux, so accum=k is defined as
    token-weighted CE grads plus uniform (1/k) aux grads. Four
    microbatches with unbalanced masks, one sgd step: the port's train
    step against JAX's (1-device mesh), and the reported loss is the
    recombined one."""
    from polyaxon_tpu.parallel import build_mesh, rules_for_mesh
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild
    from polyaxon_tpu.runtime.step import build_train_step as jstep
    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.runtime import optim as toptim
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

    jp, tp = weights
    k = 4
    tokens = _tokens((16, 16), seed=5)
    mask = np.ones((16, 16), np.int32)
    mask[4:8, 8:] = 0
    mask[8:12, :] = 0
    mask[8:12, 0] = 1
    spec = dict(model="moe_tiny", steps=1, learning_rate=1e-2,
                optimizer="sgd", lr_schedule="constant", grad_clip_norm=None)

    mesh = build_mesh(axes={"dp": 1}, devices=cpu_devices[:1])
    rules = rules_for_mesh(mesh)
    jmodel = jmoe.model_def("moe_tiny", dtype=jnp.float32)
    jopt = jbuild(JCfg(**spec))
    with mesh:
        # The JAX step donates its state: give it copies.
        jp = jax.tree.map(jnp.array, jp)
        jstate = {"params": jp, "state": {}, "opt_state": jopt.init(jp),
                  "step": jnp.zeros((), jnp.int32)}
        jstate, jm = jstep(jmodel, jopt, mesh, rules, accum_steps=k)(
            jstate, {"tokens": jnp.asarray(tokens),
                     "mask": jnp.asarray(mask)}, jax.random.key(2))

    model_def = get_model("moe_tiny", dtype=torch.float32)
    opt = toptim.build_optimizer(RuntimeConfig.from_dict(spec))
    params = jax.tree.map(lambda t: t.clone(), tp)
    state = build_init(model_def, opt, device="cpu", params=params)(0)
    state, tm = build_train_step(model_def, opt, accum_steps=k)(
        state, {"tokens": torch.from_numpy(tokens).long(),
                "mask": torch.from_numpy(mask)})
    for key in ("loss", "ce_loss", "router_aux", "loss_unweighted",
                "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), abs=1e-5,
                                               rel=1e-4), key
    flat = dict(_flat(state["params"]))
    for key, want in _flat(jstate["params"]):
        np.testing.assert_allclose(flat[key].detach().numpy(),
                                   np.asarray(want), err_msg=key,
                                   **GRAD_TOL)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def test_decode_surfaces_match_jax(weights):
    """prefill, ragged decode (an idle row), the verify chunk, the paged
    step (the paged-decode wrapper's plain version on the CPU against
    JAX's gather) and the suffix prefill, each against its JAX function
    on the same caches (the JAX functions in one compiled program)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    prompt = _tokens((2, 9), seed=6)
    _assert_router_margin(tp, prompt)
    toks = np.asarray([7, 11], np.int32)
    pos = np.asarray([9, -1], np.int32)
    chunk = _tokens((2, 3), seed=7)
    pos0 = np.asarray([10, 9], np.int32)
    # Paged: one row's prompt KV in pages 1..3 (page 0 is scratch); the
    # suffix prefill after a 4-token prefix hit.
    page, m = 4, 4
    tables = np.asarray([[1, 2, 3, -1]], np.int32)

    @jax.jit
    def jax_side(p):
        out = {}
        out["prefill"], cache = jmoe.prefill(jcfg, p, jnp.asarray(prompt),
                                             24)
        out["k"] = cache["k"]
        out["ragged"], cache = jmoe.decode_step_ragged(
            jcfg, p, cache, jnp.asarray(toks), jnp.asarray(pos))
        out["chunk"], _ = jmoe.decode_chunk(jcfg, p, cache,
                                            jnp.asarray(chunk),
                                            jnp.asarray(pos0))
        jk, jv = jmoe.paged_prefill_kv(jcfg, p, jnp.asarray(prompt[:1]))
        out["paged_k"] = jk
        pool = jmoe.paged_insert_prefill(
            jmoe.paged_init_cache(jcfg, 5, page), jk, jv,
            jnp.asarray(tables[0]), page)
        out["paged"], _ = jmoe.decode_step_paged(
            jcfg, p, pool, jnp.asarray(toks[:1]), jnp.asarray([9]),
            jnp.asarray(tables))
        out["suffix_k"], _ = jmoe.paged_prefill_suffix_kv(
            jcfg, p, jnp.asarray(prompt[:1, m:]), jk[:, :m], jv[:, :m],
            jnp.int32(m))
        return out

    want = jax_side(jp)
    tlg, tcache = tmoe.prefill(tcfg, tp, torch.as_tensor(prompt).long(), 24)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(want["prefill"]),
                               **FWD_TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(want["k"]),
                               **FWD_TOL)
    tlg, tcache = tmoe.decode_step_ragged(tcfg, tp, tcache,
                                          torch.as_tensor(toks).long(),
                                          torch.as_tensor(pos).long())
    np.testing.assert_allclose(tlg[0].numpy(), np.asarray(want["ragged"][0]),
                               **FWD_TOL)
    tlg, _ = tmoe.decode_chunk(tcfg, tp, tcache, torch.as_tensor(chunk).long(),
                               torch.as_tensor(pos0).long())
    np.testing.assert_allclose(tlg.numpy(), np.asarray(want["chunk"]),
                               **FWD_TOL)
    tk, tv = tmoe.paged_prefill_kv(tcfg, tp,
                                   torch.as_tensor(prompt[:1]).long())
    np.testing.assert_allclose(tk.numpy(), np.asarray(want["paged_k"]),
                               **FWD_TOL)
    tpool = tmoe.paged_init_cache(tcfg, 5, page, device="cpu")
    tpool = tmoe.paged_insert_prefill(tpool, tk, tv,
                                      torch.as_tensor(tables[0]), page)
    tlg, _ = tmoe.decode_step_paged(tcfg, tp, tpool,
                                    torch.as_tensor(toks[:1]).long(),
                                    torch.tensor([9]),
                                    torch.as_tensor(tables))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(want["paged"]),
                               **FWD_TOL)
    tks, _ = tmoe.paged_prefill_suffix_kv(
        tcfg, tp, torch.as_tensor(prompt[:1, m:]).long(), tk[:, :m],
        tv[:, :m], m)
    np.testing.assert_allclose(tks.numpy(), np.asarray(want["suffix_k"]),
                               **FWD_TOL)


def test_generate_tokens_equal(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    prompt = _tokens((2, 7), seed=8)
    want = np.asarray(jax.jit(lambda p, t: jmoe.generate(
        jcfg, p, t, max_new_tokens=8))(jp, jnp.asarray(prompt)))
    got = tmoe.generate(tcfg, tp, torch.as_tensor(prompt).long(),
                        max_new_tokens=8)
    assert got.tolist() == want.tolist()


def test_ep_axis_and_undecodable_routers_refuse(tmp_path):
    """An ``ep`` mesh axis beside ``fsdp`` is placed now (trained against
    the reference in ``tests/test_torch_axis_pairs.py``): each expert
    shards over ep and its ``embed`` over fsdp, as the rules place it.
    Expert-choice routing cannot be decoded (both packages refuse it)."""
    from torch.distributed.tensor import Replicate, Shard

    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import (rules_for_mesh,
                                                      tree_placements)

    _, tcfg = _cfgs()
    mesh = build_mesh(axes={"fsdp": 2, "ep": 2}, devices=range(4))
    pl = tree_placements(tmoe.logical_axes(tcfg)["params"], mesh,
                         rules_for_mesh(mesh))
    assert pl["layers"]["w_gate"] == [Shard(2), Shard(1)]
    assert pl["layers"]["wq"] == [Shard(1), Replicate()]
    ec = dataclasses.replace(tcfg, router="expert_choice")
    with pytest.raises(ValueError, match="top_k"):
        tmoe.prefill(ec, {}, torch.zeros((1, 2), dtype=torch.long), 8)


def test_uniform_metrics_contract():
    """A model that declares ``uniform_metrics`` but returns no
    ``loss_unweighted`` cannot accumulate exactly: the step raises, as
    the JAX package's does."""
    import dataclasses as dc

    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.runtime import optim as toptim
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

    model_def = get_model("moe_tiny", dtype=torch.float32)

    def apply(variables, batch, train=True, rng=None):
        loss, metrics, state = model_def.apply(variables, batch, train, rng)
        metrics.pop("loss_unweighted")
        return loss, metrics, state

    broken = dc.replace(model_def, apply=apply)
    opt = toptim.build_optimizer(RuntimeConfig.from_dict(
        {"model": "moe_tiny", "optimizer": "sgd"}))
    state = build_init(broken, opt, device="cpu")(0)
    batch = {"tokens": torch.from_numpy(_tokens((4, 8))).long()}
    with pytest.raises(ValueError, match="loss_unweighted"):
        build_train_step(broken, opt, accum_steps=2)(state, batch)
