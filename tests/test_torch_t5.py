"""The port's T5 encoder-decoder (``polyaxon_tpu_torch/models/t5.py``)
against the JAX package's on the CPU: the same f32 ``t5_tiny`` weights
(drawn by the port's init, held to the JAX init's tree, moved through
numpy) and numpy-seeded token ids.

Tolerances, as in ``tests/test_torch_train.py``: forwards (loss,
logits) to atol = rtol = 1e-5; gradients and one adafactor step (the
optimizer ``examples/t5_seq2seq.yaml`` names) to atol 1e-5, rtol 1e-4;
greedy tokens equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models import t5 as jt5
from polyaxon_tpu_torch.models import t5 as tt5
from polyaxon_tpu_torch.runtime import optim as toptim
from polyaxon_tpu_torch.runtime.config import RuntimeConfig

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)

torch.set_num_threads(1)


def _cfgs():
    return (dataclasses.replace(jt5.CONFIGS["t5_tiny"], dtype=jnp.float32),
            dataclasses.replace(tt5.CONFIGS["t5_tiny"], dtype=torch.float32))


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
    params = _drawn(jt5, jcfg, tt5, tcfg)["params"]
    return (jax.tree.map(jnp.asarray, params),
            tt5.params_from_numpy(tcfg, params, device="cpu"))


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(2, 256, shape).astype(
        np.int32)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def test_forward_gradients_and_adafactor_step_match_jax(weights):
    """Loss, accuracy and every gradient of ``apply`` (encoder non-causal,
    decoder causal, cross-attention, a masked target position), then one
    adafactor update of both trees (optax's against the port's)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    inputs, targets = _ids((2, 12), 1), _ids((2, 10), 2)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0

    def jloss(p):
        loss, m, _ = jt5.apply(jcfg, {"params": p, "state": {}},
                               {"inputs": jnp.asarray(inputs),
                                "targets": jnp.asarray(targets),
                                "mask": jnp.asarray(mask)})
        return loss, m["accuracy"]

    (jl, jacc), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    tl, tm, _ = tt5.apply(tcfg, {"params": tp, "state": {}},
                          {"inputs": torch.from_numpy(inputs).long(),
                           "targets": torch.from_numpy(targets).long(),
                           "mask": torch.from_numpy(mask)})
    tl.backward()
    tl = tl.detach()
    assert tl.item() == pytest.approx(float(jl), abs=1e-5, rel=1e-5)
    assert tm["accuracy"].item() == pytest.approx(float(jacc), abs=1e-6)
    tflat = dict(_flat(tp))
    for key, g in _flat(jg):
        np.testing.assert_allclose(tflat[key].grad.numpy(), np.asarray(g),
                                   err_msg=key, **GRAD_TOL)

    spec = dict(model="t5_tiny", optimizer="adafactor", learning_rate=1e-2,
                grad_clip_norm=1.0, steps=10)
    from polyaxon_tpu.runtime.config import RuntimeConfig as JCfg
    from polyaxon_tpu.runtime.optim import build_optimizer as jbuild

    jopt = jbuild(JCfg(**spec))
    jnew = jax.jit(lambda g, p: optax.apply_updates(
        p, jopt.update(g, jopt.init(p), p)[0]))(jg, jp)
    topt = toptim.build_optimizer(RuntimeConfig.from_dict(spec))
    leaves = toptim.tree_leaves(tp)
    state = topt.init(tp)
    topt.update(tp, [t.grad.clone() for t in leaves], state)
    for key, want in _flat(jnew):
        np.testing.assert_allclose(tflat[key].detach().numpy(),
                                   np.asarray(want), err_msg=key, **GRAD_TOL)


def test_generate_tokens_equal(weights):
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    inputs = _ids((3, 9), 3)
    want = jax.jit(lambda p, x: jt5.generate(jcfg, p, x, max_new_tokens=8))(
        jp, jnp.asarray(inputs))
    got = tt5.generate(tcfg, tp, torch.from_numpy(inputs).long(),
                       max_new_tokens=8)
    assert got.tolist() == np.asarray(want).tolist()


def test_ragged_decode_matches_jax_and_scalar(weights):
    """The mirror of ``tests/test_serving.py::TestContinuousBatching::
    test_t5_ragged_decode_matches_scalar``: a pool of two requests of
    different encoder lengths at different decoder depths and an idle
    row. The port's ragged step equals each row's scalar ``decode_step``
    and the JAX ragged step on the same pool (logits and the written
    KV)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    max_new = 8
    prompts = [np.asarray([[5, 6, 7]], np.int32),
               np.asarray([[9, 8, 7, 6, 5]], np.int32)]
    depths = [0, 2]
    pool = tt5.cb_init_cache(tcfg, 3, max_new, device="cpu")
    refs = []
    for i, (prompt, depth) in enumerate(zip(prompts, depths)):
        x = torch.from_numpy(prompt).long()
        cross = tt5.precompute_cross_kv(tcfg, tp, tt5.encode(tcfg, tp, x))
        cache = tt5.init_decoder_cache(tcfg, 1, max_new, device="cpu")
        tok = torch.tensor([tt5.BOS_ID])
        for d in range(depth + 1):
            lg, cache = tt5.decode_step(tcfg, tp, cross, cache, tok, d)
            tok = lg.argmax(-1)
        row = tt5.cb_prefill(tcfg, tp, x, max_new)
        tt5.insert_cache_row(pool, row, i)
        pool["k"][:, i] = cache["k"][:, 0]
        pool["v"][:, i] = cache["v"][:, 0]
        refs.append((tok, cross, cache, depth))
    jpool = {k: jnp.asarray(v.numpy()) for k, v in pool.items()}
    tokens = torch.stack([refs[0][0][0], refs[1][0][0], torch.tensor(0)])
    pos = torch.tensor([depths[0] + 1, depths[1] + 1, -1])
    lg, pool = tt5.decode_step_ragged(tcfg, tp, pool, tokens, pos)
    jlg, jnew = jax.jit(functools.partial(jt5.decode_step_ragged, jcfg))(
        jp, jpool, jnp.asarray(tokens.numpy(), jnp.int32),
        jnp.asarray(pos.numpy(), jnp.int32))
    np.testing.assert_allclose(lg[:2].numpy(), np.asarray(jlg[:2]),
                               **FWD_TOL)
    np.testing.assert_allclose(pool["k"][:, :2].numpy(),
                               np.asarray(jnew["k"][:, :2]), **FWD_TOL)
    for i, (tok, cross, cache, depth) in enumerate(refs):
        want, _ = tt5.decode_step(tcfg, tp, cross, cache, tok, depth + 1)
        np.testing.assert_allclose(lg[i].numpy(), want[0].numpy(),
                                   **FWD_TOL)


def test_encoder_runs_t5s_attention_impl():
    """T5 forwards ``attention_impl`` to its encoder (the port's "auto":
    the non-causal flash kernels on CUDA); the decoder cache cannot
    wrap; the budget rules are the reference's."""
    cfg = tt5.CONFIGS["t5_base"]
    assert cfg.attention_impl == "auto"
    assert cfg.encoder_config().attention_impl == "auto"
    assert cfg.head_dim == 64
    with pytest.raises(ValueError, match="cache range"):
        tt5.decode_step(cfg, {}, {"k": torch.zeros(1, 1, 3, 1, 1)},
                        {"k": torch.zeros(1, 1, 2, 1, 1)},
                        torch.zeros(1, dtype=torch.long), 2)
    with pytest.raises(ValueError, match="max_seq_len"):
        tt5.cb_validate(cfg, 513, 4, 16)
    with pytest.raises(ValueError, match="decoder budget"):
        tt5.cb_validate(cfg, 8, 17, 16)
    assert tt5.cb_admission([4, 5, 6]) == (0, tt5.BOS_ID, [4, 5, 6])
