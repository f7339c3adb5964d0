"""The port's BERT, ViT, ResNet and MNIST models against the JAX
package's on the CPU: the same f32 weights (drawn by the port's init,
held to the JAX init's tree, moved through numpy) and numpy-seeded inputs, at the ``*_tiny`` configs (and
``mnist_cnn``, which is small).

Tolerances, as in ``tests/test_torch_train.py``: the loss and accuracy
to 1e-5 (absolute and relative); every gradient to atol 1e-5, rtol
1e-4; ResNet's updated batch statistics to 1e-5. BERT and ViT run the
encoder at its default ``attention_impl="xla"`` in both packages, as
their configs do not forward the field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import bert as jbert
from polyaxon_tpu.models import mnist as jmnist
from polyaxon_tpu.models import resnet as jresnet
from polyaxon_tpu.models import vit as jvit
from polyaxon_tpu_torch.models import bert as tbert
from polyaxon_tpu_torch.models import mnist as tmnist
from polyaxon_tpu_torch.models import resnet as tresnet
from polyaxon_tpu_torch.models import vit as tvit

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


def _batch(name, rng):
    if name == "bert_tiny":
        tokens = rng.integers(5, 256, (2, 16)).astype(np.int32)
        labels = np.where(rng.random((2, 16)) < 0.3, tokens, -1)
        return {"tokens": tokens, "labels": labels.astype(np.int32),
                "type_ids": rng.integers(0, 2, (2, 16)).astype(np.int32)}
    size, channels, classes = {"vit_tiny": (32, 3, 10),
                               "resnet_tiny": (33, 3, 10),
                               "mnist_cnn": (28, 1, 10)}[name]
    return {"image": rng.standard_normal(
                (3, size, size, channels)).astype(np.float32),
            "label": rng.integers(0, classes, (3,)).astype(np.int32)}


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


FAMILIES = {"bert_tiny": (jbert, tbert), "vit_tiny": (jvit, tvit),
            "resnet_tiny": (jresnet, tresnet), "mnist_cnn": (jmnist, tmnist)}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_gradients_and_state_match_jax(name):
    """Training-mode ``apply``: the loss, the accuracy, every parameter
    gradient, and (ResNet) the new batch statistics; then ResNet's
    eval-mode forward over the updated statistics."""
    jmod, tmod = FAMILIES[name]
    jcfg = dataclasses.replace(jmod.CONFIGS[name], dtype=jnp.float32)
    tcfg = dataclasses.replace(tmod.CONFIGS[name], dtype=torch.float32)
    variables = jax.tree.map(jnp.asarray, _drawn(jmod, jcfg, tmod, tcfg))
    batch = _batch(name, np.random.default_rng(1))
    if name == "vit_tiny":
        # ViT's head is zero-initialized (its grads would be the only
        # nonzero ones past the head): give it values.
        head = np.random.default_rng(2).standard_normal(
            variables["params"]["head"].shape).astype(np.float32) * 0.1
        variables["params"]["head"] = jnp.asarray(head)

    def jloss(p, state):
        loss, m, new_state = jmod.apply(
            jcfg, {"params": p, "state": state},
            {k: jnp.asarray(v) for k, v in batch.items()}, True, None)
        return loss, (m["accuracy"], new_state)

    (jl, (jacc, jstate)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"], variables["state"])

    tp = tmod.params_from_numpy(tcfg, jax.tree.map(
        np.asarray, variables["params"]), device="cpu")
    ts = tmod.params_from_numpy(tcfg, jax.tree.map(
        np.asarray, variables["state"]), device="cpu")
    for t in dict(_flat(tp)).values():
        t.requires_grad_(True)
    tl, tm, tstate = tmod.apply(
        tcfg, {"params": tp, "state": ts},
        {k: torch.from_numpy(v) for k, v in batch.items()}, True, None)
    tl.backward()
    assert tl.item() == pytest.approx(float(jl), abs=1e-5, rel=1e-5)
    assert tm["accuracy"].item() == pytest.approx(float(jacc), abs=1e-6)
    tflat = dict(_flat(tp))
    for key, g in _flat(jg):
        np.testing.assert_allclose(tflat[key].grad.numpy(), np.asarray(g),
                                   err_msg=key, **GRAD_TOL)
    got_state = dict(_flat(tstate))
    want_state = dict(_flat(jstate))
    assert set(got_state) == set(want_state)
    for key, want in want_state.items():
        np.testing.assert_allclose(got_state[key].detach().numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    if name == "resnet_tiny":
        # The statistics moved, and eval mode reads them.
        assert not np.allclose(want_state["stem_bn/mean"], 0.0)
        images = jnp.asarray(batch["image"])
        jlogits, _ = jax.jit(jresnet.forward, static_argnums=(0, 4))(
            jcfg, variables["params"], jstate, images, False)
        tlogits, _ = tresnet.forward(tcfg, tp, tstate,
                                     torch.from_numpy(batch["image"]), False)
        np.testing.assert_allclose(tlogits.detach().numpy(),
                                   np.asarray(jlogits), atol=1e-5, rtol=1e-5)


def test_layouts_and_attention_impl():
    """JAX layouts kept (HWIO kernels, NHWC images, [in, out] matrices),
    XLA's asymmetric "SAME" padding, ViT's patch order, and the encoder's
    einsum default for BERT and ViT."""
    assert tresnet._same_pad(224, 7, 2) == (2, 3)
    assert tresnet._same_pad(56, 1, 2) == (0, 0)
    images = np.random.default_rng(3).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(images), 8).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(images), 8)))
    p = tresnet.init(tresnet.CONFIGS["resnet_tiny"], torch.Generator(),
                     device="meta")["params"]
    assert tuple(p["stem_conv"].shape) == (7, 7, 3, 8)
    for cfg in (tbert.CONFIGS["bert_large"], tvit.CONFIGS["vit_b16"]):
        assert cfg.encoder_config().attention_impl == "xla"
