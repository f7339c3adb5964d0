"""The port's ring and Ulysses attention in real gloo process groups,
held against the JAX package's ``ring_attention`` and
``ulysses_attention`` on the CPU mesh of the same shape (the
``cp_mesh`` of ``tests/test_ops.py``: dp2 x cp4), with the same numpy
inputs.

One spawn per world size runs every case: 4 ranks as cp=4, and 8 ranks
as dp2 x cp4 (each rank one [dp rows, cp sequence] block, stitched back
here). Cases: ring causal and non-causal; an odd local length, padded
at the global entry (no warning); the warned masked-einsum fallback
when the odd shard is passed straight to the sharded ring; GQA; the
gradients of ``sum(out ** 2)``; Ulysses causal and non-causal and its
GQA repeat (2 kv heads over a 4-way axis); the llama_tiny forward with
``attention_impl="ring"`` against the einsum path. Tolerances are the
JAX package's own in f32: outputs 2e-4 (``tests/test_ops.py``'s model
check), gradients 5e-4 (its ``test_gradients_match``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from polyaxon_tpu.ops.ring import ring_attention
from polyaxon_tpu.ops.ulysses import ulysses_attention
from tests import torch_dist
from tests.torch_dist_cases import attention_cases, stitch

OUT_TOL = dict(atol=2e-4, rtol=2e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-4)


def _qkv(b, s, h, kv, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((b, s, h, d), np.float32),
            "k": rng.standard_normal((b, s, kv, d), np.float32),
            "v": rng.standard_normal((b, s, kv, d), np.float32)}


CASES = {
    "ring_causal": dict(kind="ring", causal=True, grad=True,
                        **_qkv(4, 128, 8, 4)),
    "ring_dense": dict(kind="ring", causal=False, grad=True,
                       **_qkv(4, 128, 8, 4, seed=1)),
    # s_loc = 63 at cp 4: the global entry re-cuts the shards to 64 rows.
    "ring_odd": dict(kind="ring", causal=True, grad=True,
                     **_qkv(2, 252, 4, 2, seed=2)),
    "ring_inside": dict(kind="inside", causal=True,
                        **_qkv(2, 252, 4, 2, seed=3)),
    "ulysses_causal": dict(kind="ulysses", causal=True, grad=True,
                           **_qkv(4, 128, 8, 4, seed=4)),
    "ulysses_dense": dict(kind="ulysses", causal=False,
                          **_qkv(4, 128, 8, 4, seed=5)),
    # 2 kv heads < the 4-way axis: repeated up to it.
    "ulysses_gqa": dict(kind="ulysses", causal=True,
                        **_qkv(4, 128, 8, 2, seed=6)),
}


def _jax_fn(case, mesh):
    if case["kind"] == "inside":
        from polyaxon_tpu.ops import ring
        from polyaxon_tpu.parallel import compat

        spec = P(None, "cp", None, None)
        return compat.shard_map(
            functools.partial(ring._ring_attention_sharded, causal=True,
                              scale=case["q"].shape[-1] ** -0.5,
                              axis_name="cp"),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)
    attn = ring_attention if case["kind"] == "ring" else ulysses_attention
    return lambda q, k, v: attn(q, k, v, causal=case["causal"])


def _jax_reference(case, mesh):
    """JAX's output (and gradients) of the same inputs on ``mesh``."""
    q, k, v = (jnp.asarray(case[x]) for x in "qkv")
    fn = _jax_fn(case, mesh)
    with mesh:
        out = np.asarray(jax.jit(fn)(q, k, v))
        grads = None
        if case.get("grad"):
            grads = jax.jit(jax.grad(
                lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                argnums=(0, 1, 2)))(q, k, v)
    return out, grads


def _llama_inputs():
    from polyaxon_tpu.models import llama

    import dataclasses

    cfg = dataclasses.replace(llama.CONFIGS["llama_tiny"], max_seq_len=256,
                              dtype=jnp.float32)
    params = llama.init(cfg, jax.random.key(0))["params"]
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (4, 256), 0,
                                           cfg.vocab_size), np.int32)
    ref = np.asarray(llama.forward(cfg, params, jnp.asarray(tokens)))
    return {"params": jax.tree.map(np.asarray, params),
            "tokens": tokens}, ref


@pytest.fixture(scope="module")
def llama_case():
    return _llama_inputs()


@pytest.mark.parametrize("axes", [{"cp": 4}, {"dp": 2, "cp": 4}],
                         ids=["cp4", "dp2xcp4"])
def test_ring_and_ulysses_match_jax(axes, cpu_devices, llama_case):
    world = int(np.prod(list(axes.values())))
    names = tuple(axes)
    mesh = Mesh(np.array(cpu_devices[:world]).reshape(
        [axes[a] for a in names]), names)
    llama_in, llama_ref = llama_case
    results = torch_dist.run(attention_cases, world, axes, CASES, llama_in)

    for name, case in CASES.items():
        want, grads = _jax_reference(case, mesh)
        got = stitch(results, axes, lambda r: r[name]["out"])
        np.testing.assert_allclose(got, want, err_msg=name, **OUT_TOL)
        if grads is not None:
            for key, g in zip(("dq", "dk", "dv"), grads):
                np.testing.assert_allclose(
                    stitch(results, axes, lambda r: r[name][key]),
                    np.asarray(g), err_msg=f"{name} {key}", **GRAD_TOL)
        warned = [w for r in results for w in r[name]["warnings"]]
        if case["kind"] == "inside":
            # The odd shard passed straight in: the loud fallback, once
            # per rank.
            assert len(warned) == world
            assert all("masked-einsum ring" in w for w in warned)
        else:
            assert not warned, (name, warned)

    # Point-to-point exchanges of one zigzag call at cp = 4: 6 into
    # zigzag (q, k, v halves), 4 per ring step (3 steps), 2 back, less 4
    # on a rank that keeps one of its halves (a fixed point of the
    # zigzag permutations moves nothing); the backward runs each once
    # more. The dense ring: 2 per step. An odd length adds the re-cut of
    # q, k, v and of the output.
    for rank, r in enumerate(results):
        i = rank % 4
        keeps = i in ((2 * i if 2 * i < 4 else 7 - 2 * i),
                      (2 * i + 1 if 2 * i + 1 < 4 else 6 - 2 * i))
        zigzag = 6 + 4 * 3 + 2 - (4 if keeps else 0)
        assert r["ring_causal"]["fwd_exchanges"] == zigzag
        assert r["ring_causal"]["bwd_exchanges"] == zigzag
        assert r["ring_dense"]["fwd_exchanges"] == 2 * 3
        assert r["ring_odd"]["fwd_exchanges"] == zigzag + 4

    logits = stitch(results, axes, lambda r: r["llama"])
    np.testing.assert_allclose(logits, llama_ref, **OUT_TOL)
