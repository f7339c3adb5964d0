"""The port's flash backward against the JAX package's, on the CPU.

The port's ``flash_attention_with_lse`` on CPU tensors runs through the
same autograd function as on the card, with ``flash_bwd_plain`` (what
the backward kernels compute) as its backward. It is held against
``jax.grad`` through the JAX wrapper with the Pallas backward kernels in
interpret mode (block 128), and, at a length no 128-block divides,
against ``jax.grad`` through the einsum reference. The loss reads both
outputs, ``sum(o * wo) + sum(lse * wl)``, so the lse cotangent is
exercised. Inputs come from numpy seeds; everything is f32.

Tolerance: atol 1e-4 + rtol 1e-4. The gradients are sums of up to
S * n_rep products taken in different orders (blocked in the Pallas
interpreter, one pass in the port); their largest entries are about 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops import attention as jattn
from polyaxon_tpu.ops import flash as jflash
from polyaxon_tpu_torch.ops import flash as tflash

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is far faster than many on a
    shared host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, B=2, S=256, H=4, KV=2, D=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    wo = rng.standard_normal((B, S, H, D)).astype(np.float32)
    wl = rng.standard_normal((B, H, S)).astype(np.float32)
    return q, k, v, wo, wl


def _jax_grads(fn, q, k, v, wo, wl):
    def loss(q, k, v):
        o, lse = fn(q, k, v)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)

    return [np.asarray(g, np.float32) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _torch_grads(q, k, v, wo, wl, **kwargs):
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o, lse = tflash.flash_attention_with_lse(*leaves, **kwargs)
    (torch.sum(o * torch.from_numpy(wo))
     + torch.sum(lse * torch.from_numpy(wl))).backward()
    return [t.grad.numpy() for t in leaves]


PALLAS_CASES = {
    "causal": ({"causal": True}, {}),
    "non_causal": ({"causal": False}, {}),
    "gqa_8_2": ({"causal": True}, {"H": 8, "KV": 2}),
    "s512": ({"causal": True}, {"S": 512}),
    "window_64": ({"causal": True, "window": 64}, {}),
    "segments": ({"causal": True, "segments": True}, {}),
    # gemma_2b's head_dim and MQA.
    "d256_mqa_segments": ({"causal": True, "segments": True},
                          {"H": 4, "KV": 1, "D": 256}),
}


@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_backward_matches_pallas_interpret(case):
    kwargs, shape = PALLAS_CASES[case]
    kwargs = dict(kwargs)
    q, k, v, wo, wl = _inputs(7, **shape)
    jseg = tseg = None
    if kwargs.pop("segments", False):
        seg = np.array([[0] * 100 + [1] * 156, [0] * 30 + [1] * 170
                        + [2] * 56], np.int32)
        jseg, tseg = jnp.asarray(seg), torch.from_numpy(seg)
    want = _jax_grads(
        lambda *a: jflash.flash_attention_with_lse(
            *a, block_q=128, block_k=128, bwd_impl="pallas",
            interpret=True, segment_ids=jseg, **kwargs),
        q, k, v, wo, wl)
    got = _torch_grads(q, k, v, wo, wl, segment_ids=tseg, **kwargs)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("segments", [False, True])
def test_ragged_length_matches_einsum_reference(segments):
    """S=200: no 128-block divides it, so the JAX wrapper itself would
    take the einsum path; the port still runs its flash backward."""
    q, k, v, wo, wl = _inputs(8, S=200, H=4, KV=1)
    jseg = tseg = None
    if segments:
        seg = np.sort(np.random.default_rng(9).integers(0, 4, (2, 200)),
                      axis=1).astype(np.int32)
        jseg, tseg = jnp.asarray(seg), torch.from_numpy(seg)
    want = _jax_grads(
        lambda *a: jattn.xla_attention_with_lse(*a, causal=True,
                                                segment_ids=jseg),
        q, k, v, wo, wl)
    got = _torch_grads(q, k, v, wo, wl, causal=True, segment_ids=tseg)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_plain_backward_matches_autograd_of_plain_forward():
    """``flash_bwd_plain`` is the exact gradient of ``flash_fwd_plain``
    (torch autograd through the forward), with an lse cotangent and a
    window, at a ragged length."""
    q, k, v, wo, wl = _inputs(10, S=90, H=6, KV=3, D=32)
    seg = torch.from_numpy(np.repeat(np.array([[0, 1, 2], [0, 0, 1]],
                                              np.int32), 30, axis=1))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    kw = dict(causal=True, scale=32 ** -0.5, window=20)
    o, lse = tflash.flash_fwd_plain(*leaves, segment_ids=seg, **kw)
    (torch.sum(o * torch.from_numpy(wo))
     + torch.sum(lse * torch.from_numpy(wl))).backward()
    o, lse = o.detach(), lse.detach()
    got = tflash.flash_bwd_plain(
        *(t.detach() for t in leaves), seg, o, lse, torch.from_numpy(wo),
        torch.from_numpy(wl), **kw)
    for g, t in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_bwd_impl_xla_and_unused_outputs():
    """``bwd_impl="xla"`` is the plain backward on the CPU too (the
    same numbers); an unused lse (or o) reaches the backward as None."""
    q, k, v, wo, wl = _inputs(11, S=64)
    a = _torch_grads(q, k, v, wo, wl, causal=True)
    b = _torch_grads(q, k, v, wo, wl, causal=True, bwd_impl="xla")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = tflash.flash_attention(*leaves, causal=True)
    (o * torch.from_numpy(wo)).sum().backward()
    want = _torch_grads(q, k, v, wo, np.zeros_like(wl), causal=True)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-6, rtol=1e-6)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    _, lse = tflash.flash_attention_with_lse(*leaves, causal=True)
    (lse * torch.from_numpy(wl)).sum().backward()
    want = _torch_grads(q, k, v, np.zeros_like(wo), wl, causal=True)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-6, rtol=1e-6)


def test_kernel_source_names_what_it_replaces():
    from polyaxon_tpu_torch.ops import _build

    assert "flash_bwd" in _build.KERNELS
    with open(f"{_build.CSRC}/flash_bwd.cu") as fh:
        text = fh.read()
    for needle in ("_bwd_dkdv_kernel", "_bwd_dq_kernel", "bound"):
        assert needle in text
