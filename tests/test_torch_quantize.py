"""The port's int8 weight-only quantization on the CPU, held against
``polyaxon_tpu/serving/quantize.py``: the same weights quantize to the
same int8 values and f32 scales bit for bit, the trees weigh the same,
the quantized model's logits match the JAX quantized path (within 1e-4
absolute: both dequantize the same bits and compute in f32), its greedy
tokens are equal, and the tied head stays int8 in every decode step.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.serving import quantize as jq
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.models.common import lm_logits
from polyaxon_tpu_torch.serving import quantize as tq
from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
from polyaxon_tpu_torch.serving.server import ServingServer, _Engine

torch.set_num_threads(1)
ATOL = 1e-4


def _pair(name):
    jcfg = dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32)
    jp = jllama.init(jcfg, jax.random.key(0))["params"]
    tp = tllama.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


def _walk(jtree, ttree, path=""):
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for key in ttree:
            yield from _walk(jtree[key], ttree[key], f"{path}/{key}")
    else:
        yield path, jtree, ttree


@pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_tied",
                                  "gemma_tiny"])
def test_int8_bit_equal_to_reference(name):
    jcfg, jp, tcfg, tp = _pair(name)
    jqt, tqt = jq.quantize_tree(jp), tq.quantize_tree(tp)
    n = 0
    for path, a, b in _walk(jqt, tqt):
        assert isinstance(a, jq.QuantizedTensor) == isinstance(
            b, tq.QuantizedTensor), path
        if isinstance(b, tq.QuantizedTensor):
            n += 1
            assert b.q.dtype == torch.int8
            np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
            np.testing.assert_array_equal(
                b.scale.numpy().view(np.uint32),
                np.asarray(a.scale).view(np.uint32), err_msg=path)
    assert n == 8 + (0 if tcfg.tie_embeddings else 1)
    assert tq.tree_bytes(tqt) == jq.tree_bytes(jqt)
    assert tq.tree_bytes(tp) == jq.tree_bytes(jp)


def test_leaf_scales_bit_equal_on_awkward_values():
    """Stacked [L, in, out] weights, an all-zero channel and values on
    rounding ties: still the reference's bits."""
    w = np.random.default_rng(0).standard_normal((3, 64, 32)).astype(
        np.float32)
    w[1, :, 5] = 0.0
    w[2, :, 7] = np.linspace(-127, 127, 64) / 2  # .5 ties after scaling
    a = jax.jit(jq.quantize_leaf)(jnp.asarray(w))
    b = tq.quantize_leaf(torch.tensor(w))
    assert b.scale.shape == (3, 1, 32)
    np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
    np.testing.assert_array_equal(b.scale.numpy().view(np.uint32),
                                  np.asarray(a.scale).view(np.uint32))
    err = (torch.tensor(w) - b.dequantize()).abs()
    assert bool((err <= b.scale / 2 + 1e-7).all())


@pytest.mark.parametrize("dim", [1, 2], ids=["rows", "columns"])
def test_a_tp_share_of_an_int8_weight_dequantizes_as_its_slice(dim):
    """A served int8 weight that the rules leave whole over tp is cut to a
    rank's share at use (``QuantizedTensor.narrow``): its values and
    per-column scales are the whole weight's, sliced alike."""
    w = np.random.default_rng(1).standard_normal((3, 64, 32)).astype(
        np.float32)
    whole = tq.quantize_leaf(torch.tensor(w))
    for j in range(2):
        size = w.shape[dim] // 2
        share = whole.narrow(dim, j * size, size)
        assert share.shape == whole.dequantize().narrow(
            dim, j * size, size).shape
        assert torch.equal(share.dequantize(),
                           whole.dequantize().narrow(dim, j * size, size))


@pytest.mark.parametrize("name", ["llama_tiny", "llama_tiny_tied"])
def test_quantized_logits_match_the_reference_quantized_path(name):
    jcfg, jp, tcfg, tp = _pair(name)
    jqt, tqt = jq.quantize_tree(jp), tq.quantize_tree(tp)
    prompt = np.random.default_rng(3).integers(0, 256, (2, 9))
    jl, jc = jllama.prefill(jcfg, jqt, jnp.asarray(prompt), 24)
    tl, tc = tllama.prefill(tcfg, tqt, torch.tensor(prompt), 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    tok = np.asarray(jnp.argmax(jl, -1))
    jd, _ = jllama.decode_step(jcfg, jqt, jc, jnp.asarray(tok), 9)
    td, _ = tllama.decode_step(tcfg, tqt, tc, torch.tensor(tok), 9)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    want = jllama.generate(jcfg, jqt, jnp.asarray(prompt),
                           max_new_tokens=10)
    got = tllama.generate(tcfg, tqt, torch.tensor(prompt),
                          max_new_tokens=10)
    assert got.tolist() == np.asarray(want).tolist()


def test_tied_head_stays_int8_in_decode(monkeypatch):
    """A tied head is read in vocab chunks: no decode step dequantizes
    the whole [V, D] table (embedding rows are gathered int8-first)."""
    _, _, tcfg, tp = _pair("llama_tiny_tied")
    tcfg = dataclasses.replace(tcfg, lm_logits_chunk=64)
    qt = tq.quantize_tree(tp)
    assert isinstance(qt["embed"], tq.QuantizedTensor)
    assert "lm_head" not in qt
    _, cache = tllama.prefill(tcfg, qt, torch.tensor([[5, 6, 7, 8]]), 16)
    full = tuple(qt["embed"].shape)
    real = tq.QuantizedTensor.dequantize

    def guarded(self):
        assert tuple(self.shape) != full, "the whole tied table"
        return real(self)

    monkeypatch.setattr(tq.QuantizedTensor, "dequantize", guarded)
    logits, _ = tllama.decode_step(tcfg, qt, cache, torch.tensor([9]), 4)
    monkeypatch.setattr(tq.QuantizedTensor, "dequantize", real)
    deq = tq.dequantize_tree(qt)
    _, plain_cache = tllama.prefill(tcfg, deq, torch.tensor([[5, 6, 7, 8]]),
                                    16)
    plain, _ = tllama.decode_step(tcfg, deq, plain_cache, torch.tensor([9]),
                                  4)
    torch.testing.assert_close(logits, plain, atol=ATOL, rtol=0)


def test_norm_gains_never_quantized_and_tree_halves():
    _, _, tcfg, tp = _pair("llama_tiny")
    qt = tq.quantize_tree(tp)
    assert not isinstance(qt["layers"]["attn_norm"], tq.QuantizedTensor)
    assert not isinstance(qt["final_norm"], tq.QuantizedTensor)
    assert isinstance(qt["layers"]["wq"], tq.QuantizedTensor)
    # f32 matrices → int8 + f32 scales.
    assert tq.tree_bytes(qt) < 0.3 * tq.tree_bytes(tp)
    plain = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    out = tq.dequantize_tree(plain)
    assert out["w"] is plain["w"] and out["b"] is plain["b"]
    with pytest.raises(ValueError, match="int8"):
        tq.quantize_tree(tp, mode="int4")


@pytest.mark.parametrize("D,V,transpose,chunk", [
    (32, 300, False, 128), (32, 300, True, 128), (16, 3, False, 128),
    (16, 3, True, 128)])
def test_lm_logits_chunk_paths(D, V, transpose, chunk):
    """Padded vocab chunks, the tied layout and the unsplittable-vocab
    fallback all equal the one-product logits."""
    shape = (V, D) if transpose else (D, V)
    gen = torch.Generator().manual_seed(0)
    q = tq.quantize_leaf(torch.randn(shape, generator=gen) * 0.1)
    x = torch.randn((3, D), generator=gen)
    got = lm_logits(x, q, torch.float32, transpose=transpose, chunk=chunk)
    tab = q.dequantize()
    want = x @ (tab.T if transpose else tab)
    assert got.shape == (3, V)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    x3 = torch.randn((2, 5, D), generator=gen)
    got3 = lm_logits(x3, q, torch.float32, transpose=transpose, chunk=chunk)
    torch.testing.assert_close(got3, x3 @ (tab.T if transpose else tab),
                               atol=1e-5, rtol=1e-5)


def test_engines_serve_int8_alike():
    """Both engines read the same quantized tree: equal greedy tokens,
    dense and paged, and the JAX engine's."""
    jcfg, jp, tcfg, tp = _pair("llama_tiny")
    jqt, tqt = jq.quantize_tree(jp), tq.quantize_tree(tp)
    rows = [[5, 6, 7], [1, 2, 3, 4]]
    from polyaxon_tpu.serving.server import _Engine as JaxStatic

    want = JaxStatic("llama_tiny", jcfg, jqt).generate(rows, 6)
    assert _Engine("llama_tiny", tcfg, tqt, device="cpu").generate(
        rows, 6) == want
    for kv in ("dense", "paged"):
        eng = ContinuousBatchingEngine("llama_tiny", tcfg, tqt, slots=2,
                                       kv=kv, page_size=4, device="cpu")
        try:
            assert eng.generate(rows, 6, timeout=120) == want, kv
        finally:
            eng.stop()


def test_server_quantizes_at_load():
    body = {"tokens": [[5, 6, 7]], "max_new_tokens": 8}

    def gen(url):
        req = urllib.request.Request(
            url + "/v1/generate", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.load(resp)["tokens"]

    with ServingServer("llama_tiny", seed=0, quantize="int8",
                       device="cpu") as s:
        assert isinstance(s.engine.params["layers"]["wq"],
                          tq.QuantizedTensor)
        out = gen(s.url)
        assert len(out[0]) == 8 and gen(s.url) == out
