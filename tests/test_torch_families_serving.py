"""Serving the MoE and t5 families in the port, held against the JAX
package on the CPU: the reference serving tests that need ``moe`` or
``t5`` (``tests/test_serving.py``, ``tests/test_speculative.py``,
``tests/test_paged.py``), with the same f32 weights (JAX init, moved
through numpy) where tokens are compared across packages.

Greedy tokens must be equal. MoE paged reuse is held engine by engine
(dense against dense, the paged engine's first run against its first,
its second against its second): the reference's full prefill routes the
prompt with the training capacity and its suffix prefill with no-drop
capacity, so at the default ``capacity_factor`` its runs differ from one
another (ROADMAP.md, Queue 3), and the port reproduces each. At a no-drop
capacity (``n_experts / experts_per_token``) paged reuse equals dense.
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
from polyaxon_tpu.models import moe as jmoe
from polyaxon_tpu.models import t5 as jt5
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.models import moe as tmoe
from polyaxon_tpu_torch.models import t5 as tt5
from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
from polyaxon_tpu_torch.serving.quantize import quantize_tree
from polyaxon_tpu_torch.serving.server import ServingServer, _Engine
from polyaxon_tpu_torch.serving.speculative import generate_speculative

torch.set_num_threads(1)

FAMILIES = {"moe_tiny": (jmoe, tmoe), "t5_tiny": (jt5, tt5),
            "llama_tiny": (jllama, tllama)}


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


def _pair(name, seed=0, **overrides):
    """(jax cfg, jax params, port cfg, port params), f32."""
    jmod, tmod = FAMILIES[name]
    jcfg = dataclasses.replace(jmod.CONFIGS[name], dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(tmod.CONFIGS[name], dtype=torch.float32,
                               **overrides)
    params = _drawn(jmod, jcfg, tmod, tcfg, seed)["params"]
    return (jcfg, jax.tree.map(jnp.asarray, params), tcfg,
            tmod.params_from_numpy(tcfg, params, device="cpu"))


@pytest.fixture(scope="module")
def moe_pair():
    return _pair("moe_tiny")


@pytest.fixture(scope="module")
def t5_pair():
    return _pair("t5_tiny")


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _run(engine, prompts, max_new):
    try:
        return engine.generate(prompts, max_new_tokens=max_new, timeout=300)
    finally:
        engine.stop()


# ------------------------------------------------------------------ moe
def test_moe_prefix_reuse_each_engine_against_its_reference(moe_pair):
    """The mirror of ``tests/test_paged.py::TestRadixPrefixSharing::
    test_moe_prefix_reuse_matches_dense``, held engine by engine against
    the JAX engines, then paged reuse against dense at no-drop
    capacity."""
    from polyaxon_tpu.serving.batching import (
        ContinuousBatchingEngine as JaxEngine,
    )

    jcfg, jp, tcfg, tp = moe_pair
    prompt = [5, 6, 7, 1, 2, 3, 4, 9, 8, 2]
    kw = dict(slots=1, max_len=32)
    want_dense = _run(JaxEngine("moe_tiny", jcfg, jp, **kw), [prompt], 5)
    jpaged = JaxEngine("moe_tiny", jcfg, jp, kv="paged", page_size=4, **kw)
    try:
        want_first = jpaged.generate([prompt], max_new_tokens=5, timeout=300)
        want_second = jpaged.generate([prompt], max_new_tokens=5,
                                      timeout=300)
    finally:
        jpaged.stop()

    got_dense = _run(ContinuousBatchingEngine(
        "moe_tiny", tcfg, tp, device="cpu", **kw), [prompt], 5)
    paged = ContinuousBatchingEngine("moe_tiny", tcfg, tp, kv="paged",
                                     page_size=4, device="cpu", **kw)
    try:
        first = paged.generate([prompt], max_new_tokens=5, timeout=300)
        second = paged.generate([prompt], max_new_tokens=5, timeout=300)
        stats = paged.stats()
    finally:
        paged.stop()
    assert got_dense == want_dense
    assert first == want_first
    assert second == want_second
    assert stats["prefill_tokens_skipped"] > 0
    assert stats["kv_invariant_violations"] == 0

    # No-drop capacity: the full and the suffix prefill route alike.
    no_drop = dataclasses.replace(tcfg, capacity_factor=2.0)
    dense = _run(ContinuousBatchingEngine(
        "moe_tiny", no_drop, tp, device="cpu", **kw), [prompt], 5)
    paged = ContinuousBatchingEngine("moe_tiny", no_drop, tp, kv="paged",
                                     page_size=4, device="cpu", **kw)
    try:
        runs = [paged.generate([prompt], max_new_tokens=5, timeout=300)
                for _ in range(2)]
    finally:
        paged.stop()
    assert runs[0] == dense and runs[1] == dense


def test_moe_speculation_is_lossless(moe_pair):
    """``TestMoESpeculative::test_moe_target_lossless``: a MoE target
    with a self-draft and with a dense llama draft reproduces plain
    greedy generation, which equals the JAX package's."""
    jcfg, jp, tcfg, tp = moe_pair
    _, _, lcfg, lp = _pair("llama_tiny", seed=5)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 7))
    want = np.asarray(jax.jit(lambda p, x: jmoe.generate(
        jcfg, p, x, max_new_tokens=10))(jp, jnp.asarray(prompt, jnp.int32)))
    x = torch.as_tensor(prompt).long()
    assert tmoe.generate(tcfg, tp, x, max_new_tokens=10).tolist() == \
        want.tolist()
    for dcfg, dp, dfam in ((tcfg, tp, tmoe), (lcfg, lp, tllama)):
        got = generate_speculative(tcfg, tp, dcfg, dp, x, max_new_tokens=10,
                                   k=3, family=tmoe, draft_family=dfam)
        assert got.tolist() == want.tolist()


def test_moe_continuous_and_static_with_dense_draft(moe_pair):
    """``TestContinuousSpeculative::test_moe_target_with_dense_draft`` and
    ``TestMoESpeculative::test_moe_serving_with_draft``: a llama draft
    for a MoE target is lossless on the continuous engine and on the
    static one."""
    _, _, tcfg, tp = moe_pair
    _, _, lcfg, lp = _pair("llama_tiny", seed=1)
    prompts = [[5, 6, 7], [1, 2, 3, 4]]
    want = _run(ContinuousBatchingEngine("moe_tiny", tcfg, tp, slots=2,
                                         device="cpu"), prompts, 7)
    got = _run(ContinuousBatchingEngine(
        "moe_tiny", tcfg, tp, slots=2, draft=("llama_tiny", lcfg, lp, 3),
        device="cpu"), prompts, 7)
    assert got == want
    plain = _Engine("moe_tiny", tcfg, tp, device="cpu")
    spec = _Engine("moe_tiny", tcfg, tp, draft=("llama_tiny", lcfg, lp, 2),
                   device="cpu")
    assert spec.generate([[5, 6, 7]], 6) == plain.generate([[5, 6, 7]], 6)


# ------------------------------------------------------------------- t5
def test_t5_engines_match_jax_generate(t5_pair):
    """``TestContinuousBatching::test_t5_continuous_matches_static``:
    requests of different encoder lengths share the continuous engine's
    ragged decoder step; its tokens equal the static engine's and the
    JAX package's ``generate`` on the same weights."""
    jcfg, jp, tcfg, tp = t5_pair
    rows = [[5, 6, 7], [9, 8, 7, 6, 5, 4]]
    want = [np.asarray(jax.jit(lambda p, x: jt5.generate(
        jcfg, p, x, max_new_tokens=5))(jp, jnp.asarray([r], jnp.int32)))[0]
        .tolist() for r in rows]
    static = _Engine("t5_tiny", tcfg, tp, device="cpu").generate(rows, 5)
    cont = _run(ContinuousBatchingEngine("t5_tiny", tcfg, tp, slots=2,
                                         device="cpu"), rows, 5)
    assert static == want and cont == want


def test_serves_t5_seq2seq():
    """``TestServing::test_serves_t5_seq2seq``: the static engine (the
    defaults) answers, repeatably, and the streamed answer equals the
    non-streamed one."""
    with ServingServer("t5_tiny", seed=0, device="cpu") as s:
        out = _post(s.url, {"tokens": [[5, 6, 7, 8]], "max_new_tokens": 6})
        assert len(out["tokens"][0]) == 6
        assert _post(s.url, {"tokens": [[5, 6, 7, 8]],
                             "max_new_tokens": 6})["tokens"] == out["tokens"]
        req = urllib.request.Request(
            s.url + "/v1/generate", method="POST",
            data=json.dumps({"tokens": [[5, 6, 7, 8]], "max_new_tokens": 6,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            events = r.read().decode()
        streamed = [json.loads(line[6:])["token"]
                    for line in events.splitlines()
                    if line.startswith("data: ") and '"token"' in line]
        assert streamed == out["tokens"][0]
        with urllib.request.urlopen(s.url + "/v1/models", timeout=10) as r:
            assert json.load(r) == {"models": ["t5_tiny"]}


@pytest.mark.parametrize("batching", ["static", "continuous"])
def test_top_k_one_equals_greedy_over_http(batching):
    """``TestSampling::test_top_k_one_equals_greedy_over_http[t5_tiny-*]``:
    temperature 4 with top_k=1 is greedy on both engines."""
    kw = {"batching": batching, "slots": 2} if batching == "continuous" \
        else {}
    with ServingServer("t5_tiny", seed=0, device="cpu", **kw) as s:
        greedy = _post(s.url, {"tokens": [[5, 6, 7]], "max_new_tokens": 6})
        topk1 = _post(s.url, {"tokens": [[5, 6, 7]], "max_new_tokens": 6,
                              "temperature": 4.0, "top_k": 1, "seed": 9})
    assert topk1["tokens"] == greedy["tokens"]


@pytest.mark.parametrize("name", ["t5_tiny", "moe_tiny"])
def test_families_serve_int8(name, moe_pair, t5_pair):
    """``TestQuantizeInLoop::test_families_serve_int8`` (its t5 and moe
    cases): int8 serves, deterministically, and its greedy tokens equal
    the JAX package's int8 ``generate`` (the two quantizers give the same
    bits); t5's also equal its unquantized tokens, as the reference
    holds."""
    from polyaxon_tpu.serving.quantize import quantize_tree as jquantize

    jcfg, jp, tcfg, tp = moe_pair if name == "moe_tiny" else t5_pair
    jmod, _ = FAMILIES[name]
    prompt = [[5, 6, 7, 8]]
    want = np.asarray(jax.jit(lambda p, x: jmod.generate(
        jcfg, p, x, max_new_tokens=5))(jquantize(jp), jnp.asarray(
            prompt, jnp.int32))).tolist()
    engine = _Engine(name, tcfg, quantize_tree(tp), device="cpu")
    out = engine.generate(prompt, 5)
    assert out == engine.generate(prompt, 5) == want
    if name == "t5_tiny":
        assert out == _Engine(name, tcfg, tp, device="cpu").generate(
            prompt, 5)


def test_t5_speculation_refused(t5_pair):
    """``TestSpeculativeServing::test_t5_target_refused`` (a t5 target has
    no verify chunk) and a seq2seq draft (it cannot continue the target's
    token stream), on both engines."""
    _, _, tcfg, tp = t5_pair
    _, _, lcfg, lp = _pair("llama_tiny")
    with pytest.raises(ValueError, match="decode_chunk"):
        ServingServer("t5_tiny", draft_model="t5_tiny", device="cpu")
    with pytest.raises(ValueError, match="decode_chunk"):
        ContinuousBatchingEngine("t5_tiny", tcfg, tp,
                                 draft=("llama_tiny", lcfg, lp, 2),
                                 device="cpu")
    with pytest.raises(ValueError, match="prefill"):
        _Engine("llama_tiny", lcfg, lp, draft=("t5_tiny", tcfg, tp, 2),
                device="cpu")
    with pytest.raises(ValueError, match="seq2seq"):
        ContinuousBatchingEngine("llama_tiny", lcfg, lp,
                                 draft=("t5_tiny", tcfg, tp, 2),
                                 device="cpu")
    with pytest.raises(ValueError, match="decode_chunk"):
        ContinuousBatchingEngine("t5_tiny", tcfg, tp, prefill_chunk=4,
                                 device="cpu")
