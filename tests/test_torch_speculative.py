"""The port's speculative decoding on the CPU, held against the JAX
package: the llama cases of ``tests/test_speculative.py`` with the same
f32 weights (JAX init, moved through numpy). Greedy speculation is
lossless, so every token sequence must equal the reference's exactly
(f32 logit gaps of a random tiny model sit far above the ~1e-6
difference between the libraries).
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
from polyaxon_tpu.serving.batching import (
    ContinuousBatchingEngine as JaxEngine,
)
from polyaxon_tpu.serving.speculative import (
    generate_speculative as jax_speculative,
)
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
from polyaxon_tpu_torch.serving.server import ServingServer, _Engine
from polyaxon_tpu_torch.serving.speculative import (
    SpeculationPolicy,
    generate_speculative,
)

torch.set_num_threads(1)


def _weights(seed: int):
    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                               dtype=torch.float32)
    jp = jllama.init(jcfg, jax.random.key(seed))["params"]
    tp = tllama.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def target():
    return _weights(0)


@pytest.fixture(scope="module")
def indep():
    return _weights(7)


def _prompt(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape)


def test_lossless_vs_reference_and_plain_greedy(target, indep):
    """Self-draft (full acceptance) and an independent draft (low
    acceptance) reproduce plain greedy, and the JAX function's tokens."""
    jcfg, jp, tcfg, tp = target
    prompt = _prompt((2, 9))
    plain = tllama.generate(tcfg, tp, torch.tensor(prompt),
                            max_new_tokens=12)
    for label, (_, jdp, _, tdp) in (("self", target), ("indep", indep)):
        got = generate_speculative(tcfg, tp, tcfg, tdp,
                                   torch.tensor(prompt), max_new_tokens=12,
                                   k=4)
        want = np.asarray(jax_speculative(jcfg, jp, jcfg, jdp,
                                          jnp.asarray(prompt),
                                          max_new_tokens=12, k=4))
        assert got.tolist() == want.tolist() == plain.tolist(), label


@pytest.mark.parametrize("k", [1, 3, 7])
def test_k_never_changes_output(target, indep, k):
    _, _, tcfg, tp = target
    prompt = torch.tensor([[5, 6, 7, 8, 9]])
    want = tllama.generate(tcfg, tp, prompt, max_new_tokens=10)
    got = generate_speculative(tcfg, tp, tcfg, indep[3], prompt,
                               max_new_tokens=10, k=k)
    assert got.tolist() == want.tolist()


def test_self_draft_accepts_everything_every_round(target):
    """Full acceptance every round: ceil((max_new-1)/(k+1)) verify
    rounds, as the reference's regression guard for the draft-KV hole
    at the bonus position."""
    jcfg, jp, tcfg, tp = target
    prompt = [[5, 6, 7, 8, 9]]
    k, max_new = 4, 16
    out, rounds = generate_speculative(tcfg, tp, tcfg, tp,
                                       torch.tensor(prompt),
                                       max_new_tokens=max_new, k=k,
                                       return_rounds=True)
    jout, jrounds = jax_speculative(jcfg, jp, jcfg, jp, jnp.asarray(prompt),
                                    max_new_tokens=max_new, k=k,
                                    return_rounds=True)
    assert out.tolist() == np.asarray(jout).tolist()
    assert rounds == int(jrounds) == -(-(max_new - 1) // (k + 1))


def test_max_new_one_and_headroom(target):
    _, _, tcfg, tp = target
    prompt = torch.tensor([[5, 6, 7]])
    assert generate_speculative(tcfg, tp, tcfg, tp, prompt,
                                max_new_tokens=1, k=4).tolist() == \
        tllama.generate(tcfg, tp, prompt, max_new_tokens=1).tolist()
    with pytest.raises(ValueError, match="max_seq_len"):
        generate_speculative(tcfg, tp, tcfg, tp,
                             torch.zeros((1, 100), dtype=torch.long),
                             max_new_tokens=30, k=4)


def test_continuous_lossless_with_ragged_budgets(target, indep):
    """The speculating dense engine (staggered budgets, more requests
    than slots) gives the JAX speculating engine's tokens, which are the
    plain engine's, for self- and independent drafts."""
    jcfg, jp, tcfg, tp = target
    prompts = [[5, 6, 7], [1, 2, 3, 4], [9], [2, 8, 2, 8, 1]]
    budgets = [9, 4, 7, 12]
    plain = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                     device="cpu")
    try:
        want = [plain.submit(p, n).wait(timeout=300)
                for p, n in zip(prompts, budgets)]
    finally:
        plain.stop()
    for label, (_, jdp, _, tdp) in (("self", target), ("indep", indep)):
        jeng = JaxEngine("llama_tiny", jcfg, jp, slots=2,
                         draft=("llama_tiny", jcfg, jdp, 3))
        try:
            jgot = [r.wait(timeout=300) for r in
                    [jeng.submit(p, n) for p, n in zip(prompts, budgets)]]
        finally:
            jeng.stop()
        eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                       draft=("llama_tiny", tcfg, tdp, 3),
                                       device="cpu")
        try:
            got = [r.wait(timeout=300) for r in
                   [eng.submit(p, n) for p, n in zip(prompts, budgets)]]
            stats = eng.stats()
        finally:
            eng.stop()
        assert got == jgot == want, label
        assert [len(o) for o in got] == budgets
        if label == "self":
            assert stats["spec_tokens_per_round"] > 1.5, stats
            assert stats["draft_model"] == "llama_tiny"


def test_policy_cycling_and_chunked_prefill_stay_lossless(target):
    """Draft lengths 3, 1, 0 in turn, and chunked admission: the plain
    engine's tokens at every k the policy emits."""
    _, _, tcfg, tp = target
    prompts = [[5, 6, 7, 8, 9, 10, 11], [1, 2, 3]]
    plain = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                     device="cpu")
    try:
        want = [plain.submit(p, 8).wait(timeout=300) for p in prompts]
    finally:
        plain.stop()

    class CyclingPolicy(SpeculationPolicy):
        def __init__(self):
            super().__init__(3)
            self._i = 0

        def draft_len(self, view):
            k = (3, 1, 0)[self._i % 3]
            self._i += 1
            self.state = "off" if k == 0 else (
                "speculate" if k == 3 else "throttled")
            return k

    for kw in ({"spec_policy": CyclingPolicy()}, {"prefill_chunk": 3}):
        eng = ContinuousBatchingEngine(
            "llama_tiny", tcfg, tp, slots=2,
            draft=("llama_tiny", tcfg, tp, 3), device="cpu", **kw)
        try:
            got = [r.wait(timeout=300)
                   for r in [eng.submit(p, 8) for p in prompts]]
            state = eng.stats()["spec_policy_state"]
        finally:
            eng.stop()
        assert got == want, kw
        assert state in SpeculationPolicy.STATES


def test_engine_refusals(target):
    _, _, tcfg, tp = target
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=1,
                                   draft=("llama_tiny", tcfg, tp, 4),
                                   device="cpu")
    try:
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit([5, 6, 7], 4, temperature=0.8)
        fits_plain = tcfg.max_seq_len - 8
        with pytest.raises(ValueError, match="draft window"):
            eng.submit([1] * 8, fits_plain)
        assert len(eng.submit([1] * 8, 6).wait(timeout=300)) == 6
    finally:
        eng.stop()
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatchingEngine("llama_tiny", tcfg, tp, kv="paged",
                                 draft=("llama_tiny", tcfg, tp, 4),
                                 device="cpu")
    wcfg = dataclasses.replace(tcfg, sliding_window=8)
    with pytest.raises(ValueError, match="sliding_window"):
        ContinuousBatchingEngine("llama_tiny", wcfg, tp,
                                 draft=("llama_tiny", tcfg, tp, 4),
                                 device="cpu")
    # A seq2seq draft cannot continue the target's token stream.
    with pytest.raises(ValueError, match="seq2seq"):
        ContinuousBatchingEngine("llama_tiny", tcfg, tp,
                                 draft=("t5_tiny", tcfg, {}, 4),
                                 device="cpu")
    with pytest.raises(ValueError, match="token space"):
        ServingServer("llama_tiny", draft_model="llama3_draft_200m",
                      device="cpu")


def test_static_engine_speculates_losslessly(target, indep):
    jcfg, jp, tcfg, tp = target
    rows = [[5, 6, 7], [1, 2, 3], [2, 8, 2, 8, 1]]
    want = _Engine("llama_tiny", tcfg, tp, device="cpu").generate(rows, 8)
    for draft in (tp, indep[3]):
        spec = _Engine("llama_tiny", tcfg, tp, device="cpu",
                       draft=("llama_tiny", tcfg, draft, 3))
        assert spec.generate(rows, 8) == want
        # Sampled requests take the plain path.
        a = spec.generate([[5, 6, 7]], 8, temperature=0.9, seed=3)
        assert a == spec.generate([[5, 6, 7]], 8, temperature=0.9, seed=3)


def _gen(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.load(resp)


@pytest.mark.parametrize("batching", ["static", "continuous"])
def test_http_greedy_matches_undrafted_server(batching):
    greedy = {"tokens": [[5, 6, 7], [1, 2, 3]], "max_new_tokens": 8}
    with ServingServer("llama_tiny", seed=0, batching=batching,
                       device="cpu") as plain:
        want = _gen(plain.url, greedy)
    with ServingServer("llama_tiny", seed=0, batching=batching,
                       draft_model="llama_tiny", spec_k=3,
                       device="cpu") as spec:
        got = _gen(spec.url, greedy)
        with urllib.request.urlopen(spec.url + "/v1/stats") as r:
            stats = json.load(r)
    assert got["tokens"] == want["tokens"]
    if batching == "continuous":
        assert stats["spec_rounds"] >= 1
