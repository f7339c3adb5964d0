"""The port's paged continuous-batching engine and HTTP server on the
CPU, held against the JAX engine: the same f32 ``llama_tiny`` weights
(JAX init, moved through numpy) must give token-for-token equal greedy
output. Greedy argmax is exact here because f32 logit gaps on a random
tiny model are far above the 1e-4 numerical noise between libraries.
"""

import dataclasses
import json
import urllib.error
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
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.serving.batching import (
    ContinuousBatchingEngine,
    bucket_suffix_len,
)
from polyaxon_tpu_torch.serving.server import ServingServer, load_params

# More requests than slots, ragged lengths, a 1-token prompt, and shared
# prefixes that hit the radix cache on a page boundary (9 tokens = two
# 4-token pages) and inside a page (copy-on-write fork).
SHARED = [11, 12, 13, 14, 15, 16, 17, 18, 19]
ROWS = [
    SHARED + [20, 21],
    [5, 6, 7],
    SHARED + [40],
    [9],
    SHARED[:6] + [77, 78, 79, 80],
    [3, 1, 4, 1, 5, 9, 2, 6],
    SHARED + [20, 22, 23],
]


def _params():
    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                               dtype=torch.float32)
    jparams = jllama.init(jcfg, jax.random.key(0))["params"]
    tparams = tllama.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_greedy_matches_jax_engine():
    jcfg, jparams, tcfg, tparams = _params()
    jeng = JaxEngine("llama_tiny", jcfg, jparams, slots=2, max_len=48,
                     kv="paged", page_size=4)
    try:
        want = jeng.generate(ROWS, max_new_tokens=6, timeout=300)
    finally:
        jeng.stop()
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tparams, slots=2,
                                   max_len=48, page_size=4, device="cpu")
    try:
        got = eng.generate(ROWS, max_new_tokens=6, timeout=300)
        stats = eng.stats()
        assert eng.check_invariants() == []
    finally:
        eng.stop()
    assert got == want
    assert stats["kv_prefix_hits"] > 0 and stats["kv_cow_forks"] > 0
    assert stats["prefill_tokens_skipped"] > 0
    assert stats["kv_pages_free"] == stats["kv_pages_total"]


def test_eos_sampling_and_validation():
    _, _, tcfg, tparams = _params()
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tparams, slots=2,
                                   max_len=32, page_size=4, device="cpu")
    try:
        full = eng.generate([[1, 2, 3]], max_new_tokens=5)[0]
        stop = eng.generate([[1, 2, 3]], max_new_tokens=5,
                            eos_tokens=[full[1]])[0]
        assert stop == full[:2]
        a = eng.generate([[4, 5]], 6, temperature=0.9, seed=3, top_k=20)
        b = eng.generate([[4, 5]], 6, temperature=0.9, seed=3, top_k=20)
        assert a == b  # a request's draws depend on its seed alone
        with pytest.raises(ValueError, match="max_len"):
            eng.submit([1] * 30, 5)
        with pytest.raises(ValueError, match="top_p"):
            eng.submit([1], 2, top_p=0.0)
        assert eng.check_invariants() == []
    finally:
        eng.stop()


def test_deferred_features_refuse():
    _, _, tcfg, tparams = _params()
    with pytest.raises(NotImplementedError, match="not ported"):
        ContinuousBatchingEngine("llama_tiny", tcfg, tparams, device="cpu",
                                 kv="dense")
    # The engine has no parameter for an unported feature.
    for kwargs in ({"prefill_chunk": 8},
                   {"draft": ("llama_tiny", tcfg, tparams, 2)},
                   {"prefill_slots": 1}, {"class_admission": True}):
        with pytest.raises(TypeError, match="unexpected keyword"):
            ContinuousBatchingEngine("llama_tiny", tcfg, tparams,
                                     device="cpu", **kwargs)


@pytest.mark.parametrize("model", sorted(tllama.CONFIGS))
def test_kernel_shapes_checked_at_construction(model):
    """On CUDA a config the kernels cannot take is refused before any
    step; the CPU's plain versions take every config."""
    cfg = tllama.CONFIGS[model]
    tllama.check_kernel_shapes(cfg, "cpu")
    if cfg.head_dim in (64, 128, 256):
        tllama.check_kernel_shapes(cfg, "cuda")
    else:
        with pytest.raises(ValueError, match="head_dim"):
            tllama.check_kernel_shapes(cfg, "cuda")
    plain = dataclasses.replace(cfg, attention_impl="xla",
                                paged_attention_impl="gather")
    tllama.check_kernel_shapes(plain, "cuda")


def test_bucket_suffix_len():
    assert [bucket_suffix_len(n) for n in (1, 8, 9, 33)] == [8, 8, 16, 64]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_http_round_trip_on_cpu():
    with ServingServer("llama_tiny", slots=2, device="cpu") as srv:
        out = _post(f"{srv.url}/v1/generate",
                    {"tokens": [[1, 2, 3], [4, 5, 6, 7]],
                     "max_new_tokens": 4})
        assert [len(r) for r in out["tokens"]] == [4, 4]
        assert len(out["request_ids"]) == 2
        with urllib.request.urlopen(f"{srv.url}/healthz") as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        with urllib.request.urlopen(f"{srv.url}/v1/models") as resp:
            assert json.loads(resp.read()) == {"models": ["llama_tiny"]}
        with urllib.request.urlopen(f"{srv.url}/v1/stats") as resp:
            assert json.loads(resp.read())["requests_served"] == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{srv.url}/v1/generate", {"tokens": [[1]],
                                              "max_new_tokens": 0})
        assert err.value.code == 400


def test_entry_points_need_a_device(monkeypatch):
    """With no device named and no GPU, nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingServer("llama_tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params("llama_tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_params("llama_tiny", checkpoint="/nonexistent")
    # Checkpoints are read now (tests/test_torch_checkpoint.py); a
    # directory with no committed step is an error, not a random init.
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_params("llama_tiny", checkpoint="/nonexistent", device="cpu")
