"""The port's dense serving surface and engines on the CPU, held against
the JAX package with the same f32 weights (JAX init, moved through
numpy): the ring-buffer model functions (ragged rows, idle rows, a ring
wrap on a windowed config), ``generate``, the static ``_Engine`` and the
dense continuous engine, chunked prefill, and the llama-family cases of
``tests/test_serving.py`` (streaming, stats, failures, request
observability, the CLI's flags and defaults).

Tolerances: logits within 1e-4 absolute (f32 on both sides; the two
libraries order the same sums differently, ~1e-6 in practice); greedy
tokens equal (f32 logit gaps of a random tiny model sit far above that
noise).
"""

import dataclasses
import json
import re
import threading
import time
import types
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
from polyaxon_tpu.serving.server import _Engine as JaxStatic
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.obs import metrics as obs_metrics
from polyaxon_tpu_torch.serving import __main__ as cli
from polyaxon_tpu_torch.serving.batching import (
    ContinuousBatchingEngine,
    QueueFull,
)
from polyaxon_tpu_torch.serving.server import (
    ServingServer,
    _Engine,
    load_params,
)

torch.set_num_threads(1)
ATOL = 1e-4


def _pair(name="llama_tiny", **overrides):
    """(jax cfg, jax params, port cfg, port params): the same f32
    weights in both packages."""
    jcfg = dataclasses.replace(jllama.CONFIGS[name], dtype=jnp.float32,
                               **overrides)
    tcfg = dataclasses.replace(tllama.CONFIGS[name], dtype=torch.float32,
                               **overrides)
    jparams = jllama.init(jcfg, jax.random.key(0))["params"]
    tparams = tllama.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.long)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


# ------------------------------------------------------ model functions
def test_ragged_step_matches_reference_and_scalar_rows():
    """Rows at different depths and an idle row in one ragged step: the
    logits and the written cache equal JAX's, and each live row equals
    that row run alone at its scalar position."""
    jcfg, jp, tcfg, tp = _pair()
    rng = np.random.default_rng(0)
    max_len = 32
    rows = [rng.integers(0, 256, (1, 5 + 3 * i)) for i in range(3)]
    jcache = jllama.init_cache(jcfg, len(rows) + 1, max_len)
    tcache = tllama.init_cache(tcfg, len(rows) + 1, max_len, device="cpu")
    alone = []
    for i, r in enumerate(rows):
        _, c1 = jllama.prefill(jcfg, jp, jnp.asarray(r[:, :-1]), max_len)
        jcache = jllama.insert_cache_row(jcache, c1, i)
        _, t1 = tllama.prefill(tcfg, tp, _t(r[:, :-1]), max_len)
        lg, _ = tllama.decode_step(tcfg, tp, {k: v.clone() for k, v in
                                              t1.items()},
                                   _t(r[0, -1:]), r.shape[1] - 1)
        alone.append(lg[0])
        tllama.insert_cache_row(tcache, t1, i)
    _close(tcache["k"], jcache["k"])
    tokens = [int(r[0, -1]) for r in rows] + [0]
    pos = [r.shape[1] - 1 for r in rows] + [-1]
    jout, jcache = jllama.decode_step_ragged(
        jcfg, jp, jcache, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(pos, jnp.int32))
    tout, tcache = tllama.decode_step_ragged(tcfg, tp, tcache, _t(tokens),
                                             _t(pos))
    _close(tout, jout)
    _close(tcache["v"], jcache["v"])
    for i in range(len(rows)):
        _close(tout[i], alone[i])
    assert torch.isfinite(tout[-1]).all()


@pytest.mark.parametrize("plen", [6, 13])
def test_windowed_ring_wraps_like_the_reference(plen):
    """A sliding-window config (window 8) over a ring of 8 slots: a
    prompt shorter and longer than the ring, then decode steps past the
    wrap. Every step's logits equal JAX's, and the last equals a
    windowed full forward over the whole sequence."""
    window = 8
    jcfg, jp, tcfg, tp = _pair(sliding_window=window)
    rng = np.random.default_rng(plen)
    prompt = rng.integers(0, 256, (2, plen))
    max_len = plen + 12
    assert tllama.cache_len(tcfg, max_len) == window
    jl, jc = jllama.prefill(jcfg, jp, jnp.asarray(prompt), max_len)
    tl, tc = tllama.prefill(tcfg, tp, _t(prompt), max_len)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    seq = prompt
    for step in range(12):
        tok = np.asarray(jnp.argmax(jl, axis=-1))
        seq = np.concatenate([seq, tok[:, None]], axis=1)
        jl, jc = jllama.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                    plen + step)
        tl, tc = tllama.decode_step(tcfg, tp, tc, _t(tok), plen + step)
        _close(tl, jl)
    full = tllama.forward(tcfg, tp, _t(seq))
    _close(tl, full[:, -1])


def test_prefill_refusals_match_reference():
    _, _, tcfg, tp = _pair()
    with pytest.raises(ValueError, match="exceeds cache length"):
        tllama.prefill(tcfg, tp, _t(np.ones((1, 20))), 16)
    wcfg = dataclasses.replace(tcfg, sliding_window=8)
    with pytest.raises(ValueError, match="raise max_len"):
        tllama.prefill(wcfg, tp, _t(np.ones((1, 10))), 6)
    with pytest.raises(ValueError, match="full-length"):
        tllama.decode_chunk(wcfg, tp, tllama.init_cache(
            wcfg, 1, 16, device="cpu"), _t([[1, 2]]), _t([0]))


def test_decode_chunk_matches_reference():
    """A 3-token chunk per row at ragged start positions over prefilled
    rows: logits and caches equal JAX's."""
    jcfg, jp, tcfg, tp = _pair()
    rng = np.random.default_rng(1)
    max_len = 24
    prompts = [rng.integers(0, 256, (1, n)) for n in (4, 9)]
    jc = jllama.init_cache(jcfg, 2, max_len)
    tc = tllama.init_cache(tcfg, 2, max_len, device="cpu")
    for i, p in enumerate(prompts):
        jc = jllama.insert_cache_row(
            jc, jllama.prefill(jcfg, jp, jnp.asarray(p), max_len)[1], i)
        tllama.insert_cache_row(
            tc, tllama.prefill(tcfg, tp, _t(p), max_len)[1], i)
    chunk = rng.integers(0, 256, (2, 3))
    pos0 = [4, 9]
    jl, jc = jllama.decode_chunk(jcfg, jp, jc, jnp.asarray(chunk),
                                 jnp.asarray(pos0, jnp.int32))
    tl, tc = tllama.decode_chunk(tcfg, tp, tc, _t(chunk), _t(pos0))
    _close(tl, jl)
    _close(tc["k"], jc["k"])


@pytest.mark.parametrize("model", ["llama_tiny", "llama_tiny_tied",
                                   "gemma_tiny"])
def test_generate_greedy_tokens_equal(model):
    jcfg, jp, tcfg, tp = _pair(model)
    prompt = np.random.default_rng(2).integers(0, 256, (3, 7))
    want = np.asarray(jllama.generate(jcfg, jp, jnp.asarray(prompt),
                                      max_new_tokens=12))
    got = tllama.generate(tcfg, tp, _t(prompt), max_new_tokens=12)
    assert got.tolist() == want.tolist()


# -------------------------------------------------------------- engines
ROWS = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2], [3, 4, 5, 6], [7],
        [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]]
BUDGETS = [6, 9, 4, 7, 5, 3]


@pytest.mark.parametrize("model", ["llama_tiny", "llama_tiny_tied"])
def test_engines_equal_the_reference(model):
    """The static engine and the dense continuous engine (more requests
    than slots, ragged lengths and budgets, a 1-token prompt) give the
    JAX engines' greedy tokens."""
    jcfg, jp, tcfg, tp = _pair(model)
    jstatic = JaxStatic(model, jcfg, jp)
    want_static = jstatic.generate(ROWS, max_new_tokens=6)
    jeng = JaxEngine(model, jcfg, jp, slots=2, max_len=48)
    try:
        want = [r.wait(timeout=300) for r in
                [jeng.submit(p, b) for p, b in zip(ROWS, BUDGETS)]]
    finally:
        jeng.stop()
    static = _Engine(model, tcfg, tp, device="cpu")
    assert static.generate(ROWS, max_new_tokens=6) == want_static
    eng = ContinuousBatchingEngine(model, tcfg, tp, slots=2, max_len=48,
                                   device="cpu")
    try:
        got = [r.wait(timeout=300) for r in
               [eng.submit(p, b) for p, b in zip(ROWS, BUDGETS)]]
        stats = eng.stats()
    finally:
        eng.stop()
    assert got == want
    assert stats["kv"] == "dense" and stats["requests_served"] == len(ROWS)
    # A greedy prefix does not depend on the budget.
    assert [g[:min(b, 6)] for g, b in zip(got, BUDGETS)] == [
        w[:min(b, 6)] for w, b in zip(want_static, BUDGETS)]


def test_chunked_prefill_outputs_identical_to_monolithic():
    """Every prompt-length shape (shorter than the chunk, exact
    multiples, padded tails, single-token) gives the unchunked engine's
    greedy and sampled output."""
    _, _, tcfg, tp = _pair()
    prompts = [[7], [1, 2, 3], [5, 6, 7, 8, 9], [4] * 8, [2, 9] * 6 + [1]]
    outs = {}
    for chunk in (None, 4):
        eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                       prefill_chunk=chunk, device="cpu")
        try:
            reqs = [eng.submit(p, 6, temperature=t, seed=11)
                    for p in prompts for t in (0.0, 0.7)]
            outs[chunk] = [r.wait(timeout=300) for r in reqs]
        finally:
            eng.stop()
    assert outs[4] == outs[None]


def test_chunked_prefill_matches_reference_engine():
    jcfg, jp, tcfg, tp = _pair()
    prompts = [[2, 9] * 6 + [1], [5, 6, 7]]
    jeng = JaxEngine("llama_tiny", jcfg, jp, slots=2, max_len=48,
                     prefill_chunk=4)
    try:
        want = jeng.generate(prompts, max_new_tokens=5, timeout=300)
    finally:
        jeng.stop()
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                   max_len=48, prefill_chunk=4,
                                   device="cpu")
    try:
        assert eng.generate(prompts, max_new_tokens=5, timeout=300) == want
    finally:
        eng.stop()


def test_live_rows_keep_decoding_during_long_admission():
    """A short request finishes while a long prompt is still observably
    prefilling in chunks."""
    _, _, tcfg, tp = _pair()
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                   prefill_chunk=2, device="cpu")
    real = tllama.decode_chunk

    def slow_chunk(*args, **kwargs):
        time.sleep(0.01)
        return real(*args, **kwargs)

    eng._family_mod = types.SimpleNamespace(
        **{n: getattr(tllama, n) for n in dir(tllama)
           if not n.startswith("__")})
    eng._family_mod.decode_chunk = slow_chunk
    try:
        short = eng.submit([5, 6], 4)
        long = eng.submit(list(range(1, 60)), 4)
        interleaved = False
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            s = eng.stats()
            if s["requests_served"] >= 1 and s["prefilling"] >= 1:
                interleaved = True
                break
            if s["requests_served"] >= 2:
                break
            time.sleep(0.002)
        assert len(short.wait(timeout=120)) == 4
        assert len(long.wait(timeout=120)) == 4
    finally:
        eng.stop()
    assert interleaved


def test_chunked_prefill_refusals():
    _, _, tcfg, tp = _pair()
    with pytest.raises(ValueError, match="dense"):
        ContinuousBatchingEngine("llama_tiny", tcfg, tp, kv="paged",
                                 prefill_chunk=8, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        ServingServer("llama_tiny", prefill_chunk=8, device="cpu")
    wcfg = dataclasses.replace(tcfg, sliding_window=8)
    with pytest.raises(ValueError, match="sliding_window"):
        ContinuousBatchingEngine("llama_tiny", wcfg, tp, prefill_chunk=8,
                                 device="cpu")


def test_windowed_dense_engine_serves_past_the_window():
    """The dense engine over a ring smaller than the sequence: equal to
    the JAX dense engine's greedy tokens."""
    jcfg, jp, tcfg, tp = _pair(sliding_window=8)
    prompts = [list(range(3, 15)), [5, 6, 7]]
    jeng = JaxEngine("llama_tiny", jcfg, jp, slots=2, max_len=40)
    try:
        want = jeng.generate(prompts, max_new_tokens=10, timeout=300)
    finally:
        jeng.stop()
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                   max_len=40, device="cpu")
    try:
        assert eng.generate(prompts, max_new_tokens=10, timeout=300) == want
    finally:
        eng.stop()


def test_eos_truncates_on_both_engines():
    _, _, tcfg, tp = _pair()
    static = _Engine("llama_tiny", tcfg, tp, device="cpu")
    full = static.generate([[5, 6, 7], [1, 2, 3, 4]], max_new_tokens=10)
    eos = full[0][2]

    def expect(row):
        hit = next((i for i, t in enumerate(row) if t == eos), None)
        return row if hit is None else row[:hit + 1]

    assert static.generate([[5, 6, 7]], 10, eos_tokens=[eos]) == [
        expect(full[0])]
    eng = ContinuousBatchingEngine("llama_tiny", tcfg, tp, slots=2,
                                   device="cpu")
    try:
        got = eng.generate([[5, 6, 7], [1, 2, 3, 4]], 10,
                           eos_tokens=[eos], timeout=300)
    finally:
        eng.stop()
    assert got == [expect(r) for r in full]


# ------------------------------------------------------------- failures
def _engine(**kw):
    _, _, tcfg, tp = _pair()
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", 32)
    return ContinuousBatchingEngine("llama_tiny", tcfg, tp, device="cpu",
                                    **kw)


def test_persistent_step_failure_fails_fast():
    eng = _engine()
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise RuntimeError("CUDA out of memory (persistent)")

    eng._decode_logits = broken
    try:
        reqs = [eng.submit([1, 2, 3], 4) for _ in range(6)]
        errs = []
        for r in reqs:
            with pytest.raises(RuntimeError) as info:
                r.wait(timeout=120)
            errs.append(str(info.value))
        assert calls["n"] == eng.max_step_failures
        assert sum("engine failed" in e for e in errs) == 3
        assert eng.stats()["stopped"] is True
        assert eng.stats()["step_failures"] == 3
        with pytest.raises(RuntimeError, match="engine stopped"):
            eng.submit([1, 2, 3], 4)
    finally:
        eng.stop()


def test_persistent_admission_failure_fails_fast_and_releases_live():
    eng = _engine(slots=4, max_len=256)
    try:
        live = eng.submit([1, 2, 3], 200)
        deadline = time.time() + 60
        while eng.stats()["active"] == 0:
            assert time.time() < deadline
            time.sleep(0.01)

        def broken(*args):
            raise RuntimeError("CUDA out of memory")

        eng._prefill_row = broken
        bad = [eng.submit([4, 5], 50) for _ in range(3)]
        for r in bad:
            with pytest.raises(RuntimeError):
                r.wait(timeout=120)
        with pytest.raises(RuntimeError, match="engine failed"):
            live.wait(timeout=120)
        assert eng.stats()["stopped"] is True
    finally:
        eng.stop()


def test_bad_request_admission_errors_do_not_stop_engine():
    eng = _engine()
    real = tllama.cb_admission
    state = {"bad": True}

    def sometimes_bad(tokens):
        if state["bad"]:
            raise ValueError("family rejected this prompt")
        return real(tokens)

    eng._family_mod = types.SimpleNamespace(
        **{n: getattr(tllama, n) for n in dir(tllama)
           if not n.startswith("__")})
    eng._family_mod.cb_admission = sometimes_bad
    try:
        for r in [eng.submit([1, 2, 3], 4) for _ in range(4)]:
            with pytest.raises(RuntimeError, match="rejected"):
                r.wait(timeout=120)
        assert eng.stats()["stopped"] is False
        state["bad"] = False
        assert len(eng.submit([1, 2, 3], 4).wait(timeout=120)) == 4
    finally:
        eng.stop()


def test_transient_step_failure_recovers():
    eng = _engine()
    real = eng._decode_logits
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return real()

    eng._decode_logits = flaky
    try:
        with pytest.raises(RuntimeError, match="transient"):
            eng.submit([1, 2, 3], 4).wait(timeout=120)
        assert len(eng.submit([1, 2, 3], 4).wait(timeout=120)) == 4
        assert eng.stats()["stopped"] is False
        assert eng.stats()["step_failures"] == 1
    finally:
        eng.stop()


def test_over_budget_rejected():
    eng = _engine(max_len=16)
    try:
        with pytest.raises(ValueError, match="exceeds max_len"):
            eng.submit([1] * 10, 10)
    finally:
        eng.stop()


def test_shed_load_is_accounted():
    eng = _engine(max_pending=1)
    rejected = obs_metrics.serving_rejected_total()
    base_full = rejected.value(reason="queue_full")
    real = eng._decode_logits

    def slow():
        time.sleep(0.02)
        return real()

    eng._decode_logits = slow
    try:
        accepted = [eng.submit([1, 2, 3], 8)]
        with pytest.raises(QueueFull) as err:
            for _ in range(4):
                accepted.append(eng.submit([1, 2, 3], 8))
        assert err.value.retry_after >= 1
        for req in accepted:
            req.wait(timeout=300)
        stats = eng.stats()
        assert stats["rejected"]["queue_full"] >= 1
        assert rejected.value(reason="queue_full") > base_full
        assert stats["traced_requests"] == len(accepted)
    finally:
        eng.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2, 3], 4)
    assert eng.stats()["rejected"]["shutdown"] >= 1


# ----------------------------------------------------------------- HTTP
def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return json.load(resp)


def _stream(url, payload, timeout=120):
    req = urllib.request.Request(
        url + "/v1/generate", method="POST",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"].startswith("text/event-stream")
        name = None
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                name = line[len("event: "):]
            elif line.startswith("data: "):
                events.append((name or "token",
                               json.loads(line[len("data: "):])))
                name = None
    return events


def test_server_defaults_are_static_dense():
    """No engine arguments: the static engine over a dense cache, as the
    JAX server builds."""
    with ServingServer("llama_tiny", seed=0, device="cpu") as s:
        assert isinstance(s.engine, _Engine)
        assert _get(s.url, "/healthz") == {"status": "ok",
                                            "model": "llama_tiny"}
        out = _post(s.url, {"tokens": [[5, 6, 7], [1, 2, 3]],
                            "max_new_tokens": 4})
        stats = _get(s.url, "/v1/stats")
        for path in ("/requests", "/requests/deadbeef/timeline"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(s.url + path, timeout=30)
            assert err.value.code == 404
            assert "continuous" in json.load(err.value)["error"]
        for path in ("/", "/ui"):
            with urllib.request.urlopen(s.url + path, timeout=10) as r:
                assert r.headers["Content-Type"].startswith("text/html")
                assert "/v1/stats" in r.read().decode()
        alerts = _get(s.url, "/alerts")
        assert len(alerts["rules"]) == 18
        assert set(alerts) == {"alerts", "rules", "history"}
    assert stats == {"engine": "static", "device": "cpu",
                     "requests_served": 2, "tokens_generated": 8}
    # The server's random weights are the port's own draw: its dense
    # continuous engine over them gives the same tokens.
    eng = ContinuousBatchingEngine("llama_tiny", s.engine.cfg,
                                   s.engine.params, slots=2, device="cpu")
    try:
        assert eng.generate([[5, 6, 7], [1, 2, 3]], 4,
                            timeout=120) == out["tokens"]
    finally:
        eng.stop()


def test_streaming_on_both_engines():
    rows = [[5, 6, 7], [9, 8, 7, 6, 5]]
    for batching in ("continuous", "static"):
        with ServingServer("llama_tiny", seed=0, batching=batching,
                           slots=2, device="cpu") as s:
            expect = _post(s.url, {"tokens": rows,
                                   "max_new_tokens": 6})["tokens"]
            events = _stream(s.url, {"tokens": rows, "max_new_tokens": 6})
            with pytest.raises(urllib.error.HTTPError) as err:
                _stream(s.url, {"tokens": [[1] * 100],
                                "max_new_tokens": 10_000})
            assert err.value.code == 400
        done = [p for name, p in events if name == "done"]
        assert len(done) == 1 and done[0]["tokens"] == expect
        streamed = [[], []]
        for name, p in events:
            if name == "token":
                streamed[p["index"]].append(p["token"])
        assert streamed == expect, batching


@pytest.mark.parametrize("batching", ["static", "continuous"])
def test_top_k_one_equals_greedy_and_bad_sampling_is_400(batching):
    """A hot temperature with top_k=1 gives the greedy tokens on both
    engines; out-of-range sampling knobs are HTTP 400s."""
    with ServingServer("llama_tiny", seed=0, batching=batching, slots=2,
                       device="cpu") as s:
        greedy = _post(s.url, {"tokens": [[5, 6, 7]], "max_new_tokens": 6})
        topk1 = _post(s.url, {"tokens": [[5, 6, 7]], "max_new_tokens": 6,
                              "temperature": 4.0, "top_k": 1, "seed": 9})
        for bad in ({"top_p": 0.0}, {"top_p": 1.5}, {"top_k": -1},
                    {"eos_tokens": ["nope"]}, {"class": ""}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(s.url, dict({"tokens": [[1, 2]],
                                   "max_new_tokens": 4}, **bad))
            assert err.value.code == 400, bad
    assert topk1["tokens"] == greedy["tokens"]


def test_stats_and_occupancy_continuous():
    with ServingServer("llama_tiny", seed=0, batching="continuous",
                       slots=2, device="cpu") as s:
        _post(s.url, {"tokens": [[5, 6, 7], [9, 8, 7], [1, 2, 3],
                                 [4, 5, 6]], "max_new_tokens": 6})
        stats = _get(s.url, "/v1/stats")
        health = _get(s.url, "/healthz")
    assert stats["engine"] == "continuous" and stats["kv"] == "dense"
    assert stats["requests_served"] == 4 and stats["tokens_generated"] == 24
    assert stats["active"] == 0 and stats["queued"] == 0
    assert stats["queue_depth_peak"] >= 1
    assert 0.0 < stats["avg_occupancy"] <= 1.0
    assert health["kv_headroom"] is None and health["decode_active"] == 0


@pytest.fixture(scope="module")
def obs_server():
    with ServingServer("llama_tiny", seed=0, batching="continuous",
                       slots=2, prefill_chunk=4, device="cpu") as s:
        yield s


def test_concurrent_streams_leave_phase_timelines(obs_server):
    rows = [[5, 6, 7, 8, 9, 10], [9, 8, 7, 6, 5, 4], [1, 2, 3, 4, 5, 6]]
    results, errs = {}, []

    def worker(i):
        try:
            results[i] = _stream(obs_server.url,
                                 {"tokens": [rows[i]], "max_new_tokens": 6,
                                  "class": "interactive"})
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    for i in range(len(rows)):
        done = [p for name, p in results[i] if name == "done"]
        (rid,) = done[0]["request_ids"]
        payload = _get(obs_server.url, f"/requests/{rid}/timeline")
        assert payload["trace_id"] == rid
        (root,) = payload["spans"]
        phases = [c["name"] for c in root["children"]]
        assert phases[0] == "queue_wait" and phases[-1] == "decode"
        assert "prefill" in phases
        summary = payload["summary"]
        assert summary["class"] == "interactive"
        assert summary["status"] == "ok" and summary["tokens_out"] == 6
        assert summary["events"].get("first_token") == 1
        assert summary["events"].get("chunk", 0) >= 1
        assert summary["ttft_ms"] is not None and summary["ttft_ms"] > 0
        row = _get(obs_server.url, f"/requests/{rid}")
        assert row["request_id"] == rid and row["done"] is True


def test_metrics_scrape_and_listing(obs_server):
    out = _post(obs_server.url, {"tokens": [[5, 6, 7], [7, 6, 5]],
                                 "max_new_tokens": 5, "class": "scrape"})
    with urllib.request.urlopen(obs_server.url + "/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
        r'(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})?'
        r' ([-+0-9.eE]+|\+Inf|-Inf|NaN)$')
    types_, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ")
            types_[name] = mtype
        elif line.strip() and not line.startswith("#"):
            m = sample_re.match(line)
            assert m, line
            samples[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    for stem in ("ttft", "tpot", "queue_wait"):
        assert types_[f"polyaxon_serving_{stem}_seconds"] == "histogram"
        key = f'polyaxon_serving_{stem}_seconds_count{{class="scrape"}}'
        assert samples.get(key, 0) >= 2, key
    for state in ("decode", "prefill", "free"):
        assert f'polyaxon_serving_batch_slots{{state="{state}"}}' in samples
    listing = _get(obs_server.url, "/requests")["requests"]
    ids = {row["request_id"] for row in listing}
    assert set(out["request_ids"]) <= ids
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(obs_server.url, "/requests/" + "deadbeef" * 2 + "/timeline")
    assert err.value.code == 404


# ------------------------------------------------------------------ CLI
def _reference_flags() -> list[str]:
    import polyaxon_tpu.serving.__main__ as jmain

    src = open(jmain.__file__).read()
    return sorted(set(re.findall(r'add_argument\("(--[a-z0-9-]+)"', src)))


def test_cli_parses_every_reference_flag_with_its_defaults():
    parser = cli.build_parser()
    args = parser.parse_args(["--model", "llama_tiny"])
    assert args.batching == "static" and args.kv == "dense"
    ours = {a for action in parser._actions for a in action.option_strings}
    assert set(_reference_flags()) <= ours
    values = {"--model": "llama_tiny", "--batching": "continuous",
              "--kv": "paged", "--quantize": "int8", "--mesh": "tp=2",
              "--class-max-pending": "interactive=4", "--host": "h",
              "--checkpoint": "c", "--draft-model": "llama_tiny",
              "--draft-checkpoint": "d", "--trace-dump": "t",
              "--lora-alpha": "8.0"}
    argv = []
    for flag in _reference_flags():
        action = next(a for a in parser._actions
                      if flag in a.option_strings)
        if action.nargs == 0:
            argv.append(flag)
        else:
            argv += [flag, values.get(flag, "2")]
    parser.parse_args(argv)


def test_cli_main_builds_the_server_with_the_reference_defaults(
        monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_server(model, checkpoint=None, **kw):
        seen.update(kw, model=model)
        raise Stop

    import polyaxon_tpu_torch.serving.server as server_mod

    monkeypatch.setattr(server_mod, "ServingServer", fake_server)
    with pytest.raises(Stop):
        cli.main(["--model", "llama_tiny"])
    assert seen["batching"] == "static" and seen["kv"] == "dense"
    assert seen["mesh_axes"] is None and seen["quantize"] is None
    with pytest.raises(Stop):
        cli.main(["--model", "llama_tiny", "--mesh", "tp=2,dp=-1",
                  "--class-max-pending", "interactive=4"])
    assert seen["mesh_axes"] == {"tp": 2, "dp": -1}
    assert seen["class_max_pending"] == {"interactive": 4}
    with pytest.raises(SystemExit):
        cli.main(["--model", "llama_tiny", "--class-max-pending", "bad"])


def test_waiting_features_raise_naming_their_item(tmp_path, monkeypatch):
    """A serving mesh over cp is no longer refused: on one process it
    fails only for want of a second rank (cp gangs serve in
    ``tests/test_torch_serving_meshes.py``). The MoE and t5 models
    serve, and a LoRA checkpoint (item 3b) is merged at load with the
    alpha and rank of its ``_meta``."""
    with pytest.raises(ValueError, match="require 2 chips"):
        ServingServer("llama_tiny", mesh_axes={"cp": 2}, device="cpu")
    for model in ("moe_tiny", "t5_tiny"):
        server = ServingServer(model, device="cpu")
        assert server.engine.model == model
        server.httpd.server_close()
    from polyaxon_tpu_torch.models import lora
    from polyaxon_tpu_torch.runtime import checkpoint as ckpt

    _, _, tcfg, tp = _pair()
    adapters = lora.with_meta(lora.init_lora(
        tp, 2, lora.DEFAULT_TARGETS, torch.Generator().manual_seed(0)),
        rank=2, alpha=4.0)
    for ab in adapters.values():
        if "b" in ab:
            ab["b"].normal_(generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(
        ckpt, "load_tree",
        lambda path, only=None: (3, {"params": {"base": tp,
                                                "lora": adapters}}))
    _, served = load_params("llama_tiny", str(tmp_path), device="cpu")
    a, b = adapters["layers/wq"]["a"], adapters["layers/wq"]["b"]
    want = (tp["layers"]["wq"] + 2.0 * (a @ b)).to(tcfg.dtype)
    assert torch.equal(served["layers"]["wq"], want.to(
        served["layers"]["wq"].dtype))
