"""Prefill lanes, request classes and preemption on the CPU, held against
the JAX package: ``PagePool.handoff`` and ``slot_pages`` over the same
operation sequences, the speculation policy's state machine, and the
cases of ``tests/test_lanes.py`` and ``tests/test_class_admission.py``
run on both engines (the same f32 weights, JAX init moved through
numpy), with equal admission order, preemption victims, per-class
counts and greedy tokens.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import llama as jllama
from polyaxon_tpu.serving import batching as jbatching
from polyaxon_tpu.serving.paged import PagePool as JaxPool
from polyaxon_tpu.serving.speculative import (
    LaneView as JaxView,
    SpeculationPolicy as JaxPolicy,
)
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.serving import batching as tbatching
from polyaxon_tpu_torch.serving.paged import PagePool
from polyaxon_tpu_torch.serving.speculative import LaneView, SpeculationPolicy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jllama.CONFIGS["llama_tiny"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.CONFIGS["llama_tiny"],
                               dtype=torch.float32)
    jp = jllama.init(jcfg, jax.random.key(0))["params"]
    tp = tllama.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return {"jax": (jbatching, jcfg, jp), "torch": (tbatching, tcfg, tp)}


def _engine(weights, pkg, **kw):
    mod, cfg, params = weights[pkg]
    if pkg == "torch":
        kw["device"] = "cpu"
    return mod.ContinuousBatchingEngine("llama_tiny", cfg, params, **kw)


def _stopped(weights, pkg, **kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv", "paged")
    kw.setdefault("page_size", 4)
    eng = _engine(weights, pkg, **kw)
    eng.stop()
    return eng


def _req(weights, pkg, tokens, klass="batch", seq=0):
    r = weights[pkg][0]._Request(list(tokens), 4, 0.0, 0, klass=klass)
    r.seq = seq
    return r


# --------------------------------------------------------------- policy
VIEWS = [dict(prefill_backlog=0, decode_free=2),
         dict(prefill_backlog=1, decode_free=1),
         dict(prefill_backlog=9, decode_free=1),
         dict(prefill_backlog=0, decode_free=0),
         dict(prefill_backlog=3, decode_free=2),
         dict(prefill_backlog=0, decode_free=2, oldest_wait=0.6),
         dict(prefill_backlog=2), dict(decode_free=2)]


@pytest.mark.parametrize("kw", [{}, {"k_min": 2}, {"off_backlog": 3},
                                {"k_min": 2, "off_backlog": 10},
                                {"ttft_budget": 0.5}])
def test_speculation_policy_matches_reference(kw):
    ours, ref = SpeculationPolicy(4, **kw), JaxPolicy(4, **kw)
    for view in VIEWS:
        assert ours.draft_len(LaneView(**view)) == ref.draft_len(
            JaxView(**view)), view
        assert ours.state == ref.state


def test_policy_constructor_validation():
    for args, kwargs, msg in [((0,), {}, "k_max"),
                              ((2,), {"k_min": 3}, "k_min"),
                              ((2,), {"k_min": 0}, "k_min"),
                              ((2,), {"off_backlog": 0}, "off_backlog"),
                              ((2,), {"ttft_budget": 0}, "ttft_budget")]:
        with pytest.raises(ValueError, match=msg):
            SpeculationPolicy(*args, **kwargs)


# -------------------------------------------------------------- handoff
def _pool_state(pool):
    return (pool.tables.tolist(), pool.free_pages, sorted(pool._fresh_leaf),
            [pool.slot_pages(r) for r in range(pool.tables.shape[0])],
            pool.check_invariants())


SEQUENCES = {
    "row_and_refcounts_move": [("admit", 2, list(range(10))),
                               ("handoff", 2, 0)],
    "fresh_leaf_then_invalidate": [("admit", 2, list(range(12))),
                                   ("handoff", 2, 1),
                                   ("release", 1, True),
                                   ("admit", 0, list(range(12)))],
    "release_after_handoff": [("admit", 3, list(range(10))),
                              ("handoff", 3, 0), ("commit", 0),
                              ("release", 0, False),
                              ("admit", 2, list(range(10)) + [50, 51]),
                              ("handoff", 2, 1), ("commit", 1)],
    "shared_prefix_across_rows": [("admit", 2, list(range(9))),
                                  ("commit", 2), ("handoff", 2, 0),
                                  ("admit", 3, list(range(6)) + [70, 71]),
                                  ("handoff", 3, 1), ("release", 0, False),
                                  ("ensure", 1, 12)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_handoff_and_slot_pages_match_reference(name):
    ours = PagePool(slots=4, max_len=32, page_size=4, n_pages=17)
    ref = JaxPool(slots=4, max_len=32, page_size=4, n_pages=17)
    for op in SEQUENCES[name]:
        for pool in (ours, ref):
            if op[0] == "admit":
                res = pool.admit(op[1], len(op[2]), op[2])
                out = (bool(res), getattr(res, "matched_tokens", None),
                       getattr(res, "cow", None))
            elif op[0] == "handoff":
                out = pool.handoff(op[1], op[2])
            elif op[0] == "release":
                out = pool.release(op[1], invalidate_prefix=op[2])
            elif op[0] == "commit":
                out = pool.commit_prefix(op[1])
            else:
                out = pool.ensure(op[1], op[2])
            if pool is ours:
                mine = out
            else:
                assert mine == out, op
        assert _pool_state(ours) == _pool_state(ref), op
    assert ours.check_invariants() == []


def test_handoff_into_occupied_row_asserts():
    pool = PagePool(slots=4, max_len=32, page_size=4, n_pages=17)
    pool.admit(2, 6, list(range(6)))
    pool.admit(0, 6, list(range(100, 106)))
    with pytest.raises(AssertionError, match="still holds pages"):
        pool.handoff(2, 0)


# --------------------------------------------------------- lane engine
LANE_PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], [1, 2, 3],
                [7, 3, 9, 11, 2, 4, 6, 8, 10, 12, 1, 5], [42, 43, 44, 45]]


def test_lane_engine_parity_handoffs_and_health(weights):
    """The lane scheduler is output-invisible: the port's lane engine
    gives the greedy tokens of the JAX plain (interleaved) engine, the
    function it must keep, as the port's plain engine does, while moving
    pages prefill → decode; its counters equal the JAX lane engine's.
    The JAX lane engine's own tokens are ``tests/test_lanes.py``'s to
    hold: in a fresh process it gives one prompt other tokens than its
    plain engine in some runs (ROADMAP.md, Queue 3)."""
    plain_tokens, lanes = {}, {}
    for pkg in ("jax", "torch"):
        plain = _engine(weights, pkg, slots=2, kv="paged", page_size=4)
        try:
            plain_tokens[pkg] = [plain.submit(p, 6).wait(timeout=300)
                                 for p in LANE_PROMPTS]
        finally:
            plain.stop()
        eng = _engine(weights, pkg, slots=2, kv="paged", page_size=4,
                      prefill_slots=2, prefill_chunk=8,
                      prefill_lane_budget=2, decode_lane_budget=2)
        try:
            got = [r.wait(timeout=300) for r in
                   [eng.submit(p, 6) for p in LANE_PROMPTS]]
            health, stats = eng.health(), eng.stats()
        finally:
            eng.stop()
        lanes[pkg] = (got, (stats["handoffs"], stats["handoff_pages"],
                            health["prefill_pending"],
                            health["decode_active"],
                            health["spec_tokens_accepted_rate"]))
        assert stats["kv_invariant_violations"] == 0
        assert stats["prefill_slots"] == 2
    want = plain_tokens["jax"]
    assert plain_tokens["torch"] == want
    assert lanes["torch"][0] == want
    assert lanes["torch"][1] == lanes["jax"][1]
    assert lanes["torch"][1][0] == len(LANE_PROMPTS)
    assert lanes["torch"][1][1] > 0


def test_lane_starve_and_recover(weights):
    eng = _engine(weights, "torch", slots=2, kv="paged", page_size=4,
                  prefill_slots=2, prefill_chunk=8, decode_lane_budget=0)
    try:
        req = eng.submit([5, 6, 7, 8, 9], 4)
        with pytest.raises(TimeoutError):
            req.wait(timeout=1.5)
        assert eng.stats()["handoffs"] >= 1
        eng.decode_lane_budget = 2
        assert len(req.wait(timeout=120)) == 4
        assert eng.stats()["kv_invariant_violations"] == 0
    finally:
        eng.stop()


def test_lane_refusals(weights):
    for kw, msg in [({"prefill_slots": 0}, "prefill_slots"),
                    ({"prefill_slots": 1}, "paged"),
                    ({"prefill_lane_budget": 0}, "prefill_lane_budget"),
                    ({"decode_lane_budget": -1}, "decode_lane_budget")]:
        with pytest.raises(ValueError, match=msg):
            _engine(weights, "torch", **kw)


# ---------------------------------------------------- class admission
def test_class_catalog_matches_reference():
    assert {n: dataclasses.asdict(c)
            for n, c in tbatching.REQUEST_CLASSES.items()} == {
        n: dataclasses.asdict(c)
        for n, c in jbatching.REQUEST_CLASSES.items()}
    assert tbatching.DEFAULT_REQUEST_CLASS == "batch"
    for label in ("vip", "interactive", "best-effort", ""):
        assert (tbatching.resolve_request_class(label).name
                == jbatching.resolve_request_class(label).name)


def _hot_pool(eng):
    hot = list(range(12))
    assert eng._pool.admit(0, 12, hot)
    eng._pool.release(0)
    return hot


def _scenario_priority(weights, pkg):
    eng = _stopped(weights, pkg)
    hot = _hot_pool(eng)
    a = _req(weights, pkg, hot, "batch", 0)
    b = _req(weights, pkg, range(100, 112), "interactive", 1)
    eng._queues["batch"].append(a)
    eng._queues["interactive"].append(b)
    with eng._cv:
        first = eng._pick_next_locked()
    return [first.klass, a.admit_skips]


def _scenario_overdue(weights, pkg):
    eng = _stopped(weights, pkg)
    hot = _hot_pool(eng)
    overdue = _req(weights, pkg, range(100, 112), "batch", 0)
    overdue.submitted_at = time.time() - 3.5
    fresh = _req(weights, pkg, hot, "batch", 1)
    eng._queues["batch"].extend([overdue, fresh])
    with eng._cv:
        return [eng._pick_next_locked().seq]


def _scenario_hotness_then_age(weights, pkg):
    eng = _stopped(weights, pkg)
    hot = _hot_pool(eng)
    cold = _req(weights, pkg, range(100, 112), "batch", 0)
    warm = _req(weights, pkg, hot, "batch", 1)
    eng._queues["batch"].extend([cold, warm])
    picks = []
    with eng._cv:
        picks.append(eng._pick_next_locked().seq)
    picks.append(cold.admit_skips)
    eng._queues["batch"].clear()
    eng._queues["batch"].extend([_req(weights, pkg, range(100, 112),
                                      "batch", 5),
                                 _req(weights, pkg, range(200, 212),
                                      "batch", 6)])
    with eng._cv:
        picks.append(eng._pick_next_locked().seq)
    return picks


def _scenario_fifo_mode(weights, pkg):
    eng = _stopped(weights, pkg, class_admission=False)
    q = eng._queues["batch"]
    q.extend([_req(weights, pkg, range(100, 106), "best-effort", 0),
              _req(weights, pkg, range(200, 206), "interactive", 1)])
    with eng._cv:
        return [list(eng._queues), eng._pick_next_locked().seq]


def _scenario_barrier(weights, pkg):
    eng = _stopped(weights, pkg)
    hot = _hot_pool(eng)
    starved = _req(weights, pkg, range(100, 112), "best-effort", 0)
    starved.admit_skips = 64
    eng._queues["best-effort"].extend(
        [starved, _req(weights, pkg, hot, "best-effort", 1)])
    eng._queues["interactive"].append(
        _req(weights, pkg, range(200, 212), "interactive", 2))
    order = []
    for _ in range(3):
        with eng._cv:
            order.append(eng._pick_next_locked().seq)
    return order


def _scenario_dense_classes(weights, pkg):
    eng = _stopped(weights, pkg, kv="dense")
    eng._queues["best-effort"].append(_req(weights, pkg, [1], "best-effort",
                                           0))
    eng._queues["batch"].append(_req(weights, pkg, [2], "batch", 1))
    eng._queues["interactive"].append(_req(weights, pkg, [3],
                                           "interactive", 2))
    eng._queues["batch"].append(_req(weights, pkg, [4], "batch", 3))
    order = []
    for _ in range(4):
        with eng._cv:
            order.append(eng._pick_next_locked().seq)
    return order


def _scenario_eviction(weights, pkg):
    eng = _stopped(weights, pkg, slots=2)
    pool = eng._pool
    prompt = list(range(8))
    req = _req(weights, pkg, prompt, "best-effort")
    assert pool.admit(0, len(prompt), prompt)
    pool.commit_prefix(0)
    eng._slot_req[0] = req
    eng._pos[0] = len(prompt) - 1
    free_before, held = len(pool._free), pool.slot_pages(0)
    eng._evict_slot(0, reason="slots")
    return [held, len(pool._free) - free_before, pool.free_pages,
            pool.radix_stats()["resident"], pool.check_invariants(),
            eng._queues["best-effort"][0] is req, req.preemptions,
            eng.stats()["preemptions"]]


def _scenario_victims(weights, pkg):
    eng = _stopped(weights, pkg, slots=2)
    eng._slot_req[0] = _req(weights, pkg, range(6), "interactive")
    eng._slot_req[1] = _req(weights, pkg, range(10, 16), "batch")
    none = eng._pick_victim(2)
    eng2 = _stopped(weights, pkg, slots=2)
    small, big = list(range(4)), list(range(50, 62))
    assert eng2._pool.admit(0, len(small), small)
    assert eng2._pool.admit(1, len(big), big)
    eng2._slot_req[0] = _req(weights, pkg, small, "best-effort")
    eng2._slot_req[1] = _req(weights, pkg, big, "best-effort")
    return [none, eng2._pick_victim(2), eng2._pool.slot_pages(1)]


def _scenario_no_preemption(weights, pkg):
    eng = _stopped(weights, pkg, preemption=False)
    prompt = list(range(6))
    assert eng._pool.admit(0, len(prompt), prompt)
    eng._slot_req[0] = _req(weights, pkg, prompt, "best-effort")
    eng._queues["interactive"].append(
        _req(weights, pkg, range(100, 106), "interactive"))
    eng._maybe_preempt()
    return [eng._slot_req[0] is not None, eng.stats()["preemptions"]]


def _scenario_maybe_preempt(weights, pkg):
    """A blocked interactive request evicts the best-effort slot holding
    the most pages."""
    eng = _stopped(weights, pkg, slots=2)
    small, big = list(range(4)), list(range(50, 62))
    assert eng._pool.admit(0, len(small), small)
    assert eng._pool.admit(1, len(big), big)
    eng._slot_req[0] = _req(weights, pkg, small, "best-effort")
    eng._slot_req[1] = _req(weights, pkg, big, "best-effort")
    eng._queues["interactive"].append(
        _req(weights, pkg, range(100, 106), "interactive"))
    eng._maybe_preempt()
    return [[r is not None for r in eng._slot_req],
            eng.stats()["preemptions"],
            [r.seq for r in eng._queues["best-effort"]]]


SCENARIOS = [_scenario_priority, _scenario_overdue,
             _scenario_hotness_then_age, _scenario_fifo_mode,
             _scenario_barrier, _scenario_dense_classes, _scenario_eviction,
             _scenario_victims, _scenario_no_preemption,
             _scenario_maybe_preempt]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__[10:] for s in SCENARIOS])
def test_admission_and_preemption_match_reference(weights, scenario):
    """The same queue states give the same picks, aging, victims, page
    deltas and per-class counts on both engines."""
    assert scenario(weights, "torch") == scenario(weights, "jax")


def test_per_class_pending_caps(weights):
    out = {}
    for pkg in ("jax", "torch"):
        eng = _stopped(weights, pkg, class_max_pending={"best-effort": 1})
        with eng._cv:
            eng._stopped = False  # accept submits; the loop stays dead
        try:
            eng._queues["best-effort"].append(
                _req(weights, pkg, range(6), "best-effort"))
            with pytest.raises(weights[pkg][0].QueueFull) as exc:
                eng.submit(list(range(10, 16)), 2, klass="best-effort")
            assert "best-effort" in str(exc.value)
            eng.submit(list(range(20, 26)), 2, klass="interactive")
            out[pkg] = (eng.stats()["rejected"],
                        len(eng._queues["interactive"]))
        finally:
            with eng._cv:
                eng._stopped = True
        assert eng.health()["class_caps"] == {"best-effort": 1}
    assert out["torch"] == out["jax"] == ({"class_queue_full": 1}, 1)
    with pytest.raises(ValueError, match="class_max_pending"):
        _engine(weights, "torch", slots=1, max_len=32,
                class_max_pending={"interactive": 0})


def test_suffix_only_readmission_parity(weights):
    """An evicted best-effort request re-admits with its committed
    prefix from the radix tree and still produces the dense engine's
    (and the JAX dense engine's) tokens."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
    jdense = _engine(weights, "jax", slots=1, max_len=64)
    try:
        want = jdense.generate([prompt], max_new_tokens=24, timeout=300)[0]
    finally:
        jdense.stop()
    eng = _engine(weights, "torch", slots=1, max_len=64, kv="paged",
                  page_size=4)
    real = eng._decode_logits

    def slow():  # keep the best-effort row live until the rival lands
        time.sleep(0.003)
        return real()

    eng._decode_logits = slow
    try:
        be = eng.submit(prompt, 24, klass="best-effort")
        while not be.out:
            time.sleep(0.001)
        eng.submit([7, 7, 7], 2, klass="interactive").wait(timeout=300)
        got = be.wait(timeout=300)
        stats = eng.stats()
        timeline = eng.request_timeline(be.id)
    finally:
        eng.stop()
    assert be.preemptions >= 1
    assert got == want
    assert 0 < stats["readmit_suffix_tokens"] < len(prompt)
    assert stats["kv_invariant_violations"] == 0
    events = [e["name"] for s in timeline["spans"][0]["children"]
              for e in s.get("events") or []]
    assert "preempted" in events


def test_interactive_admits_through_saturation(weights):
    eng = _engine(weights, "torch", slots=2, max_len=64, kv="paged",
                  page_size=4)
    real = eng._decode_logits

    def slow():
        time.sleep(0.002)
        return real()

    eng._decode_logits = slow
    try:
        campers = [eng.submit([31 + 17 * i + j for j in range(6)], 48,
                              klass="best-effort") for i in range(3)]
        deadline = time.monotonic() + 30.0
        while (eng.health()["decode_active"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.002)
        t0 = time.time()
        ia = eng.submit([101, 102, 103, 104, 105, 106], 2,
                        klass="interactive")
        ia.wait(timeout=300)
        ttft = ia.first_token_at - t0
        for r in campers:
            assert len(r.wait(timeout=300)) == 48
        stats, health = eng.stats(), eng.health()
    finally:
        eng.stop()
    assert ttft < tbatching.REQUEST_CLASSES["interactive"].ttft_target * 4
    assert sum(stats["preemptions"].values()) >= 1
    assert stats["kv_invariant_violations"] == 0
    assert health["class_pending"] == {"interactive": 0, "batch": 0,
                                       "best-effort": 0}
