"""The port's serving fleet on the CPU, held against the JAX package:
``FleetRouter`` decisions equal the reference's for the same request and
telemetry sequences, the autoscaler and trace-propagation cases of
``tests/test_fleet.py`` and ``tests/test_fleet_telemetry.py`` over fake
engines, a real two-replica fleet of the port's engines, and request
timelines that dump in one package and read back in the other.
"""

import threading
import time

import pytest
import torch

from polyaxon_tpu.obs import analyze as janalyze
from polyaxon_tpu.obs import reqtrace as jreqtrace
from polyaxon_tpu.obs.trace import build_timeline as jbuild_timeline
from polyaxon_tpu.serving import router as jrouter
from polyaxon_tpu_torch.obs import metrics as obs_metrics
from polyaxon_tpu_torch.obs import reqtrace
from polyaxon_tpu_torch.obs.analyze import request_phases
from polyaxon_tpu_torch.obs.trace import Span, build_timeline
from polyaxon_tpu_torch.serving.fleet import (
    SCALE_UP_RULES,
    ServingFleet,
    engine_factory,
)
from polyaxon_tpu_torch.serving.router import (
    ConsistentHashRing,
    FleetRouter,
    prefix_key,
)

torch.set_num_threads(1)


def _conv(c, n=8):
    return [c * 131 + j for j in range(n)]


# --------------------------------------------------------------- router
def _drive(router_cls, ring_cls, key_fn, script):
    """Run one script of router operations; returns every observable."""
    out = []
    r = router_cls(**script["init"])
    for op in script["ops"]:
        kind = op[0]
        if kind == "route":
            d = r.route(_conv(op[1]), telemetry=op[2] if len(op) > 2
                        else None)
            out.append(("route", d.replica, d.reason, d.prefix))
        elif kind == "add":
            r.add_replica(op[1])
        elif kind == "remove":
            r.remove_replica(op[1])
        elif kind == "owner":
            out.append(("owner", r.ring.owner(key_fn(_conv(op[1])))))
        elif kind == "pressured":
            out.append(("pressured", r._pressured(op[1], op[2])))
    stats = r.stats()
    out.append(("stats", stats["affinity_entries"],
                sorted(stats["routed"].items())))
    ring = ring_cls(["a", "b", "c"], seed=3)
    out.append(("ring", [ring.owner(key_fn(_conv(i))) for i in range(40)]))
    return out


SCRIPTS = {
    "affinity_sticks": {"init": {"replicas": ["a", "b", "c"], "seed": 1},
                        "ops": [("route", 4)] * 6},
    "deterministic_mix": {"init": {"replicas": ["a", "b", "c"], "seed": 9},
                          "ops": [("route", i % 6) for i in range(60)]},
    "hot_spill_after_add": {
        "init": {"replicas": ["a", "b", "c"], "seed": 1, "recent": 32,
                 "hot_min": 16, "hot_fraction": 0.5, "spill_depth": None},
        "ops": [("route", i % 6) for i in range(24)] + [("add", "d")]
        + [("owner", i) for i in range(6)]
        + [("route", i % 6) for i in range(40)]},
    "pressure_spill": {
        "init": {"replicas": ["a", "b"], "seed": 2, "spill_depth": 4,
                 "hot_min": 999},
        "ops": [("route", 1), ("route", 1, {"a": {"status": "ok",
                                                  "queued": 10},
                                            "b": {"status": "ok",
                                                  "queued": 10}}),
                ("route", 2, {"a": {"status": "ok", "prefill_pending": 9},
                              "b": {"status": "ok",
                                    "prefill_pending": 0}})]},
    "unhealthy_skipped": {
        "init": {"replicas": ["a", "b"], "seed": 1},
        "ops": [("route", 2), ("route", 2, {"a": {"status": "stopped"},
                                            "b": {"status": "ok"}}),
                ("route", 2, {"b": {"status": "stopped"},
                              "a": {"status": "ok"}}),
                ("route", 3, {"a": {"status": "ok",
                                    "kv_headroom": {"free": 0}},
                              "b": {"status": "ok"}})]},
    "blind_round_robin": {"init": {"replicas": ["a", "b"], "seed": 1,
                                   "blind": True},
                          "ops": [("route", 3)] * 4},
    "remove_drops_affinity": {
        "init": {"replicas": ["a", "b"], "seed": 1},
        "ops": [("route", 5), ("remove", "a"), ("route", 5), ("add", "a"),
                ("route", 5), ("remove", "b"), ("route", 5)]},
    "class_cap_pressure": {
        "init": {"replicas": ["r0", "r1"], "spill_depth": None},
        "ops": [("pressured", "r0", {
            "r0": {"prefill_pending": 0,
                   "class_pending": {"interactive": 4},
                   "class_caps": {"interactive": 4}}}),
                ("pressured", "r1", {
                    "r1": {"prefill_pending": 0,
                           "class_pending": {"interactive": 1},
                           "class_caps": {"interactive": 4}}}),
                ("pressured", "r0", {"r0": {"prefill_pending": 0}})]},
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_router_decisions_equal_the_reference(name):
    ours = _drive(FleetRouter, ConsistentHashRing, prefix_key,
                  SCRIPTS[name])
    ref = _drive(jrouter.FleetRouter, jrouter.ConsistentHashRing,
                 jrouter.prefix_key, SCRIPTS[name])
    assert ours == ref


def test_ring_movement_bounded_and_restored():
    keys = [prefix_key(_conv(i)) for i in range(400)]
    ring = ConsistentHashRing(["a", "b", "c", "d"], seed=0)
    before = {k: ring.owner(k) for k in keys}
    ring.add("e")
    moved = sum(before[k] != ring.owner(k) for k in keys)
    assert 0 < moved < 0.35 * len(keys)
    ring.remove("e")
    assert {k: ring.owner(k) for k in keys} == before


# ------------------------------------------------------- fake engines
class _Result:
    def __init__(self, rid=None):
        self.id = rid
        self.done = threading.Event()
        self.done.set()

    def wait(self, timeout=None):
        return [1, 2]


class _FakeEngine:
    def __init__(self, registry=None):
        self._obs = registry
        self.queued = self.active = 0
        self.stopped = False
        self.warm_calls = 0
        self.submits = []

    def generate(self, rows, max_new_tokens, **kw):
        self.warm_calls += 1
        return [[0]] * len(rows)

    def submit(self, tokens, max_new_tokens, *, request_id=None,
               trace_parent=None, route_record=None, klass="batch", **kw):
        self.submits.append({"tokens": list(tokens),
                             "request_id": request_id,
                             "trace_parent": trace_parent,
                             "route_record": route_record, "klass": klass})
        if self._obs is not None:
            obs_metrics.serving_ttft_hist(self._obs).observe(
                0.02 + 0.01 * len(self.submits), **{"class": klass})
            if klass == "best-effort":
                obs_metrics.serving_preemptions_total(self._obs).inc(
                    **{"class": klass, "reason": "slots"})
        return _Result(request_id)

    def health(self):
        return {"status": "stopped" if self.stopped else "ok",
                "queued": self.queued, "active": self.active,
                "radix_hit_rate": None, "kv_headroom": None}

    def stats(self):
        return {"prefill_tokens_total": 16, "prefill_tokens_skipped": 12,
                "kv_invariant_violations": 0,
                "requests_served": len(self.submits)}

    def stop(self):
        self.stopped = True


def _fleet(*, replicas=2, standby=1, max_replicas=4, prewarm=True,
           clock=None):
    reg = obs_metrics.MetricsRegistry()
    engines = {}

    def factory(registry=None):
        eng = _FakeEngine(registry)
        engines[getattr(registry, "component", f"e{len(engines)}")] = eng
        return eng

    fleet = ServingFleet(factory, replicas=replicas, standby=standby,
                         max_replicas=max_replicas, prewarm=prewarm,
                         warmup_rows=[[1, 2, 3]],
                         # The default (global) registry on purpose: the
                         # fleet rebinds it to a `router` view of `reg`.
                         router=FleetRouter(seed=1),
                         registry=reg, cooldown=1.0, idle_hold=1.0,
                         clock=clock or time.monotonic)
    fleet.start()
    return fleet, engines, reg


def test_start_warms_and_scale_up_promotes():
    clock = [100.0]
    fleet, engines, _ = _fleet(clock=lambda: clock[0])
    try:
        states = fleet.stats()["states"]
        assert (states["ready"], states["standby"]) == (2, 1)
        assert all(e.warm_calls == 2 for e in engines.values())
        assert set(fleet.poll()) == {"r0", "r1"}
        ev = fleet.maybe_scale({"fleet-replica-hot"})
        assert (ev["mode"], ev["outcome"]) == ("promote", "ok")
        assert fleet.router.replicas == {"r0", "r1", "r2"}
        assert fleet.maybe_scale(SCALE_UP_RULES) is None  # cooldown
    finally:
        fleet.stop()


def test_background_build_and_drain_before_release():
    clock = [100.0]
    fleet, engines, _ = _fleet(standby=0, clock=lambda: clock[0])
    try:
        ev = fleet.maybe_scale({"serving-queue-saturation"})
        assert ev["mode"] == "build" and fleet.wait_settled(timeout=10.0)
        assert len(fleet.ready) == 3 and engines["r2"].warm_calls == 2
        engines["r2"].queued = 2
        ev = fleet.scale_down(timeout=10.0)
        assert ev["replica"] == "r2"
        assert fleet.router.replicas == {"r0", "r1"}
        time.sleep(0.1)
        assert not engines["r2"].stopped  # still draining
        engines["r2"].queued = 0
        assert fleet.wait_settled(timeout=10.0) and engines["r2"].stopped
        assert fleet.stats()["states"]["released"] == 1
        assert fleet.scale_down()["direction"] == "down"
    finally:
        fleet.stop()


def test_submit_propagates_trace_context_and_scopes_series():
    fleet, engines, reg = _fleet(standby=0)
    try:
        req, decision = fleet.submit(_conv(3), 4, klass="interactive")
        sub = engines[decision.replica].submits[-1]
        record = sub["route_record"]
        assert sub["request_id"] == req.id == record["trace_id"]
        assert (record["name"], record["component"]) == ("route", "router")
        assert sub["trace_parent"] == record["span_id"]
        assert set(record["attributes"]["candidates"]) == {"r0", "r1"}
        req2, d2 = fleet.submit(_conv(4), 4, request_id="feedc0de")
        assert req2.id == "feedc0de"
        for i in range(16):
            fleet.submit(_conv(i), 4, klass="best-effort")
        totals = obs_metrics.serving_preemptions_total(
            reg).total_by_component()
        by_engine = {rid: sum(1 for s in e.submits
                              if s["klass"] == "best-effort")
                     for rid, e in engines.items() if e.submits}
        assert len(by_engine) == 2
        assert totals == {rid: float(n) for rid, n in by_engine.items()}
        snap = fleet.fleet_snapshot()
        assert snap["components"] == sorted(by_engine)
        assert snap["ttft_skew"] is not None
        assert set(snap["per_replica"]) == set(by_engine)
        assert "router" in obs_metrics.fleet_routed_total(reg).components()
        assert fleet.stats()["prefix_hit_rate"] == pytest.approx(0.75)
    finally:
        fleet.stop()
    assert obs_metrics.fleet_ttft_skew(reg).snapshot()["series"] == {}


# ------------------------------------------------------------ timelines
def _arc(mod):
    """A routed request evicted and readmitted, as the engine records it,
    through one package's ``RequestTrace``."""
    rid = mod.new_request_id()
    route = Span(trace_id=rid, name="route", component="router",
                 attributes={"decision": "affinity", "replica": "r1",
                             "candidates": {"r0": 0, "r1": 2}})
    route.end = time.time()
    tr = mod.RequestTrace(rid, klass="best-effort", component="r1",
                          parent_id=route.span_id,
                          extra_records=[route.to_record()])
    tr.start_phase("queue_wait")
    tr.start_phase("prefill")
    tr.event("preempted", reason="slots", slot=0)
    tr.start_phase("queue_wait", requeued=True)
    tr.start_phase("prefill")
    tr.start_phase("decode")
    tr.event("first_token")
    tr.finish(tokens_out=4)
    return rid, tr


def test_route_span_parents_one_tree_and_phases_match_reference():
    rid, tr = _arc(reqtrace)
    tl = build_timeline(tr.records(), trace_id=rid)
    assert tl["span_count"] == 7 and len(tl["spans"]) == 1
    root = tl["spans"][0]
    assert (root["name"], root["component"]) == ("route", "router")
    request = root["children"][0]
    assert [c["name"] for c in request["children"]].count("queue_wait") == 2
    summary = request_phases(tl)
    assert summary == janalyze.request_phases(
        jbuild_timeline(tr.records(), trace_id=rid))
    assert summary["route"] == {"decision": "affinity", "replica": "r1"}
    assert summary["replica"] == "r1" and summary["events"]["preempted"] == 1


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_ring_dump_round_trips_across_packages(tmp_path, writer):
    """A ring dumped by one package reads back in the other, and the
    records rebuild the same timeline and phase summary."""
    mods = {"torch": reqtrace, "jax": jreqtrace}
    src = mods[writer]
    dst = mods["jax" if writer == "torch" else "torch"]
    ring = src.TimelineRing(capacity=2)
    traces = [_arc(src) for _ in range(3)]
    for _, tr in traces:
        ring.add(tr)
    path = src.dump_ring(ring, str(tmp_path))
    assert path.endswith(src.TRACE_DUMP_FILE) == True  # noqa: E712
    dump = dst.read_ring_dump(str(tmp_path))
    assert dump["capacity"] == 2 and dump["evicted"] == 1
    assert [r["summary"]["request_id"] for r in dump["requests"]] == [
        rid for rid, _ in traces[1:]]
    for entry, (rid, tr) in zip(dump["requests"], traces[1:]):
        ours = request_phases(build_timeline(entry["records"],
                                             trace_id=rid))
        theirs = janalyze.request_phases(
            jbuild_timeline(tr.records(), trace_id=rid))
        assert ours == theirs
    assert dst.read_ring_dump(str(tmp_path / "absent")) is None


# ---------------------------------------------------- real port fleet
def test_two_replica_fleet_of_port_engines():
    """Two paged llama_tiny replicas: prefix affinity keeps a shared
    prefix on one replica, both replicas serve, the fleet snapshot and
    the per-replica scoped series are present, and a request's timeline
    is one tree under its route span."""
    reg = obs_metrics.MetricsRegistry()
    fleet = ServingFleet(
        engine_factory("llama_tiny", slots=2, kv="paged", page_size=4,
                       max_len=64, device="cpu"),
        replicas=2, standby=0, max_replicas=2, prewarm=False,
        router=FleetRouter(seed=0, registry=reg), registry=reg)
    fleet.start()
    try:
        shared = list(range(40, 56))
        reqs = [fleet.submit(shared + [i], 4, klass="interactive")
                for i in range(4)]
        reqs += [fleet.submit([(i * 37 + j) % 200 for j in range(12)], 4)
                 for i in range(12)]
        for r, _ in reqs:
            assert len(r.wait(timeout=300)) == 4
        shared_replicas = {d.replica for _, d in reqs[:4]}
        served = {d.replica for _, d in reqs}
        snap = fleet.fleet_snapshot()
        tl = fleet.request_timeline(reqs[0][0].id)
        stats = fleet.stats()
    finally:
        fleet.stop()
    assert len(shared_replicas) == 1
    assert served == {"r0", "r1"}
    assert set(snap["per_replica"]) == {"r0", "r1"}
    assert snap["components"] == ["r0", "r1"]
    assert stats["kv_invariant_violations"] == 0
    assert stats["prefill_tokens_skipped"] > 0
    root = tl["spans"][0]
    assert (root["name"], root["component"]) == ("route", "router")
    assert root["children"][0]["component"] in {"r0", "r1"}
