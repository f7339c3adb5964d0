"""The port's alert rules and run reports (``polyaxon_tpu_torch/obs/
rules.py``, ``rules.json`` and ``analyze.py``), held against the JAX
package's.

- ``TestRuleSchema``, ``TestRuleLifecycle`` and ``TestReportUnit`` are
  the cases of ``tests/test_obs.py``, run on twins
  (``tests/torch_twin.py``): every call goes to the JAX module and to
  the port's with the same inputs and the same injected clock, every
  plain-data result must be equal on both sides (exact JSON equality; a
  float to 1e-12 relative), and the reference's assertions are checked
  on the port's result.
- The port's ``rules.json`` and ``oracle.json`` parse to the same rules
  and invariants as the JAX package's, and name only metrics of the
  port's catalogue.
- ``TestServingObsDrill`` drives the committed serving rules from the
  port's own engine (``device="cpu"``) and reads them over the port
  server's ``GET /alerts``.
"""

import json
import os
import time
import urllib.request

import pytest

from tests.torch_twin import assert_same, twin_modules

obs_analyze, obs_metrics, obs_oracle, obs_rules, obs_trace = twin_modules(
    "obs.analyze", "obs.metrics", "obs.oracle", "obs.rules", "obs.trace")


@pytest.fixture(autouse=True)
def _fixed_perf_clock(monkeypatch):
    """The history ring times its sampling with ``time.perf_counter``:
    pinned, so its self-accounting series are equal on both sides."""
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)


# ============================================================ the rulesets
def test_committed_files_equal_and_parse_alike():
    """The port reads its own copies, beside its modules; they hold the
    reference's bytes and parse to the same rules and invariants."""
    from polyaxon_tpu.obs import oracle as jax_oracle
    from polyaxon_tpu.obs import rules as jax_rules
    from polyaxon_tpu_torch.obs import oracle as torch_oracle
    from polyaxon_tpu_torch.obs import rules as torch_rules

    for jpath, tpath in ((jax_rules.DEFAULT_RULES_PATH,
                          torch_rules.DEFAULT_RULES_PATH),
                         (jax_oracle.DEFAULT_ORACLE_PATH,
                          torch_oracle.DEFAULT_ORACLE_PATH)):
        assert os.path.dirname(tpath) == os.path.dirname(
            torch_rules.__file__)
        with open(jpath, "rb") as j, open(tpath, "rb") as t:
            assert j.read() == t.read()
    rules = obs_rules.load_ruleset()
    assert len(rules) == 18
    for rule in rules:
        assert_same(vars(rule.jax), vars(rule.torch))
    invariants = obs_oracle.load_invariants()
    assert len(invariants) == 16
    for inv in invariants:
        assert_same(vars(inv.jax), vars(inv.torch))


def test_rules_name_only_the_ports_metrics():
    """Schema gate: every metric a rule or invariant reads is in the
    port's catalogue, and ``--check`` passes on both files."""
    from polyaxon_tpu_torch.obs import metrics, oracle, rules

    names = metrics.catalog_metric_names()
    assert {r.metric for r in rules.check_ruleset()} <= names
    assert {i.metric for i in oracle.check_invariants()
            if i.metric} <= names
    assert rules._main(["--check"]) == 0
    assert oracle._main(["--check"]) == 0


class _FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now


def _engine(rule_dicts, registry, clock=None):
    rules = [obs_rules.Rule.from_dict(d) for d in rule_dicts]
    return obs_rules.AlertEngine(rules, registry=registry,
                                 clock=clock or _FakeClock())


class TestRuleSchema:
    def test_committed_default_ruleset_validates(self):
        rules = obs_rules.check_ruleset()
        ids = [r.id for r in rules]
        assert "retry-storm" in ids
        assert "scheduler-tick-p99" in ids
        assert "step-time-regression" in ids
        assert len(ids) == len(set(ids))

    @pytest.mark.parametrize("bad,match", [
        ({"rules": [{"id": "x", "kind": "nope", "metric": "m"}]}, "kind"),
        ({"rules": [{"id": "x", "kind": "threshold",
                     "metric": "polyaxon_runs", "value": 1,
                     "for": "5 parsecs"}]}, "malformed for"),
        ({"rules": [{"id": "x", "kind": "rate",
                     "metric": "polyaxon_retry_attempts_total", "value": 1,
                     "window": "soon"}]}, "malformed window"),
        ({"rules": [{"id": "x", "kind": "threshold",
                     "metric": "polyaxon_runs", "value": 1, "op": "!="}]},
         "unknown op"),
        ({"rules": [{"id": "x", "kind": "threshold",
                     "metric": "polyaxon_runs"}]}, "exactly one"),
        ({"rules": [{"id": "x", "kind": "slo_burn_rate",
                     "metric": "polyaxon_scheduler_tick_seconds",
                     "objective": 0.99}]}, "needs `le`"),
    ])
    def test_malformed_rules_raise(self, bad, match):
        with pytest.raises(obs_rules.RuleError, match=match):
            obs_rules.load_ruleset(bad)

    def test_duplicate_ids_and_unknown_metrics_raise(self):
        rule = {"id": "dup", "kind": "threshold",
                "metric": "polyaxon_runs", "value": 1}
        with pytest.raises(obs_rules.RuleError, match="duplicate"):
            obs_rules.load_ruleset({"rules": [rule, dict(rule)]})
        with pytest.raises(obs_rules.RuleError, match="unknown metric"):
            obs_rules.load_ruleset({"rules": [
                {"id": "x", "kind": "threshold",
                 "metric": "polyaxon_typo_total", "value": 1}]})

    def test_window_parser_goldens(self):
        assert obs_rules.parse_window("250ms") == pytest.approx(0.25)
        assert obs_rules.parse_window("30s") == 30.0
        assert obs_rules.parse_window("5m") == 300.0
        assert obs_rules.parse_window("1h") == 3600.0
        assert obs_rules.parse_window(15) == 15.0
        with pytest.raises(obs_rules.RuleError):
            obs_rules.parse_window("-3s")


class TestRuleLifecycle:
    def test_threshold_fire_hysteresis_resolve(self):
        """The full episode: breach → pending (`for` not served) →
        firing → clear held `resolve_after` → resolved. A blip inside
        either window changes nothing."""
        registry = obs_metrics.MetricsRegistry()
        gauge = registry.gauge("depth", "")
        clock = _FakeClock()
        engine = _engine([{"id": "sat", "kind": "threshold",
                           "metric": "depth", "op": ">", "value": 10,
                           "for": "5s", "resolve_after": "5s"}],
                         registry, clock)
        gauge.set(50)
        assert engine.evaluate() == []  # pending, `for` not yet served
        assert engine.active() == []
        clock.now += 3
        assert engine.evaluate() == []
        clock.now += 3  # breach held 6s >= 5s
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired" and fired["rule"] == "sat"
        assert engine.active()[0]["value"] == 50
        # A clear blip shorter than resolve_after keeps it firing.
        gauge.set(0)
        clock.now += 2
        assert engine.evaluate() == []
        assert engine.active()
        gauge.set(60)  # re-breach resets the clear clock
        clock.now += 1
        assert engine.evaluate() == []
        gauge.set(0)
        clock.now += 3
        assert engine.evaluate() == []  # clear clock (re)starts here
        clock.now += 3
        assert engine.evaluate() == []  # clear held 3s < 5s
        clock.now += 3
        (resolved,) = engine.evaluate()
        assert resolved["event"] == "resolved"
        assert engine.active() == []
        events = [e["event"] for e in engine.history]
        assert events == ["fired", "resolved"]

    def test_pending_blip_never_fires(self):
        registry = obs_metrics.MetricsRegistry()
        gauge = registry.gauge("depth", "")
        clock = _FakeClock()
        engine = _engine([{"id": "sat", "kind": "threshold",
                           "metric": "depth", "op": ">", "value": 10,
                           "for": "10s"}], registry, clock)
        gauge.set(99)
        engine.evaluate()
        clock.now += 2
        gauge.set(0)  # clears before `for` is served
        engine.evaluate()
        clock.now += 20
        engine.evaluate()
        assert list(engine.history) == []

    def test_rate_rule_windows_a_counter(self):
        registry = obs_metrics.MetricsRegistry()
        counter = registry.counter("polyaxon_retry_attempts_total", "")
        clock = _FakeClock()
        engine = _engine([{"id": "storm", "kind": "rate",
                           "metric": "polyaxon_retry_attempts_total",
                           "window": "60s", "op": ">", "value": 0.2}],
                         registry, clock)
        engine.evaluate()  # baseline sample at value 0
        clock.now += 10
        counter.inc(5)  # 5 events / 10 s = 0.5/s > 0.2
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["value"] == pytest.approx(0.5)
        # No further increments: the rate decays as the window slides
        # past the burst, and the alert resolves.
        clock.now += 120
        engine.evaluate()
        transitions = [e["event"] for e in engine.history]
        assert transitions == ["fired", "resolved"]

    def test_elastic_resize_storm_fires_and_resolves(self):
        """The committed elastic-resize-storm rule: flapping
        slices drive resizes above 0.05/s, the rule fires, and resolves
        once the 2m window slides past the burst."""
        (committed,) = [r for r in obs_rules.load_ruleset()
                        if r.id == "elastic-resize-storm"]
        assert committed.metric == "polyaxon_elastic_resizes_total"
        assert committed.kind == "rate"
        registry = obs_metrics.MetricsRegistry()
        counter = registry.counter("polyaxon_elastic_resizes_total", "",
                                   ("direction", "outcome"))
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([committed], registry=registry,
                                       clock=clock)
        counter.inc(0, direction="shrink", outcome="ok")  # series exists
        engine.evaluate()  # baseline sample at value 0
        clock.now += 10
        counter.inc(3, direction="shrink", outcome="ok")
        counter.inc(2, direction="grow", outcome="ok")
        counter.inc(1, direction="shrink", outcome="failed")
        # 6 resizes / 10s = 0.6/s > 0.05/s, summed across the series.
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "elastic-resize-storm"
        assert fired["value"] == pytest.approx(0.6)
        clock.now += 240  # slides the 120s window past the burst
        engine.evaluate()
        assert [e["event"] for e in engine.history] == ["fired", "resolved"]

    def test_checkpoint_restore_slow_fires_and_resolves(self):
        """The committed checkpoint-restore-slow rule: the
        rule judges the WORST tier series (quantile_max), so healthy
        tier-0 hits cannot mask a slow store tier — slow store restores
        push that series' p99 over the 2.5s budget floor and the rule
        fires; once store restores run fast again the tail dilutes
        under budget and the clear held past resolve_after resolves."""
        (committed,) = [r for r in obs_rules.load_ruleset()
                        if r.id == "checkpoint-restore-slow"]
        assert committed.metric == "polyaxon_checkpoint_restore_seconds"
        assert committed.kind == "threshold"
        registry = obs_metrics.MetricsRegistry()
        hist = obs_metrics.checkpoint_restore_hist(registry)
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([committed], registry=registry,
                                       clock=clock)
        for _ in range(50):
            hist.observe(0.002, tier="0")  # healthy memory-replica hits
        assert engine.evaluate() == []
        for _ in range(10):
            hist.observe(4.0, tier="2")  # slow store fallbacks: p99 over
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "checkpoint-restore-slow"
        assert fired["value"] > 2.5
        for _ in range(2000):
            hist.observe(0.002, tier="2")  # store recovers: tail dilutes
        clock.now += 10
        assert engine.evaluate() == []  # clear clock starts here
        clock.now += 31  # clear held past resolve_after = 30s
        (resolved,) = engine.evaluate()
        assert resolved["event"] == "resolved"
        assert [e["event"] for e in engine.history] == ["fired", "resolved"]

    def test_fleet_replica_hot_fires_and_resolves(self):
        """The committed fleet-replica-hot rule: the gauge
        is per-replica and the alert judges the HOTTEST series (max
        across series), so one melting replica fires it even while its
        siblings idle; once the router/autoscaler relieve the queue and
        the clear holds past resolve_after it resolves."""
        (committed,) = [r for r in obs_rules.load_ruleset()
                        if r.id == "fleet-replica-hot"]
        assert committed.metric == "polyaxon_fleet_replica_queue_depth"
        assert committed.kind == "threshold"
        registry = obs_metrics.MetricsRegistry()
        gauge = obs_metrics.fleet_replica_queue_depth(registry)
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([committed], registry=registry,
                                       clock=clock)
        gauge.set(1, replica="r0")
        gauge.set(2, replica="r1")
        assert engine.evaluate() == []  # balanced fleet: quiet
        gauge.set(12, replica="r1")  # one replica melts
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "fleet-replica-hot"
        assert fired["value"] == 12
        gauge.set(0, replica="r1")  # spill + scale-up relieved it
        clock.now += 5
        assert engine.evaluate() == []  # clear < resolve_after (10s)
        clock.now += 11
        (resolved,) = engine.evaluate()
        assert resolved["event"] == "resolved"
        assert [e["event"] for e in engine.history] == ["fired",
                                                        "resolved"]

    def test_fleet_scale_flap_fires_and_resolves(self):
        """The committed fleet-scale-flap rule: an
        autoscaler thrashing grow/shrink pushes scale events above
        0.15/s over 1m, the rule fires, and resolves once the window
        slides past the flap."""
        (committed,) = [r for r in obs_rules.load_ruleset()
                        if r.id == "fleet-scale-flap"]
        assert committed.metric == "polyaxon_fleet_scale_events_total"
        assert committed.kind == "rate"
        registry = obs_metrics.MetricsRegistry()
        counter = obs_metrics.fleet_scale_events_total(registry)
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([committed], registry=registry,
                                       clock=clock)
        counter.inc(0, direction="up", outcome="ok")  # series exists
        engine.evaluate()  # baseline sample at value 0
        clock.now += 10
        counter.inc(2, direction="up", outcome="ok")
        counter.inc(2, direction="down", outcome="ok")
        # 4 events / 10s = 0.4/s > 0.15/s summed across series: flap.
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "fleet-scale-flap"
        assert fired["value"] == pytest.approx(0.4)
        clock.now += 120  # slides the 60s window past the flap
        engine.evaluate()
        assert [e["event"] for e in engine.history] == ["fired",
                                                        "resolved"]

    def test_serving_preemption_storm_fires_and_resolves(self):
        """The committed serving-preemption-storm rule: a
        burst of preemptive slot/KV evictions pushes the rate above
        0.2/s summed across (class, reason) series, the rule fires,
        and resolves once the 2m window slides past the burst."""
        (committed,) = [r for r in obs_rules.load_ruleset()
                        if r.id == "serving-preemption-storm"]
        assert committed.metric == "polyaxon_serving_preemptions_total"
        assert committed.kind == "rate"
        registry = obs_metrics.MetricsRegistry()
        counter = obs_metrics.serving_preemptions_total(registry)
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([committed], registry=registry,
                                       clock=clock)
        counter.inc(0, **{"class": "best-effort",
                          "reason": "slots"})  # series exists
        engine.evaluate()  # baseline sample at value 0
        clock.now += 10
        counter.inc(4, **{"class": "best-effort", "reason": "slots"})
        counter.inc(2, **{"class": "best-effort", "reason": "kv_pages"})
        # 6 evictions / 10s = 0.6/s > 0.2/s summed across series.
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "serving-preemption-storm"
        assert fired["value"] == pytest.approx(0.6)
        clock.now += 240  # slides the 120s window past the burst
        engine.evaluate()
        assert [e["event"] for e in engine.history] == ["fired",
                                                        "resolved"]

    def test_threshold_against_derived_value_step_regression(self):
        """value_from: p99 > 3x p50 — the relative rule the default
        step-time-regression alert uses."""
        registry = obs_metrics.MetricsRegistry()
        hist = registry.histogram("step_s", "", buckets=(0.1, 1.0, 10.0))
        clock = _FakeClock()
        engine = _engine([{"id": "reg", "kind": "threshold",
                           "metric": "step_s", "quantile": 0.99, "op": ">",
                           "value_from": {"quantile": 0.5, "factor": 3.0}}],
                         registry, clock)
        for _ in range(50):
            hist.observe(0.05)  # tight distribution: p99 ≈ p50
        assert engine.evaluate() == []
        for _ in range(5):
            hist.observe(9.0)  # a tail appears
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["value"] > fired["threshold"]

    def test_slo_burn_rate_fires_on_budget_burn(self):
        registry = obs_metrics.MetricsRegistry()
        hist = registry.histogram("tick_s", "", buckets=(0.5, 1.0, 5.0))
        clock = _FakeClock()
        engine = _engine([{"id": "burn", "kind": "slo_burn_rate",
                           "metric": "tick_s", "le": 1.0,
                           "objective": 0.99, "window": "300s",
                           "factor": 14.4}], registry, clock)
        for _ in range(100):
            hist.observe(0.1)
        engine.evaluate()  # baseline window edge
        clock.now += 30
        for _ in range(50):
            hist.observe(0.2)  # healthy traffic: no burn
        assert engine.evaluate() == []
        clock.now += 30
        for _ in range(20):
            hist.observe(3.0)  # 20 breaches / 20 obs = 100x allowed 1%
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["value"] > 14.4

    def test_slo_le_must_match_a_bucket_bound(self):
        registry = obs_metrics.MetricsRegistry()
        registry.histogram("tick_s", "", buckets=(0.5, 1.0)).observe(0.1)
        engine = _engine([{"id": "burn", "kind": "slo_burn_rate",
                           "metric": "tick_s", "le": 0.7,
                           "objective": 0.99, "window": "60s"}],
                         registry, _FakeClock())
        engine.evaluate()
        engine.evaluate()
        assert engine.active() == []  # no matching bucket → no data

    def test_missing_metric_is_not_a_breach(self):
        engine = _engine([{"id": "x", "kind": "threshold",
                           "metric": "never_registered", "op": ">",
                           "value": 0}],
                         obs_metrics.MetricsRegistry(), _FakeClock())
        assert engine.evaluate() == []
        assert engine.active() == []

    def test_overlap_regression_fires_then_resolves(self):
        """The COMMITTED overlap-regression rule fires when a
        `perf --audit` publishes an fsdp overlap ratio below the
        budgets.json floor, holds through hysteresis, and resolves once
        a re-measurement recovers — and the gauge being UNSET (no audit
        has run in this process) never breaches, so serving hosts that
        never compile the training schedules stay silent."""
        (rule,) = [r for r in obs_rules.check_ruleset()
                   if r.id == "overlap-regression"]
        # The rule's floor mirrors budgets.json — drift between the two
        # would let the alert disagree with the CI gate.
        from polyaxon_tpu.perf import budgets as perf_budgets
        floors = perf_budgets.load_budgets()["_overlap"]["min_overlap_ratio"]
        assert rule.value == floors["fsdp"]
        assert rule.labels == {"schedule": "fsdp"}

        # Cold start: registered but never set → no data → no breach.
        registry = obs_metrics.MetricsRegistry()
        obs_metrics.ensure_perf_metrics(registry)
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([rule], registry=registry,
                                       clock=clock)
        assert engine.evaluate() == []
        assert engine.active() == []

        gauge = obs_metrics.perf_overlap_ratio(registry)
        # A different schedule's measurement must not satisfy (or
        # breach) the fsdp-labeled rule.
        gauge.set(0.0, schedule="dp")
        assert engine.evaluate() == []

        gauge.set(0.0444, schedule="fsdp")  # healthy measured ratio
        assert engine.evaluate() == []
        clock.now += 30

        gauge.set(0.0, schedule="fsdp")  # scheduler deopt: serialized
        assert engine.evaluate() == []  # pending, `for` = 5s
        clock.now += 6
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "overlap-regression"
        assert fired["value"] < rule.value
        assert engine.active()

        gauge.set(0.0444, schedule="fsdp")  # knob restored, re-audited
        assert engine.evaluate() == []  # clear; hysteresis holds
        assert engine.active()
        clock.now += 20  # past resolve_after = 15s
        (resolved,) = engine.evaluate()
        assert resolved["event"] == "resolved"
        assert resolved["rule"] == "overlap-regression"
        assert engine.active() == []
        assert [e["event"] for e in engine.history] == [
            "fired", "resolved"]

    def test_decode_tpot_interference_fires_then_resolves(self):
        """The COMMITTED decode-tpot-interference rule is the
        alerting half of the lane split — it burns when consecutive
        decode steps drift past the 500ms SLO bucket (prefill work
        occupying decode ticks), and resolves once the lane scheduler
        (or an operator turning the budget knobs) restores cadence."""
        (rule,) = [r for r in obs_rules.check_ruleset()
                   if r.id == "decode-tpot-interference"]
        assert rule.kind == "slo_burn_rate"
        assert rule.le == 0.5  # the docs' 500ms decode-gap objective

        registry = obs_metrics.MetricsRegistry()
        obs_metrics.ensure_serving_metrics(registry)
        hist = obs_metrics.serving_decode_tpot_hist(registry)
        clock = _FakeClock()
        engine = obs_rules.AlertEngine([rule], registry=registry,
                                       clock=clock)
        # Cold start: registered but never observed → no data, silent.
        assert engine.evaluate() == []

        for _ in range(100):
            hist.observe(0.02)  # healthy decode cadence
        engine.evaluate()  # baseline window edge
        clock.now += 30
        for _ in range(50):
            hist.observe(0.05)
        assert engine.evaluate() == []  # within budget: no burn

        clock.now += 30
        # A prompt storm starves decode ticks: most in-window steps
        # breach the 500ms bucket — far past the 30% burn the 5%%
        # budget x factor 6 allows.
        for _ in range(100):
            hist.observe(2.0)
        (fired,) = engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "decode-tpot-interference"
        assert fired["value"] > rule.value  # burn multiple > factor 6
        assert engine.active()

        # Lane budgets restored: cadence recovers, the breach window
        # slides out, and hysteresis (resolve_after=30s) holds before
        # the resolve lands.
        clock.now += 61  # breach sample ages out of the 60s window
        for _ in range(200):
            hist.observe(0.02)
        assert engine.evaluate() == []  # clear; resolve clock starts
        clock.now += 31
        for _ in range(50):
            hist.observe(0.02)
        (resolved,) = engine.evaluate()
        assert resolved["event"] == "resolved"
        assert resolved["rule"] == "decode-tpot-interference"
        assert engine.active() == []
        assert [e["event"] for e in engine.history] == [
            "fired", "resolved"]


class TestReportUnit:
    def _timeline(self):
        def span(name, sid, start, end, parent=None, attrs=None,
                 events=None):
            return {"type": "span", "name": name, "span_id": sid,
                    "parent_id": parent, "trace_id": "r", "start": start,
                    "end": end, "duration_ms": (end - start) * 1e3,
                    "status": "ok", "attributes": attrs or {},
                    "events": events or []}

        records = [
            span("compile", "c", 0.0, 0.1),
            span("execute", "x", 0.5, 10.0),
            span("init", "i", 0.5, 1.0, parent="x",
                 events=[{"name": "chaos.store", "time": 0.6},
                         {"name": "retry", "time": 0.7}]),
            span("runtime", "r", 1.0, 10.0, parent="x"),
            span("jit_compile", "j", 1.0, 3.0, parent="r"),
            span("restore", "re", 3.0, 3.5, parent="r"),
        ]
        t = 3.5
        for k in range(6):
            step_ms = 900.0 if k != 4 else 4000.0  # window 4 spikes
            dur = 1.0 if k != 4 else 1.0
            records.append(span(
                "step", f"s{k}", t, t + dur, parent="r",
                attrs={"from_step": k * 2, "to_step": k * 2 + 1, "steps": 2,
                       "step_time_ms": step_ms, "input_wait_ms": 100.0}))
            t += dur
        records.append(span("checkpoint", "k", t, t + 0.4, parent="r"))
        records.append(span("sync", "sy", 10.2, 10.5))
        records.append({"type": "event", "name": "requeue", "time": 0.4,
                        "parent_id": None,
                        "attributes": {"reason": "RestartPolicy"}})
        return obs_trace.build_timeline(records, trace_id="r")

    def test_phase_decomposition_sums_to_wall(self):
        report = obs_analyze.analyze_timeline(self._timeline())
        assert report["run_uuid"] == "r"
        phases = report["phases"]
        assert phases["compile"]["ms"] == pytest.approx(100.0)
        assert phases["jit_compile"]["ms"] == pytest.approx(2000.0)
        assert phases["restore"]["ms"] == pytest.approx(500.0)
        assert phases["init"]["ms"] == pytest.approx(500.0)
        assert phases["checkpoint"]["ms"] == pytest.approx(400.0)
        assert phases["sync"]["ms"] == pytest.approx(300.0)
        # 6 step windows x (1000ms span - 200ms input wait).
        assert phases["step"]["ms"] == pytest.approx(4800.0)
        assert phases["input_wait"]["ms"] == pytest.approx(1200.0)
        assert phases["queue_wait"]["ms"] == pytest.approx(400.0)
        # Containers are frames, not phases.
        assert "execute" not in phases and "runtime" not in phases
        wall = report["wall_clock_ms"]
        assert abs(report["phase_sum_ms"] - wall) / wall < 0.10
        fractions = [p["fraction"] for p in phases.values()]
        assert all(f is not None and 0 <= f <= 1 for f in fractions)

    def test_step_trend_flags_the_spike(self):
        report = obs_analyze.analyze_timeline(self._timeline())
        steps = report["steps"]
        assert len(steps["windows"]) == 6
        assert steps["rolling_median_ms"] == pytest.approx(900.0)
        (anom,) = steps["anomalies"]
        assert anom["to_step"] == 9  # the spiked window
        assert anom["step_time_ms"] == pytest.approx(4000.0)
        assert anom["deviation_sigmas"] > 3.5

    def test_annotations_counted_per_phase(self):
        report = obs_analyze.analyze_timeline(self._timeline())
        notes = report["annotations"]
        assert notes["retries"] == {"init": 1}
        assert notes["chaos"] == {"init": 1}
        assert notes["requeues"] == {"RestartPolicy": 1}

    def test_resize_spans_attributed_to_resize_phase(self):
        """Elastic resize windows are a first-class phase:
        their wall time must land under ``resize``, not ``other``."""
        def span(name, sid, start, end, parent=None, attrs=None):
            return {"type": "span", "name": name, "span_id": sid,
                    "parent_id": parent, "trace_id": "r", "start": start,
                    "end": end, "duration_ms": (end - start) * 1e3,
                    "status": "ok", "attributes": attrs or {}, "events": []}

        records = [
            span("execute", "x", 0.0, 10.0),
            span("runtime", "r", 0.0, 10.0, parent="x"),
            span("resize", "z1", 4.0, 4.6, parent="r",
                 attrs={"direction": "shrink", "outcome": "ok",
                        "from_devices": 8, "to_devices": 4}),
            span("resize", "z2", 7.0, 7.4, parent="r",
                 attrs={"direction": "grow", "outcome": "ok",
                        "from_devices": 4, "to_devices": 8}),
        ]
        report = obs_analyze.analyze_timeline(
            obs_trace.build_timeline(records, trace_id="r"))
        assert report["phases"]["resize"]["ms"] == pytest.approx(1000.0)
        assert report["phases"]["resize"]["count"] == 2
        # The resize wall is accounted: `other` holds only the genuinely
        # uncovered remainder of the 10s, not the resize windows.
        assert report["phases"]["other"]["ms"] == pytest.approx(9000.0)

    def test_empty_timeline_reports_cleanly(self):
        report = obs_analyze.analyze_timeline(
            obs_trace.build_timeline([], trace_id="r"))
        assert report["wall_clock_ms"] == 0.0
        assert report["attempts"] == 0
        assert report["steps"]["anomalies"] == []

    def test_compact_report_shape(self):
        compact = obs_analyze.compact_report(
            obs_analyze.analyze_timeline(self._timeline()))
        assert compact["anomalous_windows"] == 1
        assert compact["phases_ms"]["step"] > 0
        json.dumps(compact)  # the JSON-line contract


# ===================================================== serving drill
def _get_alerts(url):
    with urllib.request.urlopen(url + "/alerts", timeout=30) as resp:
        assert resp.status == 200
        return json.load(resp)


class TestServingObsDrill:
    """The committed serving rules, evaluated against the global
    registry the port's engine records into, fire under induced queue
    saturation and resolve once the window slides past the bad epoch;
    the episode is read over the port server's ``GET /alerts``."""

    def test_alerts_endpoint_serves_the_committed_rules(self):
        from polyaxon_tpu_torch.obs import rules as torch_rules
        from polyaxon_tpu_torch.serving.server import ServingServer

        torch_rules.set_default_engine(None)
        try:
            with ServingServer("llama_tiny", seed=0, device="cpu") as s:
                out = _get_alerts(s.url)
        finally:
            torch_rules.set_default_engine(None)
        ids = sorted(r["rule"] for r in out["rules"])
        assert ids == sorted(r.id for r in torch_rules.load_ruleset())
        assert len(ids) == 18
        assert all(r["state"] in ("inactive", "pending", "firing")
                   for r in out["rules"])

    def test_ttft_burn_fires_under_saturation_then_resolves(self):
        """The reference's drill on the port's continuous engine behind
        its HTTP server: one slot, a decode step slowed to about 60 ms
        and ten queued requests push most TTFTs past the 500 ms
        objective; the clock-injected default engine that ``GET
        /alerts`` evaluates fires, holds through hysteresis, and
        resolves."""
        from polyaxon_tpu_torch.obs import metrics as torch_metrics
        from polyaxon_tpu_torch.obs import rules as torch_rules
        from polyaxon_tpu_torch.serving.server import ServingServer

        (rule,) = [r for r in torch_rules.check_ruleset()
                   if r.id == "serving-ttft-slo-burn"]
        clock = _FakeClock()
        torch_rules.set_default_engine(torch_rules.AlertEngine(
            [rule], registry=torch_metrics.REGISTRY, clock=clock))
        try:
            with ServingServer("llama_tiny", seed=0, device="cpu",
                               batching="continuous", slots=1) as s:
                engine = s.engine
                prompt = [5, 6, 7, 8, 9, 10]
                engine.submit(prompt, 2).wait(timeout=600)
                assert _get_alerts(s.url)["alerts"] == []  # baseline

                real = engine._decode_logits

                def slow():
                    time.sleep(0.06)
                    return real()

                engine._decode_logits = slow
                reqs = [engine.submit(prompt, 3) for _ in range(10)]
                for req in reqs:
                    req.wait(timeout=600)

                clock.now += 30
                (fired,) = _get_alerts(s.url)["alerts"]
                assert fired["rule"] == "serving-ttft-slo-burn"
                assert fired["state"] == "firing"
                assert fired["value"] > 6.0  # burning faster than factor

                engine._decode_logits = real
                for _ in range(12):
                    engine.submit(prompt, 2).wait(timeout=600)
                clock.now += 65
                assert _get_alerts(s.url)["alerts"]  # clear, held
                clock.now += 35
                out = _get_alerts(s.url)
                assert out["alerts"] == []
                assert [e["event"] for e in out["history"]] == [
                    "fired", "resolved"]
        finally:
            torch_rules.set_default_engine(None)

    def test_prefix_hit_collapse_fires_then_resolves(self):
        """The COMMITTED serving-prefix-hit-collapse rule
        fires when the radix hit-rate gauge collapses below 10%, holds
        through hysteresis, and resolves once the cache re-warms — and
        an UNSET gauge (cold start, before the engine has served its
        minimum admission window) never breaches a `<` rule."""
        (rule,) = [r for r in obs_rules.check_ruleset()
                   if r.id == "serving-prefix-hit-collapse"]

        # Cold start: the gauge does not exist yet → no breach. This is
        # why the engine only sets it after _hit_window_min admissions.
        cold = obs_rules.AlertEngine(
            [rule], registry=obs_metrics.MetricsRegistry(),
            clock=_FakeClock())
        assert cold.evaluate() == []
        assert cold.active() == []

        clock = _FakeClock()
        alert_engine = obs_rules.AlertEngine(
            [rule], registry=obs_metrics.REGISTRY, clock=clock)
        obs_metrics.ensure_serving_metrics()
        gauge = obs_metrics.serving_prefix_hit_rate()

        gauge.set(0.62)  # healthy: most prefill tokens served cached
        assert alert_engine.evaluate() == []
        clock.now += 30

        gauge.set(0.02)  # collapse: tree invalidated / workload shift
        assert alert_engine.evaluate() == []  # pending, `for` = 5s
        clock.now += 6
        (fired,) = alert_engine.evaluate()
        assert fired["event"] == "fired"
        assert fired["rule"] == "serving-prefix-hit-collapse"
        assert fired["value"] < 0.1
        assert alert_engine.active()

        gauge.set(0.55)  # the cache re-warmed
        assert alert_engine.evaluate() == []  # clear; hysteresis holds
        assert alert_engine.active()
        clock.now += 20  # past resolve_after = 15s
        (resolved,) = alert_engine.evaluate()
        assert resolved["event"] == "resolved"
        assert resolved["rule"] == "serving-prefix-hit-collapse"
        assert alert_engine.active() == []
        assert [e["event"] for e in alert_engine.history] == [
            "fired", "resolved"]


# ===================================================== fleet telemetry
class TestFleetTelemetry:
    """The oracle and rules cases of ``tests/test_fleet_telemetry.py``
    on twins, and the port fleet's autoscaler fed from the port's alert
    engine."""

    def test_oracle_selection_merges_scoped_series(self):
        """The metric_during judgment path: a labels selector that
        doesn't name the component merges every replica's sample into
        one federated histogram."""
        reg = obs_metrics.MetricsRegistry()
        for comp, v in (("r0", 0.1), ("r1", 0.3)):
            for _ in range(4):
                obs_metrics.serving_ttft_hist(
                    reg.scoped(comp)).observe(v, **{"class": "interactive"})
        family = obs_metrics.serving_ttft_hist(reg).snapshot()
        sample = obs_oracle._select_series(
            family, {"class": "interactive"})
        assert sample["count"] == 8
        assert sample["sum"] == pytest.approx(1.6)

    def test_catalog_carries_fleet_telemetry_entries(self):
        rule_ids = {r.id for r in obs_rules.load_ruleset()}
        assert "fleet-replica-skew" in rule_ids
        assert "serving-ttft-slo-burn" in rule_ids
        inv_ids = {i.id for i in obs_oracle.load_invariants()}
        assert "serving-ttft-federated-during-scaleup" in inv_ids

    def test_fleet_scales_on_the_ports_firing_rules(self):
        """One replica's queue passes the committed ``fleet-replica-hot``
        bound: the port's alert engine fires it from the fleet's polled
        gauge, and ``maybe_scale`` given the engine's firing rule ids
        promotes the standby. Every scale-up id is a committed rule."""
        from polyaxon_tpu_torch.obs import rules as torch_rules
        from polyaxon_tpu_torch.serving.fleet import SCALE_UP_RULES
        from tests.test_torch_fleet import _fleet

        committed = torch_rules.load_ruleset()
        assert SCALE_UP_RULES <= {r.id for r in committed}
        (rule,) = [r for r in committed if r.id == "fleet-replica-hot"]
        now = [100.0]
        fleet, engines, reg = _fleet(clock=lambda: now[0])
        alerts = torch_rules.AlertEngine([rule], registry=reg,
                                         clock=_FakeClock())
        try:
            fleet.poll()
            assert alerts.evaluate() == []
            engines["r1"].queued = 12
            fleet.poll()
            (fired,) = alerts.evaluate()
            assert fired["rule"] == "fleet-replica-hot"
            assert fired["value"] == 12
            ev = fleet.maybe_scale({a["rule"] for a in alerts.active()})
            assert (ev["direction"], ev["mode"], ev["outcome"]) == (
                "up", "promote", "ok")
            assert fleet.router.replicas == {"r0", "r1", "r2"}
        finally:
            fleet.stop()
