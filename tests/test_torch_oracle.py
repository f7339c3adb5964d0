"""The port's telemetry oracle (``polyaxon_tpu_torch/obs/oracle.py`` and
``oracle.json``), held against the JAX package's.

The cases of ``tests/test_oracle.py`` from ``TestInvariantSchema``
through ``TestOracleRulesInterplay`` run on twins
(``tests/torch_twin.py``): the same ``TelemetryBundle`` (runs, reports,
registry snapshots, alert state) goes to both packages' ``evaluate``,
the verdicts and their evidence must be equal (exact JSON equality; a
float to 1e-12 relative), and the reference's assertions are checked on
the port's. ``TestRingDump`` runs on each package in turn (its spans
carry wall-clock times); its replay case needs the fleet simulator,
which the port does not have (ROADMAP.md, Queue 1 item 12).
"""

import json
import os
import time

import pytest

from tests.torch_twin import twin_modules

obs_metrics, obs_oracle, obs_rules = twin_modules(
    "obs.metrics", "obs.oracle", "obs.rules")
Invariant = obs_oracle.Invariant
OracleError = obs_oracle.OracleError
TelemetryBundle = obs_oracle.TelemetryBundle


@pytest.fixture(autouse=True)
def _fixed_perf_clock(monkeypatch):
    """The history ring times its sampling with ``time.perf_counter``:
    pinned, so its self-accounting series are equal on both sides."""
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)


def _inv(**kw) -> Invariant:
    kw.setdefault("id", "t")
    return Invariant.from_dict(kw)


def _run(status="succeeded", uuid="u1", kind="job") -> dict:
    return {"uuid": uuid, "status": status, "kind": kind,
            "project": "platform", "name": None}


def _one(invariant, bundle) -> dict:
    verdicts = obs_oracle.evaluate([invariant], bundle)
    assert len(verdicts) == 1
    return verdicts[0]


# ================================================================= schema
class TestInvariantSchema:
    def test_committed_set_validates_and_covers_all_kinds(self):
        invariants = obs_oracle.check_invariants()
        ids = [i.id for i in invariants]
        assert len(ids) == len(set(ids))
        assert "all-runs-terminal" in ids
        assert "zero-unresolved-alerts" in ids
        assert {i.kind for i in invariants} == set(obs_oracle.KINDS)

    @pytest.mark.parametrize("bad,match", [
        ({"invariants": [{"id": "x", "kind": "nope"}]}, "unknown kind"),
        ({"invariants": [{"kind": "run_terminal"}]}, "string `id`"),
        ({"invariants": [{"id": "x", "kind": "metric",
                          "metric": "polyaxon_runs", "value": 1,
                          "op": "!="}]}, "unknown op"),
        ({"invariants": [{"id": "x", "kind": "metric",
                          "metric": "polyaxon_runs"}]}, "needs a `value`"),
        ({"invariants": [{"id": "x", "kind": "metric",
                          "metric": "polyaxon_runs", "value": 1,
                          "quantile": 1.5}]}, "outside"),
        ({"invariants": [{"id": "x", "kind": "slo",
                          "metric": "polyaxon_scheduler_tick_seconds",
                          "le": 1.0}]}, "needs `le` and `objective`"),
        ({"invariants": [{"id": "x", "kind": "slo",
                          "metric": "polyaxon_scheduler_tick_seconds",
                          "le": 1.0, "objective": 0.0}]}, "objective"),
        ({"invariants": [{"id": "x", "kind": "run_terminal",
                          "allow": ["definitely-not-a-status"]}]},
         "unknown statuses"),
        ({"invariants": [{"id": "x", "kind": "run_terminal",
                          "missing": "explode"}]}, "missing policy"),
    ])
    def test_malformed_invariants_raise(self, bad, match):
        with pytest.raises(OracleError, match=match):
            obs_oracle.load_invariants(bad)

    def test_duplicate_ids_raise(self):
        with pytest.raises(OracleError, match="duplicate"):
            obs_oracle.load_invariants({"invariants": [
                {"id": "x", "kind": "run_terminal"},
                {"id": "x", "kind": "alerts_resolved"}]})

    def test_unknown_metric_fails_the_gate(self):
        with pytest.raises(OracleError, match="unknown metric"):
            obs_oracle.load_invariants({"invariants": [
                {"id": "x", "kind": "metric",
                 "metric": "polyaxon_made_up_total", "value": 0}]})

    def test_check_cli_exit_codes(self, tmp_path):
        assert obs_oracle._main(["--check"]) == 0
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"invariants": [
            {"id": "x", "kind": "metric",
             "metric": "polyaxon_made_up_total", "value": 0}]}))
        assert obs_oracle._main(["--check", str(bad)]) == 1


# =========================================================== run_terminal
class TestRunTerminal:
    def test_all_terminal_passes_with_status_census(self):
        bundle = TelemetryBundle(runs=[_run("succeeded"),
                                       _run("failed", "u2")])
        v = _one(_inv(kind="run_terminal"), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["status_counts"] == {"succeeded": 1,
                                                  "failed": 1}

    def test_stuck_run_fails_with_offender_attached(self):
        bundle = TelemetryBundle(runs=[_run("succeeded"),
                                       _run("queued", "u2")])
        v = _one(_inv(kind="run_terminal"), bundle)
        assert v["verdict"] == "fail"
        assert v["evidence"]["offending_runs"] == [
            {"uuid": "u2", "status": "queued", "kind": "job",
             "project": "platform"}]

    def test_forbid_list_trumps_allow(self):
        bundle = TelemetryBundle(runs=[_run("failed")])
        v = _one(_inv(kind="run_terminal", forbid=["failed"]), bundle)
        assert v["verdict"] == "fail"

    def test_allow_list_narrows_terminal(self):
        bundle = TelemetryBundle(runs=[_run("failed")])
        v = _one(_inv(kind="run_terminal", allow=["succeeded"]), bundle)
        assert v["verdict"] == "fail"

    def test_missing_policy(self):
        empty = TelemetryBundle()
        assert _one(_inv(kind="run_terminal"), empty)["verdict"] == "skip"
        assert _one(_inv(kind="run_terminal", missing="fail"),
                    empty)["verdict"] == "fail"


# =========================================================== phase_budget
class TestPhaseBudget:
    @staticmethod
    def _bundle(wall, phase_sum):
        return TelemetryBundle(reports={"u1": {
            "wall_clock_ms": wall, "phase_sum_ms": phase_sum,
            "phases": {"step": {"ms": phase_sum}}}})

    def test_accounting_within_tolerance_passes(self):
        v = _one(_inv(kind="phase_budget", tolerance=0.35),
                 self._bundle(1000.0, 900.0))
        assert v["verdict"] == "pass"
        assert v["evidence"]["reports_judged"] == 1

    def test_lost_time_fails_with_ratio_evidence(self):
        v = _one(_inv(kind="phase_budget", tolerance=0.35),
                 self._bundle(1000.0, 500.0))
        assert v["verdict"] == "fail"
        assert v["evidence"]["offending_reports"][0]["ratio"] == 0.5

    def test_no_reports_skips(self):
        v = _one(_inv(kind="phase_budget"), TelemetryBundle())
        assert v["verdict"] == "skip"


# ================================================================= metric
class TestMetricPredicates:
    @pytest.fixture()
    def reg(self):
        return obs_metrics.MetricsRegistry()

    def test_value_mode_with_label_selector(self, reg):
        obs_metrics.admission_outcomes(reg).inc(3, outcome="rejected")
        obs_metrics.admission_outcomes(reg).inc(9, outcome="admitted")
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="metric",
                      metric="polyaxon_admission_outcomes_total",
                      labels={"outcome": "rejected"}, op="<=", value=5),
                 bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["observed"] == 3.0

    def test_missing_zero_treats_absent_series_as_zero(self, reg):
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="metric",
                      metric="polyaxon_admission_live_divergence_total",
                      op="<=", value=0, missing="zero"), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["observed"] == 0.0

    def test_missing_skip_and_fail_policies(self, reg):
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        spec = dict(kind="metric", metric="polyaxon_requeues_total",
                    op="<=", value=0)
        assert _one(_inv(**spec), bundle)["verdict"] == "skip"
        assert _one(_inv(**spec, missing="fail"),
                    bundle)["verdict"] == "fail"

    def test_delta_mode_judges_movement_not_absolutes(self, reg):
        counter = obs_metrics.requeues_total(reg)
        counter.inc(100, reason="preempted")
        baseline = reg.snapshot()
        counter.inc(2, reason="preempted")
        bundle = TelemetryBundle(snapshot=reg.snapshot(),
                                 baseline=baseline)
        v = _one(_inv(kind="metric", metric="polyaxon_requeues_total",
                      labels={"reason": "preempted"}, mode="delta",
                      op="<=", value=5), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["observed"] == 2.0

    def test_delta_mode_without_baseline_skips(self, reg):
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="metric", metric="polyaxon_requeues_total",
                      mode="delta", op="<=", value=5), bundle)
        assert v["verdict"] == "skip"

    def test_quantile_golden_interpolates_in_bucket(self, reg):
        hist = obs_metrics.scheduler_tick_hist(reg)
        for _ in range(4):
            hist.observe(0.002)  # all land in the (0.001, 0.0025] bucket
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="metric",
                      metric="polyaxon_scheduler_tick_seconds",
                      quantile=0.5, op="<=", value=0.0025), bundle)
        assert v["verdict"] == "pass"
        # rank 2 of 4 inside [0.001, 0.0025): 0.001 + 0.0015 * 2/4
        assert v["evidence"]["observed"] == pytest.approx(0.00175)

    def test_threshold_flips_on_op(self, reg):
        obs_metrics.retry_attempts(reg).inc(7)
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        spec = dict(kind="metric", metric="polyaxon_retry_attempts_total",
                    value=5)
        assert _one(_inv(**spec, op="<="), bundle)["verdict"] == "fail"
        assert _one(_inv(**spec, op=">"), bundle)["verdict"] == "pass"


# ======================================================== loss_continuity
class TestLossContinuity:
    @staticmethod
    def _bundle(windows, restores=0):
        return TelemetryBundle(reports={"u1": {
            "steps": {"windows": windows},
            "phases": ({"restore": {"ms": 1.0, "count": restores}}
                       if restores else {})}})

    def test_contiguous_windows_pass(self):
        bundle = self._bundle([
            {"from_step": 1, "to_step": 50, "loss": 2.5},
            {"from_step": 51, "to_step": 100, "loss": 2.3}])
        v = _one(_inv(kind="loss_continuity"), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["runs_judged"] == 1

    def test_skipped_steps_fail_with_both_windows_attached(self):
        bundle = self._bundle([
            {"from_step": 1, "to_step": 50},
            {"from_step": 61, "to_step": 100}], restores=1)
        v = _one(_inv(kind="loss_continuity"), bundle)
        assert v["verdict"] == "fail"
        disc = v["evidence"]["discontinuities"][0]
        assert disc["problem"] == "skipped 10 step(s)"
        assert disc["window"]["to_step"] == 50
        assert disc["next_window"]["from_step"] == 61
        assert disc["restores"] == 1

    def test_max_gap_steps_allows_bounded_gaps(self):
        bundle = self._bundle([
            {"from_step": 1, "to_step": 50},
            {"from_step": 61, "to_step": 100}])
        v = _one(_inv(kind="loss_continuity", max_gap_steps=10), bundle)
        assert v["verdict"] == "pass"

    def test_loss_jump_across_boundary_fails(self):
        bundle = self._bundle([
            {"from_step": 1, "to_step": 50, "loss": 2.5},
            {"from_step": 51, "to_step": 100, "loss": 9.0}])
        v = _one(_inv(kind="loss_continuity", max_loss_jump=1.0), bundle)
        assert v["verdict"] == "fail"
        assert "loss jumped" in (
            v["evidence"]["discontinuities"][0]["problem"])

    def test_twice_resized_run_passes(self):
        """The elastic-gang golden: a run that shrank and
        regrew mid-train produces three mesh segments whose step windows
        stay contiguous and whose loss keeps descending — the oracle
        must certify that as continuity, resize phases and all."""
        bundle = TelemetryBundle(reports={"u1": {
            "steps": {"windows": [
                {"from_step": 1, "to_step": 4, "loss": 3.1},   # 8 devices
                {"from_step": 5, "to_step": 8, "loss": 2.7},   # 4 devices
                {"from_step": 9, "to_step": 12, "loss": 2.4},  # 8 again
            ]},
            "phases": {"resize": {"ms": 120.0, "count": 2},
                       "restore": {"ms": 40.0, "count": 2}}}})
        v = _one(_inv(kind="loss_continuity", max_loss_jump=1.0), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["runs_judged"] == 1

    def test_resize_boundary_gap_fails(self):
        """A resize that loses the batch pointer (window restarts past
        the saved step) is exactly what loss_continuity exists to catch."""
        bundle = TelemetryBundle(reports={"u1": {
            "steps": {"windows": [
                {"from_step": 1, "to_step": 4, "loss": 3.1},
                {"from_step": 7, "to_step": 10, "loss": 2.9},
            ]},
            "phases": {"resize": {"ms": 60.0, "count": 1}}}})
        v = _one(_inv(kind="loss_continuity"), bundle)
        assert v["verdict"] == "fail"
        assert v["evidence"]["discontinuities"][0]["problem"] == \
            "skipped 2 step(s)"

    def test_single_window_skips(self):
        bundle = self._bundle([{"from_step": 1, "to_step": 50}])
        assert _one(_inv(kind="loss_continuity"),
                    bundle)["verdict"] == "skip"


# ======================================================== alerts_resolved
class TestAlertsResolved:
    def test_firing_alert_fails_with_alert_attached(self):
        bundle = TelemetryBundle(alerts={
            "alerts": [{"rule": "retry-storm", "severity": "page"}],
            "rules": [], "history": []})
        v = _one(_inv(kind="alerts_resolved"), bundle)
        assert v["verdict"] == "fail"
        assert v["evidence"]["unresolved_alerts"][0]["rule"] == "retry-storm"

    def test_allowlisted_firing_alert_passes(self):
        bundle = TelemetryBundle(alerts={
            "alerts": [{"rule": "retry-storm"}], "rules": [],
            "history": []})
        v = _one(_inv(kind="alerts_resolved", allow=["retry-storm"]),
                 bundle)
        assert v["verdict"] == "pass"

    def test_resolved_history_passes_and_counts_the_episode(self):
        bundle = TelemetryBundle(alerts={
            "alerts": [], "rules": [],
            "history": [{"event": "fired", "rule": "r"},
                        {"event": "resolved", "rule": "r"}]})
        v = _one(_inv(kind="alerts_resolved"), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["fired_total"] == 1
        assert v["evidence"]["resolved_total"] == 1


# ==================================================================== slo
class TestSlo:
    @pytest.fixture()
    def reg(self):
        return obs_metrics.MetricsRegistry()

    def test_objective_met_passes_with_good_total_evidence(self, reg):
        hist = obs_metrics.serving_ttft_hist(reg)
        for _ in range(19):
            hist.observe(0.1, **{"class": "interactive"})
        hist.observe(9.0, **{"class": "interactive"})
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="slo", metric="polyaxon_serving_ttft_seconds",
                      labels={"class": "interactive"}, le=2.5,
                      objective=0.95), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"] == {
            "metric": "polyaxon_serving_ttft_seconds",
            "labels": {"class": "interactive"}, "le": 2.5,
            "objective": 0.95, "good": 19, "total": 20, "ratio": 0.95}

    def test_objective_missed_fails(self, reg):
        hist = obs_metrics.serving_ttft_hist(reg)
        hist.observe(0.1, **{"class": "interactive"})
        hist.observe(9.0, **{"class": "interactive"})
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="slo", metric="polyaxon_serving_ttft_seconds",
                      labels={"class": "interactive"}, le=2.5,
                      objective=0.95), bundle)
        assert v["verdict"] == "fail"

    def test_le_must_be_a_bucket_bound(self, reg):
        obs_metrics.serving_ttft_hist(reg).observe(
            0.1, **{"class": "interactive"})
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="slo", metric="polyaxon_serving_ttft_seconds",
                      le=3.14159, objective=0.5), bundle)
        assert v["verdict"] == "skip"
        assert "not a bucket bound" in v["evidence"]["missing"]

    def test_no_observations_skips(self, reg):
        obs_metrics.ensure_serving_metrics(reg)
        bundle = TelemetryBundle(snapshot=reg.snapshot())
        v = _one(_inv(kind="slo", metric="polyaxon_serving_ttft_seconds",
                      le=2.5, objective=0.5), bundle)
        assert v["verdict"] == "skip"


# ========================================================= snapshot_delta
class TestSnapshotDelta:
    def test_counter_gauge_histogram_deltas(self):
        reg = obs_metrics.MetricsRegistry()
        counter = obs_metrics.requeues_total(reg)
        gauge = reg.gauge("polyaxon_queue_depth", "", ("queue",))
        hist = obs_metrics.scheduler_tick_hist(reg)
        counter.inc(5, reason="preempted")
        gauge.set(10, queue="prod")
        hist.observe(0.01)
        baseline = reg.snapshot()
        counter.inc(2, reason="preempted")
        gauge.set(4, queue="prod")
        hist.observe(0.02)
        hist.observe(0.03)
        delta = reg.snapshot_delta(baseline)
        assert delta["absolute"] is False
        deltas = delta["deltas"]
        assert deltas["polyaxon_requeues_total"]["series"] == {
            "preempted": 2.0}
        assert deltas["polyaxon_queue_depth"]["series"] == {"prod": -6.0}
        hd = deltas["polyaxon_scheduler_tick_seconds"]["series"][""]
        assert hd["count"] == 2
        assert hd["sum"] == pytest.approx(0.05)

    def test_unchanged_series_are_omitted(self):
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.requeues_total(reg).inc(5, reason="preempted")
        baseline = reg.snapshot()
        delta = reg.snapshot_delta(baseline)
        assert delta == {"absolute": False, "deltas": {}}

    def test_no_baseline_returns_absolute_snapshot(self):
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.requeues_total(reg).inc(1, reason="x")
        delta = reg.snapshot_delta(None)
        assert delta["absolute"] is True
        assert "polyaxon_requeues_total" in delta["snapshot"]


# ==================================================== rules.py interplay
class _FakeClock:
    def __init__(self, start=1000.0):
        self.now = start

    def __call__(self):
        return self.now


class TestOracleRulesInterplay:
    """The zero-unresolved-alerts invariant against a REAL AlertEngine
    driving its fire→hysteresis→resolve state machine."""

    @staticmethod
    def _engine(reg, clock):
        rule = obs_rules.Rule.from_dict({
            "id": "queue-deep", "kind": "threshold",
            "metric": "polyaxon_queue_depth", "op": ">", "value": 100,
            "for": "0s", "description": "t"})
        return obs_rules.AlertEngine([rule], registry=reg, clock=clock)

    def test_fire_then_resolve_arc(self):
        reg = obs_metrics.MetricsRegistry()
        clock = _FakeClock()
        engine = self._engine(reg, clock)
        gauge = reg.gauge("polyaxon_queue_depth", "", ("queue",))
        inv = _inv(kind="alerts_resolved")

        gauge.set(500, queue="fleet")
        clock.now += 1
        engine.evaluate()
        v = _one(inv, TelemetryBundle(alerts=engine.to_json()))
        assert v["verdict"] == "fail"
        assert (v["evidence"]["unresolved_alerts"][0]["rule"]
                == "queue-deep")

        gauge.set(0, queue="fleet")
        for _ in range(5):  # ride out clear hysteresis
            clock.now += 60
            engine.evaluate()
        v = _one(inv, TelemetryBundle(alerts=engine.to_json()))
        assert v["verdict"] == "pass"
        assert v["evidence"]["fired_total"] == 1
        assert v["evidence"]["resolved_total"] == 1

    def test_history_eviction_is_counted_in_catalogued_metric(self):
        import collections

        reg = obs_metrics.MetricsRegistry()
        engine = self._engine(reg, _FakeClock())
        engine.history = collections.deque(maxlen=2)
        for i in range(5):
            engine._append_history({"event": "fired", "i": i})
        assert len(engine.history) == 2
        snap = reg.snapshot()["polyaxon_alert_history_evictions_total"]
        assert snap["series"][""] == 3
        assert ("polyaxon_alert_history_evictions_total"
                in obs_metrics.catalog_metric_names())


# ============================================================== ring dump
@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    import importlib

    root = "polyaxon_tpu" if request.param == "jax" else "polyaxon_tpu_torch"
    return {name: importlib.import_module(f"{root}.{mod}")
            for name, mod in (("reqtrace", "obs.reqtrace"),
                              ("metrics", "obs.metrics"),
                              ("trace", "obs.trace"),
                              ("batching", "serving.batching"))}


class TestRingDump:
    @staticmethod
    def _ring(reqtrace, n=3):
        ring = reqtrace.TimelineRing(capacity=8)
        for i, klass in zip(range(n), ("interactive", "batch",
                                       "best-effort")):
            trace = reqtrace.RequestTrace(f"req{i:04d}", klass=klass)
            trace.start_phase("queue_wait")
            trace.start_phase("decode")
            trace.finish("ok")
            ring.add(trace)
        return ring

    def test_dump_round_trip(self, pkg, tmp_path):
        reqtrace = pkg["reqtrace"]
        ring = self._ring(reqtrace)
        path = reqtrace.dump_ring(ring, str(tmp_path))
        assert os.path.basename(path) == reqtrace.TRACE_DUMP_FILE
        dump = reqtrace.read_ring_dump(str(tmp_path))
        assert dump["capacity"] == 8
        assert dump["evicted"] == 0
        assert [r["summary"]["request_id"] for r in dump["requests"]] == [
            "req0000", "req0001", "req0002"]
        # Full span records survive: build_timeline can reconstruct.
        timeline = pkg["trace"].build_timeline(
            dump["requests"][0]["records"], trace_id="req0000")
        assert timeline["spans"][0]["name"] == "request"

    def test_missing_or_corrupt_dump_reads_as_none(self, pkg, tmp_path):
        reqtrace = pkg["reqtrace"]
        assert reqtrace.read_ring_dump(str(tmp_path / "nope.json")) is None
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert reqtrace.read_ring_dump(str(bad)) is None

    def test_engine_stop_dumps_ring(self, pkg, tmp_path):
        """The batching engine's shutdown hook persists the ring and
        counts the dump — without standing up a device loop (the dump
        path is independent of the model)."""
        engine_cls = pkg["batching"].ContinuousBatchingEngine
        engine = engine_cls.__new__(engine_cls)
        engine.request_tracing = True
        engine.trace_dump_path = str(tmp_path / "ring.json")
        engine._ring = self._ring(pkg["reqtrace"])
        engine._dump_ring()
        dump = pkg["reqtrace"].read_ring_dump(engine.trace_dump_path)
        assert len(dump["requests"]) == 3
        snap = pkg["metrics"].REGISTRY.snapshot().get(
            "polyaxon_serving_trace_dumps_total")
        assert snap["series"].get("ok", 0) >= 1
