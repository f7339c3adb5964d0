"""The port's metrics-history ring (``polyaxon_tpu_torch/obs/history.py``)
and the oracle's window-scoped kinds, held against the JAX package's.

The cases of ``tests/test_history.py`` from ``TestSampler`` through
``TestWindowSchemaGate``, each run on twins (``tests/torch_twin.py``):
every call goes to the JAX module and to the port's with the same
inputs and the same injected clock, every plain-data result must be
equal on both sides (exact JSON equality; a float to 1e-12 relative),
and the reference's assertions are then checked on the port's result.
The ring times its own sampling with ``time.perf_counter``; the
``_fixed_perf_clock`` fixture pins that clock, so the self-accounting
histogram is equal on both sides too.
"""

import time

import pytest

from tests.torch_twin import Twin, twin_modules

obs_history, obs_metrics, obs_oracle = twin_modules(
    "obs.history", "obs.metrics", "obs.oracle")
Invariant = obs_oracle.Invariant
OracleError = obs_oracle.OracleError
TelemetryBundle = obs_oracle.TelemetryBundle


@pytest.fixture(autouse=True)
def _fixed_perf_clock(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _inv(**kw) -> Invariant:
    kw.setdefault("id", "t")
    return Invariant.from_dict(kw)


def _one(invariant, bundle) -> dict:
    verdicts = obs_oracle.evaluate([invariant], bundle)
    assert len(verdicts) == 1
    return verdicts[0]


@pytest.fixture()
def registry():
    return obs_metrics.MetricsRegistry()


def _ring(registry, **kw):
    clock = FakeClock()
    kw.setdefault("cadence", 1.0)
    return obs_history.MetricsHistory(registry, clock=clock, **kw), clock


# ================================================================ sampler
class TestSampler:
    def test_unmoved_series_get_no_new_points(self, registry):
        hist, clock = _ring(registry)
        g = registry.gauge("g", "d")
        g.set(5.0)
        assert hist.sample() is True  # first-seen anchor
        clock.advance(1.0)
        assert hist.sample() is True  # a sampling pass ran...
        assert len(hist.points("g")) == 1  # ...but admitted nothing
        g.set(7.0)
        clock.advance(1.0)
        hist.sample()
        pts = hist.points("g")
        assert [p[1] for p in pts] == [5.0, 7.0]

    def test_cadence_gates_and_force_overrides(self, registry):
        hist, clock = _ring(registry, cadence=10.0)
        registry.counter("c", "d").inc()
        assert hist.sample() is True
        clock.advance(1.0)
        assert hist.sample() is False  # inside the cadence
        assert hist.sample(force=True) is True

    def test_backwards_clock_drops_the_sample(self, registry):
        hist, clock = _ring(registry)
        registry.gauge("g", "d").set(1.0)
        hist.sample()
        clock.advance(-5.0)
        assert hist.sample(force=True) is False
        assert hist.coverage()["samples"] == 1

    def test_counter_birth_is_anchored_absolute(self, registry):
        hist, clock = _ring(registry)
        c = registry.counter("c", "d")
        c.inc(3.0)
        hist.sample()
        (t, v), = hist.points("c")
        assert (t, v) == (clock.t, 3.0)

    def test_coarsening_thins_overflow_to_coarse_interval(self, registry):
        hist, clock = _ring(
            registry, cadence=1.0, recent_points=4, coarse_points=8,
            coarse_interval=2.0)
        g = registry.gauge("g", "d")
        for i in range(10):
            g.set(float(i))
            hist.sample()
            clock.advance(1.0)
        pts = hist.points("g")
        # recent ring keeps the full-cadence tail (last 4 samples);
        # everything older coarsened to one survivor per 2s interval.
        recent = [p[1] for p in pts[-4:]]
        assert recent == [6.0, 7.0, 8.0, 9.0]
        coarse = [p[1] for p in pts[:-4]]
        assert coarse == [0.0, 2.0, 4.0]  # every other 1s point survives
        assert hist.point_count() <= hist.max_points()

    def test_series_cap_refuses_and_counts_once(self, registry):
        hist, clock = _ring(registry, max_series=2)
        g = registry.gauge("g", "d", ("k",))
        for key in ("a", "b", "c"):
            g.set(1.0, k=key)
        hist.sample()
        clock.advance(1.0)
        g.set(2.0, k="c")
        hist.sample()  # refused series stays refused, counted once
        assert hist.series_count() == 2

        def refusals():
            snap = registry.snapshot()
            fam = snap["polyaxon_history_evictions_total"]["series"]
            return fam.get("series")

        # g/c plus the ring's own self-accounting families were refused
        # — each exactly once: further movement never recounts them.
        counted = refusals()
        assert counted >= 1
        clock.advance(1.0)
        g.set(3.0, k="c")
        hist.sample()
        assert refusals() == counted

    def test_memory_ceiling_holds_under_hammering(self, registry):
        hist, clock = _ring(
            registry, recent_points=3, coarse_points=2,
            coarse_interval=0.0, max_series=4)
        g = registry.gauge("g", "d", ("k",))
        for i in range(50):
            for key in ("a", "b", "c", "d", "e", "f"):
                g.set(float(i * 7 + hash(key) % 5), k=key)
            hist.sample()
            clock.advance(1.0)
        assert hist.series_count() <= 4
        assert hist.point_count() <= hist.max_points()
        assert hist.max_points() == 4 * (3 + 2)

    def test_window_markers_bounded_and_close_matches_open(self, registry):
        hist, clock = _ring(registry, max_windows=2)
        hist.mark_window("a", start=True)
        clock.advance(1.0)
        hist.mark_window("b", start=True)
        clock.advance(1.0)
        hist.mark_window("c", start=True)  # evicts "a"
        names = [w["name"] for w in hist.windows()]
        assert names == ["b", "c"]
        clock.advance(1.0)
        hist.mark_window("b", end=True)
        b = [w for w in hist.windows() if w["name"] == "b"][0]
        assert b["end"] == clock.t and b["start"] < b["end"]
        # closing what was never opened records a zero-length window,
        # not an exception (fail-open plane).
        hist.mark_window("ghost", end=True)
        ghost = [w for w in hist.windows() if w["name"] == "ghost"][0]
        assert ghost["start"] == ghost["end"]

    def test_sampler_is_fail_open(self):
        class Broken:
            def snapshot(self):
                raise RuntimeError("boom")

        hist = obs_history.MetricsHistory(Broken())
        assert hist.sample() is False  # counted, not raised


# ========================================================== windowed math
class TestWindowedMath:
    def test_value_at_carries_forward(self):
        pts = [[10.0, 1.0], [20.0, 2.0], [30.0, 3.0]]
        assert obs_history.value_at(pts, 5.0) is None
        assert obs_history.value_at(pts, 10.0) == 1.0
        assert obs_history.value_at(pts, 25.0) == 2.0
        assert obs_history.value_at(pts, 99.0) == 3.0

    def test_counter_delta_golden(self):
        pts = [[10.0, 4.0], [80.0, 10.0]]
        assert obs_history.windowed_counter_delta(pts, 70.0, 100.0) == 6.0
        # birth inside the window counts from zero
        assert obs_history.windowed_counter_delta(pts, 0.0, 15.0) == 4.0
        # before any point: nothing to judge
        assert obs_history.windowed_counter_delta(pts, 0.0, 5.0) is None

    def test_gauge_extent_includes_carry_in(self):
        pts = [[10.0, 5.0], [45.0, 9.0], [70.0, 1.0]]
        assert obs_history.windowed_gauge_extent(pts, 40.0, 60.0) == 9.0
        assert obs_history.windowed_gauge_extent(
            pts, 40.0, 60.0, agg="min") == 5.0  # the carry-in at 40
        assert obs_history.windowed_gauge_extent(
            pts, 40.0, 60.0, agg="last") == 9.0
        assert obs_history.windowed_gauge_extent(pts, 0.0, 5.0) is None

    def test_hist_sample_is_bucketwise_difference(self):
        pts = [
            [10.0, {"count": 2, "sum": 1.0, "buckets": {"1": 2, "+Inf": 0}}],
            [50.0, {"count": 6, "sum": 9.0, "buckets": {"1": 3, "+Inf": 3}}],
        ]
        sample = obs_history.windowed_hist_sample(pts, 40.0, 60.0)
        assert sample == {"count": 4, "sum": 8.0,
                          "buckets": {"1": 1, "+Inf": 3}}
        assert obs_history.windowed_hist_sample(pts, 0.0, 5.0) is None

    def test_slo_counts_need_a_matching_bound(self):
        sample = {"count": 10, "sum": 5.0, "buckets": {"1": 9, "+Inf": 1}}
        assert obs_history.sample_slo_counts(sample, 1.0) == (9.0, 10.0)
        assert obs_history.sample_slo_counts(sample, 0.5) is None

    def test_query_history_scopes_and_prepends_carry(self, registry):
        hist, clock = _ring(registry)
        g = registry.gauge("g", "d", ("k",))
        for v in (1.0, 4.0, 9.0):
            g.set(v, k="x")
            hist.sample()
            clock.advance(10.0)
        hist.mark_window("storm", start=True)
        clock.advance(1.0)
        g.set(2.0, k="x")
        hist.sample()
        hist.mark_window("storm", end=True)
        out = obs_history.query_history(
            hist.to_json(), name="g", window="storm", labels={"k": "x"})
        pts = out["metric"]["series"]["x"]
        # carry-in (9.0, restamped at scope start) + the in-window point
        assert [p[1] for p in pts] == [9.0, 2.0]
        assert pts[0][0] == out["scope"]["start"]
        catalog = obs_history.query_history(hist.to_json())
        assert "g" in catalog["metrics"]
        with pytest.raises(ValueError, match="no sampled series"):
            obs_history.query_history(hist.to_json(), name="nope")
        with pytest.raises(ValueError, match="neither a marked window"):
            obs_history.query_history(hist.to_json(), name="g",
                                      window="bogus$")


# =========================================================== during kinds
def _day_history() -> dict:
    """A hand-built day: one gauge, one counter, one histogram, the
    project-quota pair, and a marked storm window [40, 60]."""
    return {
        "cadence": 1.0,
        "coverage": {"start": 0.0, "end": 100.0, "samples": 100},
        "windows": [{"name": "storm", "start": 40.0, "end": 60.0}],
        "series": {
            "queue_depth": {
                "type": "gauge", "labels": ["queue"],
                "series": {"prod": [[10.0, 5.0], [45.0, 9.0], [70.0, 1.0]]},
            },
            "requeues_total": {
                "type": "counter", "labels": [],
                "series": {"": [[10.0, 4.0], [80.0, 10.0]]},
            },
            "ttft": {
                "type": "histogram", "labels": ["class"],
                "series": {"interactive": [
                    [10.0, {"count": 2, "sum": 1.0,
                            "buckets": {"1": 2, "2.5": 0, "+Inf": 0}}],
                    [50.0, {"count": 6, "sum": 9.0,
                            "buckets": {"1": 5, "2.5": 1, "+Inf": 0}}],
                ]},
            },
            "polyaxon_project_usage": {
                "type": "gauge", "labels": ["project", "resource"],
                "series": {
                    "research,runs": [[10.0, 1.0], [45.0, 3.0], [70.0, 1.0]],
                    "platform,runs": [[10.0, 2.0]],
                },
            },
            "polyaxon_project_quota_limit": {
                "type": "gauge", "labels": ["project", "resource"],
                "series": {
                    "research,runs": [[5.0, 2.0]],
                    "platform,runs": [[5.0, 0.0]],  # 0 = unlimited
                },
            },
        },
    }


class TestMetricDuring:
    def test_gauge_max_over_window_includes_carry_in(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="metric_during", metric="queue_depth",
                      labels={"queue": "prod"}, window="storm",
                      op="<=", value=8.0), bundle)
        assert v["verdict"] == "fail"
        assert v["evidence"]["observed"] == 9.0
        assert v["evidence"]["agg"] == "max"
        assert v["evidence"]["scope"] == {"window": "storm",
                                          "start": 40.0, "end": 60.0}

    def test_gauge_agg_min_and_last(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="metric_during", metric="queue_depth",
                      labels={"queue": "prod"}, window="storm",
                      agg="min", op=">=", value=5.0), bundle)
        assert v["verdict"] == "pass"
        assert v["evidence"]["observed"] == 5.0  # the carry-in at 40
        v = _one(_inv(kind="metric_during", metric="queue_depth",
                      labels={"queue": "prod"}, window="storm",
                      agg="last", op="<=", value=9.0), bundle)
        assert v["verdict"] == "pass"

    def test_counter_delta_over_trailing_span(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="metric_during", metric="requeues_total",
                      span="30s", op="<=", value=5.0), bundle)
        # trailing scope [70, 100]: carry 4 at 70 → 10 at 80 = delta 6
        assert v["verdict"] == "fail"
        assert v["evidence"]["observed"] == 6.0
        assert v["evidence"]["scope"] == {"span": 30.0,
                                          "start": 70.0, "end": 100.0}

    def test_histogram_quantile_inside_window(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="metric_during", metric="ttft",
                      labels={"class": "interactive"}, window="storm",
                      quantile=0.99, op="<=", value=2.5), bundle)
        # in-window distribution: buckets {1: 3, 2.5: 1, +Inf: 0}
        assert v["verdict"] == "pass"
        assert v["evidence"]["quantile"] == 0.99
        assert 1.0 <= v["evidence"]["observed"] <= 2.5

    def test_missing_policies(self):
        bundle = TelemetryBundle(history=_day_history())
        quiet = _inv(kind="metric_during", metric="never_sampled",
                     window="storm", op="<=", value=1.0)
        assert _one(quiet, bundle)["verdict"] == "skip"
        hard = _inv(kind="metric_during", metric="never_sampled",
                    window="storm", op="<=", value=1.0, missing="fail")
        assert _one(hard, bundle)["verdict"] == "fail"
        zero = _inv(kind="metric_during", metric="never_sampled",
                    window="storm", op="<=", value=1.0, missing="zero")
        v = _one(zero, bundle)
        assert v["verdict"] == "pass" and v["evidence"]["observed"] == 0.0
        no_window = _inv(kind="metric_during", metric="queue_depth",
                         window="unmarked", op="<=", value=1.0)
        v = _one(no_window, bundle)
        assert v["verdict"] == "skip"
        assert "no window 'unmarked'" in v["evidence"]["missing"]
        no_hist = _inv(kind="metric_during", metric="queue_depth",
                       window="storm", op="<=", value=1.0)
        assert _one(no_hist, TelemetryBundle())["verdict"] == "skip"


class TestSloDuring:
    def test_windowed_ratio_against_objective(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="slo_during", metric="ttft", le=1.0,
                      objective=0.75, window="storm"), bundle)
        # in-window: good(≤1)=3 of 4 → 0.75 meets the objective
        assert v["verdict"] == "pass"
        assert v["evidence"]["good"] == 3
        assert v["evidence"]["total"] == 4
        assert v["evidence"]["ratio"] == 0.75
        v = _one(_inv(kind="slo_during", metric="ttft", le=1.0,
                      objective=0.9, window="storm"), bundle)
        assert v["verdict"] == "fail"

    def test_le_must_be_a_bucket_bound(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="slo_during", metric="ttft", le=0.7,
                      objective=0.9, window="storm"), bundle)
        assert v["verdict"] == "skip"
        assert "not a bucket bound" in v["evidence"]["missing"]

    def test_empty_window_is_missing_not_perfect(self):
        hist = _day_history()
        hist["windows"].append({"name": "calm", "start": 0.0, "end": 5.0})
        bundle = TelemetryBundle(history=hist)
        v = _one(_inv(kind="slo_during", metric="ttft", le=1.0,
                      objective=0.9, window="calm"), bundle)
        assert v["verdict"] == "skip"
        assert "no observations" in v["evidence"]["missing"]


class TestQuotaViolation:
    def test_breach_instant_fails_with_golden_evidence(self):
        bundle = TelemetryBundle(history=_day_history())
        v = _one(_inv(kind="quota_violation"), bundle)
        assert v["verdict"] == "fail"
        assert v["evidence"]["breaches"] == [
            {"series": "research,runs", "at": 45.0,
             "used": 3.0, "limit": 2.0}]
        assert v["evidence"]["breach_total"] == 1
        assert v["evidence"]["series_checked"] == 2
        assert v["evidence"]["instants_checked"] == 4

    def test_under_limit_and_unlimited_pass(self):
        hist = _day_history()
        usage = hist["series"]["polyaxon_project_usage"]["series"]
        usage["research,runs"] = [[10.0, 1.0], [45.0, 2.0]]  # at limit: ok
        usage["platform,runs"] = [[10.0, 50.0]]  # limit 0 = unlimited
        bundle = TelemetryBundle(history=hist)
        v = _one(_inv(kind="quota_violation"), bundle)
        assert v["verdict"] == "pass"

    def test_no_usage_samples_follows_missing_policy(self):
        hist = _day_history()
        del hist["series"]["polyaxon_project_usage"]
        bundle = TelemetryBundle(history=hist)
        assert _one(_inv(kind="quota_violation"), bundle)["verdict"] == "skip"
        assert _one(_inv(kind="quota_violation", missing="fail"),
                    bundle)["verdict"] == "fail"


# ============================================================ schema gate
class TestWindowSchemaGate:
    @pytest.mark.parametrize("bad,match", [
        (dict(kind="metric_during", metric="m", op="<=", value=1.0),
         "exactly one of"),
        (dict(kind="metric_during", metric="m", op="<=", value=1.0,
              window="storm", span="5m"), "exactly one of"),
        (dict(kind="metric_during", metric="m", op="<=", value=1.0,
              span="bogus$"), "span"),
        (dict(kind="metric_during", metric="m", op="<=", value=1.0,
              window=""), "window"),
        (dict(kind="metric_during", metric="m", op="<=", value=1.0,
              window="storm", agg="p99"), "agg"),
        (dict(kind="metric", metric="m", op="<=", value=1.0,
              window="storm"), "only apply to"),
        (dict(kind="run_terminal", span="5m"), "only apply to"),
        (dict(kind="slo_during", metric="m", le=1.0, objective=0.9),
         "exactly one of"),
    ])
    def test_bad_window_specs_raise(self, bad, match):
        bad.setdefault("id", "t")
        with pytest.raises(OracleError, match=match):
            Invariant.from_dict(bad)

    def test_span_strings_parse_to_seconds(self):
        inv = _inv(kind="metric_during", metric="m", op="<=", value=1.0,
                   span="5m")
        assert inv.span == 300.0
        assert inv.window is None
