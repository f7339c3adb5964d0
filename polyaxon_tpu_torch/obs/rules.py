"""Declarative alert rules over the live metrics registry (port of
``polyaxon_tpu/obs/rules.py``, the same code under the port's module
names).

A committed ruleset (``obs/rules.json``, the port's own copy, equal to
the JAX package's) is evaluated against :data:`obs.metrics.REGISTRY` on
every agent reconcile pass and by the serving process's ``GET /alerts``;
where attributable, a firing rule stamps conditions and
``meta["alerts"]`` on the live runs it implicates.

Three rule kinds:

- ``threshold`` — instantaneous comparison of a gauge/counter value or
  a histogram quantile (``quantile: 0.99`` uses the interpolated
  ``Histogram.quantile``) against a static ``value``, or against a
  derived one (``value_from: {quantile, factor}`` — e.g. the default
  step-time-regression rule fires when p99 > 3×p50: the distribution
  grew a tail).
- ``rate`` — counter increase per second over a trailing ``window``,
  computed from the shared metrics-history ring (obs.history); each
  evaluation forces a history sample, so windows are exact at
  evaluation times (labeled counters sum across series). The
  retry-storm rule lives here.
- ``slo_burn_rate`` — Prometheus burn-rate alerting on a histogram SLO:
  ``objective`` of observations must land ≤ the ``le`` bucket bound;
  the rule fires when (window error-rate / allowed error-rate) exceeds
  ``factor``.

Hysteresis: ``for`` delays firing until the breach has held that long;
``resolve_after`` keeps a firing alert up until it has been clear that
long — a flapping signal produces one alert episode, not a storm of
them. Missing data (no samples yet) reads as NOT breaching.

Schema validation (``python -m polyaxon_tpu_torch.obs.rules --check``):
unknown metric names (checked against
``obs.metrics.catalog_metric_names``), malformed windows, duplicate
rule ids, bad kinds/ops all fail instead of shipping an alert that can
never fire.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from polyaxon_tpu_torch.obs import metrics as obs_metrics

DEFAULT_RULES_PATH = os.path.join(os.path.dirname(__file__), "rules.json")

_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_WINDOW_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s|m|h)$")
_WINDOW_UNITS = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


class RuleError(ValueError):
    """A rule spec that must not ship: CI's schema gate raises this."""


def parse_window(raw: Any, *, field_name: str = "window") -> float:
    """``"30s"``/``"5m"``/``"1h"`` (or a bare number of seconds) →
    seconds. Anything else is a :class:`RuleError` — a malformed window
    silently defaulting would disarm the alert."""
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        if raw < 0:
            raise RuleError(f"{field_name} must be >= 0, got {raw!r}")
        return float(raw)
    if isinstance(raw, str):
        match = _WINDOW_RE.match(raw.strip())
        if match:
            return float(match.group(1)) * _WINDOW_UNITS[match.group(2)]
    raise RuleError(
        f"malformed {field_name} {raw!r} (want e.g. \"30s\", \"5m\", \"1h\")")


@dataclass
class Rule:
    id: str
    kind: str  # threshold | rate | slo_burn_rate
    metric: str
    op: str = ">"
    value: Optional[float] = None
    # threshold-only: evaluate a histogram quantile instead of a value.
    quantile: Optional[float] = None
    # threshold-only: derive the threshold from the SAME histogram
    # (quantile(q) * factor) — relative rules like step-time regression.
    value_from: Optional[dict] = None
    labels: dict[str, str] = field(default_factory=dict)
    window: float = 60.0           # rate / slo_burn_rate lookback
    le: Optional[float] = None     # slo: the "good" latency bound
    objective: Optional[float] = None  # slo: good fraction target
    for_seconds: float = 0.0       # breach must hold this long to fire
    resolve_seconds: float = 0.0   # must be clear this long to resolve
    severity: str = "warn"         # warn | page
    annotate_runs: bool = False    # stamp live runs on fire
    description: str = ""

    @classmethod
    def from_dict(cls, data: dict) -> "Rule":
        if not isinstance(data, dict):
            raise RuleError(f"rule must be an object, got {type(data).__name__}")
        rule_id = data.get("id")
        if not rule_id or not isinstance(rule_id, str):
            raise RuleError(f"rule needs a string `id`, got {rule_id!r}")
        kind = data.get("kind")
        if kind not in ("threshold", "rate", "slo_burn_rate"):
            raise RuleError(f"rule {rule_id}: unknown kind {kind!r}")
        metric = data.get("metric")
        if not metric or not isinstance(metric, str):
            raise RuleError(f"rule {rule_id}: needs a `metric` name")
        op = data.get("op", ">")
        if op not in _OPS:
            raise RuleError(f"rule {rule_id}: unknown op {op!r} "
                            f"(one of {sorted(_OPS)})")
        severity = data.get("severity", "warn")
        if severity not in ("warn", "page"):
            raise RuleError(f"rule {rule_id}: severity must be "
                            f"warn|page, got {severity!r}")
        value = data.get("value")
        value_from = data.get("value_from")
        quantile = data.get("quantile")
        if quantile is not None and not 0.0 <= float(quantile) <= 1.0:
            raise RuleError(f"rule {rule_id}: quantile {quantile!r} "
                            "outside [0, 1]")
        if kind == "threshold":
            if (value is None) == (value_from is None):
                raise RuleError(f"rule {rule_id}: threshold needs exactly "
                                "one of `value` / `value_from`")
            if value_from is not None:
                if quantile is None:
                    raise RuleError(f"rule {rule_id}: value_from needs "
                                    "`quantile` on the rule too")
                bq = value_from.get("quantile")
                if bq is None or not 0.0 <= float(bq) <= 1.0:
                    raise RuleError(f"rule {rule_id}: value_from.quantile "
                                    f"{bq!r} outside [0, 1]")
                if not value_from.get("factor"):
                    raise RuleError(f"rule {rule_id}: value_from needs a "
                                    "nonzero `factor`")
        elif kind == "rate":
            if value is None:
                raise RuleError(f"rule {rule_id}: rate needs `value` "
                                "(events/second)")
        else:  # slo_burn_rate
            le = data.get("le")
            objective = data.get("objective")
            if le is None or objective is None:
                raise RuleError(f"rule {rule_id}: slo_burn_rate needs "
                                "`le` and `objective`")
            if not 0.0 < float(objective) < 1.0:
                raise RuleError(f"rule {rule_id}: objective {objective!r} "
                                "must be in (0, 1)")
            if value is None:
                value = float(data.get("factor", 1.0))
        window = parse_window(data.get("window", "60s"))
        if kind in ("rate", "slo_burn_rate") and window <= 0:
            raise RuleError(f"rule {rule_id}: {kind} needs a positive window")
        return cls(
            id=rule_id, kind=kind, metric=metric, op=op,
            value=float(value) if value is not None else None,
            quantile=float(quantile) if quantile is not None else None,
            value_from=value_from,
            labels={str(k): str(v)
                    for k, v in (data.get("labels") or {}).items()},
            window=window,
            le=float(data["le"]) if data.get("le") is not None else None,
            objective=(float(data["objective"])
                       if data.get("objective") is not None else None),
            for_seconds=parse_window(data.get("for", 0), field_name="for"),
            resolve_seconds=parse_window(data.get("resolve_after", 0),
                                         field_name="resolve_after"),
            severity=severity,
            annotate_runs=bool(data.get("annotate_runs")),
            description=str(data.get("description") or ""),
        )


def load_ruleset(source: Any = None) -> list[Rule]:
    """Rules from a dict, a JSON file path, or the committed default
    (``obs/rules.json``). Duplicate ids and unknown metric names raise
    :class:`RuleError` here — load time IS the schema gate."""
    if source is None:
        source = DEFAULT_RULES_PATH
    if isinstance(source, str):
        with open(source) as fh:
            source = json.load(fh)
    if not isinstance(source, dict) or not isinstance(
            source.get("rules"), list):
        raise RuleError("ruleset must be {\"rules\": [...]}")
    rules = [Rule.from_dict(r) for r in source["rules"]]
    seen: set[str] = set()
    for rule in rules:
        if rule.id in seen:
            raise RuleError(f"duplicate rule id {rule.id!r}")
        seen.add(rule.id)
    known = obs_metrics.catalog_metric_names()
    for rule in rules:
        if rule.metric not in known:
            raise RuleError(
                f"rule {rule.id}: unknown metric {rule.metric!r} "
                f"(known: {sorted(known)})")
    return rules


# ------------------------------------------------------------- evaluation
@dataclass
class AlertState:
    """One rule's live state machine: inactive → pending (breach seen,
    ``for`` not yet served) → firing → (clear held ``resolve_after``)
    → inactive. Transitions out of/into firing are the events the
    surfaces show."""

    rule: Rule
    state: str = "inactive"  # inactive | pending | firing
    pending_since: Optional[float] = None
    fired_at: Optional[float] = None
    clear_since: Optional[float] = None
    resolved_at: Optional[float] = None
    value: Optional[float] = None
    threshold: Optional[float] = None

    def to_json(self) -> dict:
        return {
            "rule": self.rule.id,
            "kind": self.rule.kind,
            "metric": self.rule.metric,
            "severity": self.rule.severity,
            "description": self.rule.description,
            "state": self.state,
            "value": self.value,
            "threshold": self.threshold,
            "fired_at": self.fired_at,
            "resolved_at": self.resolved_at,
        }


class AlertEngine:
    """Evaluates a ruleset against a registry; owns per-rule sample
    history (for rate/burn-rate windows) and alert state machines.
    Thread-safe: the agent loop evaluates while API handler threads
    read. ``clock`` is injectable so drills can collapse an hour-long
    window into one assertion."""

    HISTORY = 256  # fired/resolved transition ring

    def __init__(self, rules: list[Rule],
                 registry: obs_metrics.MetricsRegistry = obs_metrics.REGISTRY,
                 clock: Callable[[], float] = time.time,
                 history: Optional["obs_history.MetricsHistory"] = None):
        from polyaxon_tpu_torch.obs import history as obs_history

        self.rules = rules
        self.registry = registry
        self.clock = clock
        # Rate rules need the zero BEFORE the first increment (a
        # counter born at 1 would hide its own first delta), so the
        # documented families exist from the engine's first pass — the
        # history ring anchors every first-seen series with a point.
        obs_metrics.ensure_core_metrics(registry)
        # Rate/burn windows read from the shared metrics-history ring
        # (ONE sampling path with the agent hook, the history API, and
        # the oracle's during-window invariants) — each evaluation
        # forces a sample so windows are exact at evaluation times.
        # Sharing requires one time domain: an engine on an injected
        # clock (drills, fake-clock tests)
        # gets a private ring in its own clock domain instead — mixed
        # domains would trip the ring's monotonic guard.
        if history is not None:
            self.metrics_history = history
        elif clock is time.time:
            self.metrics_history = obs_history.history_for(registry)
        else:
            self.metrics_history = obs_history.MetricsHistory(
                registry, clock=clock)
        self._lock = threading.Lock()
        self._states = {rule.id: AlertState(rule) for rule in rules}
        self.history: deque = deque(maxlen=self.HISTORY)

    def _append_history(self, event: dict) -> None:
        """Bounded append: a transition pushed past the ring cap evicts
        the oldest one, counted into a catalogued metric so a truncated
        episode record is visible on /metrics, not silent."""
        if (self.history.maxlen is not None
                and len(self.history) >= self.history.maxlen):
            obs_metrics.alert_history_evictions(self.registry).inc()
        self.history.append(event)

    # -- observations ------------------------------------------------------
    def _instant_value(self, rule: Rule) -> Optional[float]:
        metric = self.registry.get(rule.metric)
        if metric is None:
            return None
        if isinstance(metric, obs_metrics.Histogram):
            q = rule.quantile if rule.quantile is not None else 0.99
            if rule.labels:
                try:
                    return metric.quantile(q, **rule.labels)
                except (ValueError, KeyError):
                    return None  # labels mismatch the instrument: no data
            return metric.quantile_max(q)
        if rule.labels:
            try:
                return metric.value(**rule.labels)
            except (ValueError, KeyError):
                return None
        snap = metric.snapshot()["series"]
        values = [float(v) for v in snap.values()
                  if not isinstance(v, dict)]
        return max(values) if values else None

    def _threshold_for(self, rule: Rule) -> Optional[float]:
        if rule.value_from is None:
            return rule.value
        metric = self.registry.get(rule.metric)
        if not isinstance(metric, obs_metrics.Histogram):
            return None
        base_q = float(rule.value_from["quantile"])
        try:
            base = (metric.quantile(base_q, **rule.labels) if rule.labels
                    else metric.quantile_max(base_q))
        except (ValueError, KeyError):
            return None  # labels mismatch the instrument: no data
        if base is None:
            return None
        return base * float(rule.value_from["factor"])

    def _windowed_rate(self, rule: Rule, now: float) -> Optional[float]:
        """Counter increase per second over the trailing window, read
        from the shared history ring. The right edge is the
        carry-forward total at ``now`` (the evaluation just sampled);
        the left edge sits at ``now - window``, floored at the series'
        first retained point — before that the series did not exist, so
        the window shrinks to the data exactly like the old per-rule
        deque kept its oldest sample as the edge. A clock fast-forward
        (drills) makes both edges read the same carry-forward total →
        rate 0 → stale firings resolve."""
        hist = self.metrics_history
        v1 = hist.counter_total_at(rule.metric, rule.labels, now)
        if v1 is None:
            return None
        t_first = hist.first_time(rule.metric, rule.labels)
        if t_first is None:
            return None
        left = max(now - rule.window, t_first)
        if now <= left:
            return None  # one instant of data: no window yet
        v0 = hist.counter_total_at(rule.metric, rule.labels, left)
        if v0 is None:
            return None
        return max(v1 - v0, 0.0) / (now - left)

    def _burn_rate(self, rule: Rule, now: float) -> Optional[float]:
        """Windowed SLO burn from the history ring: (good, total)
        cumulative bucket counts at both window edges, same edge
        semantics as :meth:`_windowed_rate`."""
        hist = self.metrics_history
        counts1 = hist.bucket_counts_at(rule.metric, rule.le, now)
        if counts1 is None:
            return None
        t_first = hist.first_time(rule.metric, None)
        if t_first is None:
            return None
        left = max(now - rule.window, t_first)
        if now <= left:
            return None
        counts0 = hist.bucket_counts_at(rule.metric, rule.le, left)
        if counts0 is None:
            return None
        d_total = counts1[1] - counts0[1]
        if d_total <= 0:
            return None  # no traffic in the window: nothing to burn
        error_rate = max(d_total - (counts1[0] - counts0[0]), 0.0) / d_total
        allowed = 1.0 - rule.objective
        return error_rate / allowed if allowed > 0 else None

    # -- the evaluation pass ----------------------------------------------
    def evaluate(self, plane=None) -> list[dict]:
        """One pass over every rule; returns this pass's transitions
        (``{"rule", "event": "fired"|"resolved", ...}``). With a
        ``plane``, a firing rule with ``annotate_runs`` stamps the live
        runs (condition + ``meta["alerts"]``) so the run's record shows
        the alert that implicates it."""
        now = self.clock()
        # One sampling path: every evaluation records a history sample
        # at the engine's clock, so rate/burn windows are exact at
        # evaluation times (fail-open inside — a sampling error reads
        # as carry-forward, not an engine crash).
        self.metrics_history.sample(now=now, force=True)
        transitions: list[dict] = []
        with self._lock:
            for rule in self.rules:
                state = self._states[rule.id]
                if rule.kind == "rate":
                    observed = self._windowed_rate(rule, now)
                    threshold = rule.value
                elif rule.kind == "slo_burn_rate":
                    observed = self._burn_rate(rule, now)
                    threshold = rule.value
                else:
                    observed = self._instant_value(rule)
                    threshold = self._threshold_for(rule)
                state.value = observed
                state.threshold = threshold
                breaching = (observed is not None and threshold is not None
                             and _OPS[rule.op](observed, threshold))
                event = self._advance(state, breaching, now)
                if event is not None:
                    transitions.append(event)
        if plane is not None:
            for event in transitions:
                if event["event"] == "fired" and event["annotate_runs"]:
                    self._annotate_runs(plane, event)
        return transitions

    def _advance(self, state: AlertState, breaching: bool,
                 now: float) -> Optional[dict]:
        rule = state.rule
        if breaching:
            state.clear_since = None
            if state.state == "inactive":
                state.pending_since = now
                state.state = "pending"
            if (state.state == "pending"
                    and now - state.pending_since >= rule.for_seconds):
                state.state = "firing"
                state.fired_at = now
                state.resolved_at = None
                event = {"event": "fired", "at": now, **state.to_json(),
                         "annotate_runs": rule.annotate_runs}
                self._append_history(event)
                return event
            return None
        if state.state == "pending":
            state.state = "inactive"
            state.pending_since = None
        elif state.state == "firing":
            if state.clear_since is None:
                state.clear_since = now
            if now - state.clear_since >= rule.resolve_seconds:
                state.state = "inactive"
                state.resolved_at = now
                state.pending_since = state.clear_since = None
                event = {"event": "resolved", "at": now, **state.to_json(),
                         "annotate_runs": rule.annotate_runs}
                self._append_history(event)
                return event
        return None

    def _annotate_runs(self, plane, event: dict) -> None:
        """Fired alerts become run conditions where attributable: every
        live (non-pipeline) run gets a same-status ``AlertFiring``
        condition (the quota-visibility idiom) and a bounded
        ``meta["alerts"]`` stamp. Never raises — alerting must not take
        the reconcile loop down with it."""
        from polyaxon_tpu_torch.lifecycle import LIVE_STATUSES, V1Statuses

        try:
            # Live + starting runs only: a run parked in RETRYING
            # backoff is not executing, and its condition stream is a
            # retry audit trail the stamp must not dilute.
            statuses = list(LIVE_STATUSES) + [V1Statuses.STARTING]
            for record in plane.list_runs(statuses=statuses):
                if record.kind in ("matrix", "dag", "schedule"):
                    continue
                # Re-read right before stamping: the same-status forced
                # transition below must never drag a run that just went
                # terminal back to a stale live status.
                record = plane.get_run(record.uuid)
                if record.is_done:
                    continue
                meta = dict(record.meta or {})
                alerts = list(meta.get("alerts") or [])
                alerts.append({
                    "rule": event["rule"],
                    "severity": event["severity"],
                    "fired_at": event["at"],
                    "value": event["value"],
                })
                meta["alerts"] = alerts[-8:]
                # Annotation + condition pin are one observable unit.
                with plane.store.transaction():
                    plane.store.update_run(record.uuid, meta=meta)
                    plane.store.transition(
                        record.uuid, record.status, reason="AlertFiring",
                        message=f"{event['rule']}: "
                                f"{event['description'] or event['metric']} "
                                f"(value={event['value']})"[:500],
                        force=True)
        except Exception:  # noqa: BLE001 — observability stays passive
            import logging

            logging.getLogger(__name__).warning(
                "alert run-annotation failed", exc_info=True)

    # -- read surfaces -----------------------------------------------------
    def active(self) -> list[dict]:
        with self._lock:
            return [s.to_json() for s in self._states.values()
                    if s.state == "firing"]

    def to_json(self) -> dict:
        with self._lock:
            states = [s.to_json() for s in self._states.values()]
        return {
            "alerts": [s for s in states if s["state"] == "firing"],
            "rules": states,
            "history": list(self.history),
        }


# ------------------------------------------------------- default engine
_DEFAULT: Optional[AlertEngine] = None
_DEFAULT_LOCK = threading.Lock()


def default_engine() -> AlertEngine:
    """The process-wide engine over the committed ruleset + the global
    registry: the agent evaluates it per reconcile pass; the API/CLI
    surfaces read (and lazily evaluate) the same instance."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = AlertEngine(load_ruleset())
        return _DEFAULT


def set_default_engine(engine: Optional[AlertEngine]) -> None:
    """Swap (or, with None, reset) the process-wide engine — drills
    install a clock-injected engine to assert the whole fire→resolve
    episode without waiting out real windows."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = engine


# ----------------------------------------------------------- schema gate
def check_ruleset(path: Optional[str] = None) -> list[Rule]:
    """CI entry: load (and thereby fully validate) a ruleset file."""
    return load_ruleset(path or DEFAULT_RULES_PATH)


def _main(argv: Optional[list[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Validate an alert ruleset")
    parser.add_argument("--check", action="store_true", required=True)
    parser.add_argument("path", nargs="?", default=DEFAULT_RULES_PATH)
    args = parser.parse_args(argv)
    try:
        rules = check_ruleset(args.path)
    except (RuleError, OSError, json.JSONDecodeError) as exc:
        print(f"RULES INVALID: {exc}")
        return 1
    print(f"rules ok: {len(rules)} rule(s) in {args.path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
