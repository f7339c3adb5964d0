"""Telemetry oracle: declarative end-state invariants over everything
the repo can already measure (port of ``polyaxon_tpu/obs/oracle.py``,
the same code under the port's module names; ``obs/oracle.json`` is the
port's own copy, equal to the JAX package's).

The observability stack collects four surfaces — lifecycle span
timelines (``obs.trace.build_timeline``), attribution reports
(``obs.analyze``), the metrics-registry snapshot (``obs.metrics``),
and alert state + firing history (``obs.rules``) — but until now
nothing *consumed* them as a verification plane. This module closes
that loop (the observability layer becomes the test oracle): a committed invariant set (``obs/oracle.json``, schema-gated
exactly like ``rules.json`` — load time IS the gate) is evaluated
against a :class:`TelemetryBundle` of those surfaces and produces
structured verdicts ``{invariant, verdict, evidence}`` with the
offending run/span/series/alert attached.

Invariant kinds:

- ``run_terminal``     — end-state predicates over runs: every run must
  sit in an allowed terminal status; ``forbid`` pins statuses that must
  never survive to the end (a stuck QUEUED run, a parked PREEMPTED one).
- ``phase_budget``     — a run report's phase decomposition must sum to
  its wall clock within ``tolerance`` (the "phases explain the time"
  contract the attribution plane promises).
- ``metric``           — threshold predicates over the registry
  snapshot with label selectors: instantaneous values, baseline deltas
  (``mode: "delta"`` against the bundle's baseline snapshot), or
  interpolated histogram quantiles (``quantile``).
- ``loss_continuity``  — step-window continuity across restore/resize
  boundaries, read from the ``step`` spans: step indices never skip
  forward past ``max_gap_steps``, never regress between windows, and
  (when windows carry a ``loss``) the loss never jumps more than
  ``max_loss_jump`` across a boundary.
- ``alerts_resolved``  — zero unresolved alerts at end: no rule may
  still be firing (``allow`` whitelists rule ids that may).
- ``slo``              — per-class SLO adherence from histogram
  buckets: ``objective`` of observations ≤ the ``le`` bound, per label
  selector (Prometheus SLI semantics, but as an acceptance check).
- ``metric_during``    — a threshold predicate scoped in *time*: the
  value (gauge worst-instant via ``agg``, counter in-window movement,
  or histogram in-window ``quantile``) judged over a named history
  window (``window: "storm"``) or a trailing ``span``, read from the
  bundle's metrics history (``obs.history``).
- ``slo_during``       — the ``slo`` bucket-ratio check over only the
  observations that landed inside the named window / trailing span
  (bucket-wise difference of carry-forward history samples).
- ``quota_violation``  — no sampled instant shows a project over its
  quota: every ``polyaxon_project_usage`` point is compared against
  the carry-forward ``polyaxon_project_quota_limit`` for the same
  (project, resource) series; a limit of 0 means unlimited.

Missing telemetry is handled per invariant via ``missing``: ``skip``
(default — verdict ``skip`` with the reason as evidence), ``fail``
(absence is itself a failure), or ``zero`` (an absent series reads as
0 — right for "this error counter never moved" invariants).

Surfaces: ``python -m polyaxon_tpu_torch.obs.oracle --check`` (the
schema gate) and ``ControlPlane.verify``.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from polyaxon_tpu_torch.obs import history as obs_history
from polyaxon_tpu_torch.obs import metrics as obs_metrics

DEFAULT_ORACLE_PATH = os.path.join(os.path.dirname(__file__), "oracle.json")

KINDS = ("run_terminal", "phase_budget", "metric", "loss_continuity",
         "alerts_resolved", "slo", "metric_during", "slo_during",
         "quota_violation")
WINDOW_AGGS = ("max", "min", "last")
MISSING_POLICIES = ("skip", "fail", "zero")
EVIDENCE_CAP = 16  # offending items attached per verdict, not a census

_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
}


class OracleError(ValueError):
    """An invariant spec that must not ship: CI's schema gate raises
    this (the ``rules.RuleError`` posture)."""


@dataclass
class Invariant:
    id: str
    kind: str
    description: str = ""
    missing: str = "skip"
    # run_terminal
    allow: list[str] = field(default_factory=list)
    forbid: list[str] = field(default_factory=list)
    # phase_budget
    tolerance: float = 0.35
    # metric / slo
    metric: Optional[str] = None
    op: str = "<="
    value: Optional[float] = None
    quantile: Optional[float] = None
    labels: dict[str, str] = field(default_factory=dict)
    mode: str = "value"  # value | delta
    le: Optional[float] = None
    objective: Optional[float] = None
    # loss_continuity
    max_gap_steps: int = 0
    max_loss_jump: Optional[float] = None
    # metric_during / slo_during (window-scoped judgments)
    window: Optional[str] = None   # named history window, e.g. "storm"
    span: Optional[float] = None   # trailing seconds before coverage end
    agg: str = "max"               # gauge aggregation inside the window

    @classmethod
    def from_dict(cls, data: dict) -> "Invariant":
        if not isinstance(data, dict):
            raise OracleError(
                f"invariant must be an object, got {type(data).__name__}")
        inv_id = data.get("id")
        if not inv_id or not isinstance(inv_id, str):
            raise OracleError(f"invariant needs a string `id`, got {inv_id!r}")
        kind = data.get("kind")
        if kind not in KINDS:
            raise OracleError(f"invariant {inv_id}: unknown kind {kind!r} "
                              f"(one of {KINDS})")
        missing = data.get("missing", "skip")
        if missing not in MISSING_POLICIES:
            raise OracleError(
                f"invariant {inv_id}: missing policy must be one of "
                f"{MISSING_POLICIES}, got {missing!r}")
        op = data.get("op", "<=")
        if op not in _OPS:
            raise OracleError(f"invariant {inv_id}: unknown op {op!r} "
                              f"(one of {sorted(_OPS)})")
        metric = data.get("metric")
        quantile = data.get("quantile")
        if quantile is not None and not 0.0 <= float(quantile) <= 1.0:
            raise OracleError(f"invariant {inv_id}: quantile {quantile!r} "
                              "outside [0, 1]")
        mode = data.get("mode", "value")
        window = data.get("window")
        span = data.get("span")
        if window is not None and (not isinstance(window, str) or not window):
            raise OracleError(f"invariant {inv_id}: `window` must be a "
                              f"non-empty window name, got {window!r}")
        if span is not None:
            from polyaxon_tpu_torch.obs import rules as obs_rules
            try:
                span = obs_rules.parse_window(span, field_name="span")
            except obs_rules.RuleError as exc:
                raise OracleError(f"invariant {inv_id}: {exc}") from exc
        agg = data.get("agg", "max")
        if agg not in WINDOW_AGGS:
            raise OracleError(f"invariant {inv_id}: agg must be one of "
                              f"{WINDOW_AGGS}, got {agg!r}")
        if kind in ("metric_during", "slo_during"):
            if (window is None) == (span is None):
                raise OracleError(
                    f"invariant {inv_id}: {kind} needs exactly one of "
                    "`window` (a named marker) or `span` (a trailing "
                    "duration)")
        elif window is not None or span is not None:
            raise OracleError(
                f"invariant {inv_id}: `window`/`span` only apply to "
                "metric_during|slo_during")
        if kind == "metric":
            if not metric or not isinstance(metric, str):
                raise OracleError(f"invariant {inv_id}: metric kind needs "
                                  "a `metric` name")
            if data.get("value") is None:
                raise OracleError(f"invariant {inv_id}: metric kind needs "
                                  "a `value` to compare against")
            if mode not in ("value", "delta"):
                raise OracleError(f"invariant {inv_id}: mode must be "
                                  f"value|delta, got {mode!r}")
            if mode == "delta" and quantile is not None:
                raise OracleError(f"invariant {inv_id}: quantile predicates "
                                  "only run on absolute snapshots "
                                  "(mode: value)")
        elif kind == "metric_during":
            if not metric or not isinstance(metric, str):
                raise OracleError(f"invariant {inv_id}: metric_during "
                                  "kind needs a `metric` name")
            if data.get("value") is None:
                raise OracleError(f"invariant {inv_id}: metric_during "
                                  "kind needs a `value` to compare against")
        elif kind in ("slo", "slo_during"):
            if not metric or not isinstance(metric, str):
                raise OracleError(f"invariant {inv_id}: {kind} kind needs "
                                  "a `metric` name")
            le = data.get("le")
            objective = data.get("objective")
            if le is None or objective is None:
                raise OracleError(f"invariant {inv_id}: {kind} needs `le` "
                                  "and `objective`")
            if not 0.0 < float(objective) <= 1.0:
                raise OracleError(f"invariant {inv_id}: objective "
                                  f"{objective!r} must be in (0, 1]")
        elif kind == "phase_budget":
            tolerance = float(data.get("tolerance", 0.35))
            if tolerance <= 0:
                raise OracleError(f"invariant {inv_id}: tolerance must be "
                                  f"> 0, got {tolerance!r}")
        elif kind == "loss_continuity":
            if int(data.get("max_gap_steps", 0)) < 0:
                raise OracleError(f"invariant {inv_id}: max_gap_steps "
                                  "must be >= 0")
        elif kind == "run_terminal":
            from polyaxon_tpu_torch.lifecycle import V1Statuses

            known = {s.value for s in V1Statuses}
            for key in ("allow", "forbid"):
                vals = data.get(key) or []
                if not isinstance(vals, list):
                    raise OracleError(f"invariant {inv_id}: `{key}` must "
                                      "be a list of statuses")
                unknown = [v for v in vals if v not in known]
                if unknown:
                    raise OracleError(f"invariant {inv_id}: unknown "
                                      f"statuses in `{key}`: {unknown}")
        return cls(
            id=inv_id, kind=kind,
            description=str(data.get("description") or ""),
            missing=missing,
            allow=[str(v) for v in (data.get("allow") or [])],
            forbid=[str(v) for v in (data.get("forbid") or [])],
            tolerance=float(data.get("tolerance", 0.35)),
            metric=metric, op=op,
            value=(float(data["value"]) if data.get("value") is not None
                   else None),
            quantile=float(quantile) if quantile is not None else None,
            labels={str(k): str(v)
                    for k, v in (data.get("labels") or {}).items()},
            mode=mode,
            le=float(data["le"]) if data.get("le") is not None else None,
            objective=(float(data["objective"])
                       if data.get("objective") is not None else None),
            max_gap_steps=int(data.get("max_gap_steps", 0)),
            max_loss_jump=(float(data["max_loss_jump"])
                           if data.get("max_loss_jump") is not None
                           else None),
            window=window, span=span, agg=agg,
        )


def load_invariants(source: Any = None) -> list[Invariant]:
    """Invariants from a dict, a JSON file path, or the committed
    default (``obs/oracle.json``). Duplicate ids and unknown metric
    names raise :class:`OracleError` here — load time IS the schema
    gate, same posture as ``rules.load_ruleset``."""
    if source is None:
        source = DEFAULT_ORACLE_PATH
    if isinstance(source, str):
        with open(source) as fh:
            source = json.load(fh)
    if not isinstance(source, dict) or not isinstance(
            source.get("invariants"), list):
        raise OracleError("oracle set must be {\"invariants\": [...]}")
    invariants = [Invariant.from_dict(i) for i in source["invariants"]]
    seen: set[str] = set()
    for inv in invariants:
        if inv.id in seen:
            raise OracleError(f"duplicate invariant id {inv.id!r}")
        seen.add(inv.id)
    known = obs_metrics.catalog_metric_names()
    for inv in invariants:
        if inv.metric is not None and inv.metric not in known:
            raise OracleError(
                f"invariant {inv.id}: unknown metric {inv.metric!r} "
                f"(known: {sorted(known)})")
    return invariants


# ------------------------------------------------------------ the bundle
@dataclass
class TelemetryBundle:
    """Everything one oracle evaluation sees, as plain data — so the
    same engine judges a live control plane and a replayed incident
    without caring where the telemetry came from.

    ``runs`` rows carry at least ``uuid``/``status``; ``reports`` maps
    run uuid → ``obs.analyze.analyze_timeline`` output; ``snapshot``/
    ``baseline`` are ``MetricsRegistry.snapshot()`` dicts; ``alerts``
    is ``AlertEngine.to_json()`` (alerts / rules / history); ``history``
    is ``MetricsHistory.to_json()`` — the time-series surface the
    ``*_during`` and ``quota_violation`` kinds judge."""

    runs: list[dict] = field(default_factory=list)
    timelines: dict[str, dict] = field(default_factory=dict)
    reports: dict[str, dict] = field(default_factory=dict)
    snapshot: Optional[dict] = None
    baseline: Optional[dict] = None
    alerts: Optional[dict] = None
    history: Optional[dict] = None

    def deltas(self) -> Optional[dict]:
        """Changed-series registry movement vs the baseline (None when
        either snapshot is absent — delta invariants then follow their
        ``missing`` policy)."""
        if self.snapshot is None or self.baseline is None:
            return None
        return obs_metrics.snapshot_delta(self.snapshot, self.baseline)

    @classmethod
    def from_plane(cls, plane, *, run_uuid: Optional[str] = None,
                   engine=None, baseline: Optional[dict] = None,
                   registry: Optional[obs_metrics.MetricsRegistry] = None,
                   max_timelines: int = 64) -> "TelemetryBundle":
        """Gather the four surfaces from a live ``ControlPlane``.
        ``run_uuid`` scopes the run surface to one run (the per-run
        ``GET .../verify`` shape); timelines/reports attach for up to
        ``max_timelines`` runs that actually persisted spans."""
        from polyaxon_tpu_torch.obs import rules as obs_rules
        from polyaxon_tpu_torch.obs.analyze import analyze_timeline
        from polyaxon_tpu_torch.obs.trace import build_timeline, read_trace

        registry = registry if registry is not None else obs_metrics.REGISTRY
        if run_uuid is not None:
            records = [plane.get_run(run_uuid)]
        else:
            records = plane.list_runs(limit=100000)
        runs = [{
            "uuid": r.uuid,
            "status": r.status.value,
            "kind": r.kind,
            "project": r.project,
            "name": r.name,
        } for r in records]
        timelines: dict[str, dict] = {}
        reports: dict[str, dict] = {}
        for record in records:
            if len(timelines) >= max_timelines:
                break
            if record.kind in ("matrix", "dag", "schedule"):
                continue  # pipeline shells have no execution spans
            run_dir = plane.run_artifacts_dir(record.uuid)
            span_records = read_trace(run_dir)
            if not span_records:
                continue
            timeline = build_timeline(span_records, trace_id=record.uuid)
            timelines[record.uuid] = timeline
            reports[record.uuid] = analyze_timeline(timeline)
        if engine is None:
            engine = obs_rules.default_engine()
        hist = obs_history.history_for(registry)
        hist.sample(force=True)  # coverage end = bundle time
        return cls(runs=runs, timelines=timelines, reports=reports,
                   snapshot=registry.snapshot(), baseline=baseline,
                   alerts=engine.to_json(), history=hist.to_json())


# --------------------------------------------------------- snapshot math
def _select_series(family: dict, labels: dict[str, str]) -> Optional[Any]:
    """One series sample from a snapshot family by label selector
    (None = no such series). The selector subset-matches: dimensions
    it does not name — the fleet's hidden ``component`` dimension
    above all — are wildcards, and multiple matches merge into the
    federated sample (counters sum, gauges max, histogram buckets
    merge). Empty selector on a labeled family sums
    scalars / returns None for histograms (ambiguous)."""
    series = family.get("series") or {}
    labelnames = family.get("labels") or []
    if labels:
        matched = [v for k, v in series.items()
                   if obs_metrics.match_series(labelnames, k, labels)]
        if not matched:
            return None
        if len(matched) == 1:
            return matched[0]
        return obs_metrics.merge_snap_samples(
            family.get("type") or "", matched)
    if not labelnames:
        return series.get("")
    scalars = [v for v in series.values() if not isinstance(v, dict)]
    if scalars:
        return max(float(v) for v in scalars)
    return None


def _snapshot_quantile(sample: dict, q: float) -> Optional[float]:
    """``Histogram.quantile`` semantics over a *snapshot* bucket dict
    (bound-string → per-bucket count): linear interpolation within the
    landing bucket, +Inf clamped to the largest finite bound."""
    count = int(sample.get("count") or 0)
    if count == 0:
        return None
    bounds: list[float] = []
    counts: list[int] = []
    for bound, n in sample["buckets"].items():
        bounds.append(math.inf if bound == "+Inf" else float(bound))
        counts.append(int(n))
    rank = q * count
    cumulative = 0
    finite = [b for b in bounds if b != math.inf]
    for i, n in enumerate(counts):
        prev = cumulative
        cumulative += n
        if n and cumulative >= rank:
            if bounds[i] == math.inf:
                return finite[-1] if finite else None
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else 0.0
            return lo + (hi - lo) * max(rank - prev, 0.0) / n
    return finite[-1] if finite else None


def _slo_counts(family: dict, le: float,
                labels: dict[str, str]) -> Optional[tuple[float, float]]:
    """(good, total) across the selected histogram series; None when
    the family has no matching samples or ``le`` is not a bucket
    bound."""
    series = family.get("series") or {}
    labelnames = family.get("labels") or []
    if labels:
        samples = [v for k, v in series.items()
                   if obs_metrics.match_series(labelnames, k, labels)]
    else:
        samples = list(series.values())
    good = total = 0.0
    seen = False
    for sample in samples:
        if not isinstance(sample, dict):
            continue
        matched = False
        cumulative = 0
        for bound, n in sample["buckets"].items():
            cumulative += int(n)
            if bound != "+Inf" and abs(float(bound) - le) < 1e-12:
                good += cumulative
                matched = True
                break
        if not matched:
            return None  # le is not a bound of this layout: spec bug
        seen = True
        total += int(sample.get("count") or 0)
    return (good, total) if seen else None


# ------------------------------------------------------------ evaluation
def _verdict(inv: Invariant, verdict: str, evidence: dict) -> dict:
    return {
        "invariant": inv.id,
        "kind": inv.kind,
        "verdict": verdict,
        "description": inv.description,
        "evidence": evidence,
    }


def _missing(inv: Invariant, reason: str) -> dict:
    if inv.missing == "fail":
        return _verdict(inv, "fail", {"missing": reason})
    return _verdict(inv, "skip", {"missing": reason})


def _eval_run_terminal(inv: Invariant, bundle: TelemetryBundle) -> dict:
    from polyaxon_tpu_torch.lifecycle import DONE_STATUSES

    if not bundle.runs:
        return _missing(inv, "no runs in bundle")
    allowed = set(inv.allow) or {s.value for s in DONE_STATUSES}
    forbidden = set(inv.forbid)
    offenders = []
    counts: dict[str, int] = {}
    for run in bundle.runs:
        status = run.get("status")
        counts[status] = counts.get(status, 0) + 1
        if status in forbidden or status not in allowed:
            offenders.append({k: run.get(k)
                              for k in ("uuid", "status", "kind", "project")})
    evidence = {"runs": len(bundle.runs), "status_counts": counts}
    if offenders:
        evidence["offending_runs"] = offenders[:EVIDENCE_CAP]
        evidence["offending_total"] = len(offenders)
        return _verdict(inv, "fail", evidence)
    return _verdict(inv, "pass", evidence)


def _eval_phase_budget(inv: Invariant, bundle: TelemetryBundle) -> dict:
    judged = 0
    offenders = []
    for uuid, report in bundle.reports.items():
        wall = float(report.get("wall_clock_ms") or 0.0)
        phase_sum = float(report.get("phase_sum_ms") or 0.0)
        if wall <= 0 or not report.get("phases"):
            continue
        judged += 1
        ratio = phase_sum / wall
        if abs(ratio - 1.0) > inv.tolerance:
            offenders.append({
                "run_uuid": uuid,
                "wall_clock_ms": wall,
                "phase_sum_ms": phase_sum,
                "ratio": round(ratio, 4),
            })
    if not judged:
        return _missing(inv, "no attributable reports in bundle")
    evidence = {"reports_judged": judged, "tolerance": inv.tolerance}
    if offenders:
        evidence["offending_reports"] = offenders[:EVIDENCE_CAP]
        return _verdict(inv, "fail", evidence)
    return _verdict(inv, "pass", evidence)


def _eval_metric(inv: Invariant, bundle: TelemetryBundle) -> dict:
    if inv.mode == "delta":
        deltas = bundle.deltas()
        if deltas is None:
            return _missing(inv, "no baseline snapshot for delta mode")
        family = (deltas.get("deltas") or {}).get(inv.metric)
        if family is None:
            # No movement at all: a delta of zero, by construction.
            observed: Optional[float] = 0.0
        else:
            sample = _select_series(family, inv.labels)
            if isinstance(sample, dict):
                observed = float(sample.get("count") or 0)
            elif sample is None:
                observed = 0.0
            else:
                observed = float(sample)
    else:
        if bundle.snapshot is None:
            return _missing(inv, "no registry snapshot in bundle")
        family = bundle.snapshot.get(inv.metric)
        if family is None:
            if inv.missing == "zero":
                observed = 0.0
            else:
                return _missing(inv, f"metric {inv.metric} not in snapshot")
        else:
            sample = _select_series(family, inv.labels)
            if sample is None:
                if inv.missing == "zero":
                    observed = 0.0
                else:
                    return _missing(
                        inv, f"no series matches labels {inv.labels}")
            elif isinstance(sample, dict):
                if inv.quantile is not None:
                    observed = _snapshot_quantile(sample, inv.quantile)
                    if observed is None:
                        return _missing(inv, "histogram has no samples")
                else:
                    observed = float(sample.get("count") or 0)
            else:
                observed = float(sample)
    holds = _OPS[inv.op](observed, inv.value)
    evidence = {
        "metric": inv.metric,
        "labels": inv.labels or None,
        "mode": inv.mode,
        **({"quantile": inv.quantile} if inv.quantile is not None else {}),
        "observed": round(observed, 6),
        "op": inv.op,
        "value": inv.value,
    }
    return _verdict(inv, "pass" if holds else "fail", evidence)


def _eval_loss_continuity(inv: Invariant, bundle: TelemetryBundle) -> dict:
    judged = 0
    offenders = []
    for uuid, report in bundle.reports.items():
        windows = (report.get("steps") or {}).get("windows") or []
        windows = [w for w in windows
                   if w.get("from_step") is not None
                   and w.get("to_step") is not None]
        if len(windows) < 2:
            continue
        judged += 1
        restores = ((report.get("phases") or {}).get("restore")
                    or {}).get("count", 0)
        for prev, nxt in zip(windows, windows[1:]):
            gap = int(nxt["from_step"]) - int(prev["to_step"]) - 1
            problem = None
            if gap > inv.max_gap_steps:
                problem = f"skipped {gap} step(s)"
            elif int(nxt["from_step"]) < int(prev["from_step"]):
                problem = "step window regressed"
            elif (inv.max_loss_jump is not None
                  and prev.get("loss") is not None
                  and nxt.get("loss") is not None
                  and abs(float(nxt["loss"]) - float(prev["loss"]))
                  > inv.max_loss_jump):
                problem = (f"loss jumped "
                           f"{abs(float(nxt['loss']) - float(prev['loss'])):.4f}")
            if problem:
                offenders.append({
                    "run_uuid": uuid,
                    "problem": problem,
                    "window": {k: prev.get(k)
                               for k in ("from_step", "to_step", "loss")},
                    "next_window": {k: nxt.get(k)
                                    for k in ("from_step", "to_step", "loss")},
                    "restores": restores,
                })
    if not judged:
        return _missing(inv, "no run has >= 2 step windows")
    evidence = {"runs_judged": judged, "max_gap_steps": inv.max_gap_steps}
    if offenders:
        evidence["discontinuities"] = offenders[:EVIDENCE_CAP]
        return _verdict(inv, "fail", evidence)
    return _verdict(inv, "pass", evidence)


def _eval_alerts_resolved(inv: Invariant, bundle: TelemetryBundle) -> dict:
    if bundle.alerts is None:
        return _missing(inv, "no alert state in bundle")
    allowed = set(inv.allow)
    firing = [a for a in (bundle.alerts.get("alerts") or [])
              if a.get("rule") not in allowed]
    history = bundle.alerts.get("history") or []
    evidence = {
        "history_events": len(history),
        "fired_total": sum(1 for e in history if e.get("event") == "fired"),
        "resolved_total": sum(1 for e in history
                              if e.get("event") == "resolved"),
    }
    if firing:
        evidence["unresolved_alerts"] = firing[:EVIDENCE_CAP]
        return _verdict(inv, "fail", evidence)
    return _verdict(inv, "pass", evidence)


def _eval_slo(inv: Invariant, bundle: TelemetryBundle) -> dict:
    if bundle.snapshot is None:
        return _missing(inv, "no registry snapshot in bundle")
    family = bundle.snapshot.get(inv.metric)
    if family is None or family.get("type") != "histogram":
        return _missing(inv, f"no histogram {inv.metric} in snapshot")
    counts = _slo_counts(family, inv.le, inv.labels)
    if counts is None:
        return _missing(
            inv, f"le={inv.le} is not a bucket bound of {inv.metric}")
    good, total = counts
    if total <= 0:
        return _missing(inv, "histogram has no observations")
    ratio = good / total
    evidence = {
        "metric": inv.metric,
        "labels": inv.labels or None,
        "le": inv.le,
        "objective": inv.objective,
        "good": int(good),
        "total": int(total),
        "ratio": round(ratio, 6),
    }
    return _verdict(inv, "pass" if ratio >= inv.objective else "fail",
                    evidence)


def _window_scope(inv: Invariant,
                  hist: dict) -> tuple[Optional[tuple[float, float]], str]:
    """The (start, end) seconds an invariant judges, or (None, reason)."""
    if inv.window is not None:
        bounds = obs_history.window_bounds(hist, inv.window)
        if bounds is None:
            return None, f"no window {inv.window!r} marked in history"
        return bounds, ""
    bounds = obs_history.trailing_bounds(hist, inv.span)
    if bounds is None:
        return None, "history has no sample coverage"
    return bounds, ""


def _scope_evidence(inv: Invariant, start: float, end: float) -> dict:
    scope = ({"window": inv.window} if inv.window is not None
             else {"span": inv.span})
    scope["start"] = round(start, 3)
    scope["end"] = round(end, 3)
    return scope


def _eval_metric_during(inv: Invariant, bundle: TelemetryBundle) -> dict:
    if bundle.history is None:
        return _missing(inv, "no metrics history in bundle")
    bounds, reason = _window_scope(inv, bundle.history)
    if bounds is None:
        return _missing(inv, reason)
    start, end = bounds
    selected = obs_history.select_series_points(
        bundle.history, inv.metric, inv.labels)
    family = (bundle.history.get("series") or {}).get(inv.metric) or {}
    kind = family.get("type")
    observed: Optional[float] = None
    if selected:
        if kind == "histogram":
            merged: Optional[dict] = None
            for pts in selected.values():
                sample = obs_history.windowed_hist_sample(pts, start, end)
                if sample is None:
                    continue
                if merged is None:
                    merged = {"count": 0, "sum": 0.0,
                              "buckets": {b: 0 for b in sample["buckets"]}}
                merged["count"] += sample["count"]
                merged["sum"] += sample["sum"]
                for b, n in sample["buckets"].items():
                    merged["buckets"][b] = merged["buckets"].get(b, 0) + n
            if merged is not None:
                if inv.quantile is not None:
                    observed = _snapshot_quantile(merged, inv.quantile)
                else:
                    observed = float(merged["count"])
        elif kind == "counter":
            deltas = [obs_history.windowed_counter_delta(pts, start, end)
                      for pts in selected.values()]
            deltas = [d for d in deltas if d is not None]
            if deltas:
                observed = sum(deltas)
        else:  # gauge: worst/best/final instant, per `agg`
            extents = [obs_history.windowed_gauge_extent(
                pts, start, end, agg=inv.agg)
                for pts in selected.values()]
            extents = [e for e in extents if e is not None]
            if extents:
                observed = {"min": min, "max": max}.get(
                    inv.agg, max)(extents)
    if observed is None:
        if inv.missing == "zero":
            observed = 0.0
        else:
            return _missing(
                inv, f"no sampled points for {inv.metric} "
                     f"(labels {inv.labels or {}}) inside the window")
    holds = _OPS[inv.op](observed, inv.value)
    evidence = {
        "metric": inv.metric,
        "labels": inv.labels or None,
        "scope": _scope_evidence(inv, start, end),
        **({"quantile": inv.quantile} if inv.quantile is not None else {}),
        **({"agg": inv.agg} if kind == "gauge" else {}),
        "observed": round(observed, 6),
        "op": inv.op,
        "value": inv.value,
    }
    return _verdict(inv, "pass" if holds else "fail", evidence)


def _eval_slo_during(inv: Invariant, bundle: TelemetryBundle) -> dict:
    if bundle.history is None:
        return _missing(inv, "no metrics history in bundle")
    bounds, reason = _window_scope(inv, bundle.history)
    if bounds is None:
        return _missing(inv, reason)
    start, end = bounds
    family = (bundle.history.get("series") or {}).get(inv.metric)
    if not family or family.get("type") != "histogram":
        return _missing(inv, f"no histogram {inv.metric} in history")
    selected = obs_history.select_series_points(
        bundle.history, inv.metric, inv.labels)
    if not selected:
        return _missing(inv, f"no series matches labels {inv.labels}")
    good = total = 0.0
    for pts in selected.values():
        sample = obs_history.windowed_hist_sample(pts, start, end)
        if sample is None:
            continue
        counts = obs_history.sample_slo_counts(sample, inv.le)
        if counts is None:
            return _missing(
                inv, f"le={inv.le} is not a bucket bound of {inv.metric}")
        good += counts[0]
        total += counts[1]
    if total <= 0:
        return _missing(inv, "no observations inside the window")
    ratio = good / total
    evidence = {
        "metric": inv.metric,
        "labels": inv.labels or None,
        "scope": _scope_evidence(inv, start, end),
        "le": inv.le,
        "objective": inv.objective,
        "good": int(good),
        "total": int(total),
        "ratio": round(ratio, 6),
    }
    return _verdict(inv, "pass" if ratio >= inv.objective else "fail",
                    evidence)


def _eval_quota_violation(inv: Invariant, bundle: TelemetryBundle) -> dict:
    """No sampled instant may show a project over its quota: every
    usage point is compared against the carry-forward limit for the
    same (project, resource) series. Limit <= 0 (or never sampled)
    means unlimited — admission semantics."""
    if bundle.history is None:
        return _missing(inv, "no metrics history in bundle")
    series = bundle.history.get("series") or {}
    usage = (series.get("polyaxon_project_usage") or {}).get("series") or {}
    limits = ((series.get("polyaxon_project_quota_limit") or {})
              .get("series") or {})
    if not usage:
        return _missing(inv, "no project-usage samples in history")
    breaches = []
    instants = 0
    for key, points in usage.items():
        limit_points = limits.get(key) or []
        for t, used in points:
            if isinstance(used, dict):
                continue
            instants += 1
            limit = obs_history.value_at(limit_points, t)
            if limit is None or float(limit) <= 0:
                continue
            if float(used) > float(limit) + 1e-9:
                breaches.append({
                    "series": key,
                    "at": round(float(t), 3),
                    "used": float(used),
                    "limit": float(limit),
                })
    evidence = {"series_checked": len(usage),
                "instants_checked": instants}
    if breaches:
        evidence["breaches"] = breaches[:EVIDENCE_CAP]
        evidence["breach_total"] = len(breaches)
        return _verdict(inv, "fail", evidence)
    return _verdict(inv, "pass", evidence)


_EVALUATORS = {
    "run_terminal": _eval_run_terminal,
    "phase_budget": _eval_phase_budget,
    "metric": _eval_metric,
    "loss_continuity": _eval_loss_continuity,
    "alerts_resolved": _eval_alerts_resolved,
    "slo": _eval_slo,
    "metric_during": _eval_metric_during,
    "slo_during": _eval_slo_during,
    "quota_violation": _eval_quota_violation,
}


def evaluate(invariants: list[Invariant],
             bundle: TelemetryBundle) -> list[dict]:
    """One pass: every invariant judged against the bundle. Pure —
    the verdict-count metric is the only side effect."""
    verdicts = [_EVALUATORS[inv.kind](inv, bundle) for inv in invariants]
    for verdict in verdicts:
        obs_metrics.oracle_verdicts_total().inc(verdict=verdict["verdict"])
    return verdicts


def summarize(verdicts: list[dict]) -> dict:
    counts = {"pass": 0, "fail": 0, "skip": 0}
    for v in verdicts:
        counts[v["verdict"]] = counts.get(v["verdict"], 0) + 1
    return {
        "passed": counts["fail"] == 0,
        "counts": counts,
        "verdicts": verdicts,
    }


def verify_plane(plane, *, run_uuid: Optional[str] = None,
                 source: Any = None, engine=None,
                 baseline: Optional[dict] = None) -> dict:
    """Evaluate the committed invariant set (or ``source``) against a
    live control plane — the engine behind ``ControlPlane.verify``.
    Alert rules are evaluated first so the alert surface reflects *now*,
    not the last reconcile pass."""
    from polyaxon_tpu_torch.obs import rules as obs_rules

    invariants = load_invariants(source)
    if engine is None:
        engine = obs_rules.default_engine()
    engine.evaluate(plane=plane)
    bundle = TelemetryBundle.from_plane(plane, run_uuid=run_uuid,
                                        engine=engine, baseline=baseline)
    result = summarize(evaluate(invariants, bundle))
    if run_uuid is not None:
        result["run_uuid"] = run_uuid
    return result


# ----------------------------------------------------------- schema gate
def check_invariants(path: Optional[str] = None) -> list[Invariant]:
    """CI entry: load (and thereby fully validate) an invariant file."""
    return load_invariants(path or DEFAULT_ORACLE_PATH)


def _main(argv: Optional[list[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Validate a telemetry-oracle invariant set")
    parser.add_argument("--check", action="store_true", required=True)
    parser.add_argument("path", nargs="?", default=DEFAULT_ORACLE_PATH)
    args = parser.parse_args(argv)
    try:
        invariants = check_invariants(args.path)
    except (OracleError, OSError, json.JSONDecodeError) as exc:
        print(f"ORACLE INVALID: {exc}")
        return 1
    kinds = sorted({inv.kind for inv in invariants})
    print(f"oracle ok: {len(invariants)} invariant(s) in {args.path} "
          f"(kinds: {', '.join(kinds)})")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
