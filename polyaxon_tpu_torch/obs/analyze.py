"""Performance attribution from a run's span tree (port of
``polyaxon_tpu/obs/analyze.py``, the same code under the port's module
names).

This module folds a run's lifecycle timeline (obs.trace.build_timeline
output) into a report that answers the three operator questions
directly:

1. **Where did the wall clock go?** Leaf-phase spans decompose it:
   compile (control-plane spec compile + the warm-up step's
   ``jit_compile``), queue wait (compile end → first execute start),
   scheduling (admission + placement passes), init, restore, step —
   split into device compute vs input wait using each window's
   ``input_wait_ms`` — checkpoint, eval, requeue backoff (gaps between
   execute attempts), and sidecar sync; whatever no leaf covers is
   ``other``. Container spans (execute/runtime) are frames, not time
   sinks, and are excluded so phases sum to ~the wall clock instead of
   double it.
2. **Is step time drifting?** The per-emission-window ``step`` spans
   carry ``step_time_ms``; a rolling median + MAD (the robust pair —
   one checkpoint hiccup must not move the baseline) flags anomalous
   windows at ``|x - median| > 3.5 * 1.4826 * MAD``.
3. **What hit it?** Retry / ``chaos.*`` span events are counted per
   phase, requeues per reason — a chaos drill's report says which
   phase absorbed which fault without reading the raw timeline.

Surfaces: ``ControlPlane.report`` and ``analyze_run_dir`` (a report
straight from a run's artifacts directory, with ``compact_report`` its
per-point form). ``request_phases`` does the same for one serving
request's span tree (``obs.reqtrace``).
"""

from __future__ import annotations

import statistics
from typing import Any, Iterator, Optional

# Leaf phases, in report order. `step` is further split into device
# compute vs input wait; anything not covered lands in `other`.
PHASE_ORDER = ("compile", "queue_wait", "scheduling", "init", "jit_compile",
               "restore", "step", "input_wait", "checkpoint", "eval",
               "resize", "requeue_wait", "sync", "other")

# Span names that are containers (frames around children), not phases.
_CONTAINER_SPANS = {"execute", "runtime"}
# Leaf span name → phase bucket.
_LEAF_PHASES = {"compile": "compile", "admission": "scheduling",
                "placement": "scheduling", "init": "init",
                "jit_compile": "jit_compile", "restore": "restore",
                "checkpoint": "checkpoint", "eval": "eval", "sync": "sync",
                "resize": "resize"}

MAD_K = 3.5          # deviation threshold, in robust sigmas
MAD_SCALE = 1.4826   # MAD → sigma under normality
TREND_WINDOW = 8     # rolling window, in emission windows


def walk_spans(nodes: list[dict]) -> Iterator[dict]:
    for node in nodes:
        yield node
        yield from walk_spans(node.get("children") or [])


def _rolling_anomalies(windows: list[dict]) -> tuple[Optional[float],
                                                     list[dict]]:
    """Rolling-median/MAD anomaly flags over the step-time series.
    Each window is judged against the median/MAD of the up-to-
    TREND_WINDOW points BEFORE it (never itself — a spike must not
    vouch for itself)."""
    series = [w["step_time_ms"] for w in windows]
    anomalies: list[dict] = []
    for i, value in enumerate(series):
        history = series[max(i - TREND_WINDOW, 0):i]
        if len(history) < 3:
            continue
        median = statistics.median(history)
        mad = statistics.median(abs(x - median) for x in history)
        sigma = max(MAD_SCALE * mad, 1e-3 * max(median, 1.0))
        deviation = (value - median) / sigma
        if abs(deviation) > MAD_K:
            anomalies.append({
                "to_step": windows[i].get("to_step"),
                "step_time_ms": round(value, 3),
                "median_ms": round(median, 3),
                "deviation_sigmas": round(deviation, 2),
            })
    overall = statistics.median(series) if series else None
    return (round(overall, 3) if overall is not None else None), anomalies


def analyze_timeline(timeline: dict[str, Any]) -> dict[str, Any]:
    """Fold one run's span tree + annotations into the attribution
    report. Pure function of the timeline dict — callers attach run
    metadata (status, alerts) themselves."""
    spans = list(walk_spans(timeline.get("spans") or []))
    wall_ms = float(timeline.get("duration_ms") or 0.0)

    phases: dict[str, dict[str, float]] = {
        name: {"ms": 0.0, "count": 0} for name in PHASE_ORDER}

    def credit(name: str, ms: float, n: int = 1) -> None:
        phases[name]["ms"] += max(ms, 0.0)
        phases[name]["count"] += n

    step_windows: list[dict] = []
    executes: list[dict] = []
    compiles: list[dict] = []
    retries: dict[str, int] = {}
    chaos: dict[str, int] = {}
    # Restore-phase audit: corrupt steps culled during fallback and the
    # tier each restore was satisfied from, surfaced on the report's
    # restore phase so a report shows WHERE a rerun resumed and what it
    # had to skip to get there.
    restore_skipped: list[int] = []
    restore_tiers: dict[str, int] = {}
    for span in spans:
        name = span.get("name") or ""
        duration = float(span.get("duration_ms") or 0.0)
        for event in span.get("events") or []:
            ev_name = event.get("name") or ""
            if ev_name == "retry":
                retries[name] = retries.get(name, 0) + 1
            elif ev_name.startswith("chaos."):
                chaos[name] = chaos.get(name, 0) + 1
        if name in _CONTAINER_SPANS:
            if name == "execute":
                executes.append(span)
            continue
        if name == "step":
            attrs = span.get("attributes") or {}
            steps = int(attrs.get("steps") or 0)
            wait_ms = float(attrs.get("input_wait_ms") or 0.0) * steps
            wait_ms = min(wait_ms, duration)
            credit("input_wait", wait_ms, 0)
            credit("step", duration - wait_ms)
            if attrs.get("step_time_ms") is not None:
                window = {
                    "from_step": attrs.get("from_step"),
                    "to_step": attrs.get("to_step"),
                    "steps": steps,
                    "step_time_ms": float(attrs["step_time_ms"]),
                    "input_wait_ms": float(attrs.get("input_wait_ms") or 0.0),
                }
                # The oracle's loss-continuity invariant reads the loss
                # each window ended at, when the loop recorded one.
                if attrs.get("loss") is not None:
                    window["loss"] = float(attrs["loss"])
                step_windows.append(window)
            continue
        phase = _LEAF_PHASES.get(name)
        if phase is not None:
            credit(phase, duration)
            if name == "compile":
                compiles.append(span)
            elif name == "restore":
                attrs = span.get("attributes") or {}
                restore_skipped.extend(
                    int(s) for s in attrs.get("skipped_steps") or [])
                tier = attrs.get("restore_tier")
                if tier is not None:
                    tier = str(tier)
                    restore_tiers[tier] = restore_tiers.get(tier, 0) + 1

    # Waits between phases: compile end → first execute start is queue
    # time; gaps between execute attempts are requeue backoff.
    executes.sort(key=lambda s: s.get("start") or 0)
    if executes and compiles:
        first_compile = min(compiles, key=lambda s: s.get("start") or 0)
        if (first_compile.get("end") is not None
                and executes[0].get("start") is not None):
            credit("queue_wait",
                   (executes[0]["start"] - first_compile["end"]) * 1e3)
    for prev, nxt in zip(executes, executes[1:]):
        if prev.get("end") is not None and nxt.get("start") is not None:
            credit("requeue_wait", (nxt["start"] - prev["end"]) * 1e3)

    accounted = sum(p["ms"] for name, p in phases.items() if name != "other")
    if wall_ms > accounted:
        phases["other"]["ms"] = wall_ms - accounted
        phases["other"]["count"] = 1

    step_windows.sort(key=lambda w: (w.get("to_step") is None,
                                     w.get("to_step") or 0))
    median_ms, anomalies = _rolling_anomalies(step_windows)

    requeues: dict[str, int] = {}
    for event in timeline.get("events") or []:
        if event.get("name") == "requeue":
            reason = ((event.get("attributes") or {}).get("reason")
                      or "unknown")
            requeues[reason] = requeues.get(reason, 0) + 1

    phase_sum = sum(p["ms"] for p in phases.values())
    report_phases = {}
    for name in PHASE_ORDER:
        entry = phases[name]
        if entry["ms"] <= 0 and not entry["count"]:
            continue
        report_phases[name] = {
            "ms": round(entry["ms"], 3),
            "fraction": (round(entry["ms"] / wall_ms, 4)
                         if wall_ms > 0 else None),
            "count": int(entry["count"]),
        }
    if "restore" in report_phases:
        if restore_skipped:
            report_phases["restore"]["skipped_steps"] = restore_skipped
        if restore_tiers:
            report_phases["restore"]["tiers"] = dict(
                sorted(restore_tiers.items()))
    return {
        "run_uuid": timeline.get("trace_id"),
        "wall_clock_ms": round(wall_ms, 3),
        "phase_sum_ms": round(phase_sum, 3),
        "attempts": len(executes),
        "phases": report_phases,
        "steps": {
            "windows": [
                {**w, "step_time_ms": round(w["step_time_ms"], 3),
                 "input_wait_ms": round(w["input_wait_ms"], 3)}
                for w in step_windows],
            "rolling_median_ms": median_ms,
            "anomalies": anomalies,
        },
        "annotations": {
            "retries": retries,
            "chaos": chaos,
            "requeues": requeues,
        },
    }


def request_phases(timeline: dict[str, Any]) -> dict[str, Any]:
    """Phase decomposition of ONE serving-request timeline
    (obs.reqtrace span tree): queue-wait / prefill / decode
    milliseconds, TTFT (request start → the decode phase's
    ``first_token`` event), tokens out, and the per-phase event tallies
    (chunks streamed, speculative rounds, requeues/evictions). Pure
    function of the timeline dict — GET /requests/{id}/timeline
    attaches it as ``summary`` and ``plx ops request-timeline`` prints
    it above the waterfall."""
    spans = list(walk_spans(timeline.get("spans") or []))
    root = next((s for s in spans if (s.get("name") or "") == "request"),
                None)
    # Behind a fleet the tree's top hop is the router's
    # `route` span; it is an upstream decision, not an engine phase,
    # so it reports as its own field instead of joining phases_ms.
    route = next((s for s in spans if (s.get("name") or "") == "route"),
                 None)
    phases_ms: dict[str, float] = {}
    events: dict[str, int] = {}
    ttft_ms = None
    t0 = root.get("start") if root is not None else None
    for span in spans:
        name = span.get("name") or ""
        if name not in ("request", "route"):
            phases_ms[name] = (phases_ms.get(name, 0.0)
                               + float(span.get("duration_ms") or 0.0))
        for event in span.get("events") or []:
            ev = event.get("name") or ""
            events[ev] = events.get(ev, 0) + 1
            if (ev == "first_token" and ttft_ms is None and t0 is not None
                    and event.get("time") is not None):
                ttft_ms = (float(event["time"]) - float(t0)) * 1e3
    attrs = (root.get("attributes") or {}) if root is not None else {}
    return {
        "request_id": timeline.get("trace_id"),
        "class": attrs.get("class"),
        "status": root.get("status") if root is not None else None,
        "wall_clock_ms": round(float(timeline.get("duration_ms") or 0.0), 3),
        "phases_ms": {name: round(ms, 3)
                      for name, ms in sorted(phases_ms.items())},
        "ttft_ms": round(ttft_ms, 3) if ttft_ms is not None else None,
        "tokens_out": attrs.get("tokens_out"),
        # Radix prefix reuse (paged kv): prefill tokens served from the
        # cache instead of recomputed for THIS request.
        "prefix_cached_tokens": attrs.get("prefix_cached_tokens"),
        "events": events,
        **({"route": {
            "decision": (route.get("attributes") or {}).get("decision"),
            "replica": (route.get("attributes") or {}).get("replica"),
        }} if route is not None else {}),
        **({"replica": root.get("component")}
           if root is not None and root.get("component")
           and root.get("component") != "serving" else {}),
        **({"error": root.get("error")}
           if root is not None and root.get("error") else {}),
    }


def analyze_run_dir(run_dir: str) -> dict[str, Any]:
    """Report straight from a run's artifacts dir, without a control
    plane."""
    from polyaxon_tpu_torch.obs.trace import build_timeline, read_trace

    return analyze_timeline(build_timeline(read_trace(run_dir)))


def compact_report(report: dict[str, Any]) -> dict[str, Any]:
    """The per-point form of a report: phase milliseconds + trend
    verdict, without the full window list."""
    return {
        "wall_clock_ms": report["wall_clock_ms"],
        "phases_ms": {name: entry["ms"]
                      for name, entry in report["phases"].items()},
        "rolling_median_step_ms": report["steps"]["rolling_median_ms"],
        "anomalous_windows": len(report["steps"]["anomalies"]),
        "annotations": report["annotations"],
    }
