"""Serving-request phase decomposition (the part of
``polyaxon_tpu/obs/analyze.py`` the serving path reads, the same code
under the port's module names): ``request_phases`` folds one request's
span tree (``obs.reqtrace``) into queue-wait / prefill / decode
milliseconds, TTFT and event tallies. The run-report half of the JAX
module (``analyze_timeline``, ``analyze_run_dir``) is ROADMAP.md,
Queue 1 item 9.
"""

from __future__ import annotations

from typing import Any, Iterator


def walk_spans(nodes: list[dict]) -> Iterator[dict]:
    for node in nodes:
        yield node
        yield from walk_spans(node.get("children") or [])



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
