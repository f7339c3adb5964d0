"""Run-lifecycle tracing (ISSUE 5 tentpole): Dapper-shaped spans over
the whole orchestration spine.

The trace id IS the run uuid; spans carry parent links and typed
attributes, and persist as ``events/span/lifecycle.jsonl`` under the
run's artifacts dir — the existing :class:`EventWriter` contract — so
the sidecar ships timelines to the store and streams serve them back
with zero new plumbing. Producers across process boundaries:

- control plane: ``compile`` (ControlPlane.compile_run);
- agent: ``admission`` (the pass that cleared the run), ``placement``
  (slice-pool clearance), ``execute`` (gang lifetime) with an ``init``
  child per start attempt;
- runtime loop: ``runtime`` → ``jit_compile`` / ``restore`` / ``step``
  (one per metrics-emission window, reusing ``step_time_ms`` /
  ``input_wait_ms``) / ``checkpoint`` / ``eval``;
- sidecar: ``sync`` per pass that shipped files.

Propagation follows the graft-entry env plumbing: the executor stamps
``POLYAXON_TRACE_PARENT=<trace_id>:<span_id>`` into every gang
process's env, and :meth:`RunTracer.from_env` picks it up so subprocess
runtime spans parent under the agent's ``execute`` span.

Cross-cutting seams attach ANNOTATIONS instead of spans: the active
span rides a per-thread :mod:`contextvars` slot, and
:func:`add_event` lets deep layers (chaos fault firings, retry
attempts) stamp events onto whatever lifecycle phase is running —
that is how a chaos drill reads as an annotated timeline instead of a
log-archaeology session.

Port of ``polyaxon_tpu/obs/trace.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime as _dt
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

from polyaxon_tpu_torch.tracking.events import EventWriter, V1EventKind, read_jsonl

ENV_TRACE_PARENT = "POLYAXON_TRACE_PARENT"
SPAN_STREAM = "lifecycle"  # events/span/lifecycle.jsonl


def _iso(epoch: float) -> str:
    return _dt.datetime.fromtimestamp(
        epoch, _dt.timezone.utc).isoformat()


def new_span_id() -> str:
    return os.urandom(8).hex()


@dataclass
class Span:
    trace_id: str
    name: str
    span_id: str = field(default_factory=new_span_id)
    parent_id: Optional[str] = None
    component: str = ""
    start: float = field(default_factory=time.time)
    end: Optional[float] = None
    status: str = "ok"
    error: Optional[str] = None
    attributes: dict[str, Any] = field(default_factory=dict)
    events: list[dict[str, Any]] = field(default_factory=list)

    def set(self, **attrs: Any) -> "Span":
        self.attributes.update(attrs)
        return self

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"name": name, "time": time.time(),
                            **({"attributes": attrs} if attrs else {})})

    def to_record(self) -> dict[str, Any]:
        end = self.end if self.end is not None else time.time()
        return {
            "type": "span",
            "timestamp": _iso(end),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "component": self.component,
            "start": self.start,
            "end": end,
            "duration_ms": round((end - self.start) * 1e3, 3),
            "status": self.status,
            **({"error": self.error} if self.error else {}),
            "attributes": self.attributes,
            "events": list(self.events),
        }


# The active span of the CURRENT thread/context: deep seams (chaos
# firings, store retries) annotate whatever lifecycle phase is running
# without threading a tracer through every call signature.
_CURRENT: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "polyaxon_tpu_span", default=None)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def add_event(name: str, **attrs: Any) -> bool:
    """Attach an event to the active span, if any. Never raises — this
    is called from failure paths that must not grow new failure modes."""
    try:
        span = _CURRENT.get()
        if span is None:
            return False
        span.add_event(name, **attrs)
        return True
    except Exception:  # noqa: BLE001 — observability must stay passive
        return False


def parse_trace_parent(raw: Optional[str]) -> tuple[Optional[str],
                                                    Optional[str]]:
    """``<trace_id>:<span_id>`` → (trace_id, span_id); (None, None) on
    anything malformed."""
    if not raw or ":" not in raw:
        return None, None
    trace_id, _, span_id = raw.rpartition(":")
    if not trace_id or not span_id:
        return None, None
    return trace_id, span_id


def format_trace_parent(trace_id: str, span_id: str) -> str:
    return f"{trace_id}:{span_id}"


class RunTracer:
    """Span writer for one run directory.

    Completed spans append to ``events/span/lifecycle.jsonl`` through a
    lazily-opened :class:`EventWriter` handle; call :meth:`close` (the
    runtime loop registers it on its ExitStack; the executor closes at
    gang reap) to release it. ``parent_id`` is the default parent for
    spans started without an explicit one — the propagated remote
    parent (e.g. the agent's ``execute`` span for a runtime tracer).
    """

    def __init__(self, run_dir: str, trace_id: str, *,
                 parent_id: Optional[str] = None, component: str = ""):
        self.run_dir = run_dir
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.component = component
        self._writer = EventWriter(run_dir)

    @classmethod
    def from_env(cls, run_dir: str, *, component: str = "") -> "RunTracer":
        """Tracer from the compiled env contract: trace id from
        ``POLYAXON_RUN_UUID`` (falling back to the run-dir basename —
        artifacts dirs are ``<root>/<uuid>``), remote parent from
        ``POLYAXON_TRACE_PARENT``."""
        trace_id = (os.environ.get("POLYAXON_RUN_UUID")
                    or os.path.basename(os.path.abspath(run_dir)))
        _, parent_id = parse_trace_parent(
            os.environ.get(ENV_TRACE_PARENT))
        return cls(run_dir, trace_id, parent_id=parent_id,
                   component=component)

    # -- span lifecycle ----------------------------------------------------
    def start_span(self, name: str, *, parent: Optional[Span] = None,
                   parent_id: Optional[str] = None,
                   attributes: Optional[dict] = None) -> Span:
        return Span(
            trace_id=self.trace_id,
            name=name,
            parent_id=(parent.span_id if parent is not None
                       else parent_id if parent_id is not None
                       else self.parent_id),
            component=self.component,
            attributes=dict(attributes or {}),
        )

    def finish(self, span: Span, *, status: str = "ok",
               error: Optional[str] = None) -> Span:
        if span.end is None:
            span.end = time.time()
        span.status = status
        if error:
            span.error = error[:500]
        self.write(span.to_record())
        return span

    @contextlib.contextmanager
    def span(self, name: str, *, parent: Optional[Span] = None,
             parent_id: Optional[str] = None,
             attributes: Optional[dict] = None) -> Iterator[Span]:
        """Context-managed span: becomes the thread's current span for
        its body (so :func:`add_event` seams land on it), nests under
        the enclosing current span by default, records error status on
        an exception, and always writes on exit."""
        enclosing = _CURRENT.get()
        span = self.start_span(
            name, parent=parent if parent is not None else enclosing,
            parent_id=parent_id, attributes=attributes)
        token = _CURRENT.set(span)
        try:
            yield span
        except BaseException as exc:
            span.end = time.time()
            self.finish(span, status="error",
                        error=f"{type(exc).__name__}: {exc}")
            raise
        finally:
            _CURRENT.reset(token)
            if span.end is None:
                self.finish(span)

    def record_completed(self, name: str, *, start: float, end: float,
                         parent_id: Optional[str] = None,
                         status: str = "ok", error: Optional[str] = None,
                         attributes: Optional[dict] = None,
                         events: Optional[list] = None) -> Span:
        """Write a span whose boundaries were measured by the caller
        (emission windows, admission passes)."""
        span = self.start_span(name, parent_id=parent_id,
                               attributes=attributes)
        span.start = start
        span.end = end
        span.events = list(events or [])
        return self.finish(span, status=status, error=error)

    def event(self, name: str, *, parent_id: Optional[str] = None,
              attributes: Optional[dict] = None) -> None:
        """Standalone timeline annotation not tied to an open span
        (e.g. the scheduler's requeue decision)."""
        now = time.time()
        self.write({
            "type": "event",
            "timestamp": _iso(now),
            "trace_id": self.trace_id,
            "parent_id": (parent_id if parent_id is not None
                          else self.parent_id),
            "name": name,
            "time": now,
            "attributes": dict(attributes or {}),
        })

    # -- io ---------------------------------------------------------------
    def write(self, record: dict[str, Any]) -> None:
        self._writer.write(V1EventKind.SPAN, SPAN_STREAM, record)
        # Every written span/event also lands in the run's flight-
        # recorder ring (obs.flight): the postmortem of a dead run is
        # fed as a side effect of normal tracing, no second producer.
        try:
            from polyaxon_tpu_torch.obs import flight as _flight

            _flight.RECORDER.record_trace(self.trace_id, record)
        except Exception as exc:  # the recorder is fail-open
            logging.getLogger(__name__).debug(
                "flight-recorder trace tap failed: %s", exc)

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()

    def __enter__(self) -> "RunTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def span_file(run_dir: str) -> str:
    return os.path.join(run_dir, "events", V1EventKind.SPAN,
                        f"{SPAN_STREAM}.jsonl")


def record_completed(run_dir: str, trace_id: str, name: str, *,
                     start: float, end: float, component: str = "",
                     parent_id: Optional[str] = None, status: str = "ok",
                     error: Optional[str] = None,
                     attributes: Optional[dict] = None) -> str:
    """One-shot completed-span append without a long-lived tracer —
    the control-plane seams (compile, admission, placement) fire a few
    times per run, so open-append-close per span is the simple safe
    choice (O_APPEND keeps concurrent writers line-atomic). Returns the
    lifecycle file path (the sidecar ships it eagerly)."""
    with RunTracer(run_dir, trace_id, parent_id=parent_id,
                   component=component) as tracer:
        tracer.record_completed(name, start=start, end=end, status=status,
                                error=error, attributes=attributes)
    return span_file(run_dir)


def record_event(run_dir: str, trace_id: str, name: str, *,
                 component: str = "", parent_id: Optional[str] = None,
                 attributes: Optional[dict] = None) -> str:
    """One-shot standalone event append (see :meth:`RunTracer.event`)."""
    with RunTracer(run_dir, trace_id, parent_id=parent_id,
                   component=component) as tracer:
        tracer.event(name, attributes=attributes)
    return span_file(run_dir)


# ------------------------------------------------------------- timeline
def read_trace(run_dir: str) -> list[dict[str, Any]]:
    """All span/event records of a run (tolerant of torn sidecar
    writes, like every jsonl reader here)."""
    return read_jsonl(span_file(run_dir))


def build_timeline(records: list[dict[str, Any]],
                   trace_id: Optional[str] = None) -> dict[str, Any]:
    """Ordered span tree from raw lifecycle records.

    Spans nest under their ``parent_id`` (an unknown parent — e.g. the
    parent's record not yet synced — degrades to a root, never drops
    the span); siblings and roots sort by start time; standalone events
    attach to their parent span's ``events`` list, or surface in the
    top-level ``events`` when unparented. ``t0``/``duration_ms`` give
    waterfall consumers the frame without re-deriving it.
    """
    spans: dict[str, dict] = {}
    loose_events: list[dict] = []
    for rec in records:
        if rec.get("type") == "span" and rec.get("span_id"):
            node = dict(rec)
            node["children"] = []
            node["events"] = list(rec.get("events") or [])
            spans[node["span_id"]] = node
        elif rec.get("type") == "event":
            loose_events.append(rec)

    roots: list[dict] = []
    for node in spans.values():
        parent = spans.get(node.get("parent_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)

    top_events: list[dict] = []
    for rec in loose_events:
        parent = spans.get(rec.get("parent_id") or "")
        event = {"name": rec.get("name"), "time": rec.get("time"),
                 **({"attributes": rec["attributes"]}
                    if rec.get("attributes") else {})}
        if parent is not None:
            parent["events"].append(event)
        else:
            top_events.append(event)

    def sort_tree(nodes: list[dict]) -> None:
        # span_id as the final tie-break: same-millisecond siblings with
        # the same name (e.g. two per-attempt init spans) would otherwise
        # order by dict insertion — i.e. file order, which the sidecar
        # may interleave — and golden report/timeline output would
        # wobble across runs.
        nodes.sort(key=lambda n: (n.get("start") or 0, n.get("name") or "",
                                  n.get("span_id") or ""))
        for node in nodes:
            node["events"].sort(key=lambda e: (e.get("time") or 0,
                                               e.get("name") or ""))
            sort_tree(node["children"])

    sort_tree(roots)
    top_events.sort(key=lambda e: e.get("time") or 0)

    starts = [n.get("start") for n in spans.values()
              if n.get("start") is not None]
    starts += [e["time"] for e in top_events if e.get("time") is not None]
    ends = [n.get("end") for n in spans.values() if n.get("end") is not None]
    t0 = min(starts) if starts else None
    t_end = max(ends + ([t0] if t0 is not None else [])) if ends or t0 else None
    if trace_id is None and spans:
        trace_id = next(iter(spans.values())).get("trace_id")
    return {
        "trace_id": trace_id,
        "t0": t0,
        "duration_ms": (round((t_end - t0) * 1e3, 3)
                        if t0 is not None and t_end is not None else 0.0),
        "span_count": len(spans),
        "spans": roots,
        "events": top_events,
    }


def _json_default(value):  # pragma: no cover - debugging aid
    return str(value)


def dump_timeline(timeline: dict[str, Any]) -> str:
    return json.dumps(timeline, default=_json_default, indent=2)
