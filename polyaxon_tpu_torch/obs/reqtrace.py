"""Per-request span trees for the serving path (port of
``polyaxon_tpu/obs/reqtrace.py``, the same code under the port's
module names).

Training runs persist their lifecycle spans to the run dir and the
sidecar ships them (obs.trace.RunTracer); a serving request has no run
dir and lives for milliseconds, so its spans stay **in memory**: each
request gets a :class:`RequestTrace` (the trace id IS the request id)
holding the Dapper-shaped phase tree —

    request                     (root; class/prompt_len/max_new attrs)
      queue_wait                (submit → admission dequeue; paged
                                backpressure annotates `requeue` here)
      prefill                   (monolithic admission prefill, or the
                                chunked stream — one `chunk` event per
                                segment, bounded)
      decode                    (go-live → retire; `first_token`,
                                `spec_round`, `evicted` events land on
                                whatever phase is current)

— and a :class:`TimelineRing` keeps the most recent N traces so
``GET /requests/{id}/timeline`` (serving/server.py) and
``plx ops request-timeline`` can replay any recent request without
unbounded growth. Records reuse the obs.trace Span shape, so
:func:`obs.trace.build_timeline` assembles the same tree JSON the run
timeline endpoint serves — one waterfall renderer fits both.

Everything here is passive observability: mutators never raise into
the engine loop, snapshots copy under a per-trace lock (the loop
thread records while HTTP handler threads read), and per-span events
are capped so a pathological request cannot grow a span without bound.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Optional

from polyaxon_tpu_torch.obs.trace import Span, build_timeline

# Per-span annotation cap: a 10k-token speculative request must not
# accumulate 10k `spec_round` events in a ring entry. The cap-hit count
# lands in the span's attributes so truncation is visible, not silent.
MAX_EVENTS_PER_SPAN = 64

DEFAULT_RING_CAPACITY = 256


def new_request_id() -> str:
    return os.urandom(8).hex()


class RequestTrace:
    """Span scaffolding for ONE serving request.

    The engine drives phases in order (``start_phase`` closes the
    previous one implicitly — request phases never overlap); deep seams
    annotate whatever phase is current via :meth:`event`. ``finish`` is
    idempotent: every failure path may call it without coordinating
    with the retire path.

    Fleet propagation: the fleet front door pre-generates
    the request id, opens a ``route`` span under the same trace id,
    and hands the engine its span record plus a ``parent_id`` — the
    request root nests under the route decision and the finished
    timeline is ONE tree across components. ``component`` names the
    recording replica on every span, so an eviction→readmit arc reads
    with per-hop identity.
    """

    def __init__(self, request_id: str, klass: str = "batch",
                 component: str = "serving",
                 parent_id: Optional[str] = None,
                 extra_records: Optional[list] = None,
                 **attrs: Any):
        self.request_id = request_id
        self.klass = klass
        self.component = component or "serving"
        self._lock = threading.Lock()
        self.root = Span(trace_id=request_id, name="request",
                         component=self.component, parent_id=parent_id,
                         attributes={"class": klass, **attrs})
        self._spans: list[Span] = [self.root]
        # Upstream span records (the router's `route` span) replay
        # verbatim into records(), so build_timeline sees the whole
        # cross-component tree without any join step.
        self._extra_records = list(extra_records or [])
        self._phase: Optional[Span] = None
        self._done = False

    # -- phases ------------------------------------------------------------
    def start_phase(self, name: str, **attrs: Any) -> Optional[Span]:
        with self._lock:
            if self._done:
                return None
            if self._phase is not None and self._phase.end is None:
                self._phase.end = time.time()
            span = Span(trace_id=self.request_id, name=name,
                        parent_id=self.root.span_id,
                        component=self.component,
                        attributes=dict(attrs))
            self._spans.append(span)
            self._phase = span
            return span

    def end_phase(self, status: str = "ok",
                  error: Optional[str] = None, **attrs: Any) -> None:
        with self._lock:
            span = self._phase
            if span is None or span.end is not None:
                return
            span.end = time.time()
            span.status = status
            if error:
                span.error = error[:500]
            span.attributes.update(attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Annotate the current phase (the root before any phase
        opened). Bounded: past :data:`MAX_EVENTS_PER_SPAN` the event is
        counted into ``events_dropped`` instead of appended."""
        with self._lock:
            span = self._phase if self._phase is not None else self.root
            if len(span.events) >= MAX_EVENTS_PER_SPAN:
                span.attributes["events_dropped"] = (
                    int(span.attributes.get("events_dropped") or 0) + 1)
                return
            span.add_event(name, **attrs)

    def finish(self, status: str = "ok", error: Optional[str] = None,
               **attrs: Any) -> None:
        """Close any open phase and the root. Idempotent — the first
        caller's verdict wins (retire vs a racing failure path)."""
        with self._lock:
            if self._done:
                return
            self._done = True
            now = time.time()
            if self._phase is not None and self._phase.end is None:
                self._phase.end = now
                if status != "ok":
                    self._phase.status = status
                    if error:
                        self._phase.error = error[:500]
            self.root.end = now
            self.root.status = status
            if error:
                self.root.error = error[:500]
            self.root.attributes.update(attrs)

    @property
    def done(self) -> bool:
        return self._done

    # -- snapshots ---------------------------------------------------------
    def records(self) -> list[dict[str, Any]]:
        """Span records (open spans snapshot with end=now), consumable
        by :func:`obs.trace.build_timeline` — upstream records (the
        route span) first, so the tree root is the earliest hop."""
        with self._lock:
            return ([dict(r) for r in self._extra_records]
                    + [span.to_record() for span in self._spans])

    def summary(self) -> dict[str, Any]:
        """One listing row for ``GET /requests``."""
        with self._lock:
            return {
                "request_id": self.request_id,
                "class": self.klass,
                "status": self.root.status,
                "done": self._done,
                "phase": (self._phase.name
                          if self._phase is not None and not self._done
                          else None),
                "start": self.root.start,
                **({"error": self.root.error} if self.root.error else {}),
            }


class TimelineRing:
    """Bounded most-recent-N request traces, keyed by request id.

    Insertion order is submission order; past ``capacity`` the oldest
    entry drops (even if still in flight — the engine keeps recording
    into its own reference, the trace just stops being queryable).
    """

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._traces: collections.OrderedDict[str, RequestTrace] = (
            collections.OrderedDict())
        self.evicted = 0

    def add(self, trace: RequestTrace) -> None:
        with self._lock:
            self._traces[trace.request_id] = trace
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)
                self.evicted += 1

    def get(self, request_id: str) -> Optional[RequestTrace]:
        with self._lock:
            return self._traces.get(request_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def summaries(self) -> list[dict[str, Any]]:
        """Most recent first."""
        with self._lock:
            traces = list(self._traces.values())
        return [t.summary() for t in reversed(traces)]

    def timeline(self, request_id: str) -> Optional[dict[str, Any]]:
        trace = self.get(request_id)
        if trace is None:
            return None
        return build_timeline(trace.records(), trace_id=request_id)

    def to_dump(self) -> dict[str, Any]:
        """The whole ring as plain data (oldest first), the serving
        mirror of a training run's ``postmortem.json``: summaries for
        the listing view plus full span records per request so
        ``build_timeline`` — and ``sim.replay`` — can reconstruct any
        request after the process is gone."""
        with self._lock:
            traces = list(self._traces.values())
            evicted = self.evicted
        return {
            "dumped_at": time.time(),
            "capacity": self.capacity,
            "evicted": evicted,
            "requests": [{
                "summary": t.summary(),
                "records": t.records(),
            } for t in traces],
        }


TRACE_DUMP_FILE = "request-timelines.json"


def dump_ring(ring: TimelineRing, path: str) -> str:
    """Persist a ring dump atomically (tmp + replace, the postmortem
    idiom). A directory path gets :data:`TRACE_DUMP_FILE` appended.
    Raises on I/O failure — the caller owns fail-open policy."""
    import json

    if os.path.isdir(path) or path.endswith(os.sep):
        path = os.path.join(path, TRACE_DUMP_FILE)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(ring.to_dump(), fh, indent=2, default=str)
    os.replace(tmp, path)
    return path


def read_ring_dump(path: str) -> Optional[dict[str, Any]]:
    """Load a persisted ring dump (None when absent/corrupt — same
    posture as ``flight.read_postmortem``)."""
    import json

    if os.path.isdir(path):
        path = os.path.join(path, TRACE_DUMP_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
