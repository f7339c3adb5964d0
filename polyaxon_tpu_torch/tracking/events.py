"""Event-file contract: typed jsonl streams per run (a copy of
``polyaxon_tpu/tracking/events.py``, standard library only, writing the
same file layout byte for byte so the JAX package's streams read a port
run's directory as they read their own).

Each ``log_*`` call appends a typed jsonl line under the run's events
dir; the sidecar ships the tree to the artifacts store; streams serve it
back. Layout (under ``<artifacts>/<run_uuid>/``):

    events/metric/<name>.jsonl     {"timestamp", "step", "value"}
    events/<kind>/<name>.jsonl     other typed kinds
    logs/<name>.log                plain text
    statuses.jsonl                 condition stream
    outputs.json                   declared outputs (merged)
    lineage.jsonl                  artifact lineage records
"""

from __future__ import annotations

import datetime as _dt
import json
import os
from typing import Any, Iterator, Optional


class V1EventKind:
    METRIC = "metric"
    IMAGE = "image"
    HISTOGRAM = "histogram"
    TEXT = "text"
    HTML = "html"
    AUDIO = "audio"
    VIDEO = "video"
    MODEL = "model"
    DATAFRAME = "dataframe"
    ARTIFACT = "artifact"
    CURVE = "curve"
    CONFUSION = "confusion"
    SYSTEM = "system"
    SPAN = "span"  # lifecycle trace spans (obs.trace)

    VALUES = {METRIC, IMAGE, HISTOGRAM, TEXT, HTML, AUDIO, VIDEO, MODEL,
              DATAFRAME, ARTIFACT, CURVE, CONFUSION, SYSTEM, SPAN}


def _now_iso() -> str:
    return _dt.datetime.now(_dt.timezone.utc).isoformat()


class EventWriter:
    """Append-only jsonl writer for one run directory. Buffered per file;
    ``flush()`` is cheap and called by the tracking Run on every batch."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._handles: dict[str, Any] = {}

    def _handle(self, kind: str, name: str):
        key = f"{kind}/{name}"
        if key not in self._handles:
            path = os.path.join(self.run_dir, "events", kind, f"{name}.jsonl")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._handles[key] = open(path, "a", buffering=1)
        return self._handles[key]

    def write(self, kind: str, name: str, record: dict[str, Any]) -> None:
        record.setdefault("timestamp", _now_iso())
        self._handle(kind, name).write(json.dumps(record) + "\n")

    def metric(self, name: str, value: float, step: Optional[int] = None) -> None:
        self.write(V1EventKind.METRIC, name, {"step": step, "value": float(value)})

    def flush(self) -> None:
        for handle in self._handles.values():
            handle.flush()

    def close(self) -> None:
        """Release every lazily-opened handle. Idempotent; invoked from
        the tracking Run teardown — a finished run must not pin open fds
        for its whole process lifetime."""
        for handle in self._handles.values():
            try:
                handle.close()
            except OSError:
                pass
        self._handles.clear()

    def __enter__(self) -> "EventWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def safe_subpath(root: str, rel: str) -> str:
    """Join a (possibly namespaced) user-supplied name under ``root``,
    rejecting absolute paths and ``..`` escapes. The single guard every
    read path (events, metrics, logs) funnels through."""
    path = os.path.abspath(os.path.join(root, rel))
    root = os.path.abspath(root)
    if not path.startswith(root + os.sep):
        raise ValueError(f"name escapes its directory: {rel!r}")
    return path


def read_jsonl(path: str) -> list[dict[str, Any]]:
    """Tolerant jsonl reader: skips blank and torn lines (a sidecar may
    sync a file mid-write). Shared by event and lineage readers."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail write mid-sync
    return out


def read_events(run_dir: str, kind: str, name: str,
                since_step: Optional[int] = None) -> list[dict[str, Any]]:
    path = safe_subpath(os.path.join(run_dir, "events", kind), f"{name}.jsonl")
    records = read_jsonl(path)
    if since_step is not None:
        records = [r for r in records if (r.get("step") or 0) > since_step]
    return records


def list_event_names(run_dir: str, kind: str) -> list[str]:
    """All event names of a kind, recursively — slash-namespaced names
    ('eval/sample') live in nested dirs and are returned with their
    relative path as the name."""
    root = os.path.join(run_dir, "events", kind)
    if not os.path.isdir(root):
        return []
    names = []
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for f in files:
            if f.endswith(".jsonl"):
                name = f[:-6] if rel == "." else f"{rel}/{f[:-6]}"
                names.append(name.replace(os.sep, "/"))
    return sorted(names)


def tail_file(path: str, offset: int = 0) -> tuple[str, int]:
    """Read text from ``offset``; returns (chunk, new_offset)."""
    if not os.path.exists(path):
        return "", offset
    with open(path) as fh:
        fh.seek(offset)
        chunk = fh.read()
        return chunk, fh.tell()
