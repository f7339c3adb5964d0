"""Failure flight recorder (ISSUE 6): every dead run gets a black box.

A bounded per-run ring buffer captures the run's recent telemetry as
it happens — span/event records tapped straight off ``RunTracer.write``
plus the runtime loop's per-emission metric notes — and a registry
snapshot taken at gang start anchors metric DELTAS (what moved while
this run lived, not absolute process counters). When the agent reaps a
run FAILED or PREEMPTED it dumps the ring + deltas + the tail of every
gang log to ``<run_dir>/postmortem.json``: a self-contained postmortem
the chaos gauntlet (and an operator at 3am) can read without the
process that died, the store that flaked, or the registry that has
since moved on.

Memory is strictly bounded: ``ring`` entries per run (oldest evicted),
``max_runs`` tracked runs (LRU evicted), and successful runs are
discarded at reap. Everything here is fail-open — a recorder bug must
never become a second failure mode for the run it is recording.

Port of ``polyaxon_tpu/obs/flight.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Optional

from polyaxon_tpu_torch.obs import metrics as obs_metrics

RING_LIMIT = int(os.environ.get("POLYAXON_TPU_FLIGHT_RING", "256"))
MAX_RUNS = 64
LOG_TAIL_LINES = 50
POSTMORTEM_FILE = "postmortem.json"

# Span-record fields worth keeping in the ring (events ride along —
# that is where chaos/retry annotations live).
_SPAN_KEEP = ("type", "name", "span_id", "parent_id", "component",
              "start", "end", "duration_ms", "status", "error",
              "attributes", "events", "time")


class FlightRecorder:
    def __init__(self, *, ring: int = RING_LIMIT, max_runs: int = MAX_RUNS,
                 registry: obs_metrics.MetricsRegistry = obs_metrics.REGISTRY):
        self.ring_limit = ring
        self.max_runs = max_runs
        self.registry = registry
        self._lock = threading.Lock()
        # uuid -> {"ring": deque, "baseline": snapshot|None, "started": t}
        self._runs: "OrderedDict[str, dict]" = OrderedDict()

    # -- feeds -------------------------------------------------------------
    def _entry(self, run_uuid: str) -> dict:
        """Under the lock: the run's slot, LRU-bumped, created (and the
        oldest evicted) as needed."""
        slot = self._runs.get(run_uuid)
        if slot is None:
            slot = {"ring": deque(maxlen=self.ring_limit),
                    "baseline": None, "started": time.time()}
            self._runs[run_uuid] = slot
            while len(self._runs) > self.max_runs:
                self._runs.popitem(last=False)
        else:
            self._runs.move_to_end(run_uuid)
        return slot

    def mark_start(self, run_uuid: str) -> None:
        """Gang start: snapshot the registry so the dump can report
        what moved DURING this run (metric deltas, not absolutes)."""
        try:
            with self._lock:
                slot = self._entry(run_uuid)
                slot["started"] = time.time()
            baseline = self.registry.snapshot()
            with self._lock:
                if run_uuid in self._runs:
                    self._runs[run_uuid]["baseline"] = baseline
        except Exception as exc:  # fail-open by contract
            logging.getLogger(__name__).debug(
                "flight mark_start failed for %s: %s", run_uuid, exc)

    def record_trace(self, run_uuid: str, record: dict[str, Any]) -> None:
        """Tap for RunTracer.write: keep the span/event fields that
        explain a death, drop the rest."""
        try:
            kept = {k: record[k] for k in _SPAN_KEEP if k in record}
            with self._lock:
                self._entry(run_uuid)["ring"].append(kept)
        except Exception as exc:  # fail-open by contract
            logging.getLogger(__name__).debug(
                "flight record_trace failed for %s: %s", run_uuid, exc)

    def note(self, run_uuid: str, name: str, **attrs: Any) -> None:
        """Arbitrary flight note (the runtime loop records each metrics
        emission here — the last loss/step-time values a dead run saw)."""
        try:
            with self._lock:
                self._entry(run_uuid)["ring"].append({
                    "type": "note", "name": name, "time": time.time(),
                    "attributes": attrs})
        except Exception as exc:  # fail-open by contract
            logging.getLogger(__name__).debug(
                "flight note %r failed for %s: %s", name, run_uuid, exc)

    # -- deltas ------------------------------------------------------------
    def metric_deltas(self, run_uuid: str) -> dict[str, Any]:
        """Registry movement since ``mark_start``: changed series only
        (counters/gauges as value deltas, histograms as count/sum
        deltas — :func:`obs.metrics.snapshot_delta`). Without a
        baseline the current snapshot is returned whole, flagged as
        absolute."""
        with self._lock:
            slot = self._runs.get(run_uuid)
            baseline = slot.get("baseline") if slot else None
        return self.registry.snapshot_delta(baseline)

    # -- dump --------------------------------------------------------------
    @staticmethod
    def _log_tails(run_dir: str) -> dict[str, list[str]]:
        logs_dir = os.path.join(run_dir, "logs")
        tails: dict[str, list[str]] = {}
        try:
            names = sorted(os.listdir(logs_dir))
        except OSError:
            return tails
        for name in names:
            if not name.endswith(".log"):
                continue
            path = os.path.join(logs_dir, name)
            try:
                with open(path, "rb") as fh:
                    fh.seek(0, os.SEEK_END)
                    size = fh.tell()
                    fh.seek(max(size - 64 * 1024, 0))
                    text = fh.read().decode(errors="replace")
            except OSError:
                continue
            tails[name] = text.splitlines()[-LOG_TAIL_LINES:]
        return tails

    def dump(self, run_uuid: str, run_dir: str, *, status: str,
             reason: Optional[str] = None,
             message: Optional[str] = None) -> Optional[str]:
        """Write ``<run_dir>/postmortem.json`` for a dead run; returns
        the path (None when the write itself failed — never raises).
        The ring is kept afterwards: a restart-policy rerun that dies
        again overwrites the file with the newer episode."""
        try:
            with self._lock:
                slot = self._runs.get(run_uuid)
                ring = list(slot["ring"]) if slot else []
                started = slot["started"] if slot else None
            payload = {
                "run_uuid": run_uuid,
                "dumped_at": _dt.datetime.now(
                    _dt.timezone.utc).isoformat(),
                "status": status,
                "reason": reason,
                "message": message,
                "recording_started_at": started,
                "ring": ring,
                "metric_deltas": self.metric_deltas(run_uuid),
                "logs": self._log_tails(run_dir),
            }
            os.makedirs(run_dir, exist_ok=True)
            path = os.path.join(run_dir, POSTMORTEM_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, indent=2, default=str)
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — a postmortem must not kill
            import logging  # the reap that triggered it

            logging.getLogger(__name__).warning(
                "flight-recorder dump for %s failed", run_uuid,
                exc_info=True)
            return None

    def discard(self, run_uuid: str) -> None:
        """A run that ended well needs no black box: free its ring."""
        with self._lock:
            self._runs.pop(run_uuid, None)

    def tracked_runs(self) -> list[str]:
        with self._lock:
            return list(self._runs)


# The process-global recorder every tap feeds (tests build their own).
RECORDER = FlightRecorder()


def read_postmortem(run_dir: str) -> Optional[dict]:
    path = os.path.join(run_dir, POSTMORTEM_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
