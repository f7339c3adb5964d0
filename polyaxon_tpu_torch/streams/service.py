"""Streams: serve logs/events/artifacts per run (SURVEY.md §2 "Streams",
§3.5 read path [K]).

The reference runs this as a FastAPI service multiplexing from fsspec
stores; here it is an embedded service over the store tree that the CLI
and tuner consume directly (the process boundary is optional — the same
class would back an HTTP layer). Supports snapshot reads and follow-mode
tailing with offsets.

Port of ``polyaxon_tpu/streams/service.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterator, Optional

from polyaxon_tpu_torch.tracking.events import list_event_names, read_events, tail_file


class StreamsService:
    def __init__(self, store_root: str):
        self.store_root = store_root
        # TTL cache for tree-walk results (dir sizes, detail listings):
        # the dashboard polls every ~5s per viewer, and re-walking a
        # thousand-file run tree per poll is continuous I/O for numbers
        # that change slowly. Expired entries are purged on insert so a
        # long-lived server doesn't accumulate keys for deleted runs.
        # Locked: the API's ThreadingHTTPServer calls this from
        # concurrent handler threads.
        self._walk_cache: dict[Any, tuple[float, Any]] = {}
        self._walk_cache_lock = threading.Lock()
        self._walk_inflight: dict[Any, threading.Event] = {}
        # Per-key insert generation: a walker that was degraded-past
        # (waiters gave up on it and cached their own fresher walk)
        # must not overwrite that newer entry when it finally finishes.
        self._walk_gen: dict[Any, int] = {}

    def _cached_walk(self, key: Any, compute, ttl: float = 10.0):
        with self._walk_cache_lock:
            hit = self._walk_cache.get(key)
            if hit and hit[0] > time.monotonic():
                return hit[1]
            # Single-flight per key: when a TTL lapses with N viewers
            # polling, one thread walks and the rest wait for its
            # result instead of N simultaneous tree walks.
            waiting = self._walk_inflight.get(key)
            if waiting is None:
                self._walk_inflight[key] = threading.Event()
                gen0 = self._walk_gen.get(key, 0)
        if waiting is not None:
            waiting.wait(timeout=30)
            with self._walk_cache_lock:
                hit = self._walk_cache.get(key)
                walker_stuck = self._walk_inflight.get(key) is waiting
            if hit:  # possibly expired, still the freshest walk we have
                return hit[1]
            if walker_stuck:
                # The walker is still running after 30s (hung FS?):
                # degrade to an own walk — bounded latency beats
                # waiting (or recursing) behind it forever — and CACHE
                # the result so pollers arriving during the hang get a
                # hit instead of each launching another walk against
                # the already-slow store. Same generation discipline as
                # the walker path: anything inserted while THIS compute
                # ran started later (so is fresher) — don't clobber it.
                with self._walk_cache_lock:
                    my_gen = self._walk_gen.get(key, 0)
                value = compute()
                done = time.monotonic()
                with self._walk_cache_lock:
                    if self._walk_gen.get(key, 0) == my_gen:
                        self._walk_cache[key] = (done + ttl, value)
                        self._walk_gen[key] = my_gen + 1
                return value
            # Walker finished-with-failure or died: re-enter ONCE —
            # the inflight entry is gone, so one waiter becomes the
            # new walker (and caches); the rest wait on it.
            return self._cached_walk(key, compute, ttl)
        try:
            value = compute()  # the walk itself runs unlocked
            done = time.monotonic()  # expiry from walk END: a walk
            # slower than the TTL must not insert already-expired
            with self._walk_cache_lock:
                for k in [k for k, (exp, _) in self._walk_cache.items()
                          if exp <= done]:
                    del self._walk_cache[k]
                # Generations only matter while a walk is inflight for
                # the key; drop the rest so deleted runs don't pin them.
                for k in [k for k in self._walk_gen
                          if k not in self._walk_cache
                          and k not in self._walk_inflight]:
                    del self._walk_gen[k]
                if self._walk_gen.get(key, 0) == gen0:
                    # No degraded waiter inserted while this walk ran;
                    # otherwise their walk STARTED later (after the 30s
                    # wait) — keep the newer result, drop this one.
                    self._walk_cache[key] = (done + ttl, value)
                    self._walk_gen[key] = gen0 + 1
            return value
        finally:
            # Cache insert happens BEFORE the event fires (walker
            # success path), so woken waiters find the fresh entry; on
            # a compute() exception they re-enter and one becomes the
            # new walker.
            with self._walk_cache_lock:
                event = self._walk_inflight.pop(key, None)
            if event is not None:
                event.set()

    def run_dir(self, run_uuid: str) -> str:
        return os.path.join(self.store_root, run_uuid)

    # -- metrics ----------------------------------------------------------
    def metric_names(self, run_uuid: str) -> list[str]:
        return list_event_names(self.run_dir(run_uuid), "metric")

    def get_metrics(
        self, run_uuid: str, names: Optional[list[str]] = None,
        since_step: Optional[int] = None,
    ) -> dict[str, list[dict[str, Any]]]:
        rd = self.run_dir(run_uuid)
        names = names or self.metric_names(run_uuid)
        return {name: read_events(rd, "metric", name, since_step=since_step)
                for name in names}

    def last_metric(self, run_uuid: str, name: str) -> Optional[float]:
        events = read_events(self.run_dir(run_uuid), "metric", name)
        return events[-1]["value"] if events else None

    def get_events(self, run_uuid: str, kind: str,
                   names: Optional[list[str]] = None) -> dict[str, list[dict]]:
        from polyaxon_tpu_torch.tracking.events import V1EventKind

        if kind not in V1EventKind.VALUES:
            raise ValueError(
                f"unknown event kind `{kind}`; one of {sorted(V1EventKind.VALUES)}")
        rd = self.run_dir(run_uuid)
        # Traversal in user-supplied names is rejected inside read_events
        # (tracking.events.safe_subpath) — the guard covers metrics too.
        names = names or list_event_names(rd, kind)
        return {name: read_events(rd, kind, name) for name in names}

    def get_lineage(self, run_uuid: str) -> list[dict]:
        """Artifact-lineage records appended by tracking.log_artifact /
        log_model (upstream's artifact-lineage API surface), enriched
        with ``rel_path`` (run-dir-relative, usable against the
        artifacts download route) and ``size_bytes`` when the recorded
        path still exists under the run tree — the fields the
        dashboard's artifact browser lists."""
        from polyaxon_tpu_torch.tracking.events import read_jsonl

        root = os.path.abspath(self.run_dir(run_uuid))
        records = read_jsonl(os.path.join(root, "lineage.jsonl"))
        for rec in records:
            path = os.path.abspath(str(rec.get("path", "")))
            if not path.startswith(root + os.sep):
                continue  # registered without copy: outside the run tree
            if not os.path.exists(path):
                continue  # deleted/not-yet-synced: no dead links
            rec["rel_path"] = os.path.relpath(path, root).replace(os.sep, "/")
            rec["is_dir"] = os.path.isdir(path)
            try:
                rec["size_bytes"] = (self._dir_size(path) if rec["is_dir"]
                                     else os.path.getsize(path))
            except OSError:
                pass
        return records

    def _dir_size(self, path: str) -> int:
        """Recursive size of a directory artifact (TTL-cached)."""
        def compute() -> int:
            total = 0
            for dirpath, _, filenames in os.walk(path):
                for name in filenames:
                    try:
                        total += os.path.getsize(os.path.join(dirpath, name))
                    except OSError:
                        pass  # vanished mid-walk
            return total

        return self._cached_walk(("dir_size", path), compute)

    def list_artifacts_detail(self, run_uuid: str,
                              prefix: str = "") -> list[dict]:
        """File listing with sizes, for the dashboard browser. One walk
        with scandir-cached stats (not list_artifacts + a getsize per
        file — that stats the whole tree twice), TTL-cached against the
        dashboard's live-rerender polling."""
        run_root = self.run_dir(run_uuid)
        root = os.path.join(run_root, prefix)
        if not os.path.isdir(root):
            return []

        def compute() -> list[dict]:
            out = []
            for dirpath, _, _ in os.walk(root):
                try:
                    entries = list(os.scandir(dirpath))
                except OSError:
                    continue  # vanished mid-walk
                for entry in entries:
                    try:
                        if not entry.is_file():
                            continue
                        rel = os.path.relpath(entry.path, run_root)
                        out.append({"path": rel.replace(os.sep, "/"),
                                    "size_bytes": entry.stat().st_size})
                    except OSError:
                        continue
            out.sort(key=lambda rec: rec["path"])
            return out

        return self._cached_walk(("detail", run_uuid, prefix), compute,
                                 ttl=5.0)

    # -- logs -------------------------------------------------------------
    def log_files(self, run_uuid: str) -> list[str]:
        root = os.path.join(self.run_dir(run_uuid), "logs")
        if not os.path.isdir(root):
            return []
        return sorted(os.listdir(root))

    def read_logs(self, run_uuid: str, name: str = "main.log", offset: int = 0) -> tuple[str, int]:
        from polyaxon_tpu_torch.tracking.events import safe_subpath

        root = os.path.join(self.run_dir(run_uuid), "logs")
        return tail_file(safe_subpath(root, name), offset)

    def follow_logs(
        self, run_uuid: str, name: str = "main.log", *,
        poll_seconds: float = 1.0, should_stop=None, offset: int = 0,
    ) -> Iterator[str]:
        """SSE-style tail loop (SURVEY §3.5 🔥): yields chunks until
        ``should_stop()`` returns True and the file stops growing.
        ``offset`` resumes after a snapshot read (avoids re-yielding it)."""
        while True:
            chunk, offset = self.read_logs(run_uuid, name, offset)
            if chunk:
                yield chunk
            elif should_stop is not None and should_stop():
                final, offset = self.read_logs(run_uuid, name, offset)
                if final:
                    yield final
                return
            else:
                time.sleep(poll_seconds)

    # -- outputs / statuses / artifacts -----------------------------------
    def get_outputs(self, run_uuid: str) -> dict[str, Any]:
        path = os.path.join(self.run_dir(run_uuid), "outputs.json")
        if not os.path.exists(path):
            return {}
        with open(path) as fh:
            return json.load(fh)

    def get_statuses(self, run_uuid: str) -> list[dict[str, Any]]:
        path = os.path.join(self.run_dir(run_uuid), "statuses.jsonl")
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        return out

    def list_artifacts(self, run_uuid: str, prefix: str = "") -> list[str]:
        root = os.path.join(self.run_dir(run_uuid), prefix)
        if not os.path.isdir(root):
            return []
        out = []
        for dirpath, _, filenames in os.walk(root):
            for name in filenames:
                out.append(os.path.relpath(os.path.join(dirpath, name),
                                           self.run_dir(run_uuid)))
        return sorted(out)

    def artifact_path(self, run_uuid: str, rel: str) -> str:
        from polyaxon_tpu_torch.tracking.events import safe_subpath

        root = os.path.abspath(self.run_dir(run_uuid))
        if os.path.abspath(os.path.join(root, rel)) == root:
            return root  # the run dir itself (artifact listing root)
        return safe_subpath(root, rel)
