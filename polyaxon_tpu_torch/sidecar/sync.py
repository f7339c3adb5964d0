"""Incremental rsync-like tree sync (mtime+size) with a watch loop.

The destination is either a local/mounted directory (the TPU-VM
default) or any artifact-store URL (``gs://``, ``s3://``, ...) — the
upstream sidecar ships to fsspec stores the same way (SURVEY.md §3.3).

Port of ``polyaxon_tpu/sidecar/sync.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Optional
from urllib.parse import urlparse

logger = logging.getLogger(__name__)

# Per-path once-only + time-limited summary, shared with the store
# path: the 5 s hot loop re-hits the same broken destination every
# pass, and unbounded identical warnings are their own outage.
_warned_paths: set[str] = set()
_last_summary_warn = 0.0
_SUMMARY_INTERVAL_S = 60.0


def warn_sync_failures(failed: int, first_error: str) -> None:
    """Summary warning for a sync pass with failures, at most one per
    minute process-wide."""
    global _last_summary_warn
    now = time.monotonic()
    if now - _last_summary_warn >= _SUMMARY_INTERVAL_S:
        _last_summary_warn = now
        logger.warning(
            "sync pass: %d file(s) failed to ship (will retry; first "
            "error: %s)", failed, first_error)


def warn_sync_file(path: str, dest: str, exc: Exception) -> None:
    """Per-file warning, once per source path per process."""
    if path not in _warned_paths:
        _warned_paths.add(path)
        logger.warning("sync failed for %s -> %s: %s", path, dest, exc)


def _should_copy(src: str, dest: str) -> bool:
    if not os.path.exists(dest):
        return True
    s, d = os.stat(src), os.stat(dest)
    return s.st_mtime > d.st_mtime or s.st_size != d.st_size


def sync_tree(src_root: str, dest_root: str) -> int:
    """Copy changed files; returns number synced. Append-heavy files
    (jsonl/logs) are whole-file copied — sizes here are small relative to
    checkpoints, which orbax already writes store-side.

    Only a vanished source (FileNotFoundError) is silently retried; a
    failing DESTINATION (read-only/full volume) is logged loudly — the
    same contract as ``Store.sync_dir`` — and retried next pass."""
    synced = 0
    failed = 0
    first_error = ""
    for dirpath, _, filenames in os.walk(src_root):
        rel = os.path.relpath(dirpath, src_root)
        dest_dir = os.path.join(dest_root, rel) if rel != "." else dest_root
        for name in filenames:
            if name.endswith((".tmp", ".lock")):
                continue
            src = os.path.join(dirpath, name)
            dest = os.path.join(dest_dir, name)
            if _should_copy(src, dest):
                try:
                    os.makedirs(dest_dir, exist_ok=True)
                    shutil.copy2(src, dest)
                    synced += 1
                except FileNotFoundError:
                    continue  # source vanished/rotating mid-walk
                except OSError as exc:
                    failed += 1
                    first_error = first_error or f"{exc}"
                    warn_sync_file(src, dest, exc)
                    continue
    if failed:
        warn_sync_failures(failed, first_error)
    return synced


class SidecarSync:
    def __init__(self, run_dir: str, store_dir: str, interval_seconds: float = 5.0,
                 run_uuid: Optional[str] = None):
        self.run_dir = run_dir
        self.store_dir = store_dir
        self.interval = interval_seconds
        # Lifecycle tracing: run dirs are <artifacts_root>/<uuid>, so
        # the basename is the trace id when none is given; the remote
        # parent (the agent's `execute` span) rides the env contract.
        self.run_uuid = run_uuid or os.path.basename(
            os.path.abspath(run_dir))
        from polyaxon_tpu_torch.obs import trace as obs_trace

        _, self._trace_parent = obs_trace.parse_trace_parent(
            os.environ.get(obs_trace.ENV_TRACE_PARENT))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # A URL destination ships through the store layer with the
        # incremental mtime state Store.sync_dir keeps; a plain path
        # (or file://) stays on the local fast path below.
        parsed = urlparse(store_dir)
        if parsed.scheme and parsed.scheme != "file":
            from polyaxon_tpu_torch.fs import get_store

            self._store = get_store(store_dir)
            self._store_state: dict[str, float] = {}
        else:
            self._store = None
            if parsed.scheme == "file":
                self.store_dir = parsed.path

    def sync_once(self) -> int:
        t0 = time.time()
        if self._store is not None:
            from polyaxon_tpu_torch.fs import is_transient_store_error
            from polyaxon_tpu_torch.utils.retries import with_retries

            # Transient store failures (throttles, injected chaos
            # faults — typed StoreErrors that sync_dir's per-file
            # OSError net does not catch) retry the pass in place;
            # sync_dir is incremental, so a re-pass only re-ships what
            # the failed pass missed.
            synced = with_retries(
                lambda: self._store.sync_dir(self.run_dir,
                                             state=self._store_state),
                transient=is_transient_store_error, key=self.run_dir)
        else:
            synced = sync_tree(self.run_dir, self.store_dir)
        if synced:
            self._record_sync_span(t0, synced)
        return synced

    def _record_sync_span(self, t0: float, synced: int) -> None:
        """`sync` span per pass that shipped files, then ship the span
        file itself IN this pass (recording its mtime) — otherwise the
        span write would make the next pass non-empty and the sidecar
        would emit sync spans about syncing sync spans forever."""
        from polyaxon_tpu_torch.obs import trace as obs_trace

        try:
            span_path = obs_trace.record_completed(
                self.run_dir, self.run_uuid, "sync", component="sidecar",
                start=t0, end=time.time(), parent_id=self._trace_parent,
                attributes={"files": synced,
                            "dest": ("store" if self._store is not None
                                     else "local")})
            rel = os.path.relpath(span_path, self.run_dir)
            if self._store is not None:
                key = rel.replace(os.sep, "/")
                self._store.upload_file(span_path, key)
                self._store_state[span_path] = os.path.getmtime(span_path)
            else:
                dest = os.path.join(self.store_dir, rel)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                shutil.copy2(span_path, dest)  # mtime preserved → no re-copy
        except Exception as exc:  # noqa: BLE001 — tracing must never
            # break the sync loop (incl. chaos-injected StoreErrors on
            # the span-file ship; the file re-ships next pass).
            warn_sync_file(self.run_dir, "span/lifecycle", exc)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
            except Exception as exc:  # noqa: BLE001 — keep the loop alive
                warn_sync_failures(1, f"{type(exc).__name__}: {exc}")

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="plx-sidecar", daemon=True)
            self._thread.start()

    def stop(self, final_sync: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_sync:
            self.sync_once()
