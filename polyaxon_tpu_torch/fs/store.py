"""Artifact-store IO layer (upstream `polyaxon/fs`: async fsspec
wrappers over S3/GCS/Azure/volumes — SURVEY.md §2 "fs").

A scheme-dispatched store abstraction with two native backends and one
fsspec-backed one:

- ``file://`` — host paths / mounted volumes (the TPU-VM default);
- ``memory://`` — in-process, for tests and dry runs;
- ``gs://``/``s3://``/``wasb://``/``abfs://`` — cloud object stores
  via :class:`FsspecStore`. The protocol package (gcsfs/s3fs/adlfs)
  must be importable; a missing one raises a typed, actionable
  ``StoreError`` at construction. The store *interface*
  (upload/download/sync semantics the sidecar, init phases, and
  checkpoint manager rely on) is identical across backends.

Port of ``polyaxon_tpu/fs/store.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import functools
import logging
import os
import shutil
import threading
import time
from typing import Callable, Iterator, Optional
from urllib.parse import urlparse


class StoreError(RuntimeError):
    pass


class TransientStoreError(StoreError):
    """A store failure worth retrying (network blip, throttle, injected
    chaos fault) — as opposed to a permanent one (missing key, bad
    credentials, unknown scheme)."""


def is_transient_store_error(exc: BaseException) -> bool:
    """Shared transient-vs-permanent classification for store IO: typed
    transients and network/timeout OSErrors retry; missing keys and
    usage errors do not."""
    if isinstance(exc, TransientStoreError):
        return True
    if isinstance(exc, StoreError):
        return False
    if isinstance(exc, (FileNotFoundError, IsADirectoryError,
                        NotADirectoryError, PermissionError)):
        return False
    return isinstance(exc, (TimeoutError, ConnectionError, OSError))


def _store_retry_params() -> dict:
    """Retry knobs for object-store ops (docs/robustness.md)."""
    return {
        "attempts": int(os.environ.get("POLYAXON_TPU_STORE_RETRIES", "3")),
        "base": float(os.environ.get("POLYAXON_TPU_STORE_RETRY_BASE", "0.1")),
        "transient": is_transient_store_error,
    }


class Store:
    """Blob-store interface: paths are '/'-separated keys under a root."""

    scheme = "abstract"

    # -- required surface -------------------------------------------------
    def read_bytes(self, key: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        """All keys under prefix (recursive), sorted."""
        raise NotImplementedError

    # -- derived ----------------------------------------------------------
    def read_text(self, key: str) -> str:
        return self.read_bytes(key).decode()

    def write_text(self, key: str, text: str) -> None:
        self.write_bytes(key, text.encode())

    def upload_file(self, local_path: str, key: str) -> None:
        with open(local_path, "rb") as fh:
            self.write_bytes(key, fh.read())

    def download_file(self, key: str, local_path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        with open(local_path, "wb") as fh:
            fh.write(self.read_bytes(key))
        return local_path

    def upload_dir(self, local_dir: str, prefix: str = "") -> int:
        """Recursive upload; returns number of files shipped."""
        count = 0
        for root, _, files in os.walk(local_dir):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, local_dir)
                key = f"{prefix}/{rel}".replace(os.sep, "/").lstrip("/")
                self.upload_file(path, key)
                count += 1
        return count

    def download_dir(self, prefix: str, local_dir: str) -> int:
        count = 0
        for key in self.list(prefix):
            rel = key[len(prefix):].lstrip("/") if prefix else key
            self.download_file(key, os.path.join(local_dir, rel))
            count += 1
        return count

    def sync_dir(self, local_dir: str, prefix: str = "",
                 state: Optional[dict[str, float]] = None) -> int:
        """Incremental upload: only files whose mtime advanced since the
        last call (the sidecar hot loop — SURVEY.md §3.3). In-flight
        ``.tmp``/``.lock`` files (the atomic-publish convention) are
        skipped, and files that vanish mid-walk are retried next pass —
        same guarantees as the local ``sidecar.sync_tree`` path.

        Only ``FileNotFoundError`` is treated as vanished-mid-walk;
        store-side failures (auth/permission/network OSErrors from fsspec
        backends) are logged at warning (once per path + a rate-limited
        pass summary — the 5 s sidecar loop must not spam identical
        lines) so a broken destination is loud, and retried next pass."""
        state = state if state is not None else {}
        count = 0
        failed = 0
        first_error = ""
        for root, _, files in os.walk(local_dir):
            for name in files:
                if name.endswith((".tmp", ".lock")):
                    continue
                path = os.path.join(root, name)
                try:
                    mtime = os.path.getmtime(path)
                except OSError:
                    continue
                if state.get(path) == mtime:
                    continue
                rel = os.path.relpath(path, local_dir)
                key = f"{prefix}/{rel}".replace(os.sep, "/").lstrip("/")
                try:
                    self.upload_file(path, key)
                except FileNotFoundError:
                    continue  # vanished/rotating mid-walk: retry next pass
                except OSError as exc:
                    from polyaxon_tpu_torch.sidecar.sync import warn_sync_file

                    failed += 1
                    first_error = first_error or f"{exc}"
                    warn_sync_file(path, key, exc)
                    continue  # retried next pass; mtime not recorded
                state[path] = mtime
                count += 1
        if failed:
            from polyaxon_tpu_torch.sidecar.sync import warn_sync_failures

            warn_sync_failures(failed, first_error)
        return count


class LocalStore(Store):
    scheme = "file"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key.lstrip("/")))
        if not path.startswith(self.root + os.sep) and path != self.root:
            raise StoreError(f"key {key!r} escapes store root")
        return path

    def read_bytes(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as fh:
                return fh.read()
        except FileNotFoundError as exc:
            raise StoreError(f"no such key {key!r}") from exc

    def write_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)  # atomic publish

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def list(self, prefix: str = "") -> list[str]:
        base = self._path(prefix) if prefix else self.root
        if not os.path.isdir(base):
            return [prefix] if prefix and os.path.isfile(base) else []
        out = []
        for root, _, files in os.walk(base):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(root, name), self.root)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    # Local fast paths: copy instead of read+write round-trips.
    def upload_file(self, local_path: str, key: str) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shutil.copy2(local_path, path)

    def download_file(self, key: str, local_path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        try:
            shutil.copy2(self._path(key), local_path)
        except FileNotFoundError as exc:
            raise StoreError(f"no such key {key!r}") from exc
        return local_path


class MemoryStore(Store):
    scheme = "memory"
    _shared: dict[str, dict[str, bytes]] = {}
    _lock = threading.Lock()

    def __init__(self, namespace: str = "default"):
        with MemoryStore._lock:
            self._blobs = MemoryStore._shared.setdefault(namespace, {})

    def read_bytes(self, key: str) -> bytes:
        try:
            return self._blobs[key.lstrip("/")]
        except KeyError as exc:
            raise StoreError(f"no such key {key!r}") from exc

    def write_bytes(self, key: str, data: bytes) -> None:
        self._blobs[key.lstrip("/")] = bytes(data)

    def exists(self, key: str) -> bool:
        key = key.lstrip("/")
        return key in self._blobs or any(
            k.startswith(key + "/") for k in self._blobs)

    def delete(self, key: str) -> None:
        key = key.lstrip("/")
        for k in [k for k in self._blobs if k == key or k.startswith(key + "/")]:
            del self._blobs[k]

    def list(self, prefix: str = "") -> list[str]:
        prefix = prefix.lstrip("/")
        return sorted(
            k for k in self._blobs
            if not prefix or k == prefix or k.startswith(prefix.rstrip("/") + "/")
        )


class FsspecStore(Store):
    """Cloud object stores through fsspec (upstream `polyaxon/fs`
    materializes the same protocols via fsspec wrappers — SURVEY.md §2
    "fs"/"Connections" rows).

    The protocol package does the heavy lifting: ``gs://`` → gcsfs
    (present in this image), ``s3://`` → s3fs, ``wasb://``/``abfs://``
    → adlfs. A missing package raises a typed ``StoreError`` at
    construction — a connection kind either runs or fails loudly at
    resolution time, never silently. The ``memory://`` fsspec protocol
    exercises this exact code path offline in tests.
    """

    # Upstream wasb:// URLs ride the Gen2-compatible adlfs protocol.
    _SCHEME_ALIASES = {"wasb": "abfs", "wasbs": "abfs", "az": "abfs",
                       "gcs": "gs"}

    def __init__(self, url: str):
        try:
            import fsspec
        except ImportError as exc:  # pragma: no cover - baked into image
            raise StoreError(
                f"store url {url!r} needs fsspec, which is not installed; "
                "use file:// volumes or register a custom store via "
                "fs.register_store()") from exc
        parsed = urlparse(url)
        self.scheme = parsed.scheme
        proto = self._SCHEME_ALIASES.get(parsed.scheme, parsed.scheme)
        resolved = url.replace(f"{parsed.scheme}://", f"{proto}://", 1)
        try:
            self.fs, self.root = fsspec.core.url_to_fs(resolved)
        except ImportError as exc:
            raise StoreError(
                f"store url {url!r} needs the fsspec protocol package for "
                f"`{proto}://` ({exc}); install it in the image or use a "
                "file:// volume") from exc
        except ValueError as exc:
            raise StoreError(f"bad store url {url!r}: {exc}") from exc
        self.root = self.root.rstrip("/")

    def _key(self, key: str) -> str:
        key = key.lstrip("/")
        return f"{self.root}/{key}" if key else self.root

    def _retrying(self, fn):
        """Bounded retries with exponential backoff around one fsspec
        op: cloud stores throw transient OSErrors under load, and one
        blip must not fail a whole run (ISSUE 1 retry layer)."""
        from polyaxon_tpu_torch.utils.retries import with_retries

        return with_retries(fn, key=self.scheme, **_store_retry_params())

    def read_bytes(self, key: str) -> bytes:
        try:
            return self._retrying(lambda: self.fs.cat_file(self._key(key)))
        except FileNotFoundError as exc:
            raise StoreError(f"no such key {key!r}") from exc

    def write_bytes(self, key: str, data: bytes) -> None:
        self._retrying(lambda: self.fs.pipe_file(self._key(key), bytes(data)))

    def exists(self, key: str) -> bool:
        return bool(self._retrying(lambda: self.fs.exists(self._key(key))))

    def delete(self, key: str) -> None:
        path = self._key(key)
        if self._retrying(lambda: self.fs.exists(path)):
            self._retrying(lambda: self.fs.rm(path, recursive=True))

    def list(self, prefix: str = "") -> list[str]:
        base = self._key(prefix) if prefix else self.root
        try:
            found = self._retrying(lambda: self.fs.find(base))
        except FileNotFoundError:
            return []
        out = []
        for path in found:
            rel = path[len(self.root):].lstrip("/")
            if rel:
                out.append(rel)
        return sorted(out)

    # Object-store fast paths: stream files instead of buffering bytes.
    def upload_file(self, local_path: str, key: str) -> None:
        self._retrying(lambda: self.fs.put_file(local_path, self._key(key)))

    def download_file(self, key: str, local_path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(local_path)), exist_ok=True)
        try:
            self._retrying(lambda: self.fs.get_file(self._key(key), local_path))
        except FileNotFoundError as exc:
            raise StoreError(f"no such key {key!r}") from exc
        return local_path


# ------------------------------------------------------------ op latency
# Every concrete store op lands in the unified registry's
# `polyaxon_store_op_seconds{op,scheme}` histogram (ISSUE 5). The
# timing wraps the CLASS methods (not a store wrapper object) so
# `isinstance(get_store(...), LocalStore)` contracts — and the chaos
# wrapper's delegation — stay intact; derived ops (sync_dir,
# download_dir) flow through the timed primitives they call.
_TIMED_OPS = ("read_bytes", "write_bytes", "exists", "delete", "list",
              "upload_file", "download_file")


def _observe_store_op(op: str, scheme: str, seconds: float) -> None:
    try:
        from polyaxon_tpu_torch.obs import metrics as obs_metrics

        obs_metrics.store_op_hist().observe(seconds, op=op, scheme=scheme)
    except Exception as exc:  # observability stays passive
        logging.getLogger(__name__).debug(
            "store-op histogram observe failed: %s", exc)


def _timed_store_op(op: str, fn):
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            _observe_store_op(op, str(getattr(self, "scheme", "?")),
                              time.perf_counter() - t0)

    wrapper.__timed_op__ = op
    return wrapper


for _cls in (LocalStore, MemoryStore, FsspecStore):
    for _op in _TIMED_OPS:
        _fn = getattr(_cls, _op)
        if getattr(_fn, "__timed_op__", None) != _op:
            setattr(_cls, _op, _timed_store_op(_op, _fn))


_REGISTRY: dict[str, Callable[[str], Store]] = {}


def register_store(scheme: str, factory: Callable[[str], Store]) -> None:
    _REGISTRY[scheme] = factory


def get_store(url: str) -> Store:
    """Dispatch a store URL: file:///path, memory://ns, gs://bucket, ...

    While a chaos fault plan with store faults is active (tests, or an
    operator drill via ``POLYAXON_TPU_CHAOS_PLAN``), the store is
    wrapped so the plan can inject typed ``StoreError``s on the Nth op;
    with no plan the concrete store is returned untouched.
    """
    parsed = urlparse(url)
    scheme = parsed.scheme or "file"
    if scheme in _REGISTRY:
        store = _REGISTRY[scheme](url)
    elif scheme == "file":
        store = LocalStore(parsed.path or url)
    elif scheme == "memory":
        store = MemoryStore(parsed.netloc or "default")
    elif scheme in ("gs", "gcs", "s3", "wasb", "wasbs", "az", "abfs"):
        store = FsspecStore(url)
    else:
        raise StoreError(f"unknown store scheme {scheme!r} in {url!r}")
    from polyaxon_tpu_torch import chaos

    plan = chaos.active_plan()
    if plan is not None and plan.has_faults("store"):
        return chaos.ChaosStore(store, plan)
    return store
