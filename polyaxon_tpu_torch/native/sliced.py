"""ctypes bindings for the slice pool (port of
``polyaxon_tpu/native/sliced.py``).

The pool places gangs on slices, tracks their heartbeats, preempts and
restarts them. Its C++ sources are the port's own copy under
``native/csrc/`` (the reference's C interface and line protocol,
unchanged). g++ builds them at first use into ``native/_build/<hash>/``
(listed in ``.gitignore``), where ``<hash>`` covers the sources and the
flags, so an edited source builds anew: ``libsliced.so`` for this
binding and the ``sliced`` daemon, which speaks the line protocol over
stdin and stdout, built side by side. Each build writes a temporary file and renames it, so
processes that build at once never load a half-written library.

On a GPU host a slice is the host's cards, a one-dimensional topology
``"N"``; a gang's ``chips`` are the card indices it was given.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from dataclasses import dataclass
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra", "-fPIC")
_POOL = ("topology.cc", "pool.cc")
_HEADERS = ("topology.h", "pool.h")
# target name -> (its own sources, extra flags)
_TARGETS = {"libsliced.so": (("capi.cc",), ("-shared",)),
            "sliced": (("main.cc",), ())}

_BUF_LEN = 1 << 16
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class SlicedError(RuntimeError):
    pass


def _build_dir() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in sorted(_POOL + _HEADERS + ("capi.cc", "main.cc")):
        with open(os.path.join(CSRC, name), "rb") as fh:
            digest.update(name.encode() + fh.read())
    return os.path.join(BUILD_DIR, digest.hexdigest()[:16])


def _ensure(target: str) -> str:
    """Build ``target`` (``libsliced.so`` or ``sliced``) if missing,
    with every other missing target beside it (one g++ each, all at
    once); return its path."""
    build = _build_dir()
    with _build_lock:
        missing = [t for t in _TARGETS
                   if not os.path.exists(os.path.join(build, t))]
        if not missing:
            return os.path.join(build, target)
        os.makedirs(build, exist_ok=True)
        jobs = []
        for name in missing:
            own, flags = _TARGETS[name]
            tmp = os.path.join(build, f"{name}.{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, *flags, "-o",
                   tmp, *(os.path.join(CSRC, s) for s in _POOL + own)]
            jobs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, tmp, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                errors.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, os.path.join(build, name))
        if errors:
            raise SlicedError("native build failed:\n" + "\n".join(errors))
    return os.path.join(build, target)


def ensure_built() -> str:
    """Build libsliced.so if missing; return its path."""
    return _ensure("libsliced.so")


def daemon_path() -> str:
    """Build the ``sliced`` line-protocol daemon if missing; return its
    path."""
    return _ensure("sliced")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())
    lib.sliced_new.restype = ctypes.c_void_p
    lib.sliced_free.argtypes = [ctypes.c_void_p]
    lib.sliced_add_slice.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.sliced_remove_slice.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sliced_free_chips.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sliced_request_gang.restype = ctypes.c_longlong
    lib.sliced_request_gang.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int]
    lib.sliced_release_gang.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.sliced_gang_info.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int]
    lib.sliced_heartbeat.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double]
    lib.sliced_preempt_slice.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.sliced_tick.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_char_p,
        ctypes.c_int]
    _lib = lib
    return lib


@dataclass
class Gang:
    gang_id: int
    state: str
    slice: str
    topology: str
    offset: tuple[int, ...]
    shape: tuple[int, ...]
    chips: tuple[int, ...]
    restarts: int
    run_uuid: str


@dataclass
class Event:
    gang_id: int
    kind: str  # PLACED | LOST | RESTART | FAILED | PREEMPTED
    detail: str = ""


class SlicePool:
    """Owned handle on a native pool instance."""

    def __init__(self):
        self._lib = _load()
        self._handle = self._lib.sliced_new()

    def close(self) -> None:
        if self._handle:
            self._lib.sliced_free(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception as exc:
            # Raising in __del__ is unusable noise at interpreter
            # teardown, but the leak is worth one debug line.
            logging.getLogger(__name__).debug(
                "SlicePool.__del__ close failed: %s", exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- inventory
    def add_slice(self, name: str, topology: str, *,
                  preemptible: bool = False) -> None:
        rc = self._lib.sliced_add_slice(
            self._handle, name.encode(), topology.encode(), int(preemptible))
        if rc != 0:
            raise SlicedError(f"add_slice({name!r}, {topology!r}) failed")

    def remove_slice(self, name: str) -> None:
        if self._lib.sliced_remove_slice(self._handle, name.encode()) != 0:
            raise SlicedError(f"unknown slice {name!r}")

    def free_chips(self, name: str) -> int:
        free = self._lib.sliced_free_chips(self._handle, name.encode())
        if free < 0:
            raise SlicedError(f"unknown slice {name!r}")
        return free

    # --------------------------------------------------------------- gangs
    def request_gang(self, run_uuid: str, topology: str, *, priority: int = 0,
                     max_restarts: int = 0) -> int:
        gang_id = self._lib.sliced_request_gang(
            self._handle, run_uuid.encode(), topology.encode(), priority,
            max_restarts)
        if gang_id == -1:
            raise SlicedError(f"malformed topology {topology!r}")
        if gang_id == -2:
            raise SlicedError(
                f"topology {topology!r} can never fit any registered slice")
        return int(gang_id)

    def release_gang(self, gang_id: int) -> None:
        if self._lib.sliced_release_gang(self._handle, gang_id) != 0:
            raise SlicedError(f"unknown gang {gang_id}")

    def gang(self, gang_id: int) -> Gang:
        buf = ctypes.create_string_buffer(_BUF_LEN)
        if self._lib.sliced_gang_info(self._handle, gang_id, buf,
                                      _BUF_LEN) < 0:
            raise SlicedError(f"unknown gang {gang_id}")
        fields = dict(
            part.split("=", 1) for part in buf.value.decode().split(";")
            if part)

        def ints(s):
            return tuple(int(x) for x in s.split(",")) if s else ()

        return Gang(
            gang_id=gang_id,
            state=fields["state"],
            slice=fields.get("slice", ""),
            topology=fields.get("topology", ""),
            offset=ints(fields.get("offset", "")),
            shape=ints(fields.get("shape", "")),
            chips=ints(fields.get("chips", "")),
            restarts=int(fields.get("restarts", "0")),
            run_uuid=fields.get("run", ""),
        )

    # ------------------------------------------------------------- signals
    def heartbeat(self, gang_id: int, proc: int, now: float) -> bool:
        return self._lib.sliced_heartbeat(self._handle, gang_id, proc,
                                          now) == 0

    def preempt_slice(self, name: str) -> int:
        evicted = self._lib.sliced_preempt_slice(self._handle, name.encode())
        if evicted < 0:
            raise SlicedError(f"unknown slice {name!r}")
        return evicted

    # ----------------------------------------------------------- reconcile
    def tick(self, now: float, *,
             heartbeat_timeout: float = 30.0) -> list[Event]:
        length = _BUF_LEN
        while True:
            buf = ctypes.create_string_buffer(length)
            if self._lib.sliced_tick(
                    self._handle, now, heartbeat_timeout, buf, length) >= 0:
                break
            # Events stay queued on overflow; retry with more room.
            length *= 4
            if length > (1 << 24):
                raise SlicedError("tick event buffer exceeded 16MB")
        events = []
        for line in buf.value.decode().splitlines():
            parts = line.split(" ", 2)
            events.append(Event(
                gang_id=int(parts[0]), kind=parts[1],
                detail=parts[2] if len(parts) > 2 else ""))
        return events
