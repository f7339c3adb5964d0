"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries land in ``ops/_build/`` (listed in ``.gitignore``)
under a name that carries the hash of the source and of every local
header it includes (``#include "x.cuh"``, followed recursively), so an
edited source or header builds anew. Nothing is compiled at import: the
first launch of a kernel builds it, or ``build_all()`` starts every
build at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check()`` raises on a non-zero code. A failed build raises too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
KERNELS = ("flash_fwd", "flash_bwd", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels build on "
                       "a machine with the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list[str]:
    """``<name>.cu`` and the local headers it includes, recursively, in
    a fixed order."""
    order, stack = [], [f"{name}.cu"]
    while stack:
        rel = stack.pop()
        if rel in order:
            continue
        order.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as fh:
            found = _LOCAL_INCLUDE.findall(fh.read())
        stack.extend(inc.decode() for inc in reversed(found))
    return order


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _sources(name):
        with open(os.path.join(CSRC, rel), "rb") as fh:
            digest.update(rel.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, extra: tuple = ()) -> Optional[tuple]:
    """Start ``nvcc`` for one kernel unless its library exists.
    Returns (process, temp output, final path) or None."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish(name: str, started: tuple) -> str:
    proc, tmp, path = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half
    return out


def build_all(verbose: bool = False) -> dict[str, str]:
    """Build every kernel library that is missing, all ``nvcc`` runs in
    parallel. ``verbose`` adds ``-Xptxas -v`` (registers, shared memory
    and spills per kernel). Returns each kernel's compiler output."""
    extra = ("-Xptxas", "-v") if verbose else ()
    with _lock:
        started = {name: _start(name, extra) for name in KERNELS}
        return {name: (_finish(name, s) if s is not None else "")
                for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a CUDA error code returned by a C entry point; every
    library exports ``error_string`` (``cudaGetErrorString``)."""
    if code != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
