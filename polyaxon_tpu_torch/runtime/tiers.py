"""Tier-0/tier-1 checkpoint planes (port of
``polyaxon_tpu/runtime/tiers.py``): the cheap restore tiers in front of
the store.

A rolling in-memory replica of the latest committed step (tier 0) over a
local-disk spill (tier 1) over the store (tier 2, in
:mod:`runtime.checkpoint`, whose ``TieredCheckpointManager`` composes
all three). numpy and the standard library only.

Commit protocol (tier 1): a step is written under a ``.tmp-<step>-<pid>``
name and published with a rename, so a reader never sees a half-written
step, and a process killed mid-write leaves only a tmp name that
``steps()`` and ``load()`` ignore and that the next manager on the
directory removes once its writer is dead. A step takes one of two
forms:

- ``<step>.npz`` (``spill``): the leaves streamed, one ``.npy`` member
  at a time, into an uncompressed npz, as the reference writes it. Zip
  members carry a CRC-32, which ``load`` (and ``np.load``) checks.
- ``<step>/`` (``link``): hard links to the files of a committed store
  step (its ``.npy`` leaves and its manifest, which holds each leaf's
  CRC-32). No byte is written twice: the spill costs disk only for the
  steps it keeps after the store has pruned them, and it guards against
  the store's prune and deletes, not against bad media (a flipped byte
  shows in both names, and both fail the CRC check).

The spill dir is named ``.tier1`` (not digits), so store step listings
never see it.

Tier 0 is a process-global registry keyed by the absolute checkpoint
directory: a rerun in the same process lands on the same slot. A rerun
in a new process loses the replica by construction and falls through to
the spill.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)

# Tier labels, as the run's outputs report them (`restore_tier`).
TIER_MEMORY = "0"
TIER_LOCAL = "1"
TIER_STORE = "2"

# The reference's restore-budget floor (wall seconds, p99). Reported
# beside the port's restore times; nothing here enforces it.
RESTORE_BUDGET_P99_SECONDS = 2.5

SPILL_DIRNAME = ".tier1"
SPILL_KEEP = 2  # committed spill steps retained per directory
# The spill's member holding the step's manifest (JSON bytes as uint8).
MANIFEST_KEY = "__manifest__"
# A linked step's manifest file (the store's; see runtime.checkpoint).
MANIFEST_FILE = "manifest.json"
TMP_PREFIX = ".tmp-"
# Bytes per read or write call when streaming a leaf.
CHUNK_BYTES = 64 << 20
# Threads that read a spill's members at once.
LOAD_WORKERS = 4

# When set, spills write their tmp file but withhold the os.replace
# commit: the atomic-commit protocol's failure mode, drilled for real.
# Readers then never see the step.
WEDGE_TIER0_COMMITS = False


def write_npy(fh, arr: np.ndarray) -> None:
    """One ``.npy`` record (header, then the raw bytes in CHUNK_BYTES
    writes) to a binary file object: what ``np.save`` writes, without a
    copy of the array."""
    arr = np.require(arr, requirements="C")
    np.lib.format.write_array_header_1_0(
        fh, np.lib.format.header_data_from_array_1_0(arr))
    flat = memoryview(arr.reshape(-1).view(np.uint8))
    for off in range(0, len(flat), CHUNK_BYTES):
        fh.write(flat[off:off + CHUNK_BYTES])


def _stored_members(path: str) -> dict[str, tuple[int, int, int]]:
    """Each member of an uncompressed zip: name → (offset of its bytes,
    size, CRC-32)."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            fh.seek(info.header_offset)
            local = fh.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: bad header for {info.filename}")
            name_len, extra_len = struct.unpack("<2H", local[26:30])
            out[info.filename] = (info.header_offset + 30 + name_len
                                  + extra_len, info.file_size, info.CRC)
    return out


def _read_member(path: str, offset: int, size: int, crc: int, *,
                 crc_of_header: bool = True) -> np.ndarray:
    """One ``.npy`` record of ``size`` bytes at ``offset`` (a stored zip
    member, or a whole ``.npy`` file), read in CHUNK_BYTES calls straight
    into its array (``np.load`` reads a zip member 256 KB at a time);
    raises unless its bytes match ``crc``, the CRC-32 of the record (a
    zip member's) or, without ``crc_of_header``, of the array's bytes
    alone (a store manifest's)."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        version = np.lib.format.read_magic(fh)
        shape, fortran, dtype = (
            np.lib.format.read_array_header_1_0(fh) if version == (1, 0)
            else np.lib.format.read_array_header_2_0(fh))
        head_len = fh.tell() - offset
        running = 0
        if crc_of_header:
            fh.seek(offset)
            running = zlib.crc32(fh.read(head_len))
        arr = np.empty(shape, dtype, order="F" if fortran else "C")
        flat = memoryview(arr.reshape(-1, order="A").view(np.uint8))
        if head_len + len(flat) != size:
            raise ValueError(f"{path}: record size does not match its header")
        for off in range(0, len(flat), CHUNK_BYTES):
            chunk = flat[off:off + CHUNK_BYTES]
            if fh.readinto(chunk) != len(chunk):
                raise ValueError(f"{path}: truncated record")
            running = zlib.crc32(chunk, running)
    if running != crc:
        raise ValueError(f"{path}: CRC-32 mismatch")
    return arr


def _linked_members(path: str) -> tuple[dict[str, tuple], dict]:
    """A linked step's leaves, ``leaf_<i>`` → ``_read_member`` arguments,
    and its manifest."""
    with open(os.path.join(path, MANIFEST_FILE)) as fh:
        manifest = json.load(fh)
    members = {}
    for i, entry in enumerate(manifest["leaves"]):
        leaf = os.path.join(path, f"leaf_{i}.npy")
        members[f"leaf_{i}"] = (leaf, 0, os.path.getsize(leaf),
                                entry["crc32"])
    return members, manifest


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.remove(path)
        except OSError:
            pass


def tmp_owner_alive(name: str) -> bool:
    """Whether the process that owns tmp name ``.tmp-…-<pid>[.ext]`` is
    still running (unparseable names count as alive: left alone)."""
    stem = name.split(".npz")[0]
    try:
        pid = int(stem.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return True
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


class Tier0Registry:
    """Process-global in-memory replica slots, one per checkpoint dir.

    Rolling: each publish replaces the slot. Payloads are host-side
    numpy leaves (``leaf_<i>``) and the step's manifest, if any; the
    registry never touches devices, so it is safe from any thread.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: dict[str, dict[str, Any]] = {}

    def publish(self, directory: str, step: int,
                arrays: dict[str, np.ndarray],
                manifest: Optional[dict] = None) -> None:
        directory = os.path.abspath(directory)
        with self._lock:
            self._slots[directory] = {"step": int(step), "arrays": arrays,
                                      "manifest": manifest}

    def lookup(self, directory: str) -> Optional[dict[str, Any]]:
        """``{"step", "arrays", "manifest"}`` for the replica, or None.
        The arrays are returned by reference: callers must not mutate
        them."""
        with self._lock:
            return self._slots.get(os.path.abspath(directory))

    def drop(self, directory: str) -> bool:
        with self._lock:
            return self._slots.pop(os.path.abspath(directory),
                                   None) is not None

    def clear(self) -> None:
        with self._lock:
            self._slots.clear()


TIER0 = Tier0Registry()


class LocalSpill:
    """Tier 1: steps under ``<directory>/.tier1``, each an npz file or a
    directory of hard links to a store step, committed atomically (tmp
    name, then rename) so readers never see torn bytes."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self.path = os.path.join(self.directory, SPILL_DIRNAME)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.path, f"{int(step)}.npz")

    def _link_path(self, step: int) -> str:
        return os.path.join(self.path, str(int(step)))

    def _tmp_path(self, step: int, ext: str = "") -> str:
        return os.path.join(self.path,
                            f"{TMP_PREFIX}{int(step)}-{os.getpid()}{ext}")

    def _commit(self, step: int, tmp: str, final: str, keep: int) -> bool:
        if WEDGE_TIER0_COMMITS:
            logger.warning("tier-1 commit wedged for step %s under %s "
                           "(WEDGE_TIER0_COMMITS)", step, self.path)
            return False
        self.cull(step)  # re-spilling a step replaces it
        os.replace(tmp, final)
        self._prune(keep)
        return True

    def spill(self, step: int, arrays: dict[str, np.ndarray], *,
              keep: int = SPILL_KEEP,
              manifest: Optional[dict] = None) -> bool:
        """Commit one step, streaming each leaf into an npz file; returns
        False when the commit was withheld (:data:`WEDGE_TIER0_COMMITS`):
        the tmp bytes exist but the step is not published."""
        os.makedirs(self.path, exist_ok=True)
        tmp = self._tmp_path(step, ".npz")
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, value in arrays.items():
                with zf.open(f"{key}.npy", "w", force_zip64=True) as fh:
                    write_npy(fh, np.asarray(value))
            if manifest is not None:
                blob = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
                with zf.open(f"{MANIFEST_KEY}.npy", "w") as fh:
                    write_npy(fh, blob)
        return self._commit(step, tmp, self._step_path(step), keep)

    def link(self, step: int, source: str, *,
             keep: int = SPILL_KEEP) -> bool:
        """Commit one step as hard links to the files of ``source``, a
        committed store step directory (``leaf_<i>.npy`` and
        ``manifest.json``); returns False when the commit was withheld.
        Raises OSError where the files cannot be linked (the spill on
        another filesystem): the caller then spills the bytes."""
        os.makedirs(self.path, exist_ok=True)
        tmp = self._tmp_path(step)
        _remove(tmp)
        os.makedirs(tmp)
        try:
            for name in os.listdir(source):
                os.link(os.path.join(source, name), os.path.join(tmp, name))
        except OSError:
            _remove(tmp)
            raise
        return self._commit(step, tmp, self._link_path(step), keep)

    def _prune(self, keep: int) -> None:
        for stale in self.steps()[keep:]:
            self.cull(stale)

    def steps(self) -> list[int]:
        """Committed spill steps, newest first."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        out = set()
        for name in names:
            stem, ext = os.path.splitext(name)
            if name.isdigit() or (ext == ".npz" and stem.isdigit()):
                out.add(int(stem))
        return sorted(out, reverse=True)

    def load(self, step: int
             ) -> tuple[dict[str, np.ndarray], Optional[dict]]:
        """(leaves, manifest or None), the leaves read in parallel.
        Raises on missing or corrupt bytes (a leaf whose CRC-32
        disagrees): the caller culls and falls through to the next
        tier."""
        linked = self._link_path(step)
        if os.path.isdir(linked):
            members, manifest = _linked_members(linked)
            header = False
        else:
            path = self._step_path(step)
            stored = _stored_members(path)
            if not all(name.endswith(".npy") for name in stored):
                raise ValueError(f"{path}: a member is not an .npy record")
            members = {n[:-4]: (path, *m) for n, m in stored.items()}
            manifest, header = None, True
        with ThreadPoolExecutor(LOAD_WORKERS) as pool:
            arrays = dict(zip(members, pool.map(
                lambda m: _read_member(*m, crc_of_header=header),
                members.values())))
        blob = arrays.pop(MANIFEST_KEY, None)
        if blob is not None:
            manifest = json.loads(blob.tobytes())
        return arrays, manifest

    def cull(self, step: int) -> None:
        _remove(self._step_path(step))
        _remove(self._link_path(step))

    def drop_all(self) -> None:
        for step in self.steps():
            self.cull(step)

    def remove_orphans(self) -> list[str]:
        """Delete tmp names whose writing process is dead (a process
        killed mid-spill); returns them."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        gone = []
        for name in names:
            if name.startswith(TMP_PREFIX) and not tmp_owner_alive(name):
                _remove(os.path.join(self.path, name))
                gone.append(name)
        return gone


def warm(directory: str) -> Optional[int]:
    """Promote the newest committed spill step into the memory slot when
    the slot is cold. Returns the warmed step, or None when the slot was
    already hot or nothing is spilled."""
    if TIER0.lookup(directory) is not None:
        return None
    spill = LocalSpill(directory)
    for step in spill.steps():
        try:
            arrays, manifest = spill.load(step)
        except Exception:  # noqa: BLE001 — corrupt spill: cull, keep looking
            spill.cull(step)
            continue
        TIER0.publish(directory, step, arrays, manifest)
        return step
    return None
