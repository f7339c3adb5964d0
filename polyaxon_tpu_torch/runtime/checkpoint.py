"""Checkpoint and resume for the port's training runtime (port of
``polyaxon_tpu/runtime/checkpoint.py``).

The store is the port's own format, written with numpy and read back
with numpy or ``np.load``; no orbax. One directory per committed step::

    <directory>/<step>/manifest.json   step, and per leaf: tree path,
                                       kind, dtype, shape, byte count,
                                       CRC-32 of the bytes
    <directory>/<step>/leaf_<i>.npy    the leaf's bytes

A step is written under ``.tmp-<step>-<pid>`` and committed by renaming
the directory, so a process killed mid-write leaves only a tmp name that
``_list_steps`` ignores (and the next manager removes once its writer is
dead). bf16 has no numpy dtype: a bf16 leaf is stored as its raw 16-bit
words (``uint16``) and the manifest names its dtype, so nothing is cast.
Commits are atomic against the death of the process; the files are not
fsynced.

:class:`TieredCheckpointManager` puts the cheap tiers of
:mod:`runtime.tiers` in front of the store: ``save`` copies every leaf
to host memory before it returns (the step loop updates the state in
place), and a publisher thread commits the tier-0 replica, the store
(when the save is async) and the tier-1 spill (hard links to the store
step's files). ``restore`` walks steps
newest first and, per step, tries memory → spill → store; a tier that
fails to load or to validate (leaf count, shape, dtype, CRC) is culled
and the walk falls through.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from polyaxon_tpu_torch.runtime import tiers

logger = logging.getLogger(__name__)

FORMAT = "polyaxon_tpu_torch.checkpoint/1"
MANIFEST = "manifest.json"
IO_WORKERS = 4
# Host buffers: each leaf starts at a multiple of this many bytes.
ALIGN = 256


@dataclasses.dataclass
class CheckpointSpec:
    """A job's ``checkpointing`` section, with ``V1JaxCheckpointing``'s
    fields and defaults; takes the compiler's camelCase keys and
    snake_case alike."""

    enabled: Optional[bool] = True
    interval_steps: Optional[int] = None
    max_to_keep: Optional[int] = 3
    async_save: Optional[bool] = True
    restore_on_start: Optional[bool] = True

    _ALIASES = {"intervalSteps": "interval_steps", "maxToKeep": "max_to_keep",
                "asyncSave": "async_save", "restoreOnStart": "restore_on_start"}

    @classmethod
    def from_dict(cls, spec: Optional[dict]) -> "CheckpointSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        out = {}
        for key, value in (spec or {}).items():
            name = cls._ALIASES.get(key, key)
            if name not in names:
                raise ValueError(f"unknown checkpointing key `{key}`")
            out[name] = value
        return cls(**out)


# ----------------------------------------------------------- leaves
def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, value in items:
        out.extend(flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _rebuild(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _storage_dtype(dtype: torch.dtype) -> np.dtype:
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _entry(path: str, leaf: Any) -> dict:
    """The manifest record of one leaf, a tensor or an int (the step and
    the optimizer's count); its CRC is added on commit."""
    if isinstance(leaf, torch.Tensor):
        dtype = str(leaf.dtype).removeprefix("torch.")
        storage = _storage_dtype(leaf.dtype)
        kind, shape = "tensor", list(leaf.shape)
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        storage = np.dtype(np.int64)
        kind, dtype, shape = "int", storage.name, []
    else:
        raise TypeError(f"checkpoint leaf {path}: unsupported {type(leaf)}")
    nbytes = int(np.prod(shape, dtype=np.int64)) * storage.itemsize
    return {"path": path, "kind": kind, "dtype": dtype,
            "storage": storage.str, "shape": shape, "nbytes": nbytes}


def crc32(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.require(arr, requirements="C").reshape(-1)
                                 .view(np.uint8)))


def check_leaves(manifest: dict, state_like: Any) -> list[tuple[str, Any]]:
    """Raises ValueError unless the manifest's leaves match
    ``state_like``'s in count, path, kind, shape and dtype; returns
    ``flatten(state_like)``."""
    like = flatten(state_like)
    entries = manifest["leaves"]
    if len(entries) != len(like):
        raise ValueError(f"checkpoint holds {len(entries)} leaves, state "
                         f"expects {len(like)}")
    for entry, (path, leaf) in zip(entries, like):
        want = _entry(path, leaf)
        for key in ("path", "kind", "dtype", "shape"):
            if entry[key] != want[key]:
                raise ValueError(f"leaf {path}: checkpoint {key} "
                                 f"{entry[key]} != expected {want[key]}")
    return like


def _on_gpu(leaves: list[tuple[str, Any]]) -> bool:
    return any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
               for _, leaf in leaves)


def _buffer_bytes(leaves: list[tuple[str, Any]]) -> int:
    """Host-buffer bytes of a snapshot: each leaf at an ALIGN boundary."""
    return sum(-(-_entry(p, leaf)["nbytes"] // ALIGN) * ALIGN
               for p, leaf in leaves)


def _tensor_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    if not t.is_contiguous():
        raise ValueError("checkpoint tensors must be contiguous")
    return t.detach().reshape(-1).view(torch.uint8)


class _Stager:
    """Two page-locked bounce buffers for host → device copies: while
    one buffer's copy runs on the stream, the next chunk lands in the
    other."""

    def __init__(self, nbytes: int = 64 << 20):
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.events: list[Optional[torch.cuda.Event]] = [None, None]
        self.i = 0
        self.nbytes = nbytes

    def chunks(self, dst: torch.Tensor):
        """Yields (host uint8 numpy view to fill, n) and sends each
        filled chunk on to ``dst``'s bytes in order."""
        flat = _tensor_bytes(dst)
        for off in range(0, flat.numel(), self.nbytes):
            n = min(self.nbytes, flat.numel() - off)
            i, self.i = self.i, 1 - self.i
            if self.events[i] is not None:
                self.events[i].synchronize()
            buf = self.bufs[i]
            yield buf.numpy()[:n], n
            flat[off:off + n].copy_(buf[:n], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dst.device))
            self.events[i] = ev

    def drain(self) -> None:
        for ev in self.events:
            if ev is not None:
                ev.synchronize()


def _fill(dst: torch.Tensor, src: np.ndarray, stager: Optional[_Stager]
          ) -> None:
    """Copy host bytes ``src`` into tensor ``dst`` (same byte count)."""
    src_bytes = np.require(src, requirements="C").reshape(-1).view(np.uint8)
    if dst.device.type == "cpu":
        _tensor_bytes(dst).numpy()[:] = src_bytes
        return
    off = 0
    for buf, n in stager.chunks(dst):
        buf[:] = src_bytes[off:off + n]
        off += n


def _read_npy_into(path: str, entry: dict, dst: Optional[torch.Tensor],
                   stager: Optional[_Stager]) -> np.ndarray:
    """Read a stored leaf, checking its header against the manifest
    entry and its bytes against the entry's CRC-32. A tensor leaf is
    read straight into ``dst`` (through the page-locked stager for a
    device tensor) and an empty array is returned; other leaves are
    returned."""
    with open(path, "rb") as fh:
        version = np.lib.format.read_magic(fh)
        shape, fortran, dtype = (
            np.lib.format.read_array_header_1_0(fh) if version == (1, 0)
            else np.lib.format.read_array_header_2_0(fh))
        if (list(shape) != entry["shape"] or fortran
                or dtype.str != entry["storage"]):
            raise ValueError(f"{path}: header {shape} {dtype.str} does not "
                             f"match the manifest")
        crc, out = 0, np.empty(0, np.uint8)
        if dst is not None and dst.is_cuda:
            for buf, n in stager.chunks(dst):
                if fh.readinto(memoryview(buf)) != n:
                    raise ValueError(f"{path}: truncated")
                crc = zlib.crc32(memoryview(buf), crc)
        else:
            if dst is None:
                out = np.empty(shape, dtype)
            view = (out.reshape(-1).view(np.uint8) if dst is None
                    else _tensor_bytes(dst).numpy())
            if fh.readinto(memoryview(view)) != entry["nbytes"]:
                raise ValueError(f"{path}: truncated")
            crc = zlib.crc32(memoryview(view))
        if fh.read(1):
            raise ValueError(f"{path}: trailing bytes")
    if crc != entry["crc32"]:
        raise ValueError(f"{path}: CRC-32 {crc} != manifest "
                         f"{entry['crc32']}")
    return out


def _list_store_steps(directory: str) -> list[int]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted((int(n) for n in names if n.isdigit()), reverse=True)


def read_manifest(directory: str, step: int) -> dict:
    with open(os.path.join(directory, str(step), MANIFEST)) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"step {step} under {directory}: unknown format "
                         f"{manifest.get('format')!r}")
    return manifest


def load_tree(directory: str, step: Optional[int] = None, *,
              only: Optional[str] = None) -> tuple[int, dict]:
    """(step, tree) of a committed store step (the latest by default)
    with its leaves on the host, CRC-checked: tensor leaves as CPU
    tensors of their saved dtype, ints as ints, lists as dicts keyed by
    index. ``only``: read just the subtree of that name
    when the step has one (``"params"`` of a train state), else all.
    For readers without the state's structure (serving a checkpoint)."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = _list_store_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        step = steps[0]
    manifest = read_manifest(directory, step)
    entries = list(enumerate(manifest["leaves"]))
    if only is not None:
        chosen = [(i, e) for i, e in entries
                  if e["path"] == only or e["path"].startswith(only + "/")]
        entries = chosen or entries
    tree: dict = {}
    for i, entry in entries:
        arr = _read_npy_into(os.path.join(directory, str(step),
                                          f"leaf_{i}.npy"), entry, None, None)
        if entry["kind"] == "tensor":
            value = torch.from_numpy(arr)
            if entry["dtype"] == "bfloat16":
                value = value.view(torch.bfloat16)
        else:
            value = int(arr)
        node = tree
        *parents, leaf_key = entry["path"].split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf_key] = value
    return step, tree


class _HostBuffer:
    """The flat host buffer snapshots are taken into, page-locked
    (``cudaHostRegister``) when the state lives on a GPU, so the device →
    host copy runs at the link's rate. One buffer: the tier-0 replica is
    the latest snapshot itself, and a save drops it just before the next
    snapshot overwrites the buffer (saves wait for the previous commit,
    so nothing else reads it then). A replica may outlive its manager:
    its arrays keep the memory, which is then no longer page-locked."""

    def __init__(self) -> None:
        self.buf: Optional[np.ndarray] = None
        self.pinned = False

    def take(self, nbytes: int, pin: bool) -> np.ndarray:
        if self.buf is None or self.buf.nbytes < nbytes:
            self.close()
            self.buf = np.empty(nbytes, np.uint8)
            if pin:
                err = torch.cuda.cudart().cudaHostRegister(
                    self.buf.ctypes.data, nbytes, 0)
                if int(err) != 0:
                    raise RuntimeError(f"cudaHostRegister failed ({err})")
                self.pinned = True
        return self.buf

    def holds(self, arr: np.ndarray) -> bool:
        """Whether ``arr`` lies in the (page-locked) buffer."""
        return self.pinned and np.may_share_memory(arr, self.buf)

    def close(self) -> None:
        if self.pinned:
            torch.cuda.cudart().cudaHostUnregister(self.buf.ctypes.data)
            self.pinned = False
        self.buf = None


class CheckpointManager:
    """The store tier alone: ``save`` writes a step (synchronously, or on
    a writer thread when the spec's ``async_save`` is on), ``restore``
    reads one back into a state of the same structure."""

    _tiered = False  # whether every save goes through the publisher

    def __init__(self, directory: str, spec: Optional[CheckpointSpec] = None):
        self.spec = spec or CheckpointSpec()
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._remove_orphans()
        # Steps skipped by the most recent restore() because they failed
        # to load or validate (newest first).
        self.last_restore_skipped: list[int] = []
        # Which tier satisfied the most recent restore() ("0" memory /
        # "1" local spill / "2" store).
        self.last_restore_tier: Optional[str] = None
        self._steps_cache: Optional[list[int]] = None
        self._buffer = _HostBuffer()
        self._pool = ThreadPoolExecutor(IO_WORKERS,
                                        thread_name_prefix="ckpt-io")
        self._cv = threading.Condition()
        self._pending: Optional[tuple[int, list[np.ndarray], dict]] = None
        self._publishing = False
        self._publisher_stop = False
        self._publisher: Optional[threading.Thread] = None
        self.publish_errors = 0
        # Seconds, per save and restore: the step loop's stall in save()
        # (waiting for the previous commit, then the host copy), each
        # tier's commit, each tier's winning restore.
        self.save_wait_seconds: list[float] = []
        self.snapshot_seconds: list[float] = []
        self.save_seconds: dict[str, list[float]] = {}
        self.restore_seconds: dict[str, list[float]] = {}

    # --------------------------------------------------------- timing
    def _observe_save(self, tier: str, seconds: float) -> None:
        self.save_seconds.setdefault(tier, []).append(seconds)

    def _observe_restore(self, tier: str, seconds: float) -> None:
        self.restore_seconds.setdefault(tier, []).append(seconds)

    # ----------------------------------------------------------- spec
    @property
    def enabled(self) -> bool:
        return bool(self.spec.enabled)

    def should_save(self, step: int) -> bool:
        if not self.enabled:
            return False
        interval = self.spec.interval_steps
        return bool(interval) and step > 0 and step % interval == 0

    # ----------------------------------------------------------- save
    def prepare(self, state: Any) -> None:
        """Allocate (and page-lock) the snapshot buffer now, off the step
        loop, instead of in the first save."""
        leaves = flatten(state)
        self._buffer.take(_buffer_bytes(leaves), _on_gpu(leaves))

    def _snapshot(self, step: int, state: Any
                  ) -> tuple[list[np.ndarray], dict]:
        """Every leaf copied to host memory, the copy complete on return.
        The leaves land in the host buffer: a device copy of the state
        would not fit beside training."""
        leaves = flatten(state)
        entries = [_entry(p, leaf) for p, leaf in leaves]
        buf = self._buffer.take(_buffer_bytes(leaves), _on_gpu(leaves))
        replica = tiers.TIER0.lookup(self.directory)
        if replica is not None and any(
                np.may_share_memory(a, buf)
                for a in replica["arrays"].values()):
            tiers.TIER0.drop(self.directory)  # about to be overwritten
        arrays, off, streams = [], 0, set()
        for (path, leaf), entry in zip(leaves, entries):
            n = entry["nbytes"]
            host = buf[off:off + n].view(entry["storage"]).reshape(
                entry["shape"])
            off += -(-n // ALIGN) * ALIGN
            if entry["kind"] == "tensor":
                with torch.no_grad():
                    dst = torch.from_numpy(host)
                    if leaf.dtype == torch.bfloat16:
                        dst = dst.view(torch.bfloat16)
                    dst.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
                if leaf.is_cuda:
                    streams.add(torch.cuda.current_stream(leaf.device))
            else:
                host[...] = leaf
            arrays.append(host)
        for stream in streams:
            stream.synchronize()
        manifest = {"format": FORMAT, "step": int(step), "leaves": entries}
        return arrays, manifest

    def _checksum(self, arrays: list[np.ndarray], manifest: dict) -> None:
        for entry, crc in zip(manifest["leaves"],
                              self._pool.map(crc32, arrays)):
            entry["crc32"] = crc

    def _write_store(self, step: int, arrays: list[np.ndarray],
                     manifest: dict) -> None:
        """Write one step under a tmp name and commit it by rename, then
        prune to ``max_to_keep``."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory,
                           f"{tiers.TMP_PREFIX}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        def write(i: int) -> None:
            with open(os.path.join(tmp, f"leaf_{i}.npy"), "wb") as fh:
                tiers.write_npy(fh, arrays[i])

        list(self._pool.map(write, range(len(arrays))))
        with open(os.path.join(tmp, MANIFEST), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):
            self._delete(step)  # re-saving a step replaces it
        os.rename(tmp, final)
        self._steps_cache = None
        keep = self.spec.max_to_keep
        if keep:
            for stale in _list_store_steps(self.directory)[keep:]:
                self._delete(stale)

    def save(self, step: int, state: Any, *, force: bool = False) -> None:
        """Snapshot ``state`` to host memory, then commit it: on the
        publisher thread when the spec's ``async_save`` is on, else
        before returning. Waits first for the previous save's commit
        (one save in flight). The port's train step draws no random
        numbers, so the state (params, optimizer moments and count,
        step) is all a resume needs."""
        if not self.enabled and not force:
            return
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        arrays, manifest = self._snapshot(step, state)
        t2 = time.perf_counter()
        self.save_wait_seconds.append(t1 - t0)
        self.snapshot_seconds.append(t2 - t1)
        if not self.spec.async_save:
            self._checksum(arrays, manifest)
            self._write_store(step, arrays, manifest)
            self._observe_save(tiers.TIER_STORE, time.perf_counter() - t2)
        if self.spec.async_save or self._tiered:
            self._hand_off(int(step), arrays, manifest)

    def _hand_off(self, step: int, arrays: list[np.ndarray],
                  manifest: dict) -> None:
        with self._cv:
            self._pending = (step, arrays, manifest)
            if self._publisher is None or not self._publisher.is_alive():
                self._publisher_stop = False
                self._publisher = threading.Thread(
                    target=self._publish_loop, name="ckpt-publisher",
                    daemon=True)
                self._publisher.start()
            self._cv.notify_all()

    def _publish(self, step: int, arrays: list[np.ndarray],
                 manifest: dict) -> None:
        """Commit a handed-off snapshot (the store, for an async save)."""
        self._checksum(arrays, manifest)
        t0 = time.perf_counter()
        self._write_store(step, arrays, manifest)
        self._observe_save(tiers.TIER_STORE, time.perf_counter() - t0)

    def _publish_loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._publisher_stop:
                    self._cv.wait()
                if self._pending is None:
                    return
                step, arrays, manifest = self._pending
                self._pending = None
                self._publishing = True
            try:
                self._publish(step, arrays, manifest)
            except Exception as exc:  # noqa: BLE001 — reported, counted
                self.publish_errors += 1
                logger.warning("checkpoint commit for step %s failed: %s",
                               step, exc)
            finally:
                with self._cv:
                    self._publishing = False
                    self._cv.notify_all()

    # -------------------------------------------------------- listing
    def _remove_orphans(self) -> None:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if (name.startswith(tiers.TMP_PREFIX)
                    and not tiers.tmp_owner_alive(name)):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                logger.info("removed %s, left by a dead writer", name)

    def _delete(self, step: int) -> None:
        """Retire a committed step: renamed to a tmp name first, so no
        listing sees it half-deleted."""
        path = os.path.join(self.directory, str(step))
        gone = os.path.join(self.directory,
                            f"{tiers.TMP_PREFIX}del-{step}-{os.getpid()}")
        try:
            os.rename(path, gone)
        except OSError:
            return
        shutil.rmtree(gone, ignore_errors=True)
        self._steps_cache = None

    def _list_steps(self) -> list[int]:
        """Committed store steps, newest first; listed once and cached
        until the next save or delete."""
        if self._steps_cache is None:
            self._steps_cache = _list_store_steps(self.directory)
        return self._steps_cache

    def latest_step(self) -> Optional[int]:
        steps = self._list_steps()
        return steps[0] if steps else None

    # -------------------------------------------------------- restore
    def _load_store(self, state_like: Any, step: int) -> Any:
        """Step ``step`` of the store into ``state_like``: tensors are
        filled in place (device tensors through page-locked buffers),
        scalars returned anew. Raises on any mismatch."""
        manifest = read_manifest(self.directory, step)
        like = check_leaves(manifest, state_like)
        step_dir = os.path.join(self.directory, str(step))

        def load(i: int, stager: Optional[_Stager]) -> Any:
            entry, (_, leaf) = manifest["leaves"][i], like[i]
            dst = leaf if entry["kind"] == "tensor" else None
            arr = _read_npy_into(os.path.join(step_dir, f"leaf_{i}.npy"),
                                 entry, dst, stager)
            return leaf if entry["kind"] == "tensor" else int(arr)

        return _rebuild(state_like, iter(self._map_leaves(load, like)))

    def _map_leaves(self, fn, like: list[tuple[str, Any]]) -> list[Any]:
        """``fn(i, stager)`` for every leaf index, on the IO threads, each
        thread with its own page-locked stager when the state is on a
        GPU; every copy has landed when this returns."""
        on_gpu = _on_gpu(like)
        local = threading.local()

        def run(i: int) -> Any:
            stager = None
            if on_gpu:
                stager = getattr(local, "stager", None)
                if stager is None:
                    stager = local.stager = _Stager()
            try:
                with torch.no_grad():
                    return fn(i, stager)
            finally:
                if stager is not None:
                    stager.drain()

        values = list(self._pool.map(run, range(len(like))))
        if on_gpu:
            torch.cuda.synchronize()  # the unstaged copies too
        return values

    def _cull_store(self, step: int, exc: Exception) -> None:
        logger.warning("checkpoint step %s under %s failed to restore (%s: "
                       "%s); falling back to the next-older step", step,
                       self.directory, type(exc).__name__, str(exc)[:200])
        self._delete(step)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore into ``state_like``'s tensors (in place) and return the
        state with its scalars restored. With no explicit ``step``, a
        step that fails to load or validate is culled and the walk falls
        back to the next-older one (``last_restore_skipped``); an
        explicit ``step`` never falls back."""
        self.wait()
        self.last_restore_skipped = []
        self.last_restore_tier = None
        t0 = time.perf_counter()
        if step is not None:
            restored = self._load_store(state_like, step)
            return self._won(restored, step, tiers.TIER_STORE, t0)
        steps = self._list_steps()
        if not steps:
            raise FileNotFoundError(f"No checkpoint under {self.directory}")
        last_error: Optional[Exception] = None
        for candidate in list(steps):
            try:
                restored = self._load_store(state_like, candidate)
            except Exception as exc:  # noqa: BLE001 — fall back to older
                last_error = exc
                self.last_restore_skipped.append(candidate)
                self._cull_store(candidate, exc)
                continue
            return self._won(restored, candidate, tiers.TIER_STORE, t0)
        raise RuntimeError(
            f"no restorable checkpoint under {self.directory}: every step "
            f"{steps} failed to load") from last_error

    def _won(self, restored: Any, candidate: int, tier: str,
             t_restore: float) -> Any:
        self.last_restore_tier = tier
        self._observe_restore(tier, time.perf_counter() - t_restore)
        if self.last_restore_skipped:
            logger.warning(
                "restored step %s from tier %s after skipping corrupt "
                "step(s) %s", candidate, tier, self.last_restore_skipped)
        else:
            logger.info("Restored checkpoint step=%s tier=%s from %s",
                        candidate, tier, self.directory)
        return restored

    # ---------------------------------------------------------- drain
    def wait(self) -> None:
        """Block until every handed-off save has committed."""
        with self._cv:
            while self._pending is not None or self._publishing:
                self._cv.wait(timeout=0.1)

    def close(self) -> None:
        self.wait()
        with self._cv:
            self._publisher_stop = True
            self._cv.notify_all()
        if self._publisher is not None:
            self._publisher.join(timeout=5.0)
            self._publisher = None
        self._pool.shutdown()
        self._buffer.close()


class TieredCheckpointManager(CheckpointManager):
    """Store-backed manager with the cheap tiers in front.

    ``save`` snapshots the state to host memory and hands it to the
    publisher thread, which commits the tier-0 replica, then the store
    (async saves), then the tier-1 spill as hard links to the store's
    files (a copy of its own where they cannot be linked): atomic on
    disk. ``restore`` walks candidate steps newest first and, per
    step, tries memory → spill → store; a tier that fails validation is
    culled and the walk falls through, so a poisoned tier never wins
    over an older clean one. A spill win is promoted into memory, so the
    next restore is a tier-0 hit.
    """

    _tiered = True

    def __init__(self, directory: str, spec: Optional[CheckpointSpec] = None):
        super().__init__(directory, spec)
        self._spill = tiers.LocalSpill(self.directory)
        self._spill.remove_orphans()

    # ----------------------------------------------------------- save
    def _publish(self, step: int, arrays: list[np.ndarray],
                 manifest: dict) -> None:
        named = {f"leaf_{i}": a for i, a in enumerate(arrays)}
        if self.spec.async_save:  # a sync save committed the store already
            self._checksum(arrays, manifest)
        t0 = time.perf_counter()
        tiers.TIER0.publish(self.directory, step, named, manifest)
        self._observe_save(tiers.TIER_MEMORY, time.perf_counter() - t0)
        if self.spec.async_save:
            t0 = time.perf_counter()
            self._write_store(step, arrays, manifest)
            self._observe_save(tiers.TIER_STORE, time.perf_counter() - t0)
        t0 = time.perf_counter()
        try:
            committed = self._spill.link(
                step, os.path.join(self.directory, str(step)))
        except OSError as exc:
            logger.info("tier-1 spill cannot link the store's files (%s); "
                        "writing its own copy", exc)
            committed = self._spill.spill(step, named, manifest=manifest)
        self._observe_save(tiers.TIER_LOCAL, time.perf_counter() - t0)
        if not committed:
            logger.warning("tier-1 commit withheld for step %s", step)

    # -------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        candidates = list(self._list_steps())
        replica = tiers.TIER0.lookup(self.directory)
        if replica is not None:
            candidates.append(int(replica["step"]))
        candidates.extend(self._spill.steps())
        return max(candidates, default=None)

    def _materialize(self, state_like: Any, arrays: dict[str, np.ndarray],
                     manifest: Optional[dict]) -> Any:
        """Host leaves of tier 0 or 1 into ``state_like``: tensors filled
        in place, scalars returned anew. Any mismatch raises; the caller
        culls the tier and falls through."""
        like = flatten(state_like)
        if len(arrays) != len(like):
            raise ValueError(f"tier replica holds {len(arrays)} leaves, "
                             f"state expects {len(like)}")
        if manifest is not None:
            check_leaves(manifest, state_like)
        wants = [_entry(path, leaf) for path, leaf in like]
        for i, want in enumerate(wants):  # all checked before any copy
            arr = arrays[f"leaf_{i}"]
            if (list(arr.shape) != want["shape"]
                    or arr.dtype.str != want["storage"]):
                raise ValueError(
                    f"leaf_{i}: replica {arr.dtype}{list(arr.shape)} != "
                    f"expected {want['dtype']}{want['shape']}")

        def fill(i: int, stager: Optional[_Stager]) -> Any:
            arr, want, leaf = arrays[f"leaf_{i}"], wants[i], like[i][1]
            if want["kind"] == "int":
                return int(arr)
            if leaf.is_cuda and self._buffer.holds(arr):
                src = torch.from_numpy(arr)  # page-locked already
                if leaf.dtype == torch.bfloat16:
                    src = src.view(torch.bfloat16)
                leaf.copy_(src, non_blocking=True)
            else:
                _fill(leaf, arr, stager)
            return leaf

        return _rebuild(state_like, iter(self._map_leaves(fill, like)))

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        if step is not None:
            # Explicit step: the caller asked for those exact store
            # bytes, with no tier preference and no fallback.
            return super().restore(state_like, step)
        self.wait()
        self.last_restore_skipped = []
        self.last_restore_tier = None
        t_restore = time.perf_counter()
        replica = tiers.TIER0.lookup(self.directory)
        spill_steps = set(self._spill.steps())
        store_steps = self._list_steps()
        candidates = sorted(
            set(store_steps) | spill_steps
            | ({int(replica["step"])} if replica is not None else set()),
            reverse=True)
        if not candidates:
            raise FileNotFoundError(f"No checkpoint under {self.directory}")
        last_error: Optional[Exception] = None
        for candidate in candidates:
            if replica is not None and int(replica["step"]) == candidate:
                try:
                    restored = self._materialize(
                        state_like, replica["arrays"], replica["manifest"])
                except Exception as exc:  # noqa: BLE001 — cull, fall through
                    last_error = exc
                    tiers.TIER0.drop(self.directory)
                    replica = None
                    logger.warning(
                        "tier-0 replica at step %s unusable (%s: %s); "
                        "falling through", candidate, type(exc).__name__,
                        str(exc)[:200])
                else:
                    return self._won(restored, candidate, tiers.TIER_MEMORY,
                                     t_restore)
            if candidate in spill_steps:
                try:
                    arrays, manifest = self._spill.load(candidate)
                    restored = self._materialize(state_like, arrays,
                                                 manifest)
                except Exception as exc:  # noqa: BLE001 — cull, fall through
                    last_error = exc
                    self._spill.cull(candidate)
                    logger.warning(
                        "tier-1 spill step %s unusable (%s: %s); falling "
                        "through", candidate, type(exc).__name__,
                        str(exc)[:200])
                else:
                    tiers.TIER0.publish(self.directory, candidate, arrays,
                                        manifest)
                    return self._won(restored, candidate, tiers.TIER_LOCAL,
                                     t_restore)
            if candidate in store_steps:
                try:
                    restored = self._load_store(state_like, candidate)
                except Exception as exc:  # noqa: BLE001 — cull, fall back
                    last_error = exc
                    self._cull_store(candidate, exc)
                else:
                    return self._won(restored, candidate, tiers.TIER_STORE,
                                     t_restore)
            # Every tier that held this step failed.
            self.last_restore_skipped.append(candidate)
        raise RuntimeError(
            f"no restorable checkpoint under {self.directory}: every step "
            f"{candidates} failed across all tiers") from last_error
