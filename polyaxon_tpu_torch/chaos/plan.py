"""Deterministic fault injection for the control plane (ISSUE 1).

A :class:`ChaosPlan` is a seed-addressed list of faults, each pinned to
one of four seams the orchestration spine crosses on every run:

- ``store``      — artifact-store I/O: raise a typed transient (or
                   permanent) ``StoreError`` on the Nth matching op;
- ``gang``       — executor gangs: kill a member (SIGKILL for
                   subprocess gangs, an injected exception for the
                   in-process fast path), optionally gated on the run
                   having written ``min_checkpoints`` checkpoint steps;
- ``init``       — stall a named init phase for ``seconds``;
- ``checkpoint`` — corrupt the LATEST checkpoint step's bytes on disk
                   right before a restore, so the fallback path runs;
- ``tick``       — swallow the Nth scheduler tick (a stalled control
                   plane), proving ticks are idempotent;
- ``slice-loss`` — elastic gangs (ISSUE 14): op ``kill`` takes a slice
                   away mid-train (an elastic gang files a *shrink*
                   resize; a non-elastic gang is preempted), op
                   ``restore`` returns the capacity (files a *grow*).
                   ``min_checkpoints`` gates like the gang seam, and a
                   ``restore`` is only eligible after a ``kill`` fired;
- ``tier0-loss`` — tiered checkpointing (ISSUE 16): drop the in-memory
                   tier-0 replica AND its local-disk spill right before
                   a restore, so the store-fallback path is drilled,
                   not assumed (``runtime.tiers`` consults this seam).

Activation: tests call :func:`polyaxon_tpu_torch.chaos.install`; operators
point ``POLYAXON_TPU_CHAOS_PLAN`` at a JSON file (or inline JSON) or
pass ``--chaos-plan`` to ``plx agent``/``plx server``. Every firing is
appended to ``plan.consumed`` so a test can assert the whole plan was
exercised. Counters are per-process (subprocess gang members that
inherit the env var keep their own counts).

Plan JSON::

    {"seed": 7, "faults": [
      {"seam": "store", "op": "read_bytes", "at": 1, "times": 1,
       "config": {"error": "transient"}},
      {"seam": "gang", "op": "kill", "config": {"min_checkpoints": 2}},
      {"seam": "checkpoint", "op": "corrupt_latest"},
      {"seam": "tick", "op": "skip", "at": 3},
      {"seam": "slice-loss", "op": "kill", "config": {"min_checkpoints": 2}},
      {"seam": "slice-loss", "op": "restore", "config": {"min_checkpoints": 4}},
      {"seam": "tier0-loss", "op": "drop"}
    ]}

``at`` is 1-based over MATCHING events; ``times`` consecutive events
fire starting there. ``op: "*"`` matches every op of the seam.

Port of ``polyaxon_tpu/chaos/plan.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

logger = logging.getLogger(__name__)

ENV_CHAOS_PLAN = "POLYAXON_TPU_CHAOS_PLAN"


class ChaosKill(RuntimeError):
    """Raised inside an in-process gang member to simulate its death."""


@dataclass
class Fault:
    seam: str
    op: str = "*"
    at: int = 1
    times: int = 1
    config: dict = field(default_factory=dict)
    # runtime counters
    seen: int = 0
    fired: int = 0

    def matches(self, seam: str, op: str) -> bool:
        return self.seam == seam and self.op in ("*", op)

    @property
    def exhausted(self) -> bool:
        return self.fired >= self.times

    @classmethod
    def from_dict(cls, data: dict) -> "Fault":
        known = {"seam", "op", "at", "times", "config"}
        extra = {k: v for k, v in data.items() if k not in known}
        config = dict(data.get("config") or {})
        config.update(extra)  # allow flat {"error": ...} style entries
        return cls(seam=data["seam"], op=data.get("op", "*"),
                   at=int(data.get("at", 1)), times=int(data.get("times", 1)),
                   config=config)


class ChaosPlan:
    def __init__(self, faults: list[Fault], seed: int = 0):
        self.faults = faults
        self.seed = seed
        self.consumed: list[dict] = []
        self._lock = threading.Lock()

    # ----------------------------------------------------------- loading
    @classmethod
    def from_dict(cls, data: dict) -> "ChaosPlan":
        return cls([Fault.from_dict(f) for f in data.get("faults", [])],
                   seed=int(data.get("seed", 0)))

    @classmethod
    def load(cls, source: str) -> "ChaosPlan":
        """``source`` is a JSON file path or inline JSON."""
        text = source
        if not source.lstrip().startswith("{"):
            with open(source) as fh:
                text = fh.read()
        return cls.from_dict(json.loads(text))

    # ------------------------------------------------------------ firing
    def fire(self, seam: str, op: str, detail: str = "") -> Optional[Fault]:
        """Record one event at (seam, op); return the fault that fires
        on it, if any. Each fault counts matching events independently,
        so two faults can trigger on different Ns of the same seam."""
        with self._lock:
            for fault in self.faults:
                if not fault.matches(seam, op) or fault.exhausted:
                    continue
                fault.seen += 1
                if fault.seen >= fault.at:
                    fault.fired += 1
                    self.consumed.append(
                        {"seam": seam, "op": op, "detail": detail,
                         "event": fault.seen})
                    logger.warning("chaos: firing %s/%s (event %d) %s",
                                   seam, op, fault.seen, detail)
                    # Annotate the lifecycle phase the fault hit
                    # (obs.trace): a drill reads as events on the run's
                    # timeline instead of log archaeology. add_event is
                    # a no-op outside an active span and never raises.
                    try:
                        from polyaxon_tpu_torch.obs import trace as _trace

                        _trace.add_event(f"chaos.{seam}", op=op,
                                         detail=detail, event=fault.seen)
                    except ImportError:  # pragma: no cover
                        pass
                    # Bracket the fault's active stretch as a named
                    # history window (``chaos.<seam>``): opened on its
                    # first firing, closed when its budget exhausts, so
                    # during-window oracle invariants can scope to the
                    # drill. Fail-open like the trace annotation.
                    try:
                        from polyaxon_tpu_torch.obs import history as _history

                        hist = _history.default_history()
                        if fault.fired == 1:
                            hist.mark_window(f"chaos.{seam}", start=True)
                        if fault.exhausted:
                            hist.mark_window(f"chaos.{seam}", end=True)
                    except Exception:  # noqa: BLE001
                        pass
                    return fault
        return None

    def has_faults(self, seam: str) -> bool:
        return any(f.seam == seam and not f.exhausted for f in self.faults)

    @property
    def done(self) -> bool:
        """Every declared fault has fired its full budget."""
        return all(f.exhausted for f in self.faults)

    # ------------------------------------------------- seam: gangs/init
    def gang_kill_due(self, run_uuid: str, ckpt_dir: str) -> bool:
        """True (once per fault budget) when a gang-kill fault is due
        for this run. ``min_checkpoints`` gates the kill on the run
        having already persisted that many checkpoint steps, so the
        restart can prove resume actually resumes."""
        pending = [f for f in self.faults
                   if f.matches("gang", "kill") and not f.exhausted]
        if not pending:
            return False
        fault = pending[0]
        need = int(fault.config.get("min_checkpoints", 0))
        if need and _checkpoint_steps(ckpt_dir) < need:
            return False  # not an eligible event yet: don't count it
        return self.fire("gang", "kill", detail=run_uuid) is not None

    def maybe_kill_gang(self, run_uuid: str, ckpt_dir: str) -> None:
        """In-process gang seam: raise :class:`ChaosKill` when due."""
        if self.gang_kill_due(run_uuid, ckpt_dir):
            raise ChaosKill(
                f"chaos: gang member of run {run_uuid} killed by fault plan")

    def slice_loss_due(self, run_uuid: str, ckpt_dir: str) -> Optional[str]:
        """Return ``"kill"`` or ``"restore"`` when a slice-loss fault is
        due for this run (once per fault budget), else None.

        ``min_checkpoints`` gates each fault on the run having persisted
        that many checkpoint steps — a resize needs something to restore
        — and a ``restore`` (capacity returned → grow) is only eligible
        after a ``kill`` has fired, so a plan cannot regrow a gang it
        never shrank. Ineligible events are not counted (the
        ``gang_kill_due`` rule)."""
        pending = [f for f in self.faults
                   if f.seam == "slice-loss" and not f.exhausted]
        if not pending:
            return None
        killed = any(f.seam == "slice-loss" and f.op == "kill" and f.fired
                     for f in self.faults)
        for fault in pending:
            op = "kill" if fault.op == "*" else fault.op
            if op == "restore" and not killed:
                continue
            need = int(fault.config.get("min_checkpoints", 0))
            if need and _checkpoint_steps(ckpt_dir) < need:
                continue  # not an eligible event yet: don't count it
            if self.fire("slice-loss", op, detail=run_uuid) is not None:
                return op
            return None
        return None

    def tier0_loss_due(self, directory: str) -> bool:
        """True (once per fault budget) when a ``tier0-loss`` fault is
        due for this checkpoint directory. The caller
        (:func:`runtime.tiers.tier0_loss_due`) drops the in-memory
        replica and the local spill so the restore must walk down to
        the persistent store — the fallback drill."""
        pending = [f for f in self.faults
                   if f.matches("tier0-loss", "drop") and not f.exhausted]
        if not pending:
            return False
        return self.fire("tier0-loss", "drop", detail=directory) is not None

    def maybe_stall_init(self, phase_kind: str) -> float:
        """Stall seam for executor init phases; returns seconds slept."""
        fault = self.fire("init", phase_kind)
        if fault is None:
            return 0.0
        seconds = float(fault.config.get("seconds", 0.1))
        time.sleep(seconds)
        return seconds

    # ------------------------------------------------- seam: checkpoint
    def corrupt_checkpoint(self, directory: str,
                           steps: list[int]) -> Optional[int]:
        """Corrupt the newest step's files on disk (returns the step),
        if a ``checkpoint/corrupt_latest`` fault is due."""
        if not steps:
            return None
        fault = self.fire("checkpoint", "corrupt_latest",
                          detail=str(max(steps)))
        if fault is None:
            return None
        target = max(steps)
        step_dir = os.path.join(directory, str(target))
        corrupted = 0
        for root, _, files in os.walk(step_dir):
            for name in files:
                path = os.path.join(root, name)
                try:
                    with open(path, "wb") as fh:
                        fh.write(b"\x00CHAOS-CORRUPTED\x00")
                    corrupted += 1
                except OSError:
                    continue
        logger.warning("chaos: corrupted checkpoint step %s (%d files)",
                       target, corrupted)
        return target


from polyaxon_tpu_torch.fs.store import Store as _Store  # noqa: E402 — no cycle:
# fs.store only imports chaos lazily inside get_store()


class ChaosStore(_Store):
    """Store wrapper injecting plan faults on primitive ops.

    Installed by ``fs.get_store`` only while a plan with store faults
    is active. Subclasses ``Store`` so the DERIVED surface
    (``download_dir``, ``sync_dir``, ``read_text``, ...) runs through
    the hooked primitives below — a fault plan targeting ``read_bytes``
    fires no matter which entry point the caller used. Retry layers
    (FsspecStore internals, the init/sidecar call sites) sit OUTSIDE
    this wrapper, so injected transient faults exercise the real retry
    paths.
    """

    def __init__(self, inner: Any, plan: ChaosPlan):
        self._inner = inner
        self._plan = plan
        self.scheme = getattr(inner, "scheme", "chaos")

    def _hook(self, op: str, detail: str = "") -> None:
        fault = self._plan.fire("store", op, detail=detail)
        if fault is None:
            return
        from polyaxon_tpu_torch.fs.store import StoreError, TransientStoreError

        if fault.config.get("error", "transient") == "permanent":
            raise StoreError(
                f"chaos: injected permanent store fault on {op} {detail}")
        raise TransientStoreError(
            f"chaos: injected transient store fault on {op} {detail}")

    def read_bytes(self, key: str) -> bytes:
        self._hook("read_bytes", key)
        return self._inner.read_bytes(key)

    def write_bytes(self, key: str, data: bytes) -> None:
        self._hook("write_bytes", key)
        return self._inner.write_bytes(key, data)

    def exists(self, key: str) -> bool:
        self._hook("exists", key)
        return self._inner.exists(key)

    def delete(self, key: str) -> None:
        self._hook("delete", key)
        return self._inner.delete(key)

    def list(self, prefix: str = "") -> list:
        self._hook("list", prefix)
        return self._inner.list(prefix)

    def upload_file(self, local_path: str, key: str) -> None:
        self._hook("upload_file", key)
        return self._inner.upload_file(local_path, key)

    def download_file(self, key: str, local_path: str) -> str:
        self._hook("download_file", key)
        return self._inner.download_file(key, local_path)

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


def _checkpoint_steps(ckpt_dir: str) -> int:
    """Count orbax step directories (digit-named dirs) under a
    checkpoints dir; 0 when the dir does not exist yet."""
    try:
        return sum(1 for name in os.listdir(ckpt_dir)
                   if name.isdigit()
                   and os.path.isdir(os.path.join(ckpt_dir, name)))
    except OSError:
        return 0


# ------------------------------------------------------------ activation
_ACTIVE: Optional[ChaosPlan] = None
_ENV_CHECKED = False


def install(plan: ChaosPlan) -> ChaosPlan:
    global _ACTIVE
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = False


def active_plan() -> Optional[ChaosPlan]:
    """The installed plan, else one lazily loaded from the env var
    (checked once per process), else None."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is not None:
        return _ACTIVE
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        source = os.environ.get(ENV_CHAOS_PLAN)
        if source:
            try:
                _ACTIVE = ChaosPlan.load(source)
            except (OSError, ValueError, KeyError) as exc:
                logger.error("ignoring unloadable chaos plan %r: %s",
                             source, exc)
    return _ACTIVE
