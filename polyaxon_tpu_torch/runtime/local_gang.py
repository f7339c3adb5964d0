"""Local gangs: one process of a plan that holds several devices trains
as a gang of ranks, one per device.

A JAX process drives every chip it sees: ``build_mesh`` resolves the
job's mesh against ``jax.devices()`` and the process shards its rows
over its chips. A torch process drives one card, so a plan process that
holds D devices (``bootstrap.local_devices``) starts D rank processes
and supervises them instead of training itself:

- rank ``p·D + d`` of a world of ``P·D`` (P plan processes) runs the
  rank command (the launcher, or a caller's rewrite of it) bound to its
  device by ``POLYAXON_TPU_LOCAL_DEVICE_IDS``, with
  ``POLYAXON_TPU_RANKS_PER_PROCESS=D``, so the loop draws each plan
  process's rows once and hands each rank its row block;
- every rank's output goes to ``<artifacts>/logs/rank-<r>.log``; rank 0
  prints each metrics emission and then its result as JSON lines, which
  the supervisor reads back (``on_metrics``, the returned
  ``TrainResult``), and every rank prints its kernel launches last;
- the gang starts together and fails together: the first rank that
  exits nonzero has the others terminated, and the supervisor raises;
- a stop (``should_stop`` in the supervisor) is a file that rank 0
  polls each step; the loop agrees on it over every rank, so the gang
  stops at one step and saves it (``runtime/loop.py``);
- a rank dies with the thread that started it (``PR_SET_PDEATHSIG``).

``POLYAXON_TPU_MESH_AXES`` overrides the mesh's axes in every rank, as
``run_jaxjob(mesh_axes=...)`` does (elastic segments).
"""

from __future__ import annotations

import collections
import ctypes
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

from polyaxon_tpu_torch.parallel import bootstrap

logger = logging.getLogger(__name__)

ENV_MESH_AXES = "POLYAXON_TPU_MESH_AXES"
ENV_STOP_FILE = "POLYAXON_TPU_GANG_STOP_FILE"
# The device type the supervisor trains on; set only in a gang's ranks.
ENV_GANG_DEVICE = "POLYAXON_TPU_GANG_DEVICE"
ENV_GANG_PARENT = "POLYAXON_TPU_GANG_PARENT"

LAUNCHER = ("-m", "polyaxon_tpu_torch.runtime.launch")
POLL_S = 0.02
TERMINATE_GRACE_S = 10.0
_PR_SET_PDEATHSIG = 1
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Kernel launches the ranks of this process's gangs reported, summed.
LAUNCHES: collections.Counter = collections.Counter()


def supervised(env: Optional[dict] = None) -> bool:
    """True in a rank of a local gang."""
    return bool((os.environ if env is None else env).get(ENV_GANG_DEVICE))


def die_with_parent() -> None:
    """Have the kernel kill this rank when the thread that started it
    ends, and exit now if it has already."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    except (OSError, AttributeError):  # not Linux: the supervisor kills
        pass
    parent = os.environ.get(ENV_GANG_PARENT)
    if parent and os.getppid() != int(parent):
        os._exit(1)


def rank_envs(base: dict, *, devices: list[int], device_type: str,
              coordinator: str, stop_file: str, process_id: int = 0,
              num_processes: int = 1,
              mesh_axes: Optional[dict] = None) -> list[dict]:
    """The env of each rank of plan process ``process_id``'s gang."""
    per = len(devices)
    envs = []
    for d, dev in enumerate(devices):
        env = dict(base)
        env.update({
            bootstrap.ENV_COORDINATOR: coordinator,
            bootstrap.ENV_NUM_PROCESSES: str(num_processes * per),
            bootstrap.ENV_PROCESS_ID: str(process_id * per + d),
            bootstrap.ENV_LOCAL_DEVICE_IDS: str(dev),
            bootstrap.ENV_RANKS_PER_PROCESS: str(per),
            ENV_GANG_DEVICE: device_type,
            ENV_GANG_PARENT: str(os.getpid()),
            ENV_STOP_FILE: stop_file,
        })
        if mesh_axes:
            env[ENV_MESH_AXES] = json.dumps(
                {k: int(v) for k, v in mesh_axes.items()})
        else:
            env.pop(ENV_MESH_AXES, None)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_REPO, env.get("PYTHONPATH")) if p)
        envs.append(env)
    return envs


class LocalGang:
    """The rank processes of one gang: started together, reaped
    together."""

    def __init__(self, command: list[str], envs: list[dict], log_dir: str):
        self.command = list(command)
        self.envs = envs
        self.log_dir = log_dir
        self.ranks = [int(e[bootstrap.ENV_PROCESS_ID]) for e in envs]
        self.logs = [os.path.join(log_dir, f"rank-{r}.log")
                     for r in self.ranks]
        self.procs: list[subprocess.Popen] = []
        self.offsets: list[int] = []
        self._buffer = b""
        self._terminated_at: Optional[float] = None
        self.failed: Optional[int] = None  # the first rank seen to fail

    def start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        try:
            for env, log in zip(self.envs, self.logs):
                with open(log, "ab") as fh:
                    self.offsets.append(fh.tell())
                    self.procs.append(subprocess.Popen(
                        self.command, env=env, stdout=fh,
                        stderr=subprocess.STDOUT))
        except Exception:
            self.kill()
            raise

    def read_lines(self) -> list[dict]:
        """The JSON lines rank 0 (of this gang) printed since the last
        call."""
        with open(self.logs[0], "rb") as fh:
            fh.seek(self.offsets[0])
            data = fh.read()
        self.offsets[0] += len(data)
        self._buffer += data
        *lines, self._buffer = self._buffer.split(b"\n")
        out = []
        for line in lines:
            if line.startswith(b"{"):
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
        return out

    def poll(self) -> Optional[int]:
        """None while a rank runs; then the exit code of the first rank
        seen to fail, or 0. That rank has the others terminated (killed
        past a grace period): they would wait on it forever."""
        codes = [p.poll() for p in self.procs]
        if self.failed is None:
            self.failed = next((r for r, c in zip(self.ranks, codes)
                                if c not in (None, 0)), None)
        if all(c is not None for c in codes):
            if self.failed is None:
                return 0
            return codes[self.ranks.index(self.failed)]
        if self.failed is not None:
            now = time.monotonic()
            if self._terminated_at is None:
                self._terminated_at = now
                for p in self.procs:
                    if p.poll() is None:
                        p.terminate()
            elif now - self._terminated_at > TERMINATE_GRACE_S:
                self.kill()
        return None

    def tail(self, rank: int, n: int = 3000) -> str:
        path = self.logs[self.ranks.index(rank)]
        with open(path, "rb") as fh:
            fh.seek(max(os.path.getsize(path) - n, 0))
            return fh.read().decode(errors="replace")

    def launches(self) -> collections.Counter:
        """Every rank's kernel launches, from the last ``launches`` line
        each printed in this gang."""
        total: collections.Counter = collections.Counter()
        for path, start in zip(self.logs, self.offsets):
            with open(path, "rb") as fh:
                fh.seek(start)
                last = None
                for line in fh:
                    if line.startswith(b'{"launches"'):
                        last = line
            if last is not None:
                total.update(json.loads(last)["launches"])
        return total

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        for p in self.procs:
            p.wait()


def run(job: dict, *, devices: list[int], device, mesh_axes=None,
        artifacts_dir: Optional[str] = None,
        on_metrics: Optional[Callable[[int, dict], None]] = None,
        should_stop: Optional[Callable[[], bool]] = None, tracer=None,
        command: Optional[list[str]] = None, env: Optional[dict] = None,
        process_id: int = 0, num_processes: int = 1,
        coordinator: Optional[str] = None):
    """Train ``job`` as a gang of ``len(devices)`` ranks of plan process
    ``process_id`` (of ``num_processes``) and supervise it: returns rank
    0's ``TrainResult`` (None in a gang without rank 0), raises when a
    rank fails. ``command`` is what each rank runs (the launcher by
    default); ``env`` its base env (this process's by default)."""
    from polyaxon_tpu_torch.obs import trace as obs_trace
    from polyaxon_tpu_torch.runtime.launch import (ENV_ARTIFACTS_PATH,
                                                   ENV_JAXJOB_SPEC,
                                                   ENV_RUN_UUID)
    from polyaxon_tpu_torch.runtime.loop import TrainResult

    if num_processes > 1 and not coordinator:
        raise RuntimeError(f"a local gang of plan process {process_id} of "
                           f"{num_processes} needs the gang's coordinator")
    coordinator = coordinator or f"127.0.0.1:{bootstrap.free_port()}"
    scratch = tempfile.mkdtemp(prefix="local-gang-")
    stop_file = os.path.join(scratch, "stop")
    base = dict(os.environ if env is None else env)
    base[ENV_JAXJOB_SPEC] = json.dumps(job)
    # Without an artifacts dir the ranks write into the gang's scratch,
    # never into a run's directory an inherited env names.
    base[ENV_ARTIFACTS_PATH] = artifacts_dir or scratch
    if tracer is not None:  # rank 0's spans parent where the caller's do
        base[ENV_RUN_UUID] = tracer.trace_id
        if tracer.parent_id:
            base[obs_trace.ENV_TRACE_PARENT] = obs_trace.format_trace_parent(
                tracer.trace_id, tracer.parent_id)
    envs = rank_envs(base, devices=devices, device_type=device.type,
                     coordinator=coordinator, stop_file=stop_file,
                     process_id=process_id, num_processes=num_processes,
                     mesh_axes=mesh_axes)
    log_dir = (os.path.join(artifacts_dir, "logs") if artifacts_dir
               else scratch)
    gang = LocalGang(command or [sys.executable, *LAUNCHER], envs, log_dir)
    outputs = None

    def dispatch(records):
        nonlocal outputs
        for rec in records:
            if "outputs" in rec:
                outputs = rec["outputs"]
            elif "step" in rec and on_metrics is not None:
                step = rec.pop("step")
                on_metrics(step, rec)

    logger.info("local gang: %d ranks of process %d/%d on %s devices %s "
                "(logs %s)", len(devices), process_id, num_processes,
                device.type, devices, log_dir)
    gang.start()
    try:
        stopping = False
        while True:
            dispatch(gang.read_lines())
            code = gang.poll()
            if code is not None:
                break
            if (not stopping and should_stop is not None
                    and should_stop()):
                with open(stop_file, "w"):
                    pass
                stopping = True
            time.sleep(POLL_S)
        dispatch(gang.read_lines())
        LAUNCHES.update(gang.launches())
    finally:
        gang.kill()
        shutil.rmtree(scratch, ignore_errors=True)
    if code != 0:
        rank = gang.failed
        raise RuntimeError(
            f"local gang rank {rank} exited with {code}: "
            f"{gang.tail(rank) if rank is not None else ''}")
    if process_id != 0:
        return None
    if outputs is None:
        raise RuntimeError(f"local gang rank 0 reported no result: "
                           f"{gang.tail(gang.ranks[0])}")
    return TrainResult(**outputs)
