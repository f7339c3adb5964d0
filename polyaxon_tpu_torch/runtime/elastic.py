"""Elastic gangs: shrink and regrow a live jaxjob across slice loss (port
of ``polyaxon_tpu/runtime/elastic.py``, its names and env variables).

A gang losing a slice used to cost the whole run: the executor reaped
it PREEMPTED and the scheduler paid a full backoff-requeue round trip.
This module turns that signal into a *resize* instead:

1. The agent/executor files a resize request on the run's
   :class:`ElasticController` (the channel between the slice-weather
   side and the training side).
2. The segment's ``should_stop`` sees the pending request; the ranks
   agree on it before the next step (``runtime/loop.py``) and break
   there, and the loop force-saves a checkpoint on every exit, so the
   segment ends durably at an exact step.
3. The target topology is **pre-warmed before committing**: one step of
   the job on the target devices (a contained subprocess by default). A
   failed prewarm never strands the run — a failed *shrink* falls back
   to the existing PREEMPTED → backoff-requeue path
   (:class:`ResizeAborted`), a failed *grow* keeps training on the
   current devices.
4. The next segment restores across meshes (a checkpoint holds whole
   leaves, and each rank takes its piece: ``runtime/checkpoint.py``) and
   resumes the data stream at the exact batch pointer
   (``start_batch=step``).

Where the JAX package runs each segment in its own process over a subset
of ``jax.devices()``, the port starts each segment as a new local gang,
one rank per device (``runtime/local_gang.py``; a segment over one
device trains in the calling thread). So the old segment's tier-0
replica, which lives in its ranks' memory, is gone, and the next gang
restores from tier 1, the local spill (ROADMAP.md, Queue 3).

Resize attempts are bounded by a budget (``POLYAXON_TPU_ELASTIC_BUDGET``,
default 2); an exhausted budget denies further requests so the caller
degrades to plain preemption. Every attempt lands in the run's
``meta["elastic"]`` audit trail, a ``resize`` span on the run timeline
(with from/to topology), ``polyaxon_elastic_resizes_total`` and the
resize-duration histogram.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

ENV_ELASTIC_BUDGET = "POLYAXON_TPU_ELASTIC_BUDGET"
ENV_ELASTIC_PREWARM = "POLYAXON_TPU_ELASTIC_PREWARM"
DEFAULT_BUDGET = 2
DEFAULT_PREWARM_TIMEOUT = 300.0
_CHILD_FLAG = "--_prewarm-child"


class PrewarmError(RuntimeError):
    """The target topology could not be validated/compiled; the resize
    must not commit (the current mesh keeps running, or — for a shrink
    whose devices are already gone — the run falls back to requeue)."""


class ResizeAborted(RuntimeError):
    """A shrink could not be completed (prewarm failed for the survivor
    topology): the caller must take the existing PREEMPTED → backoff
    requeue path instead of continuing on a mesh it cannot run."""


# --------------------------------------------------------------- topology
def _mesh_spec(job: dict):
    from polyaxon_tpu_torch.polyflow.runs import V1MeshSpec

    return V1MeshSpec.from_dict(job["mesh"]) if job.get("mesh") else None


def resolved_base_axes(job: dict, n_devices: int) -> dict[str, int]:
    """The job's mesh axes resolved against the FULL gang device count
    (the shape every resize scales from)."""
    mesh_spec = _mesh_spec(job)
    if mesh_spec is not None:
        axes = mesh_spec.resolved_axes(n_devices)
    else:
        axes = {"dp": n_devices}
    return dict(axes)


def scaled_axes(base_axes: dict[str, int], base_devices: int,
                target_devices: int) -> dict[str, int]:
    """Scale ONLY the data-parallel axis to the target device count.

    Model-parallel axes (tp/fsdp/pp/...) are topology-shaped: keeping
    them fixed keeps every parameter shard layout valid across the
    resize, so the cross-mesh restore is a pure resharding of the batch
    dimension. A target that would need a fractional dp degree raises
    :class:`PrewarmError` (the resize cannot commit).
    """
    if target_devices == base_devices:
        return dict(base_axes)
    axes = dict(base_axes)
    dp = int(axes.get("dp", 1))
    new_dp, rem = divmod(dp * target_devices, base_devices)
    if rem or new_dp < 1:
        raise PrewarmError(
            f"cannot scale dp={dp} from {base_devices} to "
            f"{target_devices} devices: non-integer data-parallel degree")
    axes["dp"] = new_dp
    if math.prod(axes.values()) != target_devices:
        raise PrewarmError(
            f"axes {axes} cover {math.prod(axes.values())} devices, "
            f"not {target_devices} (model-parallel axes don't fit)")
    return axes


def elastic_capable(job: dict) -> bool:
    """A run can resize only if its state survives the mesh change:
    checkpointing on AND restore-on-start on (the segment boundary is a
    forced save + cross-mesh restore)."""
    from polyaxon_tpu_torch.runtime.checkpoint import CheckpointSpec

    if job.get("checkpointing") is None:
        return False
    ckpt = CheckpointSpec.from_dict(job["checkpointing"])
    return bool(ckpt.enabled and ckpt.restore_on_start)


# -------------------------------------------------------------- controller
class ElasticController:
    """Thread-safe resize channel + audit trail for one run.

    The executor/agent side calls :meth:`request`; the training side
    observes :meth:`pending` through its ``should_stop`` closure, pops
    the request with :meth:`take` after the segment exits, and records
    the attempt via :meth:`begin_attempt`/:meth:`finish_attempt`.
    :meth:`snapshot` is the ``meta["elastic"]`` payload the executor
    flushes into the store on poll.
    """

    def __init__(self, run_uuid: str, *, budget: Optional[int] = None,
                 prior_attempts: Optional[list[dict]] = None):
        if budget is None:
            try:
                budget = int(os.environ.get(ENV_ELASTIC_BUDGET,
                                            DEFAULT_BUDGET))
            except ValueError:
                budget = DEFAULT_BUDGET
        self.run_uuid = run_uuid
        self.budget = max(int(budget), 0)
        self._lock = threading.Lock()
        self._pending: Optional[dict] = None
        self._resizing = False
        self._used = 0
        # A requeued incarnation starts on the full mesh with a fresh
        # budget, but the audit trail spans the run's whole life — the
        # failed shrink that caused the requeue must survive the rerun's
        # first meta flush.
        self._attempts: list[dict] = [dict(a) for a in prior_attempts or []]
        self._shrunk = False
        self._dirty = True  # first snapshot always flushes

    def request(self, direction: str, *, reason: str = "",
                target_devices: Optional[int] = None) -> bool:
        """File a resize; False when the budget is exhausted, another
        resize is in flight, or a grow is requested while not shrunk —
        the caller falls back to plain preemption (or ignores)."""
        if direction not in ("shrink", "grow"):
            raise ValueError(f"direction must be shrink|grow, got {direction!r}")
        with self._lock:
            if self._pending is not None or self._resizing:
                return False
            if self._used >= self.budget:
                return False
            if direction == "grow" and not self._shrunk:
                return False
            self._used += 1
            self._pending = {"direction": direction, "reason": reason,
                             "target_devices": target_devices}
            self._dirty = True
            return True

    def pending(self) -> bool:
        with self._lock:
            return self._pending is not None

    def take(self) -> Optional[dict]:
        with self._lock:
            req = self._pending
            if req is not None:
                self._pending = None
                self._resizing = True
                self._dirty = True
            return req

    def begin_attempt(self, direction: str, reason: str,
                      from_devices: int, to_devices: int) -> dict:
        attempt = {"direction": direction, "reason": reason,
                   "from_devices": int(from_devices),
                   "to_devices": int(to_devices), "outcome": "pending"}
        with self._lock:
            self._attempts.append(attempt)
            self._dirty = True
        return attempt

    def finish_attempt(self, attempt: dict, outcome: str, *,
                       error: Optional[str] = None,
                       duration_s: Optional[float] = None) -> None:
        with self._lock:
            attempt["outcome"] = outcome
            if error:
                attempt["error"] = str(error)[:300]
            if duration_s is not None:
                attempt["duration_s"] = round(duration_s, 3)
            self._resizing = False
            if outcome == "ok":
                self._shrunk = attempt["direction"] == "shrink"
            self._dirty = True

    @property
    def shrunk(self) -> bool:
        with self._lock:
            return self._shrunk

    @property
    def resizing(self) -> bool:
        """True while a request is granted-but-untaken or mid-commit.
        Weather deliverers (the chaos seam, the agent's grow offers)
        must hold new events while this is set: a request filed now
        would be denied AND the triggering event consumed — re-offering
        next step/tick is lossless, a swallowed event is not."""
        with self._lock:
            return self._resizing or self._pending is not None

    def exhausted(self) -> bool:
        with self._lock:
            return self._used >= self.budget

    def snapshot(self, *, consume_dirty: bool = False) -> Optional[dict]:
        """The ``meta["elastic"]`` payload. With ``consume_dirty`` the
        call returns None when nothing changed since the last snapshot
        (the executor's poll-time flush stays write-free at steady
        state)."""
        with self._lock:
            if consume_dirty and not self._dirty:
                return None
            self._dirty = False
            return {
                "budget": self.budget,
                "used": self._used,
                "resizing": self._resizing or self._pending is not None,
                "shrunk": self._shrunk,
                "attempts": [dict(a) for a in self._attempts],
            }


# ----------------------------------------------------------------- prewarm
def prewarm(job: dict, target_devices: int, axes: dict[str, int], *,
            mode: Optional[str] = None,
            timeout: Optional[float] = None,
            devices: Optional[list[int]] = None, device=None,
            command: Optional[list[str]] = None,
            env: Optional[dict] = None) -> dict:
    """Validate the target topology, or run one step on it, BEFORE the
    resize commits. Raises :class:`PrewarmError` on any failure.

    Modes (``POLYAXON_TPU_ELASTIC_PREWARM``):

    - ``subprocess`` (default): a contained child trains one step of the
      job over the target devices (a local gang of ``target_devices``
      ranks running ``command``, with checkpointing off) and prints one
      JSON line — a hung or crashed step cannot take the agent down
      with it;
    - ``inline``: in-process structural validation (mesh build, sharding
      rules, batch divisibility) without running a step;
    - ``skip``: trust the topology.

    ``devices`` are the local devices the run holds (default
    ``bootstrap.local_devices(device)``).
    """
    mode = (mode or os.environ.get(ENV_ELASTIC_PREWARM, "")
            or "subprocess").strip().lower()
    if mode == "skip":
        return {"ok": True, "mode": "skip", "devices": int(target_devices)}
    if mode == "inline":
        return _prewarm_inline(job, target_devices, axes, devices=devices,
                               device=device)
    if mode == "subprocess":
        return _prewarm_subprocess(
            job, target_devices, axes, devices=devices, device=device,
            command=command, env=env,
            timeout=DEFAULT_PREWARM_TIMEOUT if timeout is None else timeout)
    raise PrewarmError(f"unknown prewarm mode {mode!r}")


def _local_devices(devices, device) -> list[int]:
    from polyaxon_tpu_torch.parallel import bootstrap

    if devices is not None:
        return list(devices)
    return bootstrap.local_devices(device)


def _prewarm_inline(job: dict, n: int, axes: dict[str, int], *,
                    devices: Optional[list[int]] = None,
                    device=None) -> dict:
    """Structural validation of the target mesh: everything that can
    reject a resize without running a step — axis product, the port's
    placements, sharding rules, batch divisibility against the new
    data-parallel degree."""
    from polyaxon_tpu_torch.parallel.mesh import build_mesh
    from polyaxon_tpu_torch.parallel.sharding import (batch_spec,
                                                      require_ported,
                                                      rules_for_mesh)
    from polyaxon_tpu_torch.polyflow.environment import V1TpuTopology
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig

    devs = _local_devices(devices, device)
    if len(devs) < n:
        raise PrewarmError(f"target needs {n} devices, host has {len(devs)}")
    topology = (V1TpuTopology.from_dict(job["topology"])
                if job.get("topology") else None)
    try:
        mesh = build_mesh(_mesh_spec(job), topology, devices=range(n),
                          axes=axes)
        require_ported(mesh.shape)
        rules = rules_for_mesh(mesh)
    except (ValueError, NotImplementedError) as exc:
        raise PrewarmError(f"mesh build failed for {n} devices: {exc}") from exc
    cfg = RuntimeConfig.from_dict(job.get("runtime") or {})
    global_batch = cfg.global_batch_size or (cfg.batch_size or 8) * n
    # One plan process holds the devices of an elastic run.
    spec = batch_spec(mesh, rules)
    batch_axes = spec[0] if len(spec) else None
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    shards = 1
    for axis in batch_axes or ():
        shards *= mesh.shape[axis]
    if shards and global_batch % shards:
        raise PrewarmError(
            f"global batch {global_batch} does not stay divisible by the "
            f"{shards}-way batch sharding of the target mesh")
    accum = max(int(cfg.grad_accum_steps or 1), 1)
    if accum > 1 and (global_batch % accum
                      or (global_batch // accum) % max(shards, 1)):
        raise PrewarmError(
            f"grad_accum_steps {accum} incompatible with global batch "
            f"{global_batch} on the {shards}-way target sharding")
    return {"ok": True, "mode": "inline", "devices": int(n),
            "axes": {k: int(v) for k, v in (axes or {}).items()}}


def _prewarm_subprocess(job: dict, n: int, axes: dict[str, int], *,
                        timeout: float, devices=None, device=None,
                        command=None, env=None) -> dict:
    """Contained one-step run on the target devices: the child prints
    exactly one JSON report line; a hang is terminated then killed (its
    ranks die with it)."""
    from polyaxon_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cmd = [sys.executable, "-m", "polyaxon_tpu_torch.runtime.elastic",
           _CHILD_FLAG,
           "--spec", json.dumps(job),
           "--devices", str(int(n)),
           "--axes", json.dumps({k: int(v) for k, v in (axes or {}).items()}),
           "--device", dev.type,
           "--local-devices", json.dumps(_local_devices(devices, dev))]
    if command:
        cmd += ["--command", json.dumps(list(command))]
    from polyaxon_tpu_torch.runtime.local_gang import _REPO

    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, child_env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, env=child_env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise PrewarmError(
            f"prewarm step for {n} devices hung past {timeout:.0f}s "
            "and was killed")
    line = next((ln for ln in reversed((out or "").strip().splitlines())
                 if ln.startswith("{")), None)
    if line is None:
        raise PrewarmError(
            f"prewarm child rc={proc.returncode} left no report: "
            f"{(err or '').strip()[-300:]}")
    try:
        payload = json.loads(line)
    except ValueError as exc:
        raise PrewarmError(f"unparseable prewarm report: {line[:200]}") from exc
    if not payload.get("ok"):
        raise PrewarmError(payload.get("error") or "prewarm failed")
    payload["mode"] = "subprocess"
    return payload


def _child_main(argv: list[str]) -> int:
    """Prewarm child: run ONE step of the job on the target devices,
    report one JSON line, never raise (containment contract)."""
    parser = argparse.ArgumentParser(prog="elastic-prewarm-child")
    parser.add_argument("--spec", required=True)
    parser.add_argument("--devices", type=int, required=True)
    parser.add_argument("--axes", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--local-devices", default=None)
    parser.add_argument("--command", default=None)
    # Containment test hook: hang instead of training so the parent's
    # timeout/kill path is drillable fast.
    parser.add_argument("--sleep", type=float, default=0.0)
    try:
        args = parser.parse_args(argv)
        if args.sleep:
            time.sleep(args.sleep)
        spec = json.loads(args.spec)
        axes = {k: int(v) for k, v in json.loads(args.axes).items()}
        # One-step probe of the REAL job: steps=1 runs the warm-up step
        # and nothing else; checkpointing off so the probe never touches
        # the run's checkpoint dir.
        spec.setdefault("runtime", {})["steps"] = 1
        spec["checkpointing"] = {"enabled": False}
        from polyaxon_tpu_torch.runtime.loop import run_torchjob

        devs = _local_devices(
            json.loads(args.local_devices) if args.local_devices else None,
            args.device)
        if len(devs) < args.devices:
            raise PrewarmError(
                f"target needs {args.devices} devices, child sees {len(devs)}")
        t0 = time.perf_counter()
        result = run_torchjob(
            spec, devices=devs[:args.devices], mesh_axes=axes,
            device=args.device,
            gang_command=json.loads(args.command) if args.command else None)
        print(json.dumps({
            "ok": True, "devices": args.devices, "axes": axes,
            "compile_time_s": round(result.compile_time_s
                                    or (time.perf_counter() - t0), 3),
        }))
        return 0
    except BaseException as exc:  # noqa: BLE001 — containment: one line out, no traceback exit
        print(json.dumps({"ok": False,
                          "error": f"{type(exc).__name__}: {exc}"[:500]}))
        return 1


# ------------------------------------------------------------ segment loop
def run_elastic(
    job: dict,
    *,
    controller: ElasticController,
    artifacts_dir: Optional[str] = None,
    on_metrics: Optional[Callable[[int, dict[str, float]], None]] = None,
    devices: Optional[list[int]] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    tracer=None,
    device=None,
    gang_command: Optional[list[str]] = None,
    gang_env: Optional[dict] = None,
):
    """Run a jaxjob as a sequence of fixed-topology segments.

    Each segment is one ``loop.run_torchjob`` call over the currently
    active device subset (a local gang over more than one); a granted
    resize request breaks the segment at a step boundary (the loop
    force-saves on every exit), pre-warms the target topology, and the
    next segment restores across meshes and resumes the data stream at
    the exact batch pointer. Returns the final segment's
    ``TrainResult``.
    """
    from polyaxon_tpu_torch.device import resolve_device
    from polyaxon_tpu_torch.obs import flight as obs_flight
    from polyaxon_tpu_torch.obs import metrics as obs_metrics
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.runtime import loop as loop_mod
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig

    device = resolve_device(device)
    cfg = RuntimeConfig.from_dict(job.get("runtime") or {})
    all_devices = (list(devices) if devices is not None
                   else bootstrap.local_devices(device))
    full_n = len(all_devices)
    base_axes = resolved_base_axes(job, full_n)
    current_n = full_n

    def segment_stop() -> bool:
        if should_stop is not None and should_stop():
            return True
        return controller.pending()

    while True:
        result = loop_mod.run_torchjob(
            job, artifacts_dir=artifacts_dir, on_metrics=on_metrics,
            devices=all_devices[:current_n],
            mesh_axes=scaled_axes(base_axes, full_n, current_n),
            should_stop=segment_stop, tracer=tracer, device=device,
            gang_command=gang_command, gang_env=gang_env)
        req = controller.take()
        if req is None:
            return result
        direction = req["direction"]
        reason = req.get("reason", "")
        if ((should_stop is not None and should_stop())
                or result.steps >= cfg.steps):
            # External stop or natural completion won the race with the
            # request: record it, never resize a finished segment.
            attempt = controller.begin_attempt(direction, reason,
                                               current_n, current_n)
            controller.finish_attempt(attempt, "superseded")
            return result
        target_n = req.get("target_devices")
        if not target_n:
            target_n = max(current_n // 2, 1) if direction == "shrink" else full_n
        target_n = min(max(int(target_n), 1), full_n)
        attempt = controller.begin_attempt(direction, reason,
                                           current_n, target_n)
        t0 = time.perf_counter()
        span_cm = (tracer.span("resize", attributes={
            "direction": direction, "reason": reason,
            "from_devices": current_n, "to_devices": target_n,
            "from_step": result.steps,
        }) if tracer is not None else contextlib.nullcontext())
        with span_cm as sp:
            try:
                if target_n == current_n:
                    raise PrewarmError(
                        f"resize target equals current topology "
                        f"({current_n} devices)")
                target_axes = scaled_axes(base_axes, full_n, target_n)
                warm_thread = None
                if artifacts_dir:
                    # Overlap the tier-0 fetch with the target's prewarm:
                    # a side thread promotes the newest local spill into
                    # this process's memory slot, which a next segment
                    # over one device (trained in this thread) restores
                    # from; a gang's ranks restore from the spill itself.
                    from polyaxon_tpu_torch.runtime import tiers

                    warm_thread = threading.Thread(
                        target=tiers.warm,
                        args=(f"{artifacts_dir}/checkpoints",),
                        name="tier0-warm", daemon=True)
                    warm_thread.start()
                try:
                    info = prewarm(job, target_n, target_axes,
                                   devices=all_devices[:target_n],
                                   device=device, command=gang_command,
                                   env=gang_env)
                finally:
                    if warm_thread is not None:
                        warm_thread.join(timeout=30.0)
            except PrewarmError as exc:
                dt = time.perf_counter() - t0
                controller.finish_attempt(attempt, "failed",
                                          error=str(exc), duration_s=dt)
                obs_metrics.elastic_resizes_total().inc(
                    direction=direction, outcome="failed")
                obs_metrics.elastic_resize_hist().observe(dt)
                if sp is not None:
                    sp.set(outcome="failed", error=str(exc)[:300])
                if tracer is not None:
                    obs_flight.RECORDER.note(
                        tracer.trace_id, "resize", direction=direction,
                        outcome="failed", from_devices=current_n,
                        to_devices=target_n, error=str(exc)[:200])
                if direction == "shrink":
                    # The survivors have no validated program: the run
                    # must take the existing PREEMPTED → backoff-requeue
                    # path instead of stranding on a mesh it cannot run.
                    raise ResizeAborted(
                        f"shrink prewarm to {target_n} devices failed: "
                        f"{exc}") from exc
                logger.warning(
                    "elastic: grow prewarm failed for %s, staying at %d "
                    "devices: %s", controller.run_uuid, current_n, exc)
                continue
            dt = time.perf_counter() - t0
            controller.finish_attempt(attempt, "ok", duration_s=dt)
            obs_metrics.elastic_resizes_total().inc(
                direction=direction, outcome="ok")
            obs_metrics.elastic_resize_hist().observe(dt)
            if sp is not None:
                sp.set(outcome="ok", prewarm_mode=info.get("mode"))
            if tracer is not None:
                obs_flight.RECORDER.note(
                    tracer.trace_id, "resize", direction=direction,
                    outcome="ok", from_devices=current_n,
                    to_devices=target_n, step=result.steps)
            logger.info("elastic: %s %s %d→%d devices at step %d",
                        controller.run_uuid, direction, current_n,
                        target_n, result.steps)
            current_n = target_n


def _main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == _CHILD_FLAG:
        return _child_main(argv[1:])
    print(f"usage: python -m polyaxon_tpu_torch.runtime.elastic {_CHILD_FLAG} "
          "--spec JSON --devices N --axes JSON [--device cuda|cpu] "
          "[--local-devices JSON] [--command JSON]", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(_main())
