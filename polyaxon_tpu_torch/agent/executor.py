"""Local slice executor: materializes launch plans as processes.

This is the local provider behind the agent (SURVEY.md §2 "Agent", §7
step 5): the reconcile target that upstream delegates to k8s+operator.
It owns gang semantics in miniature — all processes of a plan start
together, the gang fails/stops together, and preemption (real eviction
on TPU-VMs, injected in tests) kills the gang and reports PREEMPTED so
the scheduler can requeue without consuming retries.

Modes per process:
- runnable command (python/binaries on PATH) → subprocess, stdout/err →
  ``logs/main-<i>.log`` in the run dir;
- ``in_process=True`` (tests/CLI fast path, single-process jaxjob
  gangs) → execute the builtin runtime (``run_torchjob``) in a thread
  on the executor's ``device``, skipping a fresh interpreter's start.
  A job that holds several local devices (``local_devices``: every card
  by default, or the CPU ids the caller lists) trains as a local gang
  of rank processes, one per device, which the thread supervises
  (``runtime/local_gang.py``: a thread cannot hold a multi-rank group);
  each rank runs the plan process's command. A job whose checkpointing
  restores on start gets a resize channel (``runtime/elastic.py``):
  slice loss files a shrink, returned capacity a grow, and each segment
  is a new gang over the surviving devices.

Port of ``polyaxon_tpu/agent/executor.py``. ``runtime/compile_cache.py``
has no counterpart: it points XLA's persistent compilation cache at a
directory, and the port compiles nothing per process that a restart
would repay (its kernels build once per checkout into ``ops/_build/``,
and it calls no ``torch.compile``), so ``POLYAXON_TPU_COMPILE_CACHE``
and ``POLYAXON_TPU_COMPILE_CACHE_DIR`` are accepted and ignored, as the
spec's ``compile_cache_dir`` is (``runtime/loop.py``). A multi-process
gang's coordinator is ``127.0.0.1`` at a free port, one per gang, where
the JAX executor keeps the plan's fixed port. A run that a slice pool
placed (``start(chips=...)``) holds the cards its placement names,
which its processes share out; every other run keeps the policy of
``device_shares``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Optional
from urllib.parse import urlparse

from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.compiler import COORDINATOR_PLACEHOLDER, ENV_JAXJOB_SPEC
from polyaxon_tpu_torch.compiler.plan import COORDINATOR_PORT, V1LaunchPlan
from polyaxon_tpu_torch.controlplane.service import ControlPlane
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.obs import flight as obs_flight
from polyaxon_tpu_torch.obs import trace as obs_trace
from polyaxon_tpu_torch.parallel.bootstrap import ENV_LOCAL_DEVICE_IDS
from polyaxon_tpu_torch.runtime import elastic as elastic_mod


class InitTimeoutError(RuntimeError):
    """A build/clone init phase overran its wall-clock budget; the run
    fails with ``reason="InitTimeout"`` instead of the timeout
    propagating through the agent tick."""


def _init_timeout(env_var: str, default: float) -> float:
    try:
        return float(os.environ.get(env_var, default))
    except ValueError:
        return default


def _safe_join(root: str, rel: str) -> str:
    """Join a user-controlled relative path under ``root``, refusing
    absolute paths and ``..`` escapes (and ``root`` itself)."""
    joined = os.path.realpath(os.path.join(root, rel))
    root_real = os.path.realpath(root)
    if not joined.startswith(root_real + os.sep):
        raise RuntimeError(
            f"init path {rel!r} escapes the run's artifacts dir")
    return joined


def device_shares(n_proc: int, pool: Optional[list[int]], *,
                  pinned: bool = False) -> list[Optional[str]]:
    """Per plan process, the cards it holds as
    ``POLYAXON_TPU_LOCAL_DEVICE_IDS``: process ``p`` of ``P`` on a host of
    ``D`` cards (``pool``) takes ``[p·D/P, (p+1)·D/P)``, so that no two
    processes share a card. None for each (every process holds what
    ``bootstrap.local_devices`` gives it) with one process, unless the
    pool is the cards a slice placement ``pinned`` the run to, or without
    a pool of cards (the CPU, which processes share). Raises
    ``ValueError`` when the cards do not split evenly."""
    if pool is None or n_proc == 1 and not pinned:
        return [None] * n_proc
    n = len(pool)
    if n % n_proc:
        raise ValueError(f"{n} local devices do not split evenly over the "
                         f"plan's {n_proc} processes")
    per = n // n_proc
    return [",".join(str(d) for d in pool[p * per:(p + 1) * per])
            for p in range(n_proc)]


@dataclass
class _Gang:
    run_uuid: str
    plan: V1LaunchPlan
    procs: list[subprocess.Popen] = field(default_factory=list)
    thread: Optional[threading.Thread] = None
    thread_error: Optional[str] = None
    thread_done: bool = False
    preempted: bool = False
    stop_event: threading.Event = field(default_factory=threading.Event)
    reaping: bool = False  # a member died; survivors were signalled
    warning: Optional[str] = None  # non-fatal anomaly → WARNING condition
    # Lifecycle tracing (obs.trace): the `execute` span covers the gang
    # from start() to its reap; subprocess children parent under it via
    # POLYAXON_TRACE_PARENT, the in-process runtime via a passed tracer.
    tracer: Optional[obs_trace.RunTracer] = None
    span: Optional[obs_trace.Span] = None
    # Elastic resize channel (runtime.elastic): present only for
    # in-process jaxjob gangs whose checkpointing makes a cross-mesh
    # restore possible; slice loss files a shrink here instead of a kill.
    elastic: Optional[elastic_mod.ElasticController] = None
    failed_resizes_dumped: int = 0  # postmortems already written
    # Restore audit from the runtime (ISSUE 16): which tier satisfied
    # the run's restore, mirrored into meta["checkpoint"] on poll so
    # ops surfaces read the store, not the thread.
    checkpoint_audit: Optional[dict] = None
    checkpoint_flushed: bool = False
    # The cards a slice placement pinned the gang to (None: unpinned).
    devices: Optional[list[int]] = None


class LocalExecutor:
    def __init__(self, plane: ControlPlane, *, in_process: bool = False,
                 device=None, local_devices=None):
        self.plane = plane
        self.store = plane.store
        self.in_process = in_process
        # Where in-process gangs train: the card unless the caller names
        # another device (``run_torchjob``'s rule). Subprocess gangs run
        # the plan's command, whose launcher trains on the card.
        self.device = device
        # The local devices an in-process job holds: a list of ids, or a
        # count (ids 0..n-1); by default ``bootstrap.local_devices``
        # (every card, or one CPU device, as JAX's host platform has one
        # unless XLA_FLAGS asks for more).
        self.local_devices = (list(range(local_devices))
                              if isinstance(local_devices, int)
                              else local_devices)
        self._gangs: dict[str, _Gang] = {}
        # The JAX executor resolves POLYAXON_TPU_COMPILE_CACHE=1 to a
        # shared XLA cache dir here; the port has no per-process compile
        # to keep (module docstring), so the env is accepted and ignored.

    # ------------------------------------------------------------------ init
    def _run_init_phases(self, plan: V1LaunchPlan) -> None:
        """Local init phases (SURVEY §3.3): auth context stub, artifact
        copies, tpu metadata discovery (local → loopback coordinator)."""
        os.makedirs(plan.artifacts_dir, exist_ok=True)
        os.makedirs(plan.outputs_dir, exist_ok=True)
        os.makedirs(os.path.join(plan.artifacts_dir, "logs"), exist_ok=True)
        fault_plan = chaos.active_plan()
        for phase in plan.init:
            if fault_plan is not None:
                fault_plan.maybe_stall_init(phase.kind)
            if phase.kind == "build":
                self._init_build(plan, phase)
            elif phase.kind == "auth":
                with open(os.path.join(plan.artifacts_dir, ".auth"), "w") as fh:
                    json.dump({"run_uuid": plan.run_uuid, "mode": "local"}, fh)
            elif phase.kind == "artifacts":
                src = phase.config.get("path") or phase.path
                scheme = urlparse(src).scheme if src else ""
                if scheme == "file":
                    src = urlparse(src).path  # → plain local path below
                elif src and scheme:
                    # Store URL (gs://, s3://, ...): download the whole
                    # prefix through the fs layer (upstream's artifacts
                    # initializer over fsspec — SURVEY §3.3).
                    from polyaxon_tpu_torch.fs import (
                        StoreError,
                        get_store,
                        is_transient_store_error,
                    )
                    from polyaxon_tpu_torch.utils.retries import with_retries

                    store = get_store(src)
                    name = (os.path.basename(urlparse(src).path.rstrip("/"))
                            or "artifacts")
                    dest = _safe_join(
                        os.path.join(plan.artifacts_dir, "inputs"), name)
                    # Retried as a unit: one transient store blip must
                    # not fail the run (download_dir re-copies already-
                    # fetched files, so the retry stays correct).
                    if with_retries(lambda: store.download_dir("", dest),
                                    transient=is_transient_store_error,
                                    key=plan.run_uuid) == 0:
                        # A single-object URL lists empty: fetch it as
                        # one file instead.
                        try:
                            with_retries(
                                lambda: store.download_file("", dest),
                                transient=is_transient_store_error,
                                key=plan.run_uuid)
                        except StoreError as exc:
                            raise StoreError(
                                f"artifacts init phase found no objects "
                                f"at {src!r}") from exc
                    continue
                if src and os.path.exists(src):
                    dest = os.path.join(plan.artifacts_dir, "inputs",
                                        os.path.basename(src))
                    os.makedirs(os.path.dirname(dest), exist_ok=True)
                    if os.path.isdir(src):
                        shutil.copytree(src, dest, dirs_exist_ok=True)
                    else:
                        shutil.copy2(src, dest)
            elif phase.kind == "file":
                content = phase.config.get("content", "")
                name = phase.config.get("filename", "file")
                path = _safe_join(os.path.join(plan.artifacts_dir, "inputs"), name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as fh:
                    fh.write(content)
            elif phase.kind == "git":
                self._init_git(plan, phase)
            elif phase.kind == "tpu_metadata":
                with open(os.path.join(plan.artifacts_dir, "tpu-metadata.json"), "w") as fh:
                    json.dump({"coordinator": "127.0.0.1", "topology": "local"}, fh)
            # dockerfile needs docker: recorded, skipped locally.

    def _init_build(self, plan: V1LaunchPlan, phase) -> None:
        """Execute the compiled ``build:`` section (upstream gates the
        main run on a separate build run; here the builder's command
        runs as the FIRST init phase, so a build failure fails the run
        with its log before any main process starts). Output lands in
        ``logs/build.log`` next to the main-process logs."""
        cmd = phase.config.get("command") or []
        if not cmd:
            raise RuntimeError("build init phase has no command")
        env = dict(os.environ)
        env.update(phase.config.get("env") or {})
        log_path = os.path.join(plan.artifacts_dir, "logs", "build.log")
        timeout = _init_timeout("POLYAXON_TPU_BUILD_TIMEOUT", 3600)
        try:
            with open(log_path, "ab") as log_handle:
                proc = subprocess.run(
                    [str(c) for c in cmd], env=env, cwd=plan.artifacts_dir,
                    stdout=log_handle, stderr=subprocess.STDOUT,
                    timeout=timeout)
        except subprocess.TimeoutExpired as exc:
            raise InitTimeoutError(
                f"build `{phase.config.get('hubRef')}` hung past "
                f"{timeout:.0f}s and was killed") from exc
        if proc.returncode != 0:
            tail = ""
            try:
                with open(log_path, "rb") as fh:
                    tail = fh.read()[-400:].decode(errors="replace")
            except OSError:
                pass
            raise RuntimeError(
                f"build `{phase.config.get('hubRef')}` failed "
                f"rc={proc.returncode}: {tail}")

    def _init_git(self, plan: V1LaunchPlan, phase) -> None:
        """Git initializer (upstream init.git): clone url@revision into the
        run context. Works against local paths and any remote git supports;
        failures raise so the run fails with the real git error."""
        url = phase.config.get("url")
        if not url:
            raise RuntimeError(
                "git init phase has no `url` (inline or via its connection)")
        revision = phase.config.get("revision")
        # A dash-prefixed "revision" would be parsed as a git option
        # (e.g. `--force` turns the checkout into a silent no-op).
        if revision and str(revision).startswith("-"):
            raise RuntimeError(f"invalid git revision {revision!r}")
        # The user-controlled path must stay inside the run's artifacts
        # dir — we rmtree it below, so absolute/`..` escapes are rejected,
        # and resolving to the artifacts root itself is refused too.
        dest = _safe_join(plan.artifacts_dir, phase.path or "repo")
        # Idempotent like every other init phase: a preemption-requeued
        # run restarts against the same artifacts dir.
        if os.path.exists(dest):
            shutil.rmtree(dest)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        # `--` stops git from parsing a dash-prefixed url as an option.
        timeout = _init_timeout("POLYAXON_TPU_GIT_TIMEOUT", 600)
        try:
            clone = subprocess.run(
                ["git", "clone", "--quiet", "--", url, dest],
                capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired as exc:
            raise InitTimeoutError(
                f"git clone {url} hung past {timeout:.0f}s and was "
                "killed") from exc
        if clone.returncode != 0:
            raise RuntimeError(f"git clone {url} failed: {clone.stderr.strip()}")
        if revision:
            try:
                checkout = subprocess.run(
                    ["git", "-C", dest, "checkout", "--quiet", revision, "--"],
                    capture_output=True, text=True,
                    timeout=min(timeout, 120))
            except subprocess.TimeoutExpired as exc:
                raise InitTimeoutError(
                    f"git checkout {revision} hung and was killed") from exc
            if checkout.returncode != 0:
                raise RuntimeError(
                    f"git checkout {revision} failed: {checkout.stderr.strip()}")

    # ----------------------------------------------------------------- start
    def _pinned_cards(self, chips: Optional[list[int]]
                      ) -> Optional[list[int]]:
        """The cards of a run placed on ``chips`` of a slice: each chip
        indexes the executor's pool of cards (``_card_pool``). None
        without a placement, or without a pool of cards (the CPU), where
        the placement only gates the start."""
        if chips is None:
            return None
        pool = self._card_pool()
        if pool is None:
            return None
        if max(chips, default=-1) >= len(pool):
            raise RuntimeError(
                f"the slice placement holds chips {chips}, but this host's "
                f"pool has {len(pool)} cards ({pool})")
        return [pool[c] for c in chips]

    def start(self, run_uuid: str,
              chips: Optional[list[int]] = None) -> bool:
        """queued → scheduled → starting → running; spawns the gang.
        ``chips``: the run's slice placement, which pins it to those
        cards of the executor's pool (``_pinned_cards``)."""
        record = self.store.get_run(run_uuid)
        plan_dict = record.launch_plan
        if not plan_dict:
            # polycheck: ignore[invariant-store-batch] -- lifecycle gates separated by gang spawn: FAILED/RUNNING mark externally observable progress and cannot batch with the scheduled hop below
            self.store.transition(run_uuid, V1Statuses.FAILED, reason="NoLaunchPlan")
            return False
        plan = V1LaunchPlan.from_dict(plan_dict)
        # One commit for the pre-spawn hop: a crash between them would
        # strand the run in SCHEDULED with no gang to reap it.
        with self.store.transaction():
            self.store.transition(run_uuid, V1Statuses.SCHEDULED)
            self.store.transition(run_uuid, V1Statuses.STARTING)

        gang = _Gang(run_uuid=run_uuid, plan=plan)
        # Arm the flight recorder before any span lands: the registry
        # baseline taken here is what turns the postmortem's metric
        # section into DELTAS (what moved while this gang lived).
        obs_flight.RECORDER.mark_start(run_uuid)
        gang.tracer = obs_trace.RunTracer(
            plan.artifacts_dir, run_uuid, component="agent")
        gang.span = gang.tracer.start_span(
            "execute", attributes={"kind": plan.run_kind,
                                   "processes": plan.num_processes,
                                   "in_process": self.in_process})
        try:
            gang.devices = self._pinned_cards(chips)
            if gang.devices is not None:
                gang.span.set(devices=gang.devices)
            # Init runs inside a child span AS the current span, so the
            # deep seams it crosses (chaos store faults, with_retries
            # attempts, init stalls) annotate it (obs.trace.add_event).
            with gang.tracer.span("init", parent=gang.span) as init_span:
                init_span.set(phases=[p.kind for p in plan.init])
                self._run_init_phases(plan)
            if self.in_process and self._can_run_in_process(plan):
                gang.elastic = self._make_elastic(plan)
                gang.thread = threading.Thread(
                    target=self._run_in_process, args=(gang,), daemon=True
                )
                gang.thread.start()
            else:
                # A local gang's coordinator listens on a free port, so
                # that gangs on one host never share one.
                from polyaxon_tpu_torch.parallel.bootstrap import free_port

                coordinator = f"127.0.0.1:{free_port()}"
                pinned = gang.devices is not None
                shares = device_shares(
                    len(plan.processes),
                    gang.devices if pinned else self._card_pool(),
                    pinned=pinned)
                for proc_spec, share in zip(plan.processes, shares):
                    env = dict(os.environ)
                    env.update(proc_spec.env)
                    if pinned:
                        env[ENV_LOCAL_DEVICE_IDS] = share
                    elif share is not None:
                        env.setdefault(ENV_LOCAL_DEVICE_IDS, share)
                    # Trace propagation rides the same env plumbing as
                    # the graft/tracking contract: the child's runtime
                    # spans parent under this gang's `execute` span.
                    env[obs_trace.ENV_TRACE_PARENT] = (
                        obs_trace.format_trace_parent(run_uuid,
                                                      gang.span.span_id))
                    for key, value in list(env.items()):
                        if isinstance(value, str) and COORDINATOR_PLACEHOLDER in value:
                            env[key] = value.replace(
                                f"{COORDINATOR_PLACEHOLDER}:{COORDINATOR_PORT}",
                                coordinator).replace(
                                    COORDINATOR_PLACEHOLDER, "127.0.0.1")
                    cmd = list(proc_spec.command) + list(proc_spec.args)
                    if not cmd:
                        raise RuntimeError("Process has no command")
                    if shutil.which(cmd[0]) is None and not os.path.exists(cmd[0]):
                        raise RuntimeError(
                            f"Command `{cmd[0]}` is not executable on this host "
                            f"(image `{proc_spec.image}` delegation needs a cluster provider)"
                        )
                    log_path = os.path.join(plan.artifacts_dir, "logs",
                                            f"main-{proc_spec.index}.log")
                    log_handle = open(log_path, "ab")
                    try:
                        proc = subprocess.Popen(
                            cmd, env=env, stdout=log_handle, stderr=subprocess.STDOUT,
                            cwd=proc_spec.working_dir or None, start_new_session=True,
                        )
                    except Exception:
                        log_handle.close()
                        raise
                    proc._plx_log_handle = log_handle  # closed in poll()
                    gang.procs.append(proc)
        except Exception as exc:
            # Kill any half-started gang members — a partial gang must not
            # keep running unowned (gang semantics: start together or not
            # at all).
            for proc in gang.procs:
                try:
                    proc.kill()
                except OSError:
                    pass
                handle = getattr(proc, "_plx_log_handle", None)
                if handle and not handle.closed:
                    handle.close()
            reason = ("InitTimeout" if isinstance(exc, InitTimeoutError)
                      else "StartError")
            self._finish_gang_span(gang, status="error",
                                   error=f"{reason}: {exc}")
            self.store.transition(run_uuid, V1Statuses.FAILED,
                                  reason=reason, message=str(exc)[:500])
            # A run that died in init gets its black box too.
            obs_flight.RECORDER.dump(run_uuid, plan.artifacts_dir,
                                     status=V1Statuses.FAILED.value,
                                     reason=reason, message=str(exc)[:500])
            return False
        self._gangs[run_uuid] = gang
        self.store.transition(run_uuid, V1Statuses.RUNNING)
        return True

    def _finish_gang_span(self, gang: _Gang, *, status: str = "ok",
                          error: Optional[str] = None, **attrs) -> None:
        """Close the gang's `execute` span + its writer handle (the
        EventWriter-close contract: a reaped gang pins no fds)."""
        if gang.tracer is None:
            return
        try:
            if gang.span is not None:
                gang.span.set(**attrs)
                gang.tracer.finish(gang.span, status=status, error=error)
        finally:
            gang.tracer.close()
            gang.tracer = gang.span = None

    def _card_pool(self) -> Optional[list[int]]:
        """The cards this host's plan processes share out
        (``device_shares``): the executor's ``local_devices``, else
        ``bootstrap.local_devices`` on a host with cards (every card, or
        the ids of this process's ``POLYAXON_TPU_LOCAL_DEVICE_IDS``);
        None without cards, or for an executor that names another
        device."""
        import torch

        from polyaxon_tpu_torch.parallel import bootstrap

        if self.local_devices is not None:
            return list(self.local_devices)
        if (not torch.cuda.is_available() or self.device is not None
                and torch.device(self.device).type != "cuda"):
            return None
        return bootstrap.local_devices("cuda")

    def _can_run_in_process(self, plan: V1LaunchPlan) -> bool:
        return (
            plan.run_kind == "jaxjob"
            and plan.num_processes == 1
            and ENV_JAXJOB_SPEC in plan.processes[0].env
        )

    def _make_elastic(self, plan: V1LaunchPlan) -> Optional[
            elastic_mod.ElasticController]:
        """A resize channel for gangs that can actually survive one:
        jaxjob with checkpointing + restore-on-start (the segment
        boundary is a forced save and a cross-mesh restore)."""
        try:
            job = json.loads(plan.processes[0].env[ENV_JAXJOB_SPEC])
        except (KeyError, ValueError):
            return None
        if not elastic_mod.elastic_capable(job):
            return None
        try:
            prior = ((self.store.get_run(plan.run_uuid).meta or {})
                     .get("elastic") or {}).get("attempts")
        except KeyError:
            prior = None
        return elastic_mod.ElasticController(plan.run_uuid,
                                             prior_attempts=prior)

    def request_resize(self, run_uuid: str, direction: str, *,
                       reason: str = "",
                       target_devices: Optional[int] = None) -> bool:
        """File a resize against a live elastic gang. False means the
        gang cannot resize (no channel, budget exhausted, already
        resizing, dead thread) — callers fall back to :meth:`preempt`."""
        gang = self._gangs.get(run_uuid)
        if (gang is None or gang.elastic is None or gang.preempted
                or gang.thread is None or not gang.thread.is_alive()):
            return False
        granted = gang.elastic.request(direction, reason=reason,
                                       target_devices=target_devices)
        if granted and gang.span is not None:
            gang.span.add_event("resize_requested", direction=direction,
                                reason=reason)
        return granted

    def shrunk_elastic_runs(self) -> list[str]:
        """Live gangs currently training on a shrunk mesh — the set the
        agent offers a grow to when slice capacity returns."""
        return [uuid for uuid, gang in self._gangs.items()
                if gang.elastic is not None and gang.elastic.shrunk
                and not gang.preempted
                and gang.thread is not None and gang.thread.is_alive()]

    def _run_in_process(self, gang: _Gang) -> None:
        from polyaxon_tpu_torch.runtime.loop import run_torchjob
        from polyaxon_tpu_torch.tracking.run import Run

        plan = gang.plan
        proc_spec = plan.processes[0]
        # The job as the launcher reads it from the same env var.
        job = json.loads(proc_spec.env[ENV_JAXJOB_SPEC])
        tracking = Run(plan.run_uuid, plan.artifacts_dir)
        # The runtime thread gets its OWN tracer (thread-owned writer
        # handle) parented under the gang's `execute` span — the same
        # shape the subprocess path gets via POLYAXON_TRACE_PARENT.
        tracer = obs_trace.RunTracer(
            plan.artifacts_dir, plan.run_uuid, component="runtime",
            parent_id=gang.span.span_id if gang.span is not None else None)
        ckpt_dir = os.path.join(plan.artifacts_dir, "checkpoints")
        # A local gang's ranks run the plan process's command in its env.
        gang_command = list(proc_spec.command) + list(proc_spec.args)
        gang_env = {**os.environ, **proc_spec.env}

        def should_stop() -> bool:
            # Chaos gang seam for the in-process fast path: a thread
            # has no pid to SIGKILL, so a due kill-fault raises inside
            # the step loop (or the local gang's supervision, which
            # kills the ranks) — the same abrupt member death, observed
            # through the same FAILED reap. `preempted` stops the loop
            # too: an in-process gang has no process to kill, so the
            # preempt signal must reach the step loop itself.
            fault_plan = chaos.active_plan()
            if fault_plan is not None:
                fault_plan.maybe_kill_gang(plan.run_uuid, ckpt_dir)
                if gang.elastic is not None and not gang.elastic.resizing:
                    # Slice-loss seam, consulted per step (per poll of a
                    # local gang's supervision) against checkpoint
                    # counts: "kill" files a shrink (denied → budget
                    # exhausted → plain preemption), "restore" files a
                    # grow. NOT consulted mid-resize: the request would
                    # be denied and the fired fault swallowed — the next
                    # step retries.
                    op = fault_plan.slice_loss_due(plan.run_uuid, ckpt_dir)
                    if op == "kill":
                        if not gang.elastic.request(
                                "shrink", reason="ChaosSliceLoss"):
                            gang.preempted = True
                    elif op == "restore":
                        gang.elastic.request(
                            "grow", reason="ChaosCapacityReturned")
            return gang.stop_event.is_set() or gang.preempted

        try:
            tracking.log_status(V1Statuses.RUNNING)
            kwargs = dict(artifacts_dir=plan.artifacts_dir,
                          on_metrics=tracking.log_metrics_cb(),
                          should_stop=should_stop, tracer=tracer,
                          device=self.device,
                          devices=(gang.devices if gang.devices is not None
                                   else self.local_devices),
                          gang_command=gang_command, gang_env=gang_env)
            if gang.elastic is not None:
                result = elastic_mod.run_elastic(
                    job, controller=gang.elastic, **kwargs)
            else:
                result = run_torchjob(job, **kwargs)
            if result.restore_skipped_steps:
                gang.warning = (
                    f"restored checkpoint step {result.restored_from_step} "
                    f"after skipping corrupt step(s) "
                    f"{result.restore_skipped_steps}")
            if result.restored_from_step is not None:
                gang.checkpoint_audit = {
                    "restored_from_step": result.restored_from_step,
                    "restore_tier": result.restore_tier,
                    **({"restore_skipped_steps":
                        result.restore_skipped_steps}
                       if result.restore_skipped_steps else {}),
                }
            tracking.log_outputs(
                steps=result.steps, throughput=result.throughput,
                wall_time=result.wall_time, param_count=result.param_count,
                # Same resume-audit field as the subprocess entrypoint
                # (runtime/launch.py): None means cold start.
                restored_from_step=result.restored_from_step,
                **({"restore_tier": result.restore_tier}
                   if result.restore_tier is not None else {}),
                **({"restore_skipped_steps": result.restore_skipped_steps}
                   if result.restore_skipped_steps else {}),
                **{f"final_{k}": v for k, v in result.final_metrics.items()},
            )
            if gang.stop_event.is_set():
                tracking.log_status(V1Statuses.STOPPED, reason="StopRequested")
            elif gang.preempted:
                pass  # the poll reap owns the PREEMPTED transition
            else:
                tracking.log_succeeded()
        except elastic_mod.ResizeAborted as exc:
            # A shrink that could not prewarm (or whose budget ran out)
            # degrades to the EXISTING preemption path: the poll reap
            # transitions PREEMPTED and the scheduler backoff-requeues.
            gang.preempted = True
            with open(os.path.join(plan.artifacts_dir, "logs", "main-0.log"), "a") as fh:
                fh.write(f"elastic resize aborted: {exc}\n")
        except Exception as exc:
            gang.thread_error = f"{type(exc).__name__}: {exc}"
            with open(os.path.join(plan.artifacts_dir, "logs", "main-0.log"), "a") as fh:
                fh.write(traceback.format_exc())
            tracking.log_failed(reason=type(exc).__name__, message=str(exc)[:2000])
        finally:
            tracer.close()
            tracking.close()
            gang.thread_done = True

    # ------------------------------------------------------------------ poll
    def poll(self) -> int:
        """Reap finished gangs → terminal statuses. Returns actions.

        Precedence is STOPPING > preempted > exit status: a gang whose
        run was asked to stop reaps STOPPED even if a preemption landed
        while it was dying (the operator's intent wins over weather).
        """
        fault_plan = chaos.active_plan()
        if fault_plan is not None:
            # Chaos gang seam for subprocess gangs: SIGKILL one member
            # of a due gang; the normal reap path must terminate the
            # survivors and fail the run with the signal code.
            for run_uuid, gang in list(self._gangs.items()):
                live = [p for p in gang.procs if p.poll() is None]
                ckpt_dir = os.path.join(gang.plan.artifacts_dir,
                                        "checkpoints")
                if live and fault_plan.gang_kill_due(run_uuid, ckpt_dir):
                    try:
                        live[0].kill()
                    except OSError:
                        pass
            # Chaos slice-loss seam for gangs WITHOUT a resize channel
            # (subprocess, or checkpointing off): losing a slice is a
            # plain preemption — the pre-elastic behavior, kept as the
            # degradation floor. Elastic gangs consult the seam from
            # their own step loop (deterministic against checkpoints).
            for run_uuid, gang in list(self._gangs.items()):
                if gang.elastic is not None:
                    continue
                ckpt_dir = os.path.join(gang.plan.artifacts_dir,
                                        "checkpoints")
                if fault_plan.slice_loss_due(run_uuid, ckpt_dir) == "kill":
                    self.preempt(run_uuid)
        actions = 0
        for run_uuid, gang in list(self._gangs.items()):
            # Mirror the resize audit into meta["elastic"] on every poll
            # while the gang is LIVE: the scheduler's resizing-hold and
            # the ops surfaces read the store, not the controller.
            self._flush_elastic(run_uuid, gang)
            self._flush_checkpoint(run_uuid, gang)
        for run_uuid, gang in list(self._gangs.items()):
            status = self._gang_status(gang)
            if status is None:
                continue
            del self._gangs[run_uuid]
            # Final audit flush: the thread may have finished an attempt
            # between the live flush above and its exit.
            self._flush_elastic(run_uuid, gang)
            self._flush_checkpoint(run_uuid, gang)
            record = self.store.get_run(run_uuid)
            if record.status == V1Statuses.STOPPING:
                self._finish_gang_span(gang, final="stopped")
                # polycheck: ignore[invariant-store-batch] -- exclusive per-gang reap branches: exactly one terminal write runs per gang (the WARNING+terminal pair below batches separately)
                self.store.transition(run_uuid, V1Statuses.STOPPED)
                obs_flight.RECORDER.discard(run_uuid)  # operator intent
            elif gang.preempted:
                self._finish_gang_span(gang, status="error",
                                       error="preempted", final="preempted")
                self.store.transition(run_uuid, V1Statuses.PREEMPTED,
                                      reason="SlicePreempted", force=True)
                # Preemption is a death the operator did not ask for:
                # dump the black box (the backoff requeue keeps the ring
                # alive, so a later fatal reap overwrites with more).
                obs_flight.RECORDER.dump(
                    run_uuid, gang.plan.artifacts_dir,
                    status=V1Statuses.PREEMPTED.value,
                    reason="SlicePreempted")
            else:
                target = V1Statuses.SUCCEEDED if status == 0 else V1Statuses.FAILED
                self._finish_gang_span(
                    gang, status="ok" if status == 0 else "error",
                    error=(None if status == 0 else
                           gang.thread_error or f"exit code {status}"),
                    final=target.value, exit_code=status)
                with self.store.transaction():
                    if gang.warning:
                        # Non-fatal anomaly (e.g. checkpoint fallback):
                        # pinned as a WARNING condition so operators see
                        # it without the run dying — committed with the
                        # terminal hop so a crash between them cannot
                        # strand the run live in WARNING.
                        self.store.transition(
                            run_uuid, V1Statuses.WARNING,
                            reason="CheckpointFallback",
                            message=gang.warning[:500], force=True)
                    self.store.transition(
                        run_uuid, target,
                        reason="Completed" if status == 0 else "ProcessFailed",
                        message=gang.thread_error or (None if status == 0
                                                      else f"exit code {status}"),
                    )
                if target == V1Statuses.FAILED:
                    # The reap that declared the run dead writes its
                    # postmortem: ring of recent spans/notes, metric
                    # deltas since gang start, and every log tail.
                    obs_flight.RECORDER.dump(
                        run_uuid, gang.plan.artifacts_dir,
                        status=target.value, reason="ProcessFailed",
                        message=gang.thread_error
                        or f"exit code {status}")
                else:
                    obs_flight.RECORDER.discard(run_uuid)
            actions += 1
        return actions

    def _flush_elastic(self, run_uuid: str, gang: _Gang) -> None:
        """Write the controller's audit into ``meta["elastic"]`` when it
        changed, and dump a postmortem for every newly FAILED resize
        attempt — a failed resize is evidence worth keeping on disk even
        when the run survives it (grow failures don't kill the run)."""
        if gang.elastic is None:
            return
        snap = gang.elastic.snapshot(consume_dirty=True)
        if snap is None:
            return
        try:
            record = self.store.get_run(run_uuid)
        except KeyError:
            return
        meta = dict(record.meta or {})
        meta["elastic"] = snap
        self.store.update_run(run_uuid, meta=meta)
        failed = sum(1 for a in snap["attempts"]
                     if a["outcome"] == "failed")
        if failed > gang.failed_resizes_dumped:
            gang.failed_resizes_dumped = failed
            last = next(a for a in reversed(snap["attempts"])
                        if a["outcome"] == "failed")
            obs_flight.RECORDER.dump(
                run_uuid, gang.plan.artifacts_dir,
                status=V1Statuses.RUNNING.value, reason="ResizeFailed",
                message=(f"{last['direction']} {last['from_devices']}→"
                         f"{last['to_devices']} devices: "
                         f"{last.get('error', '')}")[:500])

    def _flush_checkpoint(self, run_uuid: str, gang: _Gang) -> None:
        """Write the runtime's restore audit into ``meta["checkpoint"]``
        once it exists: ``restore_tier`` ("0" memory / "1" spill / "2"
        store) + ``restored_from_step`` (+ any culled steps), so `plx ops
        report` and the drills can assert WHERE a rerun resumed from."""
        if gang.checkpoint_audit is None or gang.checkpoint_flushed:
            return
        try:
            record = self.store.get_run(run_uuid)
        except KeyError:
            return
        meta = dict(record.meta or {})
        meta["checkpoint"] = dict(gang.checkpoint_audit)
        self.store.update_run(run_uuid, meta=meta)
        gang.checkpoint_flushed = True

    def _gang_status(self, gang: _Gang) -> Optional[int]:
        """None while running; else first nonzero exit code of the gang.

        Gang liveness: the moment any member exits nonzero, survivors are
        terminated (they would otherwise block on the dead coordinator
        forever) and the gang is reaped on a later poll once all exited.
        """
        if gang.thread is not None:
            if not gang.thread_done and gang.thread.is_alive():
                return None
            return 1 if gang.thread_error else 0
        codes = []
        running = []
        for proc in gang.procs:
            code = proc.poll()
            if code is None:
                running.append(proc)
            else:
                codes.append(code)
        if running:
            if not gang.reaping and any(c != 0 for c in codes):
                gang.reaping = True
                for proc in running:
                    try:
                        proc.terminate()
                    except OSError:
                        pass
            return None
        for proc in gang.procs:
            handle = getattr(proc, "_plx_log_handle", None)
            if handle and not handle.closed:
                handle.close()
        if not codes:
            return 1
        # Any nonzero (incl. negative signal codes) fails the gang.
        return next((c for c in codes if c != 0), 0)

    # ------------------------------------------------------------- stop/kill
    def stop(self, run_uuid: str) -> None:
        gang = self._gangs.get(run_uuid)
        if gang is None:
            return
        if gang.span is not None:
            gang.span.add_event("stop_requested")
        gang.stop_event.set()  # in-process runtime loop checks this per step
        if gang.thread is not None and gang.thread.is_alive():
            # Drain: the loop exits at the next step boundary; a
            # bounded join lets its final status/checkpoint writes land
            # before teardown (daemon threads die mid-write at exit).
            gang.thread.join(timeout=30)
        for proc in gang.procs:
            try:
                proc.terminate()
            except OSError:
                pass

    def preempt(self, run_uuid: str) -> bool:
        """Simulate slice preemption (fault-injection hook — SURVEY §5.3:
        test-only in the fake provider; real eviction signals map here)."""
        gang = self._gangs.get(run_uuid)
        if gang is None:
            return False
        if gang.span is not None:
            gang.span.add_event("preempt")
        gang.preempted = True
        for proc in gang.procs:
            try:
                proc.kill()
            except OSError:
                pass
        return True

    @property
    def active_runs(self) -> list[str]:
        return list(self._gangs)
