"""The training loop (port of ``polyaxon_tpu/runtime/loop.py``): job
spec → mesh → model → data → train step → metrics.

The job's ``mesh`` (and ``topology`` for multi-slice placement) resolves
over the ranks of the process group — a gang's, started by the launcher
(``parallel/bootstrap.py``), or a one-rank group the loop starts for an
in-process run and destroys after it — and the parameters are placed on
it (``runtime/step.py``). Every axis is placed (a few combinations of
the model-parallel axes raise: ``parallel/sharding.py``); each process
drives one device. A caller that holds several devices (``devices``, by
default every card) trains as a local gang of ranks, one per device
(``runtime/local_gang.py``), as a JAX process spans its chips; each plan
process's rows are drawn once and split over its ranks. In a gang the
ranks agree on ``should_stop`` before every step (one host-side
all-reduce), so they stop at one step. Emissions, tracking and
checkpoint writes come from rank 0.

``run_torchjob`` takes the job as a dict (the JSON form of a jaxjob run
spec: ``runtime``, and optionally ``mesh`` and ``checkpointing``) and
follows ``_run_jaxjob``: restore from the newest committed checkpoint,
one warm-up step outside the timed window (reported once as
``compile_time_s``; here it is the first step's wall time, kernel
builds included), emissions every ``log_every`` steps, periodic eval
over a fixed batch set, checkpoints every ``intervalSteps`` and at the
end, ``profile_steps`` traced by ``torch.profiler``, and
``should_stop``.

With an artifacts dir it writes the lifecycle spans ``run_jaxjob``
writes, under the same names (``obs/trace.py``): ``runtime`` over the
run, ``restore``, ``jit_compile`` (the warm-up step), one ``step`` per
metrics-emission window, ``eval`` and ``checkpoint``. The port's windows
time only timed steps (the warm-up step is ``jit_compile``'s), but the
first window's step range starts at the warm-up step, as the JAX loop's
does, so the windows of a run and of its resumed segments are
contiguous.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import shutil
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from polyaxon_tpu_torch.device import resolve_device
from polyaxon_tpu_torch.models import family_of, get_model
from polyaxon_tpu_torch.obs import flight as obs_flight
from polyaxon_tpu_torch.obs import metrics as obs_metrics
from polyaxon_tpu_torch.obs import trace as obs_trace
from polyaxon_tpu_torch.parallel import bootstrap
from polyaxon_tpu_torch.parallel.mesh import build_mesh, row_block, use_mesh
from polyaxon_tpu_torch.parallel.sharding import param_bytes, rules_for_mesh
from polyaxon_tpu_torch.polyflow.environment import V1TpuTopology
from polyaxon_tpu_torch.polyflow.runs import V1MeshSpec
from polyaxon_tpu_torch.runtime import data as data_lib
from polyaxon_tpu_torch.runtime.checkpoint import (CheckpointSpec,
                                                   TieredCheckpointManager)
from polyaxon_tpu_torch.runtime.config import RuntimeConfig
from polyaxon_tpu_torch.runtime.flops import peak_flops, train_flops_per_token
from polyaxon_tpu_torch.runtime.optim import build_optimizer, tree_leaves
from polyaxon_tpu_torch.runtime.step import (build_eval_step, build_init,
                                             build_train_step, rank_rows)

logger = logging.getLogger(__name__)

MetricsCallback = Callable[[int, dict[str, float]], None]


@dataclasses.dataclass
class TrainResult:
    steps: int
    final_metrics: dict[str, float]
    throughput: float  # units/sec (tokens or examples)
    unit: str
    units_per_step: int
    wall_time: float
    param_count: int
    # Where the checkpoint restore landed (None: a cold start), the steps
    # it skipped as corrupt (newest first) and the tier that served it.
    restored_from_step: Optional[int] = None
    restore_skipped_steps: list[int] = dataclasses.field(default_factory=list)
    restore_tier: Optional[str] = None
    # Host time blocked on the next batch, per timed step.
    input_wait_ms: float = 0.0
    # Wall time of the warm-up step (kernel builds included).
    compile_time_s: float = 0.0
    # Host time per step the ranks of a gang spent agreeing to go on (the
    # stop flag's all-reduce); 0 in a one-rank group.
    stop_check_ms: float = 0.0
    # Checkpoint accounting, empty without checkpointing: bytes per
    # checkpoint, and seconds per save (the step loop's stall: waiting for
    # the previous commit, then the host copy), per commit and per restore
    # by tier.
    checkpoint: dict = dataclasses.field(default_factory=dict)


def _job_mesh(job: dict, device: torch.device,
              mesh_axes: Optional[dict[str, int]] = None):
    """The job's mesh over the process group's ranks (every rank when the
    job names none, as the JAX loop's ``{"dp": n}``); ``mesh_axes``
    overrides the resolved axes."""
    mesh_spec = (V1MeshSpec.from_dict(job["mesh"]) if job.get("mesh")
                 else None)
    topology = (V1TpuTopology.from_dict(job["topology"])
                if job.get("topology") else None)
    return build_mesh(mesh_spec, topology, axes=mesh_axes,
                      device_type=device.type)


def _dataset_kwargs(cfg: RuntimeConfig, model_cfg, batch: int) -> dict:
    """The JAX loop's rule: spec extras, then the model's sequence
    length, vocabulary and image shape where it has them."""
    kwargs: dict[str, Any] = {"batch_size": batch, "seed": cfg.seed}
    for key in ("path", "tokenizer", "image_size", "num_classes",
                "mask_rate"):
        if key in cfg.extras:
            kwargs[key] = cfg.extras[key]
    if cfg.seq_len:
        kwargs["seq_len"] = cfg.seq_len
    elif hasattr(model_cfg, "max_seq_len"):
        kwargs["seq_len"] = min(model_cfg.max_seq_len, 2048)
    for key in ("vocab_size", "image_size", "num_classes"):
        if hasattr(model_cfg, key) and key not in kwargs:
            kwargs[key] = getattr(model_cfg, key)
    return kwargs


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log_checkpoint_budget(ckpt: TieredCheckpointManager, state) -> int:
    """Log the bytes of one checkpoint beside the free host memory and
    disk it needs (one host snapshot; the steps the store keeps and those
    the spill's hard links keep beside them, and one step being written);
    returns the bytes."""
    from polyaxon_tpu_torch.runtime import tiers
    from polyaxon_tpu_torch.runtime.checkpoint import flatten
    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    nbytes = sum(t.numel() * t.element_size() for _, t in flatten(state)
                 if isinstance(t, torch.Tensor))
    keep = ckpt.spec.max_to_keep or 1
    disk_need = nbytes * (max(keep, tiers.SPILL_KEEP) + 1)
    disk_free = shutil.disk_usage(ckpt.directory).free
    try:
        host_free = meminfo().get("MemAvailable")
    except OSError:
        host_free = None
    logger.info("checkpoint: %.2f GB per step; host memory available "
                "%s GB (the snapshot buffer needs %.2f GB); disk free %.2f "
                "GB under %s (at most %.2f GB in use)", nbytes / 1e9,
                f"{host_free / 1e9:.2f}" if host_free is not None else "?",
                nbytes / 1e9, disk_free / 1e9, ckpt.directory,
                disk_need / 1e9)
    if disk_free < disk_need:
        logger.warning("checkpoint: the disk under %s may fill: %.2f GB "
                       "free, up to %.2f GB needed", ckpt.directory,
                       disk_free / 1e9, disk_need / 1e9)
    return nbytes


def _checkpoint_report(ckpt: TieredCheckpointManager, nbytes: int) -> dict:
    return {"bytes": nbytes, "save_wait_s": ckpt.save_wait_seconds,
            "snapshot_s": ckpt.snapshot_seconds,
            "commit_s": ckpt.save_seconds,
            "restore_s": ckpt.restore_seconds,
            "publish_errors": ckpt.publish_errors}


class _StepProfiler:
    """A ``torch.profiler`` trace of one step, written as a Chrome trace
    to ``<artifacts>/profile/step_<n>.json``."""

    def __init__(self, artifacts_dir: str, step: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.path = os.path.join(artifacts_dir, "profile",
                                 f"step_{step}.json")
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=activities, record_shapes=True)
        self.prof.__enter__()

    def stop(self) -> None:
        _sync(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        logger.info("profile of one step written to %s", self.path)


def _save(ckpt: TieredCheckpointManager, step: int, state, n_proc: int,
          force: bool = False) -> None:
    """Every rank gathers the state leaf by leaf; rank 0 writes it. With
    several processes the save is committed before any rank goes on (a
    barrier), so a restarted gang finds a step every rank saved."""
    ckpt.save(step, state, force=force)
    if n_proc > 1:
        ckpt.wait()
        dist.barrier()


def _span(tracer: Optional[obs_trace.RunTracer], name: str, **attrs):
    """Span when tracing is on, nullcontext (yielding None) when off."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, attributes=attrs or None)


def _stop_agreed(should_stop: Optional[Callable[[], bool]],
                 n_ranks: int) -> bool:
    """Whether to stop before the next step. In a gang every rank asks
    its ``should_stop`` (the launcher gives one to rank 0) and the ranks
    agree on the answer through one all-reduce of one element on a gloo
    group, which waits on no device stream: a stop one rank saw alone
    would leave the others in the next step's collectives."""
    stop = should_stop is not None and bool(should_stop())
    if n_ranks == 1:
        return stop
    flag = torch.tensor([int(stop)], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                    group=bootstrap.host_group())
    return bool(flag.item())


def run_torchjob(job: dict, *, artifacts_dir: Optional[str] = None,
                 on_metrics: Optional[MetricsCallback] = None,
                 devices: Optional[list[int]] = None,
                 mesh_axes: Optional[dict[str, int]] = None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 device=None,
                 tracer: Optional[obs_trace.RunTracer] = None,
                 gang_command: Optional[list[str]] = None,
                 gang_env: Optional[dict[str, str]] = None
                 ) -> TrainResult:
    """Train the job's ``runtime`` section (on ``cuda`` unless the caller
    names another device; raises without a GPU) over the job's mesh,
    which must resolve to the process group's ranks; ``mesh_axes``
    overrides its resolved axes, as ``run_jaxjob``'s does.

    Outside a gang, ``devices`` are the local devices this call holds
    (default ``bootstrap.local_devices``: every card, or one CPU device).
    Over more than one it trains as a local gang, one rank per device,
    and supervises it (``local_gang.run``): each rank runs
    ``gang_command`` (the launcher by default) with ``gang_env`` (this
    process's env by default). With an artifacts
    dir, ``checkpointing``
    saves to and restores from ``<artifacts>/checkpoints`` and
    ``profile_steps`` traces to ``<artifacts>/profile``. ``lora_rank >
    0`` trains LoRA adapters over a frozen base (``models/lora.py``);
    ``compile_cache_dir`` is accepted and means nothing without XLA.

    Tracing follows ``run_jaxjob``: an explicit ``tracer`` (the
    in-process executor passes one parented under its ``execute`` span)
    is used as it is and left open for its owner; without one, and with
    an artifacts dir, a tracer is built from the env contract
    (``RunTracer.from_env``: the subprocess path, where the executor
    sets ``POLYAXON_TRACE_PARENT``) and closed here."""
    if job.get("kind", "jaxjob") != "jaxjob" or not job.get("runtime"):
        raise ValueError("run_torchjob requires a jaxjob with a `runtime` "
                         "section")
    cfg = RuntimeConfig.from_dict(job["runtime"])
    ckpt_job = job.get("checkpointing")
    ckpt_spec = (CheckpointSpec.from_dict(ckpt_job) if ckpt_job is not None
                 else CheckpointSpec(enabled=False))
    device = resolve_device(device)
    if bootstrap.world_size() == 1:
        devices = (list(devices) if devices is not None
                   else bootstrap.local_devices(device))
        if len(devices) > 1:
            from polyaxon_tpu_torch.runtime import local_gang

            return local_gang.run(
                job, devices=devices, device=device, mesh_axes=mesh_axes,
                artifacts_dir=artifacts_dir, on_metrics=on_metrics,
                should_stop=should_stop, tracer=tracer,
                command=gang_command, env=gang_env)
        if device.type == "cuda" and device.index is None and devices:
            device = torch.device("cuda", devices[0])

    with bootstrap.process_group(device):
        mesh = _job_mesh(job, device, mesh_axes)
        lead = bootstrap.rank() == 0
        if not lead:  # rank 0 emits, tracks and traces
            on_metrics = tracer = None
        close_tracer = False
        if tracer is None and artifacts_dir and lead:
            tracer = obs_trace.RunTracer.from_env(artifacts_dir,
                                                  component="runtime")
            close_tracer = True
        try:
            with use_mesh(mesh), _span(
                    tracer, "runtime", model=cfg.model, steps=cfg.steps,
                    devices=mesh.size) as run_span:
                return _run_torchjob(job, cfg, ckpt_spec, device, mesh,
                                     artifacts_dir=artifacts_dir,
                                     on_metrics=on_metrics,
                                     should_stop=should_stop, tracer=tracer,
                                     run_span=run_span)
        finally:
            if close_tracer:
                tracer.close()


def _run_torchjob(job: dict, cfg: RuntimeConfig, ckpt_spec: CheckpointSpec,
                  device: torch.device, mesh, *,
                  artifacts_dir: Optional[str],
                  on_metrics: Optional[MetricsCallback],
                  should_stop: Optional[Callable[[], bool]],
                  tracer: Optional[obs_trace.RunTracer],
                  run_span: Optional[obs_trace.Span]) -> TrainResult:
    family = family_of(cfg.model)
    overrides = cfg.model_overrides(type(family.CONFIGS[cfg.model]))
    if isinstance(overrides.get("dtype"), str):  # "float32", "bfloat16"
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    model_def = get_model(cfg.model, **overrides)
    model_cfg = model_def.config
    # Families whose training launches a kernel check its shapes here;
    # bert, vit, resnet and mnist launch none.
    if hasattr(family, "check_kernel_shapes"):
        family.check_kernel_shapes(model_cfg, device, training=True)

    rules = rules_for_mesh(mesh)
    logger.info("mesh axes=%s devices=%d", mesh.shape, mesh.size)

    n_ranks = bootstrap.world_size()
    per_process = bootstrap.ranks_per_process()
    n_proc = n_ranks // per_process  # the plan's processes
    if n_ranks > 1:
        bootstrap.host_group()  # made by every rank at one point
    global_batch = cfg.global_batch_size or (cfg.batch_size or 8) * mesh.size
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} must divide process count {n_proc}")
    # Every plan process draws its rows from the same seed, as the JAX
    # loop's processes do (ROADMAP.md, Queue 3: the reference's
    # duplicated per-process data). Its ranks (one, or a local gang's)
    # hold `local_blocks` row blocks of the batch axes (dp, fsdp, and ep
    # under EP_RULES) and split its rows between them, as the reference's
    # `shard_batches` lays a process's rows over its devices. The ranks
    # of a replica axis (tp, sp, pp) train the same rows; under cp every
    # rank keeps the whole rows and the model cuts its sequence shard
    # after the next-token shift. So a step trains per_host_batch /
    # local_blocks rows per batch shard. Under gradient accumulation each
    # rank's microbatch m is its block of the global batch's m-th slice,
    # as the reference cuts microbatches (``rank_rows``).
    per_host_batch = global_batch // n_proc
    first = bootstrap.rank() // per_process * per_process
    n_blocks, _ = row_block(mesh)
    local_blocks = len({row_block(mesh, r)[1]
                        for r in range(first, first + per_process)})
    accum = max(int(cfg.grad_accum_steps or 1), 1)
    if per_host_batch % (local_blocks * accum):
        raise ValueError(f"grad_accum_steps {accum} x the process's "
                         f"{local_blocks} row block(s) must divide the "
                         f"per-process batch {per_host_batch} (global batch "
                         f"{global_batch})")
    dataset_name = cfg.dataset or data_lib.dataset_for_model(cfg.model)
    ds_kwargs = _dataset_kwargs(cfg, model_cfg, per_host_batch)
    seq = ds_kwargs.get("seq_len", 1)
    # The units a step trains (throughput and MFU count these; the JAX
    # loop counts global_batch x seq under every axis: ROADMAP.md,
    # Queue 3).
    units_per_step = (per_host_batch // local_blocks * n_blocks
                      * (seq if model_def.unit == "tokens" else 1))

    optimizer = build_optimizer(cfg)
    if cfg.lora_rank:
        from polyaxon_tpu_torch.models.lora import (lora_model_def,
                                                    wrap_optimizer)

        model_def = lora_model_def(model_def, cfg.lora_rank, cfg.lora_alpha,
                                   cfg.lora_targets)
        optimizer = wrap_optimizer(optimizer)
        logger.info("lora: rank=%d alpha=%s targets=%s", cfg.lora_rank,
                    cfg.lora_alpha, cfg.lora_targets or "default")
    # Placed before the optimizer state is built, so the moments are
    # made for this rank's shards only.
    state = build_init(model_def, optimizer, device=device, mesh=mesh,
                       rules=rules)(cfg.seed)
    train_step = build_train_step(model_def, optimizer, accum_steps=accum,
                                  mesh=mesh)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    logger.info("model=%s params=%.2fM bytes=%.1fMB device=%s accum=%d",
                cfg.model, n_params / 1e6,
                param_bytes(state["params"]) / 1e6, device, accum)
    if cfg.steps <= 0:
        return TrainResult(steps=0, final_metrics={}, throughput=0.0,
                           unit=model_def.unit, units_per_step=0,
                           wall_time=0.0, param_count=n_params)

    ckpt: Optional[TieredCheckpointManager] = None
    ckpt_bytes = 0
    restored_from = None
    restore_skipped: list[int] = []
    restore_tier: Optional[str] = None
    if artifacts_dir and ckpt_spec.enabled:
        ckpt = TieredCheckpointManager(
            os.path.join(artifacts_dir, "checkpoints"), ckpt_spec)
        ckpt.writer = bootstrap.rank() == 0
        ckpt_bytes = _log_checkpoint_budget(ckpt, state)
        if ckpt_spec.restore_on_start and ckpt.latest_step() is not None:
            with _span(tracer, "restore") as sp:
                state = ckpt.restore(state)
                restored_from = int(state["step"])
                restore_skipped = list(ckpt.last_restore_skipped)
                restore_tier = ckpt.last_restore_tier
                if sp is not None:
                    sp.set(restored_from_step=restored_from,
                           skipped_steps=restore_skipped,
                           restore_tier=restore_tier)
    start_step = int(state["step"])
    if start_step >= cfg.steps:
        if ckpt:
            ckpt.close()
        return TrainResult(
            steps=start_step, final_metrics={}, throughput=0.0,
            unit=model_def.unit, units_per_step=0, wall_time=0.0,
            param_count=n_params, restored_from_step=restored_from,
            restore_skipped_steps=restore_skipped, restore_tier=restore_tier,
            checkpoint=_checkpoint_report(ckpt, ckpt_bytes) if ckpt else {})
    if ckpt:
        t_prep = time.perf_counter()
        ckpt.prepare(state)
        logger.info("checkpoint: host snapshot buffer ready in %.2fs",
                    time.perf_counter() - t_prep)

    pin = device.type == "cuda"
    prefetcher = None
    # Batch i is a function of (seed, i): a restored run resumes the
    # stream at its step, and the warm-up step below consumes batch
    # `start_step`.
    # Each rank lays its rows out so that its microbatches are its blocks
    # of the global batch's (``rank_rows``).
    host = data_lib.host_batches(
        (rank_rows(b, mesh, accum, local_blocks) for b in data_lib.get_dataset(
            dataset_name, start_batch=start_step, **ds_kwargs)),
        pin=pin)
    if cfg.prefetch > 0:
        host = prefetcher = data_lib.PrefetchIterator(host, depth=cfg.prefetch)
    try:
        batches = data_lib.device_batches(host, device)
        run_eval = None
        if cfg.eval_every:
            eval_step = build_eval_step(model_def, mesh=mesh)
            eval_kwargs = dict(ds_kwargs, seed=cfg.seed + 104_729)
            if cfg.extras.get("eval_path"):  # a held-out corpus
                eval_kwargs["path"] = cfg.extras["eval_path"]
            n_eval = max(cfg.eval_steps, 1)
            eval_iter = data_lib.device_batches(data_lib.host_batches(
                data_lib.get_dataset(dataset_name, start_batch=0,
                                     **eval_kwargs), pin=pin), device)
            eval_batches = [next(eval_iter) for _ in range(n_eval)]

            def run_eval(state) -> dict[str, float]:
                sums: dict[str, float] = {}
                for batch in eval_batches:
                    for k, v in eval_step(state, batch).items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                return {f"eval_{k}": v / n_eval for k, v in sums.items()}

        # Warm-up outside the timed window: the first step builds the
        # kernels and fills PyTorch's caches. It is a real training step.
        with _span(tracer, "jit_compile") as sp:
            t_first = time.perf_counter()
            state, metrics = train_step(state, next(batches))
            _sync(device)
            compile_time_s = time.perf_counter() - t_first
            if sp is not None:
                sp.set(compile_time_s=round(compile_time_s, 3))

        flops_unit = (train_flops_per_token(cfg.model, seq, n_params)
                      if model_def.unit == "tokens" else None)
        peak = (peak_flops(torch.cuda.get_device_name(device))
                if device.type == "cuda" else None)
        last_eval: dict[str, float] = {}
        evaled_at = -1
        # Only timed steps enter a window. The JAX loop starts this count
        # at 1 (the warm-up step, for its trace spans), so its first
        # window halves step_time_ms and doubles tokens/s (ROADMAP.md,
        # Queue 3).
        steps_since_emit = 0
        window_from = start_step  # the warm-up step opens the first window
        stop_s, stop_checks = 0.0, 0
        emitted_compile = False
        wait_window = wait_total = 0.0
        timed_steps = 0
        off_clock = 0.0  # eval, checkpoint stalls and profiled steps
        t0 = t_emit = time.perf_counter()
        t_emit_wall = time.time()  # wall twin of t_emit for step spans
        for step in range(start_step + 1, cfg.steps):
            t_stop = time.perf_counter()
            stop = _stop_agreed(should_stop, n_ranks)
            stop_s += time.perf_counter() - t_stop
            stop_checks += 1
            if stop:
                logger.info("stop requested at step %d", step)
                break
            profiler = None
            if cfg.profile_steps and step in cfg.profile_steps \
                    and artifacts_dir:
                _sync(device)
                t_prof = time.perf_counter()
                profiler = _StepProfiler(artifacts_dir, step, device)
            t_wait = time.perf_counter()
            batch = next(batches)
            dt_wait = time.perf_counter() - t_wait
            state, metrics = train_step(state, batch)
            if profiler is not None:
                # The traced step stays off the clock and out of the
                # window: the profiler's cost is not the step's.
                profiler.stop()
                dt_prof = time.perf_counter() - t_prof
                t_emit += dt_prof
                t_emit_wall = time.time()
                off_clock += dt_prof
            else:
                wait_window += dt_wait
                wait_total += dt_wait
                timed_steps += 1
                steps_since_emit += 1
            if on_metrics and (step % cfg.log_every == 0
                               or step == cfg.steps - 1):
                vals = {k: float(v) for k, v in metrics.items()}
                _sync(device)
                window = time.perf_counter() - t_emit
                if window > 0 and steps_since_emit:
                    ups = units_per_step * steps_since_emit / window
                    vals[f"{model_def.unit}_per_sec"] = ups
                    vals["step_time_ms"] = 1e3 * window / steps_since_emit
                    vals["input_wait_ms"] = 1e3 * wait_window / steps_since_emit
                    if flops_unit:
                        achieved = ups * flops_unit / mesh.size
                        vals["tflops_per_sec_per_chip"] = achieved / 1e12
                        if peak:
                            vals["mfu"] = achieved / peak
                if not emitted_compile:
                    vals["compile_time_s"] = compile_time_s
                    emitted_compile = True
                # The emission window is one `step` span and one
                # histogram sample, as in the JAX loop.
                if steps_since_emit and window > 0:
                    obs_metrics.training_step_hist().observe(
                        window / steps_since_emit)
                if tracer is not None and steps_since_emit:
                    tracer.record_completed(
                        "step", start=t_emit_wall, end=time.time(),
                        parent_id=(run_span.span_id if run_span is not None
                                   else None),
                        attributes={
                            "from_step": window_from,
                            "to_step": step,
                            "steps": steps_since_emit,
                            **{k: round(vals[k], 3) for k in
                               ("step_time_ms", "input_wait_ms", "loss")
                               if k in vals},
                        })
                steps_since_emit = 0
                window_from = step + 1
                wait_window = 0.0
                if tracer is not None:
                    # The flight ring keeps the last emissions a dying
                    # run saw.
                    obs_flight.RECORDER.note(
                        tracer.trace_id, "metrics", step=step,
                        **{k: round(float(v), 5) for k, v in vals.items()})
                on_metrics(step, vals)
                t_emit = time.perf_counter()
                t_emit_wall = time.time()
            if run_eval is not None and step % cfg.eval_every == 0:
                _sync(device)
                t_eval = time.perf_counter()
                with _span(tracer, "eval", step=step):
                    last_eval = run_eval(state)
                evaled_at = state["step"]
                if on_metrics:
                    on_metrics(step, last_eval)
                dt_eval = time.perf_counter() - t_eval
                t_emit += dt_eval
                t_emit_wall = time.time()
                off_clock += dt_eval
            if ckpt and ckpt.should_save(step):
                # The save's stall (the previous commit, then the host
                # copy) is kept off the training clock, as eval is.
                t_save = time.perf_counter()
                with _span(tracer, "checkpoint", step=step):
                    _save(ckpt, step, state, n_ranks)
                dt_save = time.perf_counter() - t_save
                t_emit += dt_save
                t_emit_wall = time.time()
                off_clock += dt_save
        _sync(device)
        wall = time.perf_counter() - t0 - off_clock
        final_metrics = {k: float(v) for k, v in metrics.items()}
        if run_eval is not None:
            if evaled_at != state["step"]:
                last_eval = run_eval(state)
                if on_metrics:
                    on_metrics(max(state["step"] - 1, 0), last_eval)
            final_metrics.update(last_eval)
        final_step = state["step"]
        # Flush the un-emitted window (an early stop lands between
        # emissions), so the step spans cover every step trained.
        if tracer is not None and window_from < final_step:
            window = time.perf_counter() - t_emit
            attrs = {"from_step": window_from, "to_step": final_step - 1,
                     "steps": steps_since_emit}
            if window > 0 and steps_since_emit:
                attrs["step_time_ms"] = round(
                    1e3 * window / steps_since_emit, 3)
                attrs["input_wait_ms"] = round(
                    1e3 * wait_window / steps_since_emit, 3)
                obs_metrics.training_step_hist().observe(
                    window / steps_since_emit)
            elif window > 0:
                # A segment stopped right after its warm-up step: the
                # window holds that step alone and the time since it, as
                # the JAX loop's window that counts its warm-up step.
                attrs["step_time_ms"] = round(1e3 * window, 3)
                attrs["input_wait_ms"] = 0.0
            if "loss" in final_metrics:
                attrs["loss"] = round(final_metrics["loss"], 3)
            tracer.record_completed(
                "step", start=t_emit_wall, end=time.time(),
                parent_id=(run_span.span_id if run_span is not None
                           else None),
                attributes=attrs)
        if ckpt:
            with _span(tracer, "checkpoint", step=final_step, final=True):
                _save(ckpt, final_step, state, n_ranks, force=True)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if ckpt:
            ckpt.close()  # waits for the final commit

    throughput = (units_per_step * timed_steps / wall
                  if wall > 0 and timed_steps else 0.0)
    return TrainResult(
        steps=state["step"], final_metrics=final_metrics,
        throughput=throughput, unit=model_def.unit,
        units_per_step=units_per_step, wall_time=wall, param_count=n_params,
        restored_from_step=restored_from,
        restore_skipped_steps=restore_skipped, restore_tier=restore_tier,
        input_wait_ms=1e3 * wait_total / timed_steps if timed_steps else 0.0,
        compile_time_s=compile_time_s,
        stop_check_ms=1e3 * stop_s / stop_checks if stop_checks else 0.0,
        checkpoint=_checkpoint_report(ckpt, ckpt_bytes) if ckpt else {})

