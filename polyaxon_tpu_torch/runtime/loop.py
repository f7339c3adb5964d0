"""The training loop (port of ``polyaxon_tpu/runtime/loop.py``): job
spec → model → data → train step → metrics, on one device.

``run_torchjob`` takes the job as a dict (the JSON form of a jaxjob run
spec: ``runtime``, and optionally ``mesh`` and ``checkpointing``) and
follows ``_run_jaxjob``: restore from the newest committed checkpoint,
one warm-up step outside the timed window (reported once as
``compile_time_s``; here it is the first step's wall time, kernel
builds included), emissions every ``log_every`` steps, periodic eval
over a fixed batch set, checkpoints every ``intervalSteps`` and at the
end, ``profile_steps`` traced by ``torch.profiler``, and
``should_stop``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Any, Callable, Optional

import torch

from polyaxon_tpu_torch.device import resolve_device
from polyaxon_tpu_torch.models import get_model, llama
from polyaxon_tpu_torch.runtime import data as data_lib
from polyaxon_tpu_torch.runtime.checkpoint import (CheckpointSpec,
                                                   TieredCheckpointManager)
from polyaxon_tpu_torch.runtime.config import RuntimeConfig
from polyaxon_tpu_torch.runtime.flops import peak_flops, train_flops_per_token
from polyaxon_tpu_torch.runtime.optim import build_optimizer, tree_leaves
from polyaxon_tpu_torch.runtime.step import (build_eval_step, build_init,
                                             build_train_step)

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
    # Checkpoint accounting, empty without checkpointing: bytes per
    # checkpoint, and seconds per save (the step loop's stall: waiting for
    # the previous commit, then the host copy), per commit and per restore
    # by tier.
    checkpoint: dict = dataclasses.field(default_factory=dict)


def _check_single_device(job: dict) -> None:
    axes = (job.get("mesh") or {}).get("axes") or {}
    size = 1
    for name, n in axes.items():
        if n != -1:
            size *= int(n)
    if size != 1:
        raise ValueError(
            f"mesh axes {axes} need {size} devices; the port trains on one "
            "device (the parallel layer is ROADMAP.md, Queue 1 item 7)")


def _check_ported(cfg: RuntimeConfig) -> None:
    if cfg.lora_rank > 0:
        raise NotImplementedError(
            "LoRA (lora_rank > 0) is not ported yet: ROADMAP.md, Queue 1 "
            "item 3b")


def _dataset_kwargs(cfg: RuntimeConfig, model_cfg, batch: int) -> dict:
    kwargs: dict[str, Any] = {"batch_size": batch, "seed": cfg.seed}
    for key in ("path", "tokenizer"):
        if key in cfg.extras:
            kwargs[key] = cfg.extras[key]
    kwargs["seq_len"] = cfg.seq_len or min(model_cfg.max_seq_len, 2048)
    kwargs["vocab_size"] = model_cfg.vocab_size
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


def run_torchjob(job: dict, *, artifacts_dir: Optional[str] = None,
                 on_metrics: Optional[MetricsCallback] = None,
                 should_stop: Optional[Callable[[], bool]] = None,
                 device=None) -> TrainResult:
    """Train the job's ``runtime`` section on one device (``cuda`` unless
    the caller names another; raises without a GPU). The mesh must
    resolve to one device. With an artifacts dir, ``checkpointing``
    saves to and restores from ``<artifacts>/checkpoints`` and
    ``profile_steps`` traces to ``<artifacts>/profile``. ``lora_rank >
    0`` raises NotImplementedError; ``compile_cache_dir`` is accepted
    and means nothing without XLA."""
    if job.get("kind", "jaxjob") != "jaxjob" or not job.get("runtime"):
        raise ValueError("run_torchjob requires a jaxjob with a `runtime` "
                         "section")
    cfg = RuntimeConfig.from_dict(job["runtime"])
    _check_single_device(job)
    _check_ported(cfg)
    ckpt_job = job.get("checkpointing")
    ckpt_spec = (CheckpointSpec.from_dict(ckpt_job) if ckpt_job is not None
                 else CheckpointSpec(enabled=False))
    device = resolve_device(device)

    # Only the llama family is ported: get_model refuses any other name.
    overrides = cfg.model_overrides(llama.LlamaConfig)
    if isinstance(overrides.get("dtype"), str):  # "float32", "bfloat16"
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    model_def = get_model(cfg.model, **overrides)
    model_cfg = model_def.config
    llama.check_kernel_shapes(model_cfg, device, training=True)

    global_batch = cfg.global_batch_size or (cfg.batch_size or 8)
    accum = max(int(cfg.grad_accum_steps or 1), 1)
    if global_batch % accum:
        raise ValueError(f"grad_accum_steps {accum} must divide the global "
                         f"batch {global_batch}")
    dataset_name = cfg.dataset or data_lib.dataset_for_model(cfg.model)
    ds_kwargs = _dataset_kwargs(cfg, model_cfg, global_batch)
    seq = ds_kwargs["seq_len"]
    units_per_step = global_batch * (seq if model_def.unit == "tokens" else 1)

    optimizer = build_optimizer(cfg)
    state = build_init(model_def, optimizer, device=device)(cfg.seed)
    train_step = build_train_step(model_def, optimizer, accum_steps=accum)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    logger.info("model=%s params=%.2fM device=%s accum=%d", cfg.model,
                n_params / 1e6, device, accum)
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
        ckpt_bytes = _log_checkpoint_budget(ckpt, state)
        if ckpt_spec.restore_on_start and ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            restored_from = int(state["step"])
            restore_skipped = list(ckpt.last_restore_skipped)
            restore_tier = ckpt.last_restore_tier
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
    host = data_lib.host_batches(
        data_lib.get_dataset(dataset_name, start_batch=start_step,
                             **ds_kwargs),
        pin=pin)
    if cfg.prefetch > 0:
        host = prefetcher = data_lib.PrefetchIterator(host, depth=cfg.prefetch)
    try:
        batches = data_lib.device_batches(host, device)
        run_eval = None
        if cfg.eval_every:
            eval_step = build_eval_step(model_def)
            eval_kwargs = dict(ds_kwargs, seed=cfg.seed + 104_729)
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
        t_first = time.perf_counter()
        state, metrics = train_step(state, next(batches))
        _sync(device)
        compile_time_s = time.perf_counter() - t_first

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
        emitted_compile = False
        wait_window = wait_total = 0.0
        timed_steps = 0
        off_clock = 0.0  # eval, checkpoint stalls and profiled steps
        t0 = t_emit = time.perf_counter()
        for step in range(start_step + 1, cfg.steps):
            if should_stop is not None and should_stop():
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
                        achieved = ups * flops_unit
                        vals["tflops_per_sec_per_chip"] = achieved / 1e12
                        if peak:
                            vals["mfu"] = achieved / peak
                if not emitted_compile:
                    vals["compile_time_s"] = compile_time_s
                    emitted_compile = True
                steps_since_emit = 0
                wait_window = 0.0
                on_metrics(step, vals)
                t_emit = time.perf_counter()
            if run_eval is not None and step % cfg.eval_every == 0:
                _sync(device)
                t_eval = time.perf_counter()
                last_eval = run_eval(state)
                evaled_at = state["step"]
                if on_metrics:
                    on_metrics(step, last_eval)
                dt_eval = time.perf_counter() - t_eval
                t_emit += dt_eval
                off_clock += dt_eval
            if ckpt and ckpt.should_save(step):
                # The save's stall (the previous commit, then the host
                # copy) is kept off the training clock, as eval is.
                t_save = time.perf_counter()
                ckpt.save(step, state)
                dt_save = time.perf_counter() - t_save
                t_emit += dt_save
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
        if ckpt:
            ckpt.save(state["step"], state, force=True)
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
        checkpoint=_checkpoint_report(ckpt, ckpt_bytes) if ckpt else {})

