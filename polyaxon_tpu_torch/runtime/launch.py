"""Process entry point of a training run (port of
``polyaxon_tpu/runtime/launch.py``)::

    POLYAXON_JAXJOB_SPEC='{"runtime": {"model": "llama_200m", ...}}' \
        python -m polyaxon_tpu_torch.runtime.launch

Reads the job spec (JSON) from ``POLYAXON_JAXJOB_SPEC`` and the run's
artifacts directory from ``POLYAXON_RUN_ARTIFACTS_PATH`` (default
``./.plx-runs/<POLYAXON_RUN_UUID or "local">``) and trains on the card.
The run's tracking record goes into the artifacts directory as the JAX
package writes it (``tracking/run.py``): statuses (``running``, then
``succeeded`` or ``failed``), a metric event per emitted value, system
metrics, and the outputs (steps, throughput, restore audit, final
metrics). Each emission and then the run's result are also printed as
one JSON line on stdout, and last the process's kernel launches,
``{"launches": {"flash_fwd": n, "flash_bwd_dkdv": n, "flash_bwd_dq": n,
"paged_decode": n}}`` (the counters of ``ops/flash.py`` and
``ops/paged_attention.py``; the executor writes stdout to
``<artifacts>/logs/main-<i>.log``). With ``checkpointing`` in the spec the run
saves under ``<artifacts>/checkpoints`` and, started again on the same
directory, resumes from the newest committed step. Every process of a
gang runs this entry: it starts the process group from the plan's env
contract (``parallel/bootstrap.py``: NCCL on the card, gloo on the CPU;
one process is a one-rank group) and destroys it at the end; rank 0
alone keeps the tracking record. Exit codes: 2 without a spec, 0 on
success, 1 on a failure (after printing the traceback).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import traceback

ENV_JAXJOB_SPEC = "POLYAXON_JAXJOB_SPEC"
ENV_ARTIFACTS_PATH = "POLYAXON_RUN_ARTIFACTS_PATH"
ENV_RUN_UUID = "POLYAXON_RUN_UUID"


def _emit(step: int, vals: dict) -> None:
    print(json.dumps({"step": step, **vals}), flush=True)


def _emit_launches() -> None:
    from polyaxon_tpu_torch.ops import flash, paged_attention

    print(json.dumps({"launches": {
        "flash_fwd": flash.launches,
        "flash_bwd_dkdv": flash.bwd_dkdv_launches,
        "flash_bwd_dq": flash.bwd_dq_launches,
        "paged_decode": paged_attention.launches}}), flush=True)


def main(device=None) -> int:
    """Run the job in ``POLYAXON_JAXJOB_SPEC`` on ``device`` (the card
    unless the caller names another)."""
    logging.basicConfig(
        level=os.environ.get("POLYAXON_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    spec_json = os.environ.get(ENV_JAXJOB_SPEC)
    if not spec_json:
        print(f"{ENV_JAXJOB_SPEC} is not set", file=sys.stderr)
        return 2
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.tracking.run import Run

    run_uuid = os.environ.get(ENV_RUN_UUID, "local")
    artifacts_dir = os.environ.get(ENV_ARTIFACTS_PATH) or os.path.join(
        os.getcwd(), ".plx-runs", run_uuid)
    os.makedirs(artifacts_dir, exist_ok=True)

    group = bootstrap.read_env_contract()
    tracking = None
    if group.process_id == 0:
        tracking = Run(run_uuid, artifacts_dir, collect_system_metrics=True)
        tracking.log_status(V1Statuses.RUNNING)
        log_metrics = tracking.log_metrics_cb()

    def on_metrics(step: int, vals: dict) -> None:
        log_metrics(step, vals)
        _emit(step, vals)

    try:
        from polyaxon_tpu_torch.runtime.loop import run_torchjob

        bootstrap.initialize(group, device=device)
        job = json.loads(spec_json)
        result = run_torchjob(job, artifacts_dir=artifacts_dir,
                              on_metrics=on_metrics if tracking else None,
                              device=device)
        if tracking is None:
            return 0
        tracking.log_outputs(
            steps=result.steps,
            throughput=result.throughput,
            throughput_unit=f"{result.unit}/sec",
            wall_time=result.wall_time,
            param_count=result.param_count,
            # Where the checkpoint restore landed (None: a cold start),
            # so the plane can audit that a requeued run resumed.
            restored_from_step=result.restored_from_step,
            **({"restore_skipped_steps": result.restore_skipped_steps}
               if result.restore_skipped_steps else {}),
            **{f"final_{k}": v for k, v in result.final_metrics.items()},
        )
        tracking.log_succeeded()
        print(json.dumps({"outputs": dataclasses.asdict(result)}),
              flush=True)
        return 0
    except Exception as exc:  # noqa: BLE001 — reported, then the exit code says so
        traceback.print_exc()
        if tracking is not None:
            tracking.log_failed(reason=type(exc).__name__,
                                message=str(exc)[:2000])
        return 1
    finally:
        if tracking is not None:
            tracking.close()
        bootstrap.shutdown()
        _emit_launches()


if __name__ == "__main__":
    sys.exit(main())
