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
alone keeps the tracking record.

A process that holds several devices (every card of the host, or the
ids in ``POLYAXON_TPU_LOCAL_DEVICE_IDS``: ``bootstrap.local_devices``)
trains as a local gang instead (``runtime/local_gang.py``): it runs its
own command again once per device, as ranks ``p·D .. p·D + D - 1`` of
the plan's ``P·D``, supervises them and keeps the tracking record from
what rank 0 prints; its ``launches`` line sums its ranks'. A rank of
such a gang (``POLYAXON_TPU_GANG_DEVICE`` set) keeps no record: rank 0
prints its emissions and result, stops when the supervisor's stop file
appears, and the mesh takes ``POLYAXON_TPU_MESH_AXES`` when set. Exit
codes: 2 without a spec, 0 on success, 1 on a failure (after printing
the traceback).
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


def emit_launches() -> None:
    """Print this process's kernel launches and its local gangs' ranks'
    as one JSON line (``{"launches": {...}}``): the launcher's last line,
    and what ``plx-torch serve`` prints as it stops."""
    from polyaxon_tpu_torch.ops import flash, paged_attention
    from polyaxon_tpu_torch.runtime.local_gang import LAUNCHES

    own = {"flash_fwd": flash.launches,
           "flash_bwd_dkdv": flash.bwd_dkdv_launches,
           "flash_bwd_dq": flash.bwd_dq_launches,
           "paged_decode": paged_attention.launches}
    print(json.dumps({"launches": {k: v + LAUNCHES.get(k, 0)
                                   for k, v in own.items()}}), flush=True)


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
    from polyaxon_tpu_torch.device import resolve_device
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.parallel import bootstrap
    from polyaxon_tpu_torch.runtime import local_gang
    from polyaxon_tpu_torch.tracking.run import Run

    run_uuid = os.environ.get(ENV_RUN_UUID, "local")
    artifacts_dir = os.environ.get(ENV_ARTIFACTS_PATH) or os.path.join(
        os.getcwd(), ".plx-runs", run_uuid)
    os.makedirs(artifacts_dir, exist_ok=True)

    group = bootstrap.read_env_contract()
    in_gang = local_gang.supervised()
    if in_gang:
        local_gang.die_with_parent()
        device = device or os.environ[local_gang.ENV_GANG_DEVICE]
    lead = group.process_id == 0
    tracking = None
    if lead and not in_gang:
        tracking = Run(run_uuid, artifacts_dir, collect_system_metrics=True)
        tracking.log_status(V1Statuses.RUNNING)
        log_metrics = tracking.log_metrics_cb()

    def on_metrics(step: int, vals: dict) -> None:
        log_metrics(step, vals)
        _emit(step, vals)

    try:
        from polyaxon_tpu_torch.runtime.loop import run_torchjob

        job = json.loads(spec_json)
        devices = [] if in_gang else bootstrap.local_devices(device)
        if devices:
            logging.getLogger(__name__).info(
                "local devices %s (%s=%s)", devices,
                bootstrap.ENV_LOCAL_DEVICE_IDS,
                os.environ.get(bootstrap.ENV_LOCAL_DEVICE_IDS, ""))
        if len(devices) > 1:
            result = local_gang.run(
                job, devices=devices, device=resolve_device(device),
                artifacts_dir=artifacts_dir,
                on_metrics=on_metrics if tracking else None,
                command=[sys.executable, *sys.orig_argv[1:]],
                process_id=group.process_id,
                num_processes=group.num_processes,
                coordinator=group.coordinator)
        else:
            bootstrap.initialize(group, device=device)
            axes = os.environ.get(local_gang.ENV_MESH_AXES)
            stop_file = os.environ.get(local_gang.ENV_STOP_FILE)
            result = run_torchjob(
                job, artifacts_dir=artifacts_dir,
                on_metrics=(on_metrics if tracking
                            else _emit if in_gang and lead else None),
                mesh_axes=json.loads(axes) if axes else None,
                should_stop=((lambda: os.path.exists(stop_file))
                             if in_gang and lead and stop_file else None),
                device=device)
        if in_gang and lead:
            print(json.dumps({"outputs": dataclasses.asdict(result)}),
                  flush=True)
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
        emit_launches()


if __name__ == "__main__":
    sys.exit(main())
