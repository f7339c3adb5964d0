"""Process entry point of a training run (port of
``polyaxon_tpu/runtime/launch.py``)::

    POLYAXON_JAXJOB_SPEC='{"runtime": {"model": "llama_200m", ...}}' \
        python -m polyaxon_tpu_torch.runtime.launch

Reads the job spec (JSON) from ``POLYAXON_JAXJOB_SPEC`` and the run's
artifacts directory from ``POLYAXON_RUN_ARTIFACTS_PATH`` (default
``./.plx-runs/<POLYAXON_RUN_UUID or "local">``), trains on the card and
logs each metrics emission, then the run's outputs, as one JSON line on
stdout. Tracking (``tracking/run.py``) is not ported. Exit codes: 2
without a spec, 0 on success, 1 on a failure (after printing the
traceback).
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


def main() -> int:
    logging.basicConfig(
        level=os.environ.get("POLYAXON_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    spec_json = os.environ.get(ENV_JAXJOB_SPEC)
    if not spec_json:
        print(f"{ENV_JAXJOB_SPEC} is not set", file=sys.stderr)
        return 2
    try:
        from polyaxon_tpu_torch.runtime.loop import run_torchjob

        job = json.loads(spec_json)
        run_uuid = os.environ.get(ENV_RUN_UUID, "local")
        artifacts_dir = os.environ.get(ENV_ARTIFACTS_PATH) or os.path.join(
            os.getcwd(), ".plx-runs", run_uuid)
        os.makedirs(artifacts_dir, exist_ok=True)
        result = run_torchjob(job, artifacts_dir=artifacts_dir,
                              on_metrics=_emit)
        print(json.dumps({"outputs": dataclasses.asdict(result)}),
              flush=True)
        return 0
    except Exception:  # noqa: BLE001 — reported, then the exit code says so
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
