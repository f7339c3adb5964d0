"""In-process tracking client (port of ``polyaxon_tpu/tracking/run.py``,
with the same file contract, so the JAX package's streams read a port
run's directory as they read one of its own).

Works offline-first: writes the event/outputs/lineage contract straight
into the run's artifacts dir (which the sidecar syncs to the store).
``from_env()`` picks up the env contract injected by the compiler
(POLYAXON_RUN_UUID / POLYAXON_RUN_ARTIFACTS_PATH), so user code does:

    from polyaxon_tpu_torch.tracking import get_or_create_run
    run = get_or_create_run()
    run.log_metrics(loss=..., step=10)
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Optional

from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.tracking.events import EventWriter, V1EventKind, _now_iso
from polyaxon_tpu_torch.tracking.systemmetrics import SystemMetricsMonitor

ENV_RUN_UUID = "POLYAXON_RUN_UUID"
ENV_RUN_NAME = "POLYAXON_RUN_NAME"
ENV_ARTIFACTS_PATH = "POLYAXON_RUN_ARTIFACTS_PATH"
ENV_OUTPUTS_PATH = "POLYAXON_RUN_OUTPUTS_PATH"
ENV_PROJECT = "POLYAXON_PROJECT"

_ACTIVE: Optional["Run"] = None


class Run:
    def __init__(
        self,
        run_uuid: str,
        artifacts_dir: str,
        *,
        name: str = "",
        project: str = "",
        collect_system_metrics: bool = False,
        system_metrics_interval: float = 10.0,
    ):
        self.run_uuid = run_uuid
        self.name = name
        self.project = project
        self.artifacts_dir = artifacts_dir
        os.makedirs(self.outputs_dir, exist_ok=True)
        self._events = EventWriter(artifacts_dir)
        self._monitor: Optional[SystemMetricsMonitor] = None
        self._last_step: Optional[int] = None
        if collect_system_metrics:
            self._monitor = SystemMetricsMonitor(
                self._emit_system_metrics, interval_seconds=system_metrics_interval
            )
            self._monitor.start()

    # -- paths ------------------------------------------------------------
    @property
    def outputs_dir(self) -> str:
        return os.path.join(self.artifacts_dir, "outputs")

    @property
    def outputs_file(self) -> str:
        return os.path.join(self.artifacts_dir, "outputs.json")

    # -- metrics/events ----------------------------------------------------
    def log_metrics(self, step: Optional[int] = None, **metrics: float) -> None:
        if step is None:
            step = (self._last_step or 0) + 1
        self._last_step = step
        for name, value in metrics.items():
            self._events.metric(name, value, step=step)
        self._events.flush()

    def log_metrics_cb(self):
        """Adapter matching the runtime's ``on_metrics(step, dict)``."""
        return lambda step, metrics: self.log_metrics(step=step, **metrics)

    def _emit_system_metrics(self, metrics: dict[str, float]) -> None:
        for name, value in metrics.items():
            self._events.write(V1EventKind.SYSTEM, name, {"value": value})
        self._events.flush()

    def log_text(self, name: str, text: str, step: Optional[int] = None) -> None:
        self._events.write(V1EventKind.TEXT, name, {"step": step, "text": text})

    def log_curve(self, name: str, x: list, y: list, step: Optional[int] = None) -> None:
        self._events.write(V1EventKind.CURVE, name, {"step": step, "x": list(x), "y": list(y)})

    def log_html(self, name: str, html: str, step: Optional[int] = None) -> None:
        self._events.write(V1EventKind.HTML, name, {"step": step, "html": html})

    def _asset_path(self, group: str, rel: str) -> str:
        """Asset file path under the run tree; creates parent dirs so
        slash-namespaced names ('eval/sample') work like event names."""
        dest = os.path.join(self.artifacts_dir, "assets", group, rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        return dest

    def _asset_tag(self, step: Optional[int]) -> str:
        """Unique filename suffix: the step when given, else a
        monotonically increasing counter (no silent overwrites)."""
        if step is not None:
            return str(step)
        self._asset_seq = getattr(self, "_asset_seq", -1) + 1
        return f"u{self._asset_seq}"

    def log_image(self, name: str, image: Any, step: Optional[int] = None) -> str:
        """Array ([H,W] / [H,W,{1,3,4}]; float in 0-1 or integer in
        0-255) or an existing file path → PNG asset + image event."""
        import numpy as _np

        tag = self._asset_tag(step)
        if isinstance(image, (str, os.PathLike)):
            base = os.path.basename(str(image))
            dest = self._asset_path("images", f"{name}-{tag}-{base}")
            shutil.copy2(image, dest)
        else:
            from PIL import Image as _Image

            arr = _np.asarray(image)
            if arr.dtype != _np.uint8:
                if _np.issubdtype(arr.dtype, _np.integer):
                    arr = _np.clip(arr, 0, 255).astype(_np.uint8)
                else:
                    arr = (_np.clip(arr, 0.0, 1.0) * 255).astype(_np.uint8)
            if arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]
            dest = self._asset_path("images", f"{name}-{tag}.png")
            _Image.fromarray(arr).save(dest)
        # Events record the run-relative path: remote consumers compose it
        # with the artifact endpoints; the producer-local absolute path is
        # meaningless off-host.
        self._events.write(V1EventKind.IMAGE, name, {
            "step": step, "path": os.path.relpath(dest, self.artifacts_dir)})
        return dest

    def log_histogram(self, name: str, values: Any, *, bins: int = 30,
                      step: Optional[int] = None) -> None:
        import numpy as _np

        counts, edges = _np.histogram(_np.asarray(values).ravel(), bins=bins)
        self._events.write(V1EventKind.HISTOGRAM, name, {
            "step": step, "counts": counts.tolist(), "edges": edges.tolist()})

    def log_confusion_matrix(self, name: str, labels: list, matrix: Any,
                             step: Optional[int] = None) -> None:
        import numpy as _np

        self._events.write(V1EventKind.CONFUSION, name, {
            "step": step, "labels": list(labels),
            "matrix": _np.asarray(matrix).tolist()})

    def log_dataframe(self, name: str, df: Any, step: Optional[int] = None) -> str:
        """A pandas DataFrame (or anything with ``to_csv``) → CSV asset +
        dataframe event."""
        dest = self._asset_path("dataframes", f"{name}-{self._asset_tag(step)}.csv")
        df.to_csv(dest, index=False)
        self._events.write(V1EventKind.DATAFRAME, name, {
            "step": step, "path": os.path.relpath(dest, self.artifacts_dir)})
        return dest

    # -- outputs/lineage ---------------------------------------------------
    def log_outputs(self, **outputs: Any) -> None:
        current: dict[str, Any] = {}
        if os.path.exists(self.outputs_file):
            with open(self.outputs_file) as fh:
                current = json.load(fh)
        current.update(outputs)
        tmp = self.outputs_file + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(current, fh, indent=2, default=str)
        os.replace(tmp, self.outputs_file)

    def get_outputs(self) -> dict[str, Any]:
        if not os.path.exists(self.outputs_file):
            return {}
        with open(self.outputs_file) as fh:
            return json.load(fh)

    def log_artifact(
        self,
        path: str,
        *,
        name: Optional[str] = None,
        kind: str = V1EventKind.ARTIFACT,
        copy: bool = True,
    ) -> str:
        """Register (and by default copy) an artifact into the run tree,
        appending a lineage record."""
        name = name or os.path.basename(path)
        dest = os.path.join(self.artifacts_dir, "assets", name)
        if copy and os.path.abspath(path) != os.path.abspath(dest):
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            if os.path.isdir(path):
                shutil.copytree(path, dest, dirs_exist_ok=True)
            else:
                shutil.copy2(path, dest)
        record = {
            "timestamp": _now_iso(),
            "name": name,
            "kind": kind,
            "path": dest if copy else path,
        }
        with open(os.path.join(self.artifacts_dir, "lineage.jsonl"), "a") as fh:
            fh.write(json.dumps(record) + "\n")
        return record["path"]

    def log_model(self, path: str, *, name: str = "model", framework: str = "torch") -> str:
        return self.log_artifact(path, name=name, kind=V1EventKind.MODEL)

    # -- statuses ----------------------------------------------------------
    def log_status(self, status: V1Statuses, reason: str = "", message: str = "") -> None:
        record = {
            "timestamp": _now_iso(),
            "status": status.value if isinstance(status, V1Statuses) else status,
            "reason": reason,
            "message": message,
        }
        with open(os.path.join(self.artifacts_dir, "statuses.jsonl"), "a") as fh:
            fh.write(json.dumps(record) + "\n")

    def log_succeeded(self) -> None:
        self.log_status(V1Statuses.SUCCEEDED)

    def log_failed(self, reason: str = "", message: str = "") -> None:
        self.log_status(V1Statuses.FAILED, reason=reason, message=message)

    # -- lifecycle ---------------------------------------------------------
    def flush(self) -> None:
        self._events.flush()

    def close(self) -> None:
        if self._monitor is not None:
            self._monitor.stop()
            # Final sample so short runs still record system metrics.
            try:
                self._emit_system_metrics(self._monitor.sample())
            except Exception as exc:
                logging.getLogger(__name__).debug(
                    "final system-metrics sample dropped: %s", exc)
        self._events.close()
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def from_env(collect_system_metrics: bool = False) -> Run:
    run_uuid = os.environ.get(ENV_RUN_UUID)
    artifacts = os.environ.get(ENV_ARTIFACTS_PATH)
    if not run_uuid or not artifacts:
        raise RuntimeError(
            f"Tracking env contract missing ({ENV_RUN_UUID}/{ENV_ARTIFACTS_PATH}); "
            "running outside a compiled run? Use Run(...) directly."
        )
    return Run(
        run_uuid,
        artifacts,
        name=os.environ.get(ENV_RUN_NAME, ""),
        project=os.environ.get(ENV_PROJECT, ""),
        collect_system_metrics=collect_system_metrics,
    )


def get_or_create_run(collect_system_metrics: bool = False) -> Run:
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = from_env(collect_system_metrics=collect_system_metrics)
    return _ACTIVE
