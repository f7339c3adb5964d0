"""System metrics (port of ``polyaxon_tpu/tracking/systemmetrics.py``):
host and GPU samples, taken by a background thread.

The host sample reads ``/proc/stat``, ``/proc/meminfo``,
``os.getloadavg`` and ``shutil.disk_usage`` (no psutil) and keeps the
reference's key names. ``gpu_metrics`` takes the place of the
reference's ``tpu_metrics`` and ``libtpu_metrics``, with keys
``gpu<i>_*``:

- memory, from the caching allocator's host-side counters
  (``torch.cuda.memory_stats``) and ``torch.cuda.mem_get_info``: in use,
  reserved, limit, percent and peak. Neither call waits on a stream, and
  both are skipped until the process itself has initialized CUDA, so
  the sampler never creates a context or synchronizes training;
- utilization, power, temperature and SM clock, from one
  ``nvidia-smi --query-gpu=... --format=csv,noheader,nounits`` per
  sample.

A telemetry source that fails latches off for the life of the process,
as the reference's libtpu probe does.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)

_cpu_last: dict = {}


def _cpu_percent() -> float:
    """Busy share of all CPUs since the previous call (0.0 on the first
    call, as ``psutil.cpu_percent(interval=None)`` gives)."""
    with open("/proc/stat") as fh:
        fields = [int(x) for x in fh.readline().split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)  # idle+iowait
    total = sum(fields[:8])  # guest time is already in user/nice
    last = _cpu_last.get("sample")
    _cpu_last["sample"] = (idle, total)
    if last is None or total <= last[1]:
        return 0.0
    return 100.0 * (1.0 - (idle - last[0]) / (total - last[1]))


def meminfo() -> dict[str, int]:
    """``/proc/meminfo`` in bytes."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[key] = int(parts[0]) * 1024  # kB
    return out


def host_metrics() -> dict[str, float]:
    """``cpu_percent``, ``memory_used_gb``, ``memory_percent``,
    ``disk_used_percent`` and ``load_1m``, computed as psutil computes
    them on Linux; a key whose source is missing is left out."""
    out: dict[str, float] = {}
    try:
        out["cpu_percent"] = _cpu_percent()
    except (OSError, ValueError, IndexError):
        pass
    try:
        mem = meminfo()
        total = mem["MemTotal"]
        cached = mem.get("Cached", 0) + mem.get("SReclaimable", 0)
        used = total - mem["MemFree"] - mem.get("Buffers", 0) - cached
        if used < 0:
            used = total - mem["MemFree"]
        avail = mem.get("MemAvailable", mem["MemFree"])
        out["memory_used_gb"] = used / 2**30
        out["memory_percent"] = 100.0 * (total - avail) / total
    except (OSError, ValueError, KeyError, ZeroDivisionError):
        pass
    try:
        disk = shutil.disk_usage("/")
        out["disk_used_percent"] = 100.0 * disk.used / (disk.used + disk.free)
    except (OSError, ZeroDivisionError):
        pass
    try:
        out["load_1m"] = os.getloadavg()[0]
    except OSError:
        pass
    return out


# nvidia-smi query field -> emitted key suffix.
_SMI_FIELDS = {
    "utilization.gpu": "utilization_pct",
    "utilization.memory": "memory_util_pct",
    "power.draw": "power_w",
    "temperature.gpu": "temperature_c",
    "clocks.sm": "sm_clock_mhz",
}
_state: dict = {"memory": True, "smi": True}


def _visible_indices() -> Optional[list[str]]:
    """Physical indices of the visible GPUs in torch's order, or None
    when every GPU is visible."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return None
    return [v.strip() for v in visible.split(",") if v.strip()]


def _memory_metrics() -> dict[str, float]:
    out: dict[str, float] = {}
    import torch

    if not torch.cuda.is_initialized():
        return out  # never create a context from the sampler
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats.get("reserved_bytes.all.peak"):
            continue  # a device this process never used: no context there
        in_use = stats.get("allocated_bytes.all.current", 0)
        _, limit = torch.cuda.mem_get_info(i)
        out[f"gpu{i}_hbm_used_gb"] = in_use / 2**30
        out[f"gpu{i}_hbm_reserved_gb"] = (
            stats.get("reserved_bytes.all.current", 0) / 2**30)
        out[f"gpu{i}_hbm_limit_gb"] = limit / 2**30
        out[f"gpu{i}_hbm_percent"] = 100.0 * in_use / limit
        out[f"gpu{i}_hbm_peak_gb"] = (
            stats.get("allocated_bytes.all.peak", 0) / 2**30)
    return out


def _smi_metrics() -> dict[str, float]:
    cmd = ["nvidia-smi", "--query-gpu=index," + ",".join(_SMI_FIELDS),
           "--format=csv,noheader,nounits"]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=10,
                         check=True)
    visible = _visible_indices()
    out: dict[str, float] = {}
    for line in res.stdout.strip().splitlines():
        cells = [c.strip() for c in line.split(",")]
        if visible is None:
            i = int(cells[0])
        elif cells[0] in visible:
            i = visible.index(cells[0])
        else:
            continue
        for suffix, raw in zip(_SMI_FIELDS.values(), cells[1:]):
            try:
                out[f"gpu{i}_{suffix}"] = float(raw)
            except ValueError:  # "[N/A]" on parts that lack the sensor
                continue
    return out


def gpu_metrics() -> dict[str, float]:
    """Per-GPU samples, keys ``gpu<i>_*``; empty without a GPU. Each
    source that raises is disabled for the rest of the process."""
    out: dict[str, float] = {}
    for source, fn in (("memory", _memory_metrics), ("smi", _smi_metrics)):
        if not _state[source]:
            continue
        try:
            out.update(fn())
        except Exception as exc:  # noqa: BLE001 — telemetry must not fail
            _state[source] = False
            logger.debug("gpu %s metrics disabled: %s", source, exc)
    return out


class SystemMetricsMonitor:
    """Background sampler thread; emits through a callback (the tracking
    Run wires it to ``log_metrics(kind='system')``)."""

    def __init__(
        self,
        emit: Callable[[dict[str, float]], None],
        interval_seconds: float = 10.0,
        include_gpu: bool = True,
    ):
        self.emit = emit
        self.interval = interval_seconds
        self.include_gpu = include_gpu
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample(self) -> dict[str, float]:
        metrics = host_metrics()
        if self.include_gpu:
            metrics.update(gpu_metrics())
        return metrics

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.emit(self.sample())
            except Exception as exc:
                # sampling must never kill the training process
                logger.debug("system metrics sample dropped: %s", exc)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name="plx-sysmetrics", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
