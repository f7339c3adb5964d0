"""The port's tracking (``polyaxon_tpu_torch.tracking``) and its launcher
against the JAX package, on the CPU.

A port ``Run`` and a JAX ``Run`` make the same calls into two run
directories of one store; the JAX package's ``StreamsService`` must read
both the same way (metrics, events, outputs, statuses, artifacts,
lineage) and the files must be the same, line for line, once the
timestamps are taken out. Every comparison is exact: both sides write
the same JSON from the same values. The launcher is run in-process with
``device="cpu"``; the host sampler is checked with psutil unimportable.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from polyaxon_tpu.streams.service import StreamsService
from polyaxon_tpu.tracking import run as jrun
from polyaxon_tpu.tracking import systemmetrics as jsys
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.tracking import events as tevents
from polyaxon_tpu_torch.tracking import run as trun
from polyaxon_tpu_torch.tracking import systemmetrics as tsys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Frame:
    """Anything with ``to_csv`` is logged as a dataframe."""

    def to_csv(self, path, index=False):
        with open(path, "w") as fh:
            fh.write("a,b\n1,2\n")


def _drive(run, tmp_path):
    """The same calls, whichever package's Run."""
    run.log_metrics(step=1, loss=2.5, accuracy=0.25)
    run.log_metrics(loss=2.25)  # auto step: 2
    run.log_metrics(step=5, **{"eval/loss": 2.0})
    run.log_text("note", "hello", step=1)
    run.log_curve("roc", [0.0, 0.5, 1.0], [0.0, 0.8, 1.0], step=2)
    run.log_html("report", "<b>x</b>")
    run.log_histogram("w", np.arange(10.0), bins=5, step=3)
    run.log_confusion_matrix("cm", ["a", "b"], [[1, 0], [2, 3]], step=3)
    run.log_image("img", np.linspace(0, 1, 12).reshape(3, 4), step=4)
    run.log_dataframe("table", _Frame(), step=4)
    src = tmp_path / f"model-{run.run_uuid}.bin"
    src.write_bytes(b"weights")
    run.log_model(str(src), name="model.bin")
    run.log_artifact(str(src), name="extra/blob.bin")
    run.log_outputs(steps=6, throughput=1.5)
    run.log_outputs(restored_from_step=3, final_loss=2.0)
    run.log_status(V1Statuses.RUNNING if run.__module__.startswith(
        "polyaxon_tpu_torch") else jrun.V1Statuses.RUNNING)
    run.log_failed(reason="Boom", message="it broke")
    run.log_succeeded()
    run.close()


def _strip(value):
    """A record without its timestamp, and with the run's own directory
    name cut out of paths."""
    if isinstance(value, dict):
        return {k: _strip(v) for k, v in value.items() if k != "timestamp"}
    if isinstance(value, list):
        return [_strip(v) for v in value]
    if isinstance(value, str):
        return value.replace("port", "RUN").replace("jax", "RUN")
    return value


def _files(run_dir):
    out = {}
    for root, _, names in os.walk(run_dir):
        for name in names:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, run_dir).replace("port", "RUN") \
                .replace("jax", "RUN")
            if name.endswith(".jsonl"):
                with open(path) as fh:
                    out[rel] = [_strip(json.loads(x)) for x in fh if x.strip()]
            elif name.endswith(".json"):
                with open(path) as fh:
                    out[rel] = _strip(json.load(fh))
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


def test_streams_read_a_port_run_as_a_jax_run(tmp_path):
    store = tmp_path / "store"
    _drive(trun.Run("port", str(store / "port")), tmp_path)
    _drive(jrun.Run("jax", str(store / "jax")), tmp_path)
    svc = StreamsService(str(store))
    assert svc.metric_names("port") == svc.metric_names("jax") == [
        "accuracy", "eval/loss", "loss"]
    assert _strip(svc.get_metrics("port")) == _strip(svc.get_metrics("jax"))
    assert [r["step"] for r in svc.get_metrics("port")["loss"]] == [1, 2]
    assert svc.last_metric("port", "loss") == 2.25
    for kind in ("text", "curve", "html", "histogram", "confusion", "image",
                 "dataframe"):
        assert _strip(svc.get_events("port", kind)) == \
            _strip(svc.get_events("jax", kind)), kind
    assert svc.get_outputs("port") == svc.get_outputs("jax") == {
        "steps": 6, "throughput": 1.5, "restored_from_step": 3,
        "final_loss": 2.0}
    statuses = svc.get_statuses("port")
    assert [s["status"] for s in statuses] == ["running", "failed",
                                               "succeeded"]
    assert _strip(statuses) == _strip(svc.get_statuses("jax"))
    assert svc.list_artifacts("port") == svc.list_artifacts("jax")
    assert _strip(svc.get_lineage("port")) == _strip(svc.get_lineage("jax"))
    assert _files(store / "port") == _files(store / "jax")


def test_env_contract_and_statuses_match(tmp_path, monkeypatch):
    monkeypatch.setenv(trun.ENV_RUN_UUID, "abc")
    monkeypatch.setenv(trun.ENV_ARTIFACTS_PATH, str(tmp_path / "abc"))
    assert (trun.ENV_RUN_UUID, trun.ENV_ARTIFACTS_PATH, trun.ENV_RUN_NAME,
            trun.ENV_OUTPUTS_PATH, trun.ENV_PROJECT) == (
        jrun.ENV_RUN_UUID, jrun.ENV_ARTIFACTS_PATH, jrun.ENV_RUN_NAME,
        jrun.ENV_OUTPUTS_PATH, jrun.ENV_PROJECT)
    run = trun.get_or_create_run()
    assert trun.get_or_create_run() is run
    run.log_metrics(step=0, x=1.0)
    run.close()
    assert tevents.read_events(str(tmp_path / "abc"), "metric", "x")[0][
        "value"] == 1.0
    assert {s.value for s in V1Statuses} == {
        s.value for s in jrun.V1Statuses}
    monkeypatch.delenv(trun.ENV_RUN_UUID)
    with pytest.raises(RuntimeError):
        trun.from_env()


def test_events_module_matches_the_reference(tmp_path):
    from polyaxon_tpu.tracking import events as jevents

    assert tevents.V1EventKind.VALUES == jevents.V1EventKind.VALUES
    for mod, sub in ((tevents, "t"), (jevents, "j")):
        with mod.EventWriter(str(tmp_path / sub)) as writer:
            writer.metric("a/b", 1.0, step=2)
            writer.write("text", "n", {"text": "x", "timestamp": "T"})
        assert mod.list_event_names(str(tmp_path / sub), "metric") == ["a/b"]
        with pytest.raises(ValueError):
            mod.read_events(str(tmp_path / sub), "metric", "../../x")
        with open(tmp_path / sub / "events" / "text" / "n.jsonl", "a") as fh:
            fh.write("{torn")
        assert mod.read_events(str(tmp_path / sub), "text", "n") == [
            {"text": "x", "timestamp": "T"}]
    assert (tmp_path / "t" / "events" / "text" / "n.jsonl").read_bytes() == \
        (tmp_path / "j" / "events" / "text" / "n.jsonl").read_bytes()
    chunk, off = tevents.tail_file(str(tmp_path / "t" / "events" / "text" /
                                       "n.jsonl"), 3)
    assert (chunk, off) == jevents.tail_file(
        str(tmp_path / "j" / "events" / "text" / "n.jsonl"), 3)


def test_host_metrics_keys_without_psutil():
    """In a process where psutil cannot be imported, the port's host
    sample has the reference's keys, with values in range."""
    code = (
        "import sys, json; sys.modules['psutil'] = None\n"
        "from polyaxon_tpu_torch.tracking import systemmetrics as s\n"
        "s.host_metrics(); m = s.host_metrics()\n"
        "print(json.dumps(m)); assert 'psutil' not in [k for k, v in "
        "sys.modules.items() if v is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    port = json.loads(out.stdout)
    assert set(port) == set(jsys.host_metrics())
    assert 0.0 <= port["cpu_percent"] <= 100.0
    assert 0.0 < port["memory_percent"] < 100.0
    assert 0.0 < port["disk_used_percent"] <= 100.0
    assert port["memory_used_gb"] > 0 and port["load_1m"] >= 0
    # The same quantities as psutil's, on the same host: memory within a
    # few percentage points (other processes run between the samples).
    ref = jsys.host_metrics()
    assert abs(port["memory_percent"] - ref["memory_percent"]) < 5.0
    assert port["disk_used_percent"] == pytest.approx(
        ref["disk_used_percent"], abs=1.0)


def test_gpu_metrics_latch_off_without_a_gpu(monkeypatch):
    """Without nvidia-smi the sampler's source latches off after one
    failed call and the sample is empty; the allocator counters are
    read only once CUDA is initialized."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = []
    real = subprocess.run

    def fake(cmd, *a, **kw):
        calls.append(cmd)
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(tsys, "_state", {"memory": True, "smi": True})
    monkeypatch.setattr(tsys.subprocess, "run", fake)
    assert tsys.gpu_metrics() == {}
    assert tsys.gpu_metrics() == {}
    assert len(calls) == 1 and tsys._state == {"memory": True, "smi": False}
    monkeypatch.setattr(tsys.subprocess, "run", real)


def test_gpu_metrics_parse_nvidia_smi(monkeypatch):
    """One nvidia-smi call per sample; rows map to torch's order under
    CUDA_VISIBLE_DEVICES, and "[N/A]" cells are left out."""
    rows = "0, 97, 40, 612.5, 55, 1980\n1, 3, 1, [N/A], 31, 345\n"

    class Done:
        stdout = rows

    monkeypatch.setattr(tsys, "_state", {"memory": False, "smi": True})
    monkeypatch.setattr(tsys.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    m = tsys.gpu_metrics()
    assert m["gpu0_utilization_pct"] == 97.0 and m["gpu0_power_w"] == 612.5
    assert "gpu1_power_w" not in m and m["gpu1_temperature_c"] == 31.0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    m = tsys.gpu_metrics()
    assert m == {"gpu0_utilization_pct": 3.0, "gpu0_memory_util_pct": 1.0,
                 "gpu0_temperature_c": 31.0, "gpu0_sm_clock_mhz": 345.0}


def test_monitor_emits_a_final_sample(tmp_path):
    run = trun.Run("r", str(tmp_path / "r"), collect_system_metrics=True,
                   system_metrics_interval=60)
    run.close()
    names = tevents.list_event_names(str(tmp_path / "r"), "system")
    assert {"cpu_percent", "memory_percent"} <= set(names)


def _launch_job(**over):
    runtime = dict(model="llama_tiny", dataset="lm_packed_synthetic",
                   seq_len=32, global_batch_size=4, steps=4, log_every=1,
                   loss_chunk=16, attention_impl="xla", dtype="float32")
    runtime.update(over)
    return {"kind": "jaxjob", "runtime": runtime,
            "checkpointing": {"enabled": True, "intervalSteps": 2}}


def test_launcher_writes_the_tracking_record(tmp_path, monkeypatch, capsys):
    """``launch.main(device="cpu")`` on a checkpointed job: exit 0, the
    statuses running → succeeded, a metric event per emission, the
    reference's output keys, the checkpoints, and the stdout JSON lines;
    run again on the same directory it resumes from the final step."""
    from polyaxon_tpu_torch.runtime import launch

    art = tmp_path / "run"
    monkeypatch.setenv("POLYAXON_JAXJOB_SPEC", json.dumps(_launch_job()))
    monkeypatch.setenv("POLYAXON_RUN_ARTIFACTS_PATH", str(art))
    monkeypatch.setenv("POLYAXON_RUN_UUID", "run")
    assert launch.main(device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["step"] for x in lines if "loss" in x] == [1, 2, 3]
    assert lines[-1]["outputs"]["steps"] == 4
    svc = StreamsService(str(tmp_path))
    assert [s["status"] for s in svc.get_statuses("run")] == [
        "running", "succeeded"]
    losses = svc.get_metrics("run", ["loss"])["loss"]
    assert [r["step"] for r in losses] == [1, 2, 3]
    assert [r["value"] for r in losses] == [x["loss"] for x in lines
                                            if "loss" in x]
    out = svc.get_outputs("run")
    assert set(out) == {"steps", "throughput", "throughput_unit",
                        "wall_time", "param_count", "restored_from_step",
                        *(k for k in out if k.startswith("final_"))}
    assert out["steps"] == 4 and out["restored_from_step"] is None
    assert out["throughput_unit"] == "tokens/sec"
    assert out["final_loss"] == pytest.approx(lines[-2]["loss"], rel=0)
    assert sorted(n for n in os.listdir(art / "checkpoints")
                  if n.isdigit()) == ["2", "4"]
    assert any(a.startswith("checkpoints/4/") for a in
               svc.list_artifacts("run"))
    assert {"cpu_percent", "memory_percent"} <= set(
        tevents.list_event_names(str(art), "system"))

    assert launch.main(device="cpu") == 0
    again = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert again[-1]["outputs"]["restored_from_step"] == 4
    assert svc.get_outputs("run")["restored_from_step"] == 4
    assert [s["status"] for s in svc.get_statuses("run")][-2:] == [
        "running", "succeeded"]


def test_launcher_failure_is_tracked(tmp_path, monkeypatch, capsys):
    """A job that raises: exit 1, the traceback on stderr, and a failed
    status naming the exception. Without a spec: exit 2, no record."""
    from polyaxon_tpu_torch.runtime import launch

    monkeypatch.delenv("POLYAXON_JAXJOB_SPEC", raising=False)
    monkeypatch.setenv("POLYAXON_RUN_ARTIFACTS_PATH", str(tmp_path / "none"))
    assert launch.main(device="cpu") == 2
    assert not (tmp_path / "none").exists()
    monkeypatch.setenv("POLYAXON_JAXJOB_SPEC",
                       json.dumps(_launch_job(grad_accum_steps=3)))
    monkeypatch.setenv("POLYAXON_RUN_ARTIFACTS_PATH", str(tmp_path / "bad"))
    assert launch.main(device="cpu") == 1
    assert "Traceback" in capsys.readouterr().err
    statuses = StreamsService(str(tmp_path)).get_statuses("bad")
    assert [s["status"] for s in statuses] == ["running", "failed"]
    assert statuses[-1]["reason"] == "ValueError"
