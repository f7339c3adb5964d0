"""Multi-process gangs of the port, run by its agent as subprocesses
(the counterpart of ``tests/test_multiprocess_gang.py``): every process
of the compiled plan starts the port's launcher on the CPU, which starts
a gloo process group from the plan's env contract, and the processes
train one model together.

- a 2-process gang (the default mesh: dp over every rank);
- a 4-process dp2 x fsdp2 gang;
- an 8-process gang as two emulated slices of 4, dp over DCN: the lead
  rank logs the hybrid mesh, dp slowest-varying;
- a preempted 2-process gang that resumes from its checkpoint and ends
  on the loss of an unpreempted control run (abs 1e-5);
- ``examples/longcontext_ring.yaml`` at llama_tiny, seq_len 256 and
  dp1 x cp4 (ring attention, remat full) from JAX's initial weights: its
  losses against ``run_jaxjob`` on the same spec (abs 1e-4, the
  compile-and-launch tests' tolerance). The JAX job runs in one process
  on a 4-device mesh; each of the gang's 4 processes draws
  ``global_batch_size / 4`` rows from one seed and its replicated batch
  is those rows, as the reference's processes assemble it (ROADMAP.md,
  Queue 3), so the JAX job gets that batch size.
"""

import json
import os
import pickle
import sys

import pytest

from polyaxon_tpu_torch.agent import Agent
from polyaxon_tpu_torch.controlplane import ControlPlane
from polyaxon_tpu_torch.lifecycle import V1Statuses
from tests.torch_dist_cases import CPU_LAUNCHER, ENV_START_PARAMS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model": "llama_tiny", "dataset": "lm_synthetic", "seq_len": 64,
        "log_every": 1}


@pytest.fixture()
def plane(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return ControlPlane(str(tmp_path / "home"))


def submit_on_cpu(plane, spec, **kwargs):
    """Submit and compile ``spec``; every process of its plan runs the
    launcher on the CPU."""
    record = plane.submit(spec, **kwargs)
    plane.compile_run(record.uuid)
    plan = plane.get_run(record.uuid).launch_plan
    for proc in plan["processes"]:
        assert proc["command"][1:] == ["-m",
                                       "polyaxon_tpu_torch.runtime.launch"]
        proc["command"] = [sys.executable, "-c", CPU_LAUNCHER]
    plane.store.update_run(record.uuid, launch_plan=plan)
    return record


def run_gang(plane, spec, timeout=240, **kwargs):
    record = submit_on_cpu(plane, spec, **kwargs)
    status = Agent(plane).run_until_done(record.uuid, timeout=timeout)
    log = plane.streams.read_logs(record.uuid, "main-0.log")[0]
    assert status == V1Statuses.SUCCEEDED, log[-3000:]
    return record, log


def jaxjob(name, n_proc, runtime, **run):
    return {"kind": "component", "name": name,
            "run": {"kind": "jaxjob", "numProcesses": n_proc,
                    "runtime": {**TINY, **runtime}, **run}}


def test_two_process_gang_trains_together(plane):
    record, log = run_gang(plane, jaxjob(
        "gang2", 2, {"steps": 3, "global_batch_size": 4}))
    logs = plane.streams.log_files(record.uuid)
    assert {"main-0.log", "main-1.log"} <= set(logs)
    assert "mesh axes={'dp': 2} devices=2" in log
    assert plane.streams.get_outputs(record.uuid)["steps"] == 3
    assert plane.streams.get_metrics(record.uuid, ["loss"])["loss"]


def test_four_process_dp_fsdp_gang(plane):
    record, log = run_gang(plane, jaxjob(
        "gang4", 4, {"steps": 3, "global_batch_size": 8},
        mesh={"axes": {"dp": 2, "fsdp": 2}}))
    assert {f"main-{i}.log" for i in range(4)} <= set(
        plane.streams.log_files(record.uuid))
    assert "mesh axes={'dp': 2, 'fsdp': 2} devices=4" in log
    assert plane.streams.get_outputs(record.uuid)["steps"] == 3
    # Rank 0 alone tracks: one loss per step.
    losses = plane.streams.get_metrics(record.uuid, ["loss"])["loss"]
    assert [e["step"] for e in losses] == [1, 2]


def test_eight_process_multislice_dp_over_dcn(plane):
    record, log = run_gang(plane, jaxjob(
        "gang8", 8, {"steps": 2, "global_batch_size": 8},
        topology={"accelerator": "v5e", "topology": "4", "chipsPerHost": 1,
                  "slices": 2},
        mesh={"axes": {"dp": 2, "fsdp": 4}, "dcnAxes": ["dp"]}),
        timeout=300)
    assert {f"main-{i}.log" for i in range(8)} <= set(
        plane.streams.log_files(record.uuid))
    assert plane.streams.get_outputs(record.uuid)["steps"] == 2
    assert "hybrid mesh: dcn_axes=['dp']" in log
    assert "'dp': 2" in log and "'fsdp': 4" in log


def test_preempted_gang_resumes_checkpoint_exact(plane):
    import time

    spec = jaxjob("gang-preempt", 2, {"steps": 6, "global_batch_size": 4},
                  checkpointing={"enabled": True, "intervalSteps": 2,
                                 "asyncSave": False})
    record = submit_on_cpu(plane, spec)
    agent = Agent(plane)
    ckpt_dir = os.path.join(plane.run_artifacts_dir(record.uuid),
                            "checkpoints")
    deadline = time.monotonic() + 240
    preempted = False
    while time.monotonic() < deadline:
        agent.reconcile_once()
        if record.uuid in agent.executor.active_runs and os.path.isdir(
                ckpt_dir) and any(n.isdigit() for n in os.listdir(ckpt_dir)):
            assert agent.executor.preempt(record.uuid)
            preempted = True
            break
        time.sleep(0.1)
    assert preempted, "the gang wrote no checkpoint before the deadline"
    assert agent.run_until_done(record.uuid,
                                timeout=240) == V1Statuses.SUCCEEDED
    assert plane.get_run(record.uuid).retries == 0
    assert any(c["type"] == V1Statuses.PREEMPTED
               for c in plane.store.get_conditions(record.uuid))
    outputs = plane.streams.get_outputs(record.uuid)
    assert outputs["steps"] == 6
    # Resumed from a checkpoint (saved at step 2 or 4, holding the state
    # after 3 or 5 updates), not from scratch: the steps before it were
    # trained once.
    restored = outputs["restored_from_step"]
    assert restored in (3, 5)
    steps = [e["step"] for e in plane.streams.get_metrics(
        record.uuid, ["loss"])["loss"]]
    assert all(steps.count(s) == 1 for s in range(1, restored))

    control, _ = run_gang(plane, {**spec, "name": "gang-control"})
    loss_a = plane.streams.get_outputs(record.uuid)["final_loss"]
    loss_b = plane.streams.get_outputs(control.uuid)["final_loss"]
    assert abs(loss_a - loss_b) < 1e-5, (loss_a, loss_b)


LONGCONTEXT_CPU = {
    "isPreset": True, "patchStrategy": "post_merge",
    "runPatch": {"numProcesses": 4, "mesh": {"axes": {"dp": 1, "cp": 4}},
                 "runtime": {"model": "llama_tiny", "seq_len": 256,
                             "global_batch_size": 4, "steps": 3,
                             "log_every": 1, "dtype": "float32"}}}


def test_longcontext_ring_example_matches_jax(plane, tmp_path, monkeypatch,
                                              cpu_devices):
    from polyaxon_tpu.polyflow import V1JAXJob
    from polyaxon_tpu.runtime.loop import run_jaxjob
    from tests.test_torch_compile_launch import jax_initial_params

    example = os.path.join(REPO, "examples/longcontext_ring.yaml")
    record = submit_on_cpu(plane, example, presets=[LONGCONTEXT_CPU])
    plan = plane.get_run(record.uuid).launch_plan
    assert len(plan["processes"]) == 4
    job = json.loads(plan["processes"][0]["env"]["POLYAXON_JAXJOB_SPEC"])
    assert job["runtime"]["attention_impl"] == "ring"
    assert job["runtime"]["remat"] == "full"
    assert job["mesh"]["axes"] == {"dp": 1, "cp": 4}
    start = tmp_path / "params0.pkl"
    with open(start, "wb") as fh:
        pickle.dump(jax_initial_params(job["runtime"]), fh)
    monkeypatch.setenv(ENV_START_PARAMS, str(start))
    status = Agent(plane).run_until_done(record.uuid, timeout=240)
    log = plane.streams.read_logs(record.uuid, "main-0.log")[0]
    assert status == V1Statuses.SUCCEEDED, log[-3000:]
    assert "mesh axes={'dp': 1, 'cp': 4} devices=4" in log
    port = {e["step"]: e["value"] for e in plane.streams.get_metrics(
        record.uuid, ["loss"])["loss"]}

    reference = dict(job, runtime={**job["runtime"], "global_batch_size": 1,
                                   "dtype": "float32"})
    seen = {}
    result = run_jaxjob(V1JAXJob.from_dict(reference),
                        devices=cpu_devices[:4],
                        on_metrics=lambda s, v: seen.__setitem__(
                            s, v["loss"]) if "loss" in v else None)
    assert sorted(port) == sorted(seen) == [1, 2]
    for step, loss in seen.items():
        assert port[step] == pytest.approx(loss, abs=1e-4), step
    assert plane.streams.get_outputs(record.uuid)["final_loss"] == \
        pytest.approx(result.final_metrics["loss"], abs=1e-4)
