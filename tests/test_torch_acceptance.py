"""The north-star acceptance tests (``tests/test_acceptance.py:94-173``)
on the port's control plane and agent, on the CPU.

The specs are copies of ``LLAMA_PRETRAIN`` and ``HYPERBAND_SWEEP`` with a
one-device mesh and ``attention_impl: xla`` (``llama_tiny``'s head_dim 16
has no kernel; the port trains on one device). The agent runs in-process
with ``device="cpu"``. Every assert of the originals stays. Beyond them:

- ``LLAMA_PRETRAIN``'s losses through the plane are bitwise those of
  ``launch.main(device="cpu")`` on the same compiled job (which
  ``tests/test_torch_compile_launch.py`` holds to ``run_jaxjob``);
- the sweep's first-rung trial params equal those the JAX plane's
  scheduler creates from the same seed (its scheduling tick only);
- the port's trace of an in-process run holds the span names
  ``run_jaxjob`` writes for the same job;
- the JAX executor would run ``LLAMA_PRETRAIN`` as an elastic gang and
  record ``meta["elastic"]``; the port's does not (ROADMAP.md, Queue 3).
"""

import copy
import json
import os
import urllib.request

import pytest
import torch
import yaml

from polyaxon_tpu_torch.agent import Agent
from polyaxon_tpu_torch.controlplane import ControlPlane
from polyaxon_tpu_torch.lifecycle import V1Statuses
from tests.test_acceptance import HYPERBAND_SWEEP, LLAMA_PRETRAIN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_PRESET = os.path.join(REPO, "tests", "fixtures", "presets", "tpu.yaml")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pretrain_copy() -> dict:
    spec = yaml.safe_load(LLAMA_PRETRAIN)
    run = spec["component"]["run"]
    run["mesh"] = {"axes": {"dp": 1}}
    run["runtime"]["attention_impl"] = "xla"
    return spec


def sweep_copy() -> dict:
    sweep = copy.deepcopy(HYPERBAND_SWEEP)
    run = sweep["component"]["run"]
    run["mesh"] = {"axes": {"dp": 1}}
    run["runtime"]["attention_impl"] = "xla"
    return sweep


@pytest.fixture()
def plane(tmp_path):
    return ControlPlane(str(tmp_path / "home"))


class TestNorthStar:
    def test_llama_pretrain_with_tpu_preset(self, plane, tmp_path,
                                            monkeypatch, capsys):
        path = tmp_path / "llama.yaml"
        path.write_text(yaml.safe_dump(pretrain_copy()))
        record = plane.submit(str(path), presets=[TPU_PRESET])
        tpu = record.spec["runPatch"]["environment"]["tpu"]
        assert tpu["accelerator"] == "v5e" and tpu["preemptible"] is True

        agent = Agent(plane, in_process=True, device="cpu")
        status = agent.run_until_done(record.uuid, timeout=300)
        assert status == V1Statuses.SUCCEEDED

        resolved = plane.get_run(record.uuid).resolved_spec
        resolved_tpu = resolved["component"]["run"]["environment"]["tpu"]
        assert resolved_tpu["accelerator"] == "v5e"

        metrics = plane.streams.get_metrics(record.uuid, ["loss"])
        assert metrics["loss"], "no loss events tracked"
        outputs = plane.streams.get_outputs(record.uuid)
        assert outputs["steps"] == 4
        arts = plane.streams.list_artifacts(record.uuid)
        assert any("checkpoints" in a for a in arts)

        # Beyond the original: the launcher on the same compiled job (its
        # process env, another artifacts dir) gives the same losses, bit
        # for bit.
        from polyaxon_tpu_torch.runtime import launch

        env = plane.get_run(record.uuid).launch_plan["processes"][0]["env"]
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        monkeypatch.setenv("POLYAXON_RUN_ARTIFACTS_PATH",
                           str(tmp_path / "launcher"))
        capsys.readouterr()
        assert launch.main(device="cpu") == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                 if x.startswith("{")]
        want = {x["step"]: x["loss"] for x in lines if "loss" in x}
        got = {r["step"]: r["value"] for r in metrics["loss"]}
        assert got == want and want

    def test_hyperband_sweep_of_jaxjobs(self, plane):
        record = plane.submit(sweep_copy())
        agent = Agent(plane, max_concurrent=2, in_process=True, device="cpu")
        status = agent.run_until_done(record.uuid, timeout=600)
        assert status == V1Statuses.SUCCEEDED
        trials = plane.list_runs(pipeline_uuid=record.uuid)
        assert len(trials) >= 3
        assert any(t.status == V1Statuses.SUCCEEDED for t in trials)
        rungs = {(t.meta or {}).get("rung", 0) for t in trials}
        assert max(rungs) >= 1
        steps_by_rung = {}
        for t in trials:
            rung = (t.meta or {}).get("rung", 0)
            steps_by_rung.setdefault(rung, set()).add(
                t.meta["trial_params"]["steps"])
        assert min(steps_by_rung[max(rungs)]) > min(steps_by_rung[0])

    def test_sweep_best_trial_serves(self, plane):
        from polyaxon_tpu_torch.serving.server import ServingServer

        sweep = sweep_copy()
        runtime = sweep["component"]["run"]["runtime"]
        runtime["log_every"] = 1
        sweep["component"]["run"]["checkpointing"] = {
            "enabled": True, "intervalSteps": 1, "asyncSave": False}
        record = plane.submit(sweep)
        agent = Agent(plane, max_concurrent=2, in_process=True, device="cpu")
        assert agent.run_until_done(record.uuid,
                                    timeout=600) == V1Statuses.SUCCEEDED

        trials = plane.list_runs(pipeline_uuid=record.uuid)
        scored = [(plane.get_metric(t.uuid, "loss"), t)
                  for t in trials if t.status == V1Statuses.SUCCEEDED]
        scored = [(v, t) for v, t in scored if v is not None]
        assert scored, "no succeeded trial carries the sweep metric"
        best = min(scored, key=lambda vt: vt[0])[1]

        ckpt = os.path.join(plane.run_artifacts_dir(best.uuid),
                            "checkpoints")
        assert os.path.isdir(ckpt), "best trial left no checkpoint"
        with ServingServer("llama_tiny", ckpt, device="cpu") as server:
            req = urllib.request.Request(
                server.url + "/v1/generate", method="POST",
                data=json.dumps({"tokens": [[5, 6, 7]],
                                 "max_new_tokens": 5}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json.load(resp)
        assert len(out["tokens"][0]) == 5


def first_rung(plane_cls, scheduler_cls, home: str) -> list:
    plane = plane_cls(home)
    record = plane.submit(sweep_copy())
    plane.compile_run(record.uuid)
    scheduler_cls(plane).tick()
    trials = plane.list_runs(pipeline_uuid=record.uuid)
    return [(t.name, t.iteration, t.meta["bracket"], t.meta["rung"],
             t.meta["trial_params"]) for t in trials]


def test_sweep_first_rung_matches_the_jax_scheduler(tmp_path):
    from polyaxon_tpu.controlplane import ControlPlane as JPlane
    from polyaxon_tpu.controlplane import Scheduler as JScheduler
    from polyaxon_tpu_torch.controlplane import Scheduler

    ours = first_rung(ControlPlane, Scheduler, str(tmp_path / "torch"))
    theirs = first_rung(JPlane, JScheduler, str(tmp_path / "jax"))
    assert ours == theirs
    assert len(ours) >= 3 and {r[3] for r in ours} == {0}


TRACED_JOB = {"kind": "jaxjob", "mesh": {"axes": {"dp": 1}},
              "checkpointing": {"enabled": True, "intervalSteps": 2},
              "runtime": {"model": "llama_tiny", "dataset": "lm_synthetic",
                          "steps": 4, "seq_len": 32, "global_batch_size": 2,
                          "attention_impl": "xla", "log_every": 1,
                          "eval_every": 2, "eval_steps": 1}}


def runtime_span_names(records) -> set:
    return {r["name"] for r in records
            if r.get("type") == "span" and r.get("component") == "runtime"}


def test_in_process_trace_holds_the_jax_span_names(plane, tmp_path):
    """The runtime spans of a port in-process run, parented under the
    gang's `execute` span, carry the names ``run_jaxjob`` writes for the
    same job; a rerun on the same checkpoints adds ``restore`` in both."""
    import jax

    from polyaxon_tpu.obs.trace import read_trace as jread_trace
    from polyaxon_tpu.polyflow.runs import V1JAXJob
    from polyaxon_tpu.runtime.loop import run_jaxjob
    from polyaxon_tpu_torch.obs.trace import read_trace

    spec = {"kind": "operation", "name": "traced",
            "component": {"run": copy.deepcopy(TRACED_JOB)}}
    record = plane.submit(spec)
    agent = Agent(plane, in_process=True, device="cpu")
    assert agent.run_until_done(record.uuid, timeout=300) == \
        V1Statuses.SUCCEEDED
    art = plane.run_artifacts_dir(record.uuid)
    ours = read_trace(art)
    execute = next(r for r in ours if r.get("name") == "execute")
    runtime = next(r for r in ours if r.get("name") == "runtime")
    assert runtime["parent_id"] == execute["span_id"]
    assert {r["parent_id"] for r in ours if r.get("component") == "runtime"
            and r["name"] != "runtime"} == {runtime["span_id"]}

    jart = str(tmp_path / "jax-run")
    job = V1JAXJob.from_dict(copy.deepcopy(TRACED_JOB))
    run_jaxjob(job, artifacts_dir=jart, devices=jax.devices()[:1])
    theirs = jread_trace(jart)
    assert runtime_span_names(ours) == runtime_span_names(theirs) == {
        "runtime", "jit_compile", "step", "eval", "checkpoint"}

    # A rerun on the same directory restores: `restore` in both.
    rerun = dict(copy.deepcopy(TRACED_JOB))
    rerun["runtime"]["steps"] = 6
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    run_torchjob(rerun, artifacts_dir=art, device="cpu")
    run_jaxjob(V1JAXJob.from_dict(rerun), artifacts_dir=jart,
               devices=jax.devices()[:1])
    assert "restore" in runtime_span_names(read_trace(art))
    assert "restore" in runtime_span_names(jread_trace(jart))


def test_elastic_meta_matches_the_reference(plane, tmp_path):
    """Both executors give ``LLAMA_PRETRAIN`` (checkpointing that
    restores on start) a resize channel, so an in-process run records
    ``meta["elastic"]`` with the JAX executor's keys: one segment over
    the one CPU device, no attempt."""
    from polyaxon_tpu.agent import LocalExecutor as JExecutor
    from polyaxon_tpu.compiler.plan import V1LaunchPlan as JPlan
    from polyaxon_tpu.controlplane import ControlPlane as JPlane
    from polyaxon_tpu.runtime.elastic import ElasticController
    from polyaxon_tpu_torch.agent import LocalExecutor
    from polyaxon_tpu_torch.compiler.plan import V1LaunchPlan

    jplane = JPlane(str(tmp_path / "jax"))
    jrecord = jplane.submit(pretrain_copy())
    jplane.compile_run(jrecord.uuid)
    jplan = JPlan.from_dict(jplane.get_run(jrecord.uuid).launch_plan)
    jchannel = JExecutor(jplane, in_process=True)._make_elastic(jplan)
    assert jchannel is not None

    record = plane.submit(pretrain_copy())
    plane.compile_run(record.uuid)
    plan = V1LaunchPlan.from_dict(plane.get_run(record.uuid).launch_plan)
    channel = LocalExecutor(plane, in_process=True,
                            device="cpu")._make_elastic(plan)
    assert channel is not None
    assert channel.snapshot() == jchannel.snapshot()

    agent = Agent(plane, in_process=True, device="cpu")
    assert agent.run_until_done(record.uuid, timeout=300) == \
        V1Statuses.SUCCEEDED
    meta = plane.get_run(record.uuid).meta["elastic"]
    assert meta == ElasticController("u", budget=meta["budget"]).snapshot()
    assert meta["attempts"] == [] and meta["used"] == 0