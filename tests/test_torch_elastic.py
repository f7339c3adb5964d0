"""Elastic gangs in the port (``runtime/elastic.py``, the executor's
resize channel), held against the JAX package's
(``tests/test_elastic.py``).

- The topology units (``scaled_axes``, ``resolved_base_axes``,
  ``elastic_capable``), the controller's arc, budget and snapshot, and
  the chaos ``slice-loss`` seam: the same inputs to both packages, equal
  answers or equal refusals.
- Prewarm: ``skip``, ``inline`` (equal reports and refusals), the env
  mode, an unknown mode, the child's containment (one JSON line, a hung
  child killed past its timeout) and one real step of a 2-rank gang in
  the ``subprocess`` mode.
- The scheduler's hold on a resizing run.
- The drill: a one-process ``{dp: 4}`` job over 4 CPU devices, chaos
  slice loss then capacity back, so it trains 4 → 2 → 4 ranks (the JAX
  drill's 8 → 4 → 8 at half the ranks), each segment a new local gang:
  SUCCEEDED with no retry, the audit, both ``resize`` spans and report
  phase, ``loss-continuity`` passing, and every emitted loss within
  1e-4 of ``run_jaxjob`` on a 4-device mesh, unresized, from JAX's
  initial weights. Each post-resize gang restores from tier 1, where
  the JAX drill restores from tier 0 in its one process (ROADMAP.md,
  Queue 3).
- The exhausted budget's fallback to PREEMPTED, backoff and requeue; the
  failed shrink and grow prewarms (``slow``, as in the JAX file).
"""

import json
import os
import sys
import time

import pytest
import torch

from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.agent import Agent, LocalExecutor
from polyaxon_tpu_torch.controlplane import ControlPlane
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.runtime import elastic
from tests.torch_deadline import deadline
from tests.torch_dist_cases import CPU_LAUNCHER, ENV_START_PARAMS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_RANK = [sys.executable, "-c", CPU_LAUNCHER]
DEVICES = 4


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    """Sub-second backoff so the PREEMPTED-fallback drills stay quick,
    and a clean chaos slate around every test."""
    from polyaxon_tpu import chaos as jchaos

    monkeypatch.setenv("POLYAXON_TPU_BACKOFF_BASE", "0.05")
    monkeypatch.setenv("POLYAXON_TPU_BACKOFF_MAX", "2")
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    chaos.uninstall()
    jchaos.uninstall()
    yield
    chaos.uninstall()
    jchaos.uninstall()


@pytest.fixture()
def plane(tmp_path):
    return ControlPlane(str(tmp_path / "home"))


def jelastic():
    from polyaxon_tpu.runtime import elastic as jax_elastic

    return jax_elastic


def outcome(fn, *args, **kwargs):
    """(answer, None) or (None, the refusal's type and message)."""
    try:
        return fn(*args, **kwargs), None
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return None, (type(exc).__name__, str(exc))


def same(port_fn, jax_fn, *args, **kwargs):
    got, want = outcome(port_fn, *args, **kwargs), outcome(
        jax_fn, *args, **kwargs)
    assert got == want
    return got


def drive(agent, plane, uuid, until, timeout=120.0, poll=0.03):
    """Reconcile until ``until(record)`` or fail the test."""
    deadline_t = time.monotonic() + timeout
    while time.monotonic() < deadline_t:
        agent.reconcile_once()
        record = plane.get_run(uuid)
        if until(record):
            return record
        time.sleep(poll)
    raise AssertionError(
        f"run {uuid} never satisfied the predicate; last status "
        f"{plane.get_run(uuid).status}: {plane.get_statuses(uuid)}")


def jaxjob_spec(*, steps=12, global_batch=8, max_retries=2):
    """The drill jaxjob: dp=4 over the 4 CPU devices an agent lends it,
    checkpoint every 2 steps with a deep keep-window (the slice-loss
    seam gates on persisted checkpoint COUNT)."""
    return {
        "kind": "operation",
        "termination": {"maxRetries": max_retries},
        "component": {
            "name": "elastic-drill",
            "run": {
                "kind": "jaxjob",
                "numProcesses": 1,
                "environment": {"restartPolicy": "on_failure"},
                "mesh": {"axes": {"dp": DEVICES}},
                "checkpointing": {"enabled": True, "intervalSteps": 2,
                                  "maxToKeep": 20, "asyncSave": False,
                                  "restoreOnStart": True},
                "runtime": {
                    "model": "llama_tiny",
                    "dataset": "lm_synthetic",
                    "steps": steps,
                    "seq_len": 64,
                    "global_batch_size": global_batch,
                    "dtype": "float32",
                    "log_every": 1,
                },
            },
        },
    }


def run_of(spec=None, **runtime_over) -> dict:
    run = json.loads(json.dumps((spec or jaxjob_spec())["component"]["run"]))
    run["runtime"].update(runtime_over)
    return run


def jax_job(run: dict):
    from polyaxon_tpu.polyflow.runs import V1JAXJob

    return V1JAXJob.from_dict(run)


def submit_cpu(plane, spec):
    """Submit and compile; the plan's process (each local gang rank)
    runs the launcher on the CPU from JAX's initial weights when
    ``POLYAXON_TEST_START_PARAMS`` is set."""
    record = plane.submit(spec)
    plane.compile_run(record.uuid)
    plan = plane.get_run(record.uuid).launch_plan
    plan["processes"][0]["command"] = list(CPU_RANK)
    plane.store.update_run(record.uuid, launch_plan=plan)
    return record


def cpu_agent(plane):
    return Agent(plane, in_process=True, device="cpu", local_devices=DEVICES)


def flat_spans(timeline):
    out = []
    stack = list(timeline.get("spans") or [])
    while stack:
        node = stack.pop()
        out.append(node)
        stack.extend(node.get("children") or [])
    return out


# ============================================================ topology math
SCALE_CASES = [
    ({"dp": 4, "fsdp": 2}, 8, 4),
    ({"dp": 2, "fsdp": 2}, 4, 8),
    ({"dp": 8}, 8, 8),
    ({"dp": 1, "tp": 8}, 8, 4),      # fractional dp
    ({"dp": 4}, 4, 3),               # non-integer
    ({"dp": 2, "tp": 2}, 4, 2),
    ({"fsdp": 4}, 4, 2),             # no dp axis: model axes don't fit
]


@pytest.mark.parametrize("base,n,target", SCALE_CASES)
def test_scaled_axes_equal_to_jax(base, n, target):
    got, _ = same(elastic.scaled_axes, jelastic().scaled_axes, base, n,
                  target)
    if got is not None and n == target:
        assert got is not base


MESHES = [None, {"axes": {"dp": -1}}, {"axes": {"dp": 2, "fsdp": -1}},
          {"axes": {"dp": 2, "tp": 2}}, {"axes": {"dp": 3}}]


@pytest.mark.parametrize("mesh", MESHES)
def test_resolved_base_axes_equal_to_jax(mesh):
    run = run_of()
    run.pop("mesh")
    if mesh is not None:
        run["mesh"] = mesh
    for n in (4, 8):
        assert outcome(elastic.resolved_base_axes, run, n) == outcome(
            jelastic().resolved_base_axes, jax_job(run), n)


CKPTS = [None, {}, {"enabled": False}, {"restoreOnStart": False},
         {"enabled": True, "restoreOnStart": True}]


@pytest.mark.parametrize("ckpt", CKPTS)
def test_elastic_capable_equal_to_jax(ckpt):
    run = run_of()
    run.pop("checkpointing")
    if ckpt is not None:
        run["checkpointing"] = ckpt
    assert elastic.elastic_capable(run) == \
        jelastic().elastic_capable(jax_job(run))


# ============================================================ resize channel
def arc(mod):
    """The reference's controller cases as one script; every answer and
    snapshot on the way."""
    out = []
    c = mod.ElasticController("u1", budget=2)
    out.append(c.snapshot(consume_dirty=True))
    out.append(c.snapshot(consume_dirty=True))
    out.append(c.request("grow"))
    out.append(c.request("shrink", reason="SliceLost"))
    out.append(c.request("shrink"))
    out.append((c.resizing, c.take(), c.resizing, c.request("grow")))
    a = c.begin_attempt("shrink", "SliceLost", 8, 4)
    c.finish_attempt(a, "ok", duration_s=0.1234)
    out.append((c.resizing, c.shrunk, c.exhausted(), c.snapshot()))
    out.append(c.request("grow", reason="CapacityReturned"))
    c.take()
    a2 = c.begin_attempt("grow", "CapacityReturned", 4, 8)
    c.finish_attempt(a2, "ok")
    out.append((c.shrunk, c.exhausted(), c.request("shrink"),
                c.snapshot(consume_dirty=True)))
    out.append(c.snapshot(consume_dirty=True))
    f = mod.ElasticController("u2", budget=2,
                              prior_attempts=[{"direction": "shrink"}])
    assert f.request("shrink")
    f.take()
    b = f.begin_attempt("shrink", "r", 8, 4)
    f.finish_attempt(b, "failed", error="no compile" * 60)
    out.append((f.shrunk, b, f.request("shrink"), f.snapshot()))
    out.append(outcome(f.request, "sideways"))
    return out


def test_controller_arc_equal_to_jax():
    assert arc(elastic) == arc(jelastic())


def test_controller_budget_env_equal_to_jax(monkeypatch):
    for value in ("0", "garbage", "3", "-1"):
        monkeypatch.setenv(elastic.ENV_ELASTIC_BUDGET, value)
        c, j = (elastic.ElasticController("u"),
                jelastic().ElasticController("u"))
        assert (c.budget, c.request("shrink")) == \
            (j.budget, j.request("shrink"))
    assert elastic.ENV_ELASTIC_BUDGET == jelastic().ENV_ELASTIC_BUDGET
    assert elastic.ENV_ELASTIC_PREWARM == jelastic().ENV_ELASTIC_PREWARM


# ======================================================== chaos slice-loss
SEAM_CASES = [
    ([{"seam": "slice-loss", "op": "restore"},
      {"seam": "slice-loss", "op": "kill"}], [], 3),
    ([{"seam": "slice-loss", "op": "kill",
       "config": {"min_checkpoints": 2}}], ["2"], 3),
    ([{"seam": "slice-loss", "op": "kill",
       "config": {"min_checkpoints": 2}}], ["2", "4"], 2),
    ([{"seam": "slice-loss", "op": "*"}], [], 2),
]


@pytest.mark.parametrize("faults,steps,calls", SEAM_CASES)
def test_slice_loss_seam_equal_to_jax(faults, steps, calls, tmp_path):
    from polyaxon_tpu import chaos as jchaos

    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    for s in steps:
        (ckpt / s).mkdir()
    plans = [m.ChaosPlan.from_dict({"faults": faults})
             for m in (chaos, jchaos)]
    answers = [[p.slice_loss_due("u1", str(ckpt)) for _ in range(calls)]
               + [p.done] for p in plans]
    assert answers[0] == answers[1]


# ================================================================= prewarm
def test_skip_mode_and_env_mode(monkeypatch):
    run = run_of()
    assert elastic.prewarm(run, 4, {"dp": 4}, mode="skip") == \
        jelastic().prewarm(jax_job(run), 4, {"dp": 4}, mode="skip") == \
        {"ok": True, "mode": "skip", "devices": 4}
    monkeypatch.setenv(elastic.ENV_ELASTIC_PREWARM, "skip")
    assert elastic.prewarm(run, 4, {"dp": 4})["mode"] == "skip"


def test_unknown_mode_raises():
    with pytest.raises(elastic.PrewarmError, match="unknown prewarm"):
        elastic.prewarm(run_of(), 4, {"dp": 4}, mode="warp")


INLINE_CASES = [
    ({}, 4, {"dp": 4}),
    ({}, 2, {"dp": 2}),
    ({"global_batch_size": 6}, 4, {"dp": 4}),
    ({"grad_accum_steps": 4}, 4, {"dp": 4}),
    ({"grad_accum_steps": 2}, 4, {"dp": 4}),
    ({}, 64, {"dp": 64}),
    ({}, 4, {"dp": 2}),
]


@pytest.mark.parametrize("over,n,axes", INLINE_CASES)
def test_inline_prewarm_equal_to_jax(over, n, axes, cpu_devices):
    """Equal reports, or refusals naming the same cause; the port's
    process lends it 8 CPU devices, as the JAX tests' host has."""
    run = run_of(**over)
    got = outcome(elastic.prewarm, run, n, axes, mode="inline",
                  devices=list(range(8)), device="cpu")
    want = outcome(jelastic().prewarm, jax_job(run), n, axes,
                   mode="inline")
    assert (got[1] is None) == (want[1] is None), (got, want)
    if want[1] is None:
        assert got == want
    else:
        assert got[1][0] == want[1][0] == "PrewarmError"
        cause = ("needs 64 devices" if n == 64 else "divisible"
                 if "global_batch_size" in over else "incompatible"
                 if "grad_accum_steps" in over else "mesh build failed")
        assert cause in got[1][1] and cause in want[1][1]


def test_child_contains_failures_to_one_json_line(capsys):
    run = run_of()
    for mod, spec in ((elastic, run), (jelastic(), run)):
        rc = mod._child_main([
            "--spec", json.dumps(spec), "--devices", "64",
            "--axes", json.dumps({"dp": 64})]
            + (["--device", "cpu"] if mod is elastic else []))
        assert rc == 1
        payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert payload["ok"] is False
        assert "64 devices" in payload["error"]


@deadline(60)
def test_a_hung_child_is_killed_past_its_timeout(monkeypatch):
    real = elastic.subprocess.Popen

    def hanging(cmd, **kwargs):
        return real(cmd + ["--sleep", "60"], **kwargs)

    monkeypatch.setattr(elastic.subprocess, "Popen", hanging)
    t0 = time.monotonic()
    with pytest.raises(elastic.PrewarmError, match="hung past 2s"):
        elastic.prewarm(run_of(), 2, {"dp": 2}, mode="subprocess",
                        timeout=2.0, devices=[0, 1], device="cpu")
    assert time.monotonic() - t0 < 30


@deadline(120)
def test_subprocess_prewarm_runs_one_real_step_of_a_gang():
    out = elastic.prewarm(run_of(), 2, {"dp": 2}, mode="subprocess",
                          timeout=100.0, devices=[0, 1, 2, 3],
                          device="cpu")
    assert out["ok"] and out["mode"] == "subprocess"
    assert out["devices"] == 2 and out["axes"] == {"dp": 2}
    assert out["compile_time_s"] > 0


# ======================================================= scheduler interplay
def test_resizing_run_is_not_a_requeue_candidate(plane):
    from polyaxon_tpu_torch.controlplane.scheduler import Scheduler

    record = plane.submit(jaxjob_spec())
    plane.compile_run(record.uuid)
    plane.store.transition(record.uuid, V1Statuses.PREEMPTED,
                           reason="SlicePreempted", force=True)
    meta = dict(plane.get_run(record.uuid).meta or {})
    meta["elastic"] = {"budget": 2, "used": 1, "resizing": True,
                       "shrunk": False, "attempts": []}
    plane.store.update_run(record.uuid, meta=meta)

    sched = Scheduler(plane)
    for _ in range(3):
        sched.tick()
    held = plane.get_run(record.uuid)
    assert held.status == V1Statuses.PREEMPTED
    assert "backoff" not in (held.meta or {})

    meta["elastic"]["resizing"] = False
    plane.store.update_run(record.uuid, meta=meta)
    deadline_t = time.monotonic() + 30
    while time.monotonic() < deadline_t:
        sched.tick()
        if plane.get_run(record.uuid).status != V1Statuses.PREEMPTED:
            break
        time.sleep(0.02)
    assert plane.get_run(record.uuid).status != V1Statuses.PREEMPTED


def test_resize_channel_without_a_live_gang(plane, tmp_path):
    from polyaxon_tpu.agent import LocalExecutor as JExecutor
    from polyaxon_tpu.controlplane import ControlPlane as JPlane

    ex = LocalExecutor(plane, in_process=True, device="cpu")
    jex = JExecutor(JPlane(str(tmp_path / "jax")), in_process=True)
    for e in (ex, jex):
        assert e.request_resize("run", "shrink") is False
        assert e.shrunk_elastic_runs() == []


# =========================================================== acceptance drill
def jax_reference_losses(run: dict, cpu_devices) -> dict:
    from polyaxon_tpu.runtime.loop import run_jaxjob

    seen = {}
    ref = dict(run)
    ref.pop("checkpointing")
    run_jaxjob(jax_job(ref), devices=cpu_devices[:DEVICES],
               on_metrics=lambda s, v: seen.__setitem__(s, v["loss"])
               if "loss" in v else None)
    return seen


@deadline(240)
def test_shrink_then_regrow_succeeds_with_continuity(
        plane, monkeypatch, tmp_path, cpu_devices):
    """Chaos takes a slice mid-train (4 → 2 ranks), capacity returns
    (2 → 4), and the run reaches SUCCEEDED without a requeue: both
    resizes on the timeline and in the report, loss continuity certified
    by the oracle, and every loss the run emitted equal to the unresized
    JAX run's."""
    import pickle

    from tests.test_torch_compile_launch import jax_initial_params

    spec = jaxjob_spec(steps=12)
    start = tmp_path / "params0.pkl"
    with open(start, "wb") as fh:
        pickle.dump(jax_initial_params(run_of(spec)["runtime"]), fh)
    monkeypatch.setenv(ENV_START_PARAMS, str(start))
    monkeypatch.setenv(elastic.ENV_ELASTIC_PREWARM, "inline")
    chaos.install(chaos.ChaosPlan.from_dict({"seed": 14, "faults": [
        {"seam": "slice-loss", "op": "kill",
         "config": {"min_checkpoints": 1}},
        {"seam": "slice-loss", "op": "restore",
         "config": {"min_checkpoints": 2}},
    ]}))
    record = submit_cpu(plane, spec)
    agent = cpu_agent(plane)

    def settled(rec):
        if rec.status == V1Statuses.SUCCEEDED:
            return True
        reasons = [c.get("reason") for c in plane.get_statuses(rec.uuid)]
        assert "RetriesExhausted" not in reasons, reasons
        assert rec.status != V1Statuses.FAILED, plane.get_statuses(rec.uuid)
        return False

    final = drive(agent, plane, record.uuid, settled, timeout=200)
    assert final.retries == 0
    assert "backoff" not in (final.meta or {})

    plan = chaos.active_plan()
    assert plan.done, f"unconsumed faults; fired: {plan.consumed}"
    assert [c["seam"] for c in plan.consumed] == \
        ["slice-loss", "slice-loss"]

    # Each post-resize gang restored from the spill: the old gang's
    # memory replica died with its ranks (the JAX drill's tier "0").
    ckpt_audit = final.meta["checkpoint"]
    assert ckpt_audit["restore_tier"] == "1"
    assert ckpt_audit["restored_from_step"] >= 1

    audit = final.meta["elastic"]
    assert audit["budget"] == 2 and audit["used"] == 2
    assert audit["resizing"] is False and audit["shrunk"] is False
    assert [(a["direction"], a["outcome"], a["from_devices"],
             a["to_devices"]) for a in audit["attempts"]] == \
        [("shrink", "ok", 4, 2), ("grow", "ok", 2, 4)]
    assert all(a["duration_s"] >= 0 for a in audit["attempts"])

    outputs = plane.streams.get_outputs(record.uuid)
    assert outputs["steps"] == 12

    resizes = [s for s in flat_spans(plane.timeline(record.uuid))
               if s["name"] == "resize"]
    assert [(s["attributes"]["direction"], s["attributes"]["outcome"])
            for s in sorted(resizes, key=lambda s: s["start"])] == \
        [("shrink", "ok"), ("grow", "ok")]

    report = plane.report(record.uuid)
    assert "resize" in report["phases"]
    assert report["phases"]["resize"]["ms"] > 0

    verdicts = {v["invariant"]: v["verdict"]
                for v in plane.verify(record.uuid)["verdicts"]}
    assert verdicts["loss-continuity"] == "pass", verdicts

    # Three gangs: 4, then 2, then 4 ranks.
    with open(os.path.join(plane.run_artifacts_dir(record.uuid), "logs",
                           "rank-0.log")) as fh:
        meshes = [ln.split("mesh axes=")[1].strip() for ln in fh
                  if "mesh axes=" in ln]
    assert meshes == ["{'dp': 4} devices=4", "{'dp': 2} devices=2",
                      "{'dp': 4} devices=4"]

    port = {e["step"]: e["value"] for e in plane.streams.get_metrics(
        record.uuid, ["loss"])["loss"]}
    want = jax_reference_losses(run_of(spec), cpu_devices)
    assert len(port) >= 6 and set(port) <= set(want)
    for step, loss in port.items():
        assert loss == pytest.approx(want[step], abs=1e-4), step


@deadline(240)
def test_exhausted_budget_degrades_to_preempt_requeue(plane, monkeypatch):
    """With a zero resize budget the same slice loss takes the
    pre-elastic path — PREEMPTED, backoff, requeue — and the restarted
    run still completes."""
    monkeypatch.setenv(elastic.ENV_ELASTIC_BUDGET, "0")
    monkeypatch.setenv(elastic.ENV_ELASTIC_PREWARM, "inline")
    chaos.install(chaos.ChaosPlan.from_dict({"faults": [
        {"seam": "slice-loss", "op": "kill",
         "config": {"min_checkpoints": 1}},
    ]}))
    record = submit_cpu(plane, jaxjob_spec(steps=6))
    agent = cpu_agent(plane)
    final = drive(agent, plane, record.uuid,
                  lambda rec: rec.status == V1Statuses.SUCCEEDED,
                  timeout=200)

    preempted = [c for c in plane.get_statuses(record.uuid)
                 if c["type"] == "preempted"]
    assert preempted and preempted[-1]["reason"] == "SlicePreempted"
    assert final.meta["backoff"]["preempts"] >= 1
    assert len(final.meta["backoff"]["preempt_delays"]) >= 1
    assert final.meta["elastic"]["used"] == 0
    # The requeued gang restored from the spill (the JAX rerun, in one
    # process, from its memory replica).
    assert final.meta["checkpoint"]["restore_tier"] == "1"
    assert final.meta["checkpoint"]["restored_from_step"] >= 1
    assert plane.streams.get_outputs(record.uuid)["steps"] == 6
    assert os.path.exists(os.path.join(
        plane.run_artifacts_dir(record.uuid), "postmortem.json"))


# ===================================================== prewarm-failure paths
@pytest.mark.slow
@deadline(240)
def test_failed_shrink_prewarm_falls_back_to_requeue(plane, monkeypatch):
    def doomed(job, n, axes, **kw):
        raise elastic.PrewarmError("induced: survivor mesh rejected")

    monkeypatch.setattr(elastic, "prewarm", doomed)
    chaos.install(chaos.ChaosPlan.from_dict({"faults": [
        {"seam": "slice-loss", "op": "kill",
         "config": {"min_checkpoints": 1}},
    ]}))
    record = submit_cpu(plane, jaxjob_spec(steps=6))
    agent = cpu_agent(plane)
    final = drive(agent, plane, record.uuid,
                  lambda rec: rec.status == V1Statuses.SUCCEEDED,
                  timeout=200)

    audit = final.meta["elastic"]
    assert audit["attempts"][0]["direction"] == "shrink"
    assert audit["attempts"][0]["outcome"] == "failed"
    assert "induced" in audit["attempts"][0]["error"]
    assert audit["resizing"] is False
    conditions = [c["type"] for c in plane.get_statuses(record.uuid)]
    assert "preempted" in conditions
    assert plane.streams.get_outputs(record.uuid)["steps"] == 6
    assert os.path.exists(os.path.join(
        plane.run_artifacts_dir(record.uuid), "postmortem.json"))


@pytest.mark.slow
@deadline(240)
def test_failed_grow_prewarm_keeps_training_shrunk(plane, monkeypatch):
    real = elastic._prewarm_inline

    def grow_doomed(job, n, axes, **kw):
        if n > DEVICES // 2:
            raise elastic.PrewarmError("induced: capacity flapped away")
        return real(job, n, axes, devices=kw.get("devices"),
                    device=kw.get("device"))

    monkeypatch.setattr(elastic, "prewarm", grow_doomed)
    chaos.install(chaos.ChaosPlan.from_dict({"faults": [
        {"seam": "slice-loss", "op": "kill",
         "config": {"min_checkpoints": 1}},
        {"seam": "slice-loss", "op": "restore",
         "config": {"min_checkpoints": 2}},
    ]}))
    record = submit_cpu(plane, jaxjob_spec(steps=8))
    agent = cpu_agent(plane)
    final = drive(agent, plane, record.uuid,
                  lambda rec: rec.status == V1Statuses.SUCCEEDED,
                  timeout=200)

    assert final.retries == 0
    audit = final.meta["elastic"]
    assert [(a["direction"], a["outcome"])
            for a in audit["attempts"]] == \
        [("shrink", "ok"), ("grow", "failed")]
    assert audit["shrunk"] is True
    assert plane.streams.get_outputs(record.uuid)["steps"] == 8
    assert os.path.exists(os.path.join(
        plane.run_artifacts_dir(record.uuid), "postmortem.json"))

