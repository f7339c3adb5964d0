"""The analysis plane wired through the port's control plane and agent,
held against the JAX package's, on the CPU.

- One ``llama_tiny`` jaxjob (5 steps, a checkpoint every 2) goes through
  each package's ``ControlPlane`` and ``Agent(in_process=True)`` (the
  port's with ``device="cpu"`` and a one-device mesh, the reference's
  over the test session's 8 CPU devices, as ``tests/test_obs.py``
  runs it), each from a reset registry, alert engine and history ring
  (one sampling on every agent pass). ``report`` must give the same
  keys and the same phase names, with the accounting closing within the
  committed
  ``phase-accounting-closes`` tolerance; ``verify``, per run and
  fleet-wide, the same invariant ids with the same verdicts. Times
  differ between the packages, so they are not compared. One alert is a
  recorded divergence (ROADMAP.md, Queue 3): the JAX loop's first
  metrics window counts its compiling warm-up step, so its step-time
  histogram grows a tail and ``step-time-regression`` may fire there
  (leaving ``zero-unresolved-alerts`` failed); the port times only timed
  steps. That rule is the only one allowed to differ.
- The port's agent runs the history pass, then the alert pass, on every
  reconcile, fail-open, and the history pass refreshes the per-project
  quota gauges.
- ``MetricsRegistry.reset`` on the global registry drops the default
  metrics-history ring.
"""

import copy
import time

import pytest
import torch

JOB = {
    "kind": "operation",
    "component": {
        "name": "obs-plane",
        "run": {
            "kind": "jaxjob",
            "numProcesses": 1,
            "mesh": {"axes": {"dp": None}},
            "checkpointing": {"enabled": True, "intervalSteps": 2,
                              "asyncSave": False, "restoreOnStart": True},
            "runtime": {"model": "llama_tiny", "dataset": "lm_synthetic",
                        "steps": 5, "seq_len": 32, "global_batch_size": 8,
                        "log_every": 2},
        },
    },
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pkg(name):
    import importlib

    root = "polyaxon_tpu" if name == "jax" else "polyaxon_tpu_torch"
    return {n: importlib.import_module(f"{root}.{m}") for n, m in (
        ("agent", "agent"), ("controlplane", "controlplane"),
        ("lifecycle", "lifecycle"), ("metrics", "obs.metrics"),
        ("rules", "obs.rules"), ("history", "obs.history"),
        ("chaos", "chaos"))}


def _fresh(ns, cadence=None):
    """A reset registry, alert engine and default history ring; with a
    ``cadence``, a ring that samples at it (0: on every agent pass, so
    the quota gauges are sampled while the short run is live, however
    fast the host runs it)."""
    ns["chaos"].uninstall()
    ns["metrics"].REGISTRY.reset()
    ns["rules"].set_default_engine(None)
    ns["history"].set_default_history(
        None if cadence is None else ns["history"].MetricsHistory(
            ns["metrics"].REGISTRY, cadence=cadence))


def _run(name, home, passes=None):
    """(plane, uuid, agent) once the job has reached a terminal state."""
    ns = _pkg(name)
    _fresh(ns, cadence=0.0)
    plane = ns["controlplane"].ControlPlane(str(home))
    kw = {"device": "cpu"} if name == "torch" else {}
    agent = ns["agent"].Agent(plane, in_process=True, **kw)
    if passes is not None:
        for method in ("_sample_history", "_evaluate_alerts"):
            real = getattr(agent, method)

            def counted(real=real, method=method):
                passes.append(method)
                return real()

            setattr(agent, method, counted)
    job = copy.deepcopy(JOB)
    job["component"]["run"]["mesh"]["axes"]["dp"] = (
        8 if name == "jax" else 1)
    record = plane.submit(job)
    deadline = time.monotonic() + 300
    while time.monotonic() < deadline:
        agent.reconcile_once()
        if plane.get_run(record.uuid).is_done:
            break
        time.sleep(0.03)
    final = plane.get_run(record.uuid)
    assert final.status == ns["lifecycle"].V1Statuses.SUCCEEDED, (
        plane.get_statuses(record.uuid))
    return plane, record.uuid, agent


def _keys(tree):
    """The nested key structure of a report, without its values."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return type(tree).__name__


# See the module docstring: the only alert the packages may disagree on.
WARM_UP_RULE = "step-time-regression"


def _outcomes(result):
    return {v["invariant"]: v["verdict"] for v in result["verdicts"]}


def _rules(alerts):
    return {a["rule"] for a in alerts}


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    out = {}
    passes = []
    for name in ("jax", "torch"):
        home = tmp_path_factory.mktemp(f"plane-{name}")
        plane, uuid, agent = _run(name, home / "home",
                                  passes if name == "torch" else None)
        out[name] = (plane, uuid, agent)
    out["passes"] = passes
    yield out
    for name in ("jax", "torch"):
        _fresh(_pkg(name))


def test_report_has_the_reference_shape(planes):
    (jplane, juuid, _), (tplane, tuuid, _) = planes["jax"], planes["torch"]
    jrep, trep = jplane.report(juuid), tplane.report(tuuid)
    assert set(trep) == set(jrep)
    assert list(trep["phases"]) == list(jrep["phases"])
    for phase, entry in trep["phases"].items():
        assert set(entry) == set(jrep["phases"][phase]), phase
    assert _keys(trep["annotations"]) == _keys(jrep["annotations"])
    assert (trep["status"], trep["attempts"], trep["retries"]) == (
        jrep["status"], jrep["attempts"], jrep["retries"])
    assert _rules(trep["alerts"]) - {WARM_UP_RULE} == _rules(
        jrep["alerts"]) - {WARM_UP_RULE}
    # Windows end at the same steps; the JAX first window also holds
    # the warm-up step (the divergence above).
    assert ([w["to_step"] for w in trep["steps"]["windows"]]
            == [w["to_step"] for w in jrep["steps"]["windows"]])
    from polyaxon_tpu_torch.obs.oracle import load_invariants

    (closes,) = [i for i in load_invariants()
                 if i.id == "phase-accounting-closes"]
    wall = trep["wall_clock_ms"]
    assert wall > 0
    assert abs(trep["phase_sum_ms"] - wall) / wall <= closes.tolerance


@pytest.mark.parametrize("scope", ["run", "fleet"])
def test_verify_gives_the_reference_verdicts(planes, scope):
    results = {}
    for name in ("jax", "torch"):
        plane, uuid, _ = planes[name]
        results[name] = plane.verify(uuid if scope == "run" else None)
    jres, tres = results["jax"], results["torch"]
    assert len(tres["verdicts"]) == 16
    jout, tout = _outcomes(jres), _outcomes(tres)
    assert list(tout) == list(jout)
    assert set(tres) == set(jres)
    alerts = "zero-unresolved-alerts"
    assert {k: v for k, v in tout.items() if k != alerts} == {
        k: v for k, v in jout.items() if k != alerts}
    unresolved = {}
    for name, res in results.items():
        (verdict,) = [v for v in res["verdicts"] if v["invariant"] == alerts]
        unresolved[name] = _rules(
            verdict["evidence"].get("unresolved_alerts") or [])
    assert unresolved["torch"] - {WARM_UP_RULE} == (
        unresolved["jax"] - {WARM_UP_RULE})
    if unresolved["jax"] <= {WARM_UP_RULE} and not unresolved["torch"]:
        assert tout[alerts] == "pass"
    else:
        assert tout[alerts] == jout[alerts]
    for must in ("all-runs-terminal", "phase-accounting-closes",
                 "loss-continuity"):
        assert _outcomes(tres)[must] == "pass", must


def test_agent_runs_both_passes_in_order(planes):
    passes = planes["passes"]
    assert passes and passes.count("_sample_history") == passes.count(
        "_evaluate_alerts")
    assert passes[:2] == ["_sample_history", "_evaluate_alerts"]
    plane, uuid, agent = planes["torch"]
    from polyaxon_tpu_torch.obs import metrics as obs_metrics

    project = plane.get_run(uuid).project
    agent._history_refresh_t = None  # the next pass refreshes the gauges
    agent.reconcile_once()
    usage = obs_metrics.project_usage().snapshot()["series"]
    assert f"{project},runs" in usage
    assert obs_metrics.project_quota_limit().snapshot()["series"]


def test_passes_are_fail_open(tmp_path, monkeypatch):
    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.obs import history as obs_history
    from polyaxon_tpu_torch.obs import rules as obs_rules

    def boom(*a, **k):
        raise RuntimeError("broken telemetry")

    monkeypatch.setattr(obs_history, "default_history", boom)
    monkeypatch.setattr(obs_rules, "default_engine", boom)
    agent = Agent(ControlPlane(str(tmp_path)), device="cpu")
    assert agent.reconcile_once() == 0


def test_registry_reset_drops_the_default_ring():
    from polyaxon_tpu_torch.obs import history as obs_history
    from polyaxon_tpu_torch.obs import metrics as obs_metrics

    ring = obs_history.default_history()
    obs_metrics.REGISTRY.counter("polyaxon_test_reset_total", "").inc()
    ring.sample(force=True)
    ring.mark_window("w", start=True)
    assert ring.series_count() and ring.windows()
    obs_metrics.REGISTRY.reset()
    assert ring.series_count() == 0 and ring.windows() == []
    assert ring.coverage()["samples"] == 0
    # A private registry's reset leaves the shared ring alone.
    ring.sample(force=True)
    ring.mark_window("w", start=True)
    obs_metrics.MetricsRegistry().reset()
    assert ring.windows()
    obs_metrics.REGISTRY.reset()
