"""The port's executor and agent (``polyaxon_tpu_torch.agent``) against
the JAX package's, on the CPU.

- The init phases (``auth``, ``file``, ``artifacts`` from a local path
  and from a ``file://`` URL, ``tpu_metadata``) write byte-equal trees.
- Subprocess gangs whose command is a plain Python script reach
  SUCCEEDED, or FAILED on a non-zero exit, with the JAX executor's
  status history; ``stop`` and ``preempt`` reap as the JAX executor's do.
- A jaxjob run as a subprocess gang (the port's launcher, on the CPU)
  records that same history, its ``.auth`` file and a trace whose
  runtime spans parent under the gang's ``execute`` span.
- A plan's sync sidecar (``python -m polyaxon_tpu_torch.sidecar``) ships
  the run's files to the store as the JAX package's ``sync_tree`` does.
- What the port leaves out raises and names its ROADMAP item.
"""

import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "torch")


def pkg_ns(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        from polyaxon_tpu.agent import Agent, LocalExecutor
        from polyaxon_tpu.compiler import plan as plan_mod
        from polyaxon_tpu.controlplane import ControlPlane
        from polyaxon_tpu.lifecycle import V1Statuses
    else:
        from polyaxon_tpu_torch.agent import Agent, LocalExecutor
        from polyaxon_tpu_torch.compiler import plan as plan_mod
        from polyaxon_tpu_torch.controlplane import ControlPlane
        from polyaxon_tpu_torch.lifecycle import V1Statuses
    return SimpleNamespace(Agent=Agent, LocalExecutor=LocalExecutor,
                           plan=plan_mod, ControlPlane=ControlPlane,
                           V1Statuses=V1Statuses)


def tree(root: str) -> dict:
    """Relative path → bytes of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def init_sources(tmp_path) -> dict:
    src = tmp_path / "src"
    (src / "data" / "sub").mkdir(parents=True, exist_ok=True)
    (src / "data" / "a.txt").write_text("alpha\n")
    (src / "data" / "sub" / "b.bin").write_bytes(bytes(range(256)))
    (src / "weights.npy").write_bytes(b"\x93NUMPY" + bytes(64))
    return {"dir": str(src / "data"), "file": str(src / "weights.npy")}


INIT_CASES = {
    "auth": lambda s: [{"kind": "auth"}],
    "file": lambda s: [{"kind": "file", "config": {
        "filename": "conf/run.json", "content": '{"lr": 0.1}\n'}}],
    "artifacts-dir": lambda s: [{"kind": "artifacts", "path": s["dir"]}],
    "artifacts-file": lambda s: [{"kind": "artifacts",
                                  "config": {"path": s["file"]}}],
    "artifacts-file-url": lambda s: [{"kind": "artifacts",
                                      "config": {"path": "file://" + s["dir"]}}],
    "tpu_metadata": lambda s: [{"kind": "tpu_metadata"}],
    "all": lambda s: [{"kind": "auth"},
                      {"kind": "artifacts", "path": s["dir"]},
                      {"kind": "file", "config": {"filename": "x.sh",
                                                  "content": "echo x\n"}},
                      {"kind": "tpu_metadata"}],
}


def make_plan(ns, root: str, init: list, command=None) -> object:
    art = os.path.join(root, "run-1")
    return ns.plan.V1LaunchPlan.from_dict({
        "runUuid": "run-1", "runKind": "job", "artifactsDir": art,
        "outputsDir": os.path.join(art, "outputs"),
        "resources": {}, "init": init,
        "processes": [{"index": 0, "command": command or ["true"]}]})


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_phases_write_equal_files(case, tmp_path):
    sources = init_sources(tmp_path)
    trees = []
    for pkg in PKGS:
        ns = pkg_ns(pkg)
        plane = ns.ControlPlane(str(tmp_path / pkg / "home"))
        plan = make_plan(ns, str(tmp_path / pkg / "runs"),
                         INIT_CASES[case](sources))
        ns.LocalExecutor(plane)._run_init_phases(plan)
        trees.append(tree(plan.artifacts_dir))
    assert trees[0] == trees[1]
    assert trees[1]  # the phase wrote something
    if case == "auth":
        assert json.loads(trees[1][".auth"]) == {"run_uuid": "run-1",
                                                 "mode": "local"}


def test_init_path_escape_refused_alike(tmp_path):
    errors = []
    for pkg in PKGS:
        ns = pkg_ns(pkg)
        plane = ns.ControlPlane(str(tmp_path / pkg / "home"))
        plan = make_plan(ns, str(tmp_path / pkg / "runs"), [
            {"kind": "file", "config": {"filename": "../../escape",
                                        "content": "x"}}])
        with pytest.raises(RuntimeError) as err:
            ns.LocalExecutor(plane)._run_init_phases(plan)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def script_job(code: str) -> dict:
    return {"kind": "component", "run": {"kind": "job", "container": {
        "command": [sys.executable, "-c", code]}}}


def history(plane, uuid: str) -> list:
    return [(c["type"], c.get("reason")) for c in plane.get_statuses(uuid)]


@pytest.mark.parametrize("code,want", [
    ("import os, json; d = os.environ['POLYAXON_RUN_ARTIFACTS_PATH']; "
     "json.dump({'score': 0.5}, open(d + '/outputs.json', 'w')); "
     "print('ok')", "succeeded"),
    ("import sys; print('bad'); sys.exit(3)", "failed"),
])
def test_subprocess_gang_history(code, want, tmp_path):
    """A plain script gang: the same terminal status, status history,
    log and outputs in both packages."""
    seen = []
    for pkg in PKGS:
        ns = pkg_ns(pkg)
        plane = ns.ControlPlane(str(tmp_path / pkg))
        record = plane.submit(script_job(code))
        status = ns.Agent(plane).run_until_done(record.uuid, timeout=60,
                                                poll_seconds=0.05)
        last = plane.get_statuses(record.uuid)[-1]
        log = plane.streams.read_logs(record.uuid, "main-0.log")[0]
        seen.append((status.value, history(plane, record.uuid),
                     last.get("message"), log,
                     plane.streams.get_outputs(record.uuid)))
    assert seen[0] == seen[1]
    assert seen[1][0] == want
    if want == "failed":
        assert seen[1][2] == "exit code 3"


SLEEPER = "import time; time.sleep(30)"


def drive(agent, predicate, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        agent.reconcile_once()
        time.sleep(0.02)


@pytest.mark.parametrize("action", ["stop", "preempt"])
def test_stop_and_preempt_reap_alike(action, tmp_path, monkeypatch):
    """``plane.stop`` reaps STOPPED; ``executor.preempt`` reaps
    PREEMPTED and the scheduler requeues without a retry."""
    monkeypatch.setenv("POLYAXON_TPU_BACKOFF_BASE", "0.01")
    monkeypatch.setenv("POLYAXON_TPU_BACKOFF_MAX", "0.02")
    seen = []
    for pkg in PKGS:
        ns = pkg_ns(pkg)
        plane = ns.ControlPlane(str(tmp_path / pkg))
        agent = ns.Agent(plane)
        record = plane.submit(script_job(SLEEPER))
        drive(agent, lambda: record.uuid in agent.executor.active_runs)
        if action == "stop":
            plane.stop(record.uuid)
            drive(agent, lambda: plane.get_run(record.uuid).is_done)
        else:
            assert agent.executor.preempt(record.uuid)
            drive(agent, lambda: "retrying" in [
                c["type"] for c in plane.get_statuses(record.uuid)])
            assert plane.get_run(record.uuid).retries == 0
            plane.stop(record.uuid)
            drive(agent, lambda: plane.get_run(record.uuid).is_done
                  and not agent.executor.active_runs)
        seen.append([t for t, _ in history(plane, record.uuid)])
    assert seen[0] == seen[1]
    assert seen[1][-1] == "stopped"
    if action == "preempt":
        assert "preempted" in seen[1] and "retrying" in seen[1]


# The subprocess jaxjob: the launcher's process on the CPU (the plan's
# command runs on the card, so the test swaps in `launch.main(device=
# "cpu")` with the plan's env).
CPU_LAUNCHER = ("import sys; from polyaxon_tpu_torch.runtime import launch; "
                "sys.exit(launch.main(device='cpu'))")
SUBPROCESS_HISTORY = ["created", "compiled", "queued", "scheduled",
                      "starting", "running", "succeeded"]
TINY_JOB = {"kind": "operation", "name": "tiny", "component": {"run": {
    "kind": "jaxjob", "mesh": {"axes": {"dp": 1}},
    "checkpointing": {"enabled": True, "intervalSteps": 2},
    "runtime": {"model": "llama_tiny", "dataset": "lm_synthetic",
                "steps": 3, "seq_len": 32, "global_batch_size": 2,
                "attention_impl": "xla", "log_every": 1}}}}


def test_subprocess_jaxjob_gang(tmp_path, monkeypatch):
    """A jaxjob run by the port's agent as a subprocess gang: SUCCEEDED
    with SUBPROCESS_HISTORY (each hop a legal transition), the `auth`
    init phase's file, the launcher's tracking record and kernel-launch
    line in the gang's log, and its runtime spans parented under the
    gang's `execute` span."""
    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.lifecycle import V1Statuses, can_transition
    from polyaxon_tpu_torch.obs.trace import read_trace

    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    plane = ControlPlane(str(tmp_path / "home"))
    record = plane.submit(TINY_JOB)
    plane.compile_run(record.uuid)
    plan = plane.get_run(record.uuid).launch_plan
    proc = plan["processes"][0]
    assert proc["command"][1:] == ["-m", "polyaxon_tpu_torch.runtime.launch"]
    proc["command"] = [sys.executable, "-c", CPU_LAUNCHER]
    plane.store.update_run(record.uuid, launch_plan=plan)
    status = Agent(plane).run_until_done(record.uuid, timeout=120,
                                         poll_seconds=0.05)
    art = plane.run_artifacts_dir(record.uuid)
    log = plane.streams.read_logs(record.uuid, "main-0.log")[0]
    assert status == V1Statuses.SUCCEEDED, log[-2000:]
    types = [t for t, _ in history(plane, record.uuid)]
    assert types == SUBPROCESS_HISTORY
    assert all(can_transition(V1Statuses(a), V1Statuses(b))
               for a, b in zip(types, types[1:]))
    assert os.path.exists(os.path.join(art, ".auth"))
    assert [r["step"] for r in plane.streams.get_metrics(
        record.uuid, ["loss"])["loss"]] == [1, 2]
    assert plane.streams.get_outputs(record.uuid)["steps"] == 3
    assert any("checkpoints" in a
               for a in plane.streams.list_artifacts(record.uuid))
    lines = [json.loads(x) for x in log.splitlines() if x.startswith("{")]
    assert lines[-1] == {"launches": {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                      "flash_bwd_dq": 0, "paged_decode": 0}}
    spans = [r for r in read_trace(art) if r.get("type") == "span"]
    by_name = {}
    for span in spans:
        by_name.setdefault(span["name"], []).append(span)
    execute = by_name["execute"][0]
    runtime = by_name["runtime"][0]
    assert runtime["parent_id"] == execute["span_id"]
    assert runtime["trace_id"] == record.uuid
    for name in ("jit_compile", "step", "checkpoint"):
        assert all(s["parent_id"] == runtime["span_id"]
                   for s in by_name[name]), name
    assert by_name["init"][0]["parent_id"] == execute["span_id"]


def test_sidecar_syncs_the_run(tmp_path):
    """The sync sidecar of a compiled plan runs as ``python -m
    polyaxon_tpu_torch.sidecar`` and ships the run dir to the store: the
    store's tree equals the run's and what the JAX package's
    ``sync_tree`` ships from the same files."""
    from polyaxon_tpu.sidecar import sync_tree as jsync_tree
    from polyaxon_tpu_torch import polyaxonfile as tpf
    from polyaxon_tpu_torch.compiler import compile_operation

    store = tmp_path / "store"
    op = tpf.check_polyaxonfile(os.path.join(REPO, "tests", "fixtures",
                                             "mnist.yaml"))
    resolved = tpf.resolve_operation_context(op, run_uuid="u1",
                                             run_name="run",
                                             project_name="p")
    plan = compile_operation(resolved, run_uuid="u1",
                             artifacts_root=str(tmp_path / "runs"),
                             store_dir=str(store))
    sync = [s for s in plan.sidecars if s.kind == "sync"]
    assert len(sync) == 1
    cmd = sync[0].command
    assert cmd[1:3] == ["-m", "polyaxon_tpu_torch.sidecar"]
    run_dir = cmd[cmd.index("--run-dir") + 1]
    store_dir = cmd[cmd.index("--store-dir") + 1]
    os.makedirs(os.path.join(run_dir, "logs"))
    with open(os.path.join(run_dir, "logs", "main-0.log"), "w") as fh:
        fh.write("step 1\n")
    with open(os.path.join(run_dir, "outputs.json"), "w") as fh:
        json.dump({"loss": 0.25}, fh)
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen(cmd + ["--interval", "0.1"], env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        while tree(store_dir) != tree(run_dir):
            assert child.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=30)
    assert rc == 0
    jstore = tmp_path / "jax-store"
    jsync_tree(run_dir, str(jstore))
    assert tree(store_dir) == tree(str(jstore)) == tree(run_dir)
    # The sidecar's own `sync` span lands in the run dir and ships too.
    assert set(tree(run_dir)) == {"logs/main-0.log", "outputs.json",
                                  "events/span/lifecycle.jsonl"}
    from polyaxon_tpu_torch.obs.trace import read_trace

    assert {r["name"] for r in read_trace(run_dir)} == {"sync"}


def test_watchloop_module_runs(tmp_path):
    """``python -m polyaxon_tpu_torch.utils.watchloop`` (named by the
    port's watchdog plans) passes a failing iteration's exit code on."""
    out = subprocess.run(
        [sys.executable, "-m", "polyaxon_tpu_torch.utils.watchloop", "0.01",
         "--", sys.executable, "-c", "import sys; sys.exit(4)"],
        cwd=REPO, capture_output=True, timeout=60)
    assert out.returncode == 4


class TestRefusals:
    def test_slice_pool_names_item_10(self, tmp_path):
        from polyaxon_tpu_torch.agent import Agent
        from polyaxon_tpu_torch.controlplane import ControlPlane

        with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
            Agent(ControlPlane(str(tmp_path)), slice_manager=object())

    @pytest.mark.parametrize("method", ["report", "verify"])
    def test_report_and_verify_name_item_9(self, method, tmp_path):
        """Item 9 is ported: ``report`` and ``verify`` answer for a run
        that has not started, and refuse an unknown uuid as the JAX
        plane does."""
        from polyaxon_tpu_torch.controlplane import ControlPlane

        plane = ControlPlane(str(tmp_path))
        record = plane.submit(script_job("print(1)"))
        out = getattr(plane, method)(record.uuid)
        if method == "report":
            assert out["status"] == "created" and out["attempts"] == 0
        else:
            assert out["run_uuid"] == record.uuid
            assert len(out["verdicts"]) == 16
        with pytest.raises(KeyError):
            getattr(plane, method)("no-such-run")

    def test_compile_cache_env_sets_nothing(self, tmp_path, monkeypatch):
        """The JAX executor resolves POLYAXON_TPU_COMPILE_CACHE=1 to a
        shared XLA cache dir; the port has none and sets nothing."""
        from polyaxon_tpu_torch.agent import LocalExecutor
        from polyaxon_tpu_torch.controlplane import ControlPlane

        monkeypatch.setenv("POLYAXON_TPU_COMPILE_CACHE", "1")
        monkeypatch.delenv("POLYAXON_TPU_COMPILE_CACHE_DIR", raising=False)
        LocalExecutor(ControlPlane(str(tmp_path)))
        assert "POLYAXON_TPU_COMPILE_CACHE_DIR" not in os.environ

    def test_in_process_device_is_explicit(self, tmp_path):
        """An in-process gang trains where the caller says; without a
        device and without a GPU the run fails, naming CUDA."""
        import torch

        from polyaxon_tpu_torch.agent import Agent
        from polyaxon_tpu_torch.controlplane import ControlPlane
        from polyaxon_tpu_torch.lifecycle import V1Statuses

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        plane = ControlPlane(str(tmp_path))
        record = plane.submit(TINY_JOB)
        agent = Agent(plane, in_process=True)
        assert agent.executor.device is None
        assert agent.run_until_done(record.uuid, timeout=60,
                                    poll_seconds=0.05) == V1Statuses.FAILED
        assert "CUDA" in (plane.get_statuses(record.uuid)[-1].get("message")
                          or "")


ENV_PRINTER = ("import os; print(os.environ.get("
               "'POLYAXON_TPU_LOCAL_DEVICE_IDS', '-'))")
TWO_PROCESS_JOB = {"kind": "operation", "name": "pair", "component": {
    "run": {"kind": "jaxjob", "numProcesses": 2,
            "mesh": {"axes": {"dp": 2}},
            "runtime": {"model": "llama_tiny", "steps": 1}}}}


@pytest.mark.parametrize("pool,want", [
    ([0, 1, 2, 3], ["0,1", "2,3"]),
    ([4, 5], ["4", "5"]),
    ([0, 1, 2], None),
], ids=["four_cards", "two_cards", "three_cards"])
def test_plan_processes_hold_disjoint_cards(pool, want, tmp_path):
    """Each process of a two-process plan on one host is given its own
    share of the host's cards through POLYAXON_TPU_LOCAL_DEVICE_IDS
    (process p of P: cards [p·D/P, (p+1)·D/P)); a host whose D cards do
    not split over the P processes fails the plan at start."""
    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.agent.executor import device_shares
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    plane = ControlPlane(str(tmp_path / "home"))
    record = plane.submit(TWO_PROCESS_JOB)
    plane.compile_run(record.uuid)
    plan = plane.get_run(record.uuid).launch_plan
    assert len(plan["processes"]) == 2
    for proc in plan["processes"]:
        proc["command"] = [sys.executable, "-c", ENV_PRINTER]
    plane.store.update_run(record.uuid, launch_plan=plan)
    status = Agent(plane, local_devices=pool).run_until_done(
        record.uuid, timeout=60, poll_seconds=0.05)
    if want is None:
        assert status == V1Statuses.FAILED
        assert "do not split evenly" in plane.get_statuses(
            record.uuid)[-1]["message"]
        with pytest.raises(ValueError, match="split evenly"):
            device_shares(2, pool)
        return
    assert status == V1Statuses.SUCCEEDED
    got = [plane.streams.read_logs(record.uuid, f"main-{i}.log")[0].strip()
           for i in range(2)]
    assert got == want == device_shares(2, pool)
    # One process, or the CPU (no pool of cards), is given nothing.
    assert device_shares(1, pool) == [None]
    assert device_shares(2, None) == [None, None]
