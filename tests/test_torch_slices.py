"""The port's slice pool (``polyaxon_tpu_torch/native``,
``agent/slices.py``) against the JAX package's, on the CPU.

- Every scenario of ``tests/test_sliced.py``'s ``TestPlacement``,
  ``TestLiveness``, ``TestPreemption`` and ``TestReviewFixes`` runs, one
  case of one test, through both ``SlicePool``s: after every step the
  gang states, chips, free counts and drained events are equal.
- The ``sliced`` daemons answer one line-protocol script alike.
- ``TestAgentIntegration``'s three cases run through both agents and end
  in equal statuses and reasons.
- The pinning, which the JAX executor has no counterpart of (ROADMAP
  Queue 3): two runs of topology ``"2"`` on a slice ``"4"`` of four
  local devices hold disjoint cards, and a third waits QUEUED.

Normalisation: run uuids (and the gang ids that carry them) are not
compared across packages, and the agent cases compare status types and
reasons, not their times. The JAX package's pool is built from its own
sources with its own Makefile, into a directory of this test's, so this
file never races ``tests/test_sliced.py``'s build of ``native/build``.
"""

import os
import subprocess
import sys
import time

import pytest

from tests.torch_deadline import deadline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_build(tmp_path_factory):
    """(the JAX package's libsliced, its ``sliced`` binary), built here."""
    from polyaxon_tpu.native import sliced as ref

    from polyaxon_tpu_torch.native import ensure_built

    build = str(tmp_path_factory.mktemp("ref-native"))
    make = subprocess.Popen(
        ["make", "-j2", "-C", os.path.join(REPO, "native"), f"BUILD={build}",
         f"{build}/libsliced.so", f"{build}/sliced"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ensure_built()  # the port's two targets, meanwhile
    log = make.communicate()[0]
    assert make.returncode == 0, log
    saved = ref._LIB_PATH, ref._lib
    ref._LIB_PATH, ref._lib = os.path.join(build, "libsliced.so"), None
    try:
        lib = ref._load()
    finally:
        ref._LIB_PATH, ref._lib = saved
    return lib, os.path.join(build, "sliced")


def ref_pool(lib):
    from polyaxon_tpu.native import sliced as ref

    pool = object.__new__(ref.SlicePool)
    pool._lib, pool._handle = lib, lib.sliced_new()
    return pool


# Each scenario is a list of steps; a step's result and the pool's state
# after it are recorded. Gang handles are the index of their request.
SCENARIOS = {
    "simple_placement": [("add", "a", "4x4", False), ("req", "run-1", "2x2"),
                         ("tick", 0.0)],
    "contiguous_sub_torus": [("add", "a", "4x4", False), ("req", "r", "2x2")],
    "fills_to_capacity_then_queues": [
        ("add", "a", "4x4", False), *[("req", f"r{i}", "2x2")
                                      for i in range(4)],
        ("req", "r-extra", "2x2"), ("rel", 0), ("tick", 0.0)],
    "dimension_permutation": [("add", "a", "8x2", False), ("req", "r", "8")],
    "never_fits_raises": [("add", "a", "2x2", False), ("req", "r", "4x4")],
    "malformed_topology_raises": [("add", "a", "2x2", False),
                                  ("req", "r", "2xx")],
    "tightest_fit_first": [("add", "big", "8x8", False),
                           ("add", "small", "2x2", False),
                           ("req", "r", "2x2"), ("req", "r2", "8x8")],
    "heartbeat_timeout_restarts_then_fails": [
        ("add", "a", "2x2", False), ("req", "r", "2x2", 0, 1), ("tick", 0.0),
        ("hb", 0, 0, 0.0), ("tick", 100.0, 30.0), ("hb", 0, 0, 110.0),
        ("tick", 200.0, 30.0)],
    "no_heartbeats_means_no_timeout": [("add", "a", "2x2", False),
                                       ("req", "r", "2x2"), ("tick", 0.0),
                                       ("tick", 1e6)],
    "slice_eviction": [("add", "spot", "2x2", True), ("req", "r", "2x2"),
                       ("tick", 0.0), ("pre", "spot"), ("tick", 0.0)],
    "priority_evicts_lower_on_preemptible": [
        ("add", "spot", "2x2", True), ("req", "low", "2x2", 0),
        ("tick", 0.0), ("req", "high", "2x2", 10), ("tick", 0.0)],
    "priority_never_evicts_on_reserved": [
        ("add", "reserved", "2x2", False), ("req", "low", "2x2", 0),
        ("req", "high", "2x2", 10)],
    "higher_dim_request_rejected_not_underallocated": [
        ("add", "a", "8x8", False), ("req", "r", "2x2x2")],
    "release_erases_gang": [("add", "a", "2x2", False), ("req", "r", "2x2"),
                            ("rel", 0)],
    "eviction_is_minimal": [
        ("add", "spot", "8x8", True),
        *[("req", f"low{i}", "2x2", 0) for i in range(4)], ("tick", 0.0),
        ("req", "high", "2x2", 10),
        *[("req", f"fill{i}", "2x2", 0) for i in range(11)], ("tick", 0.0),
        ("req", "high2", "2x2", 10), ("tick", 0.0)],
    # The GPU host's slice: four cards, runs asking for some of them.
    "gpu_host_cards": [("add", "gpu0", "4", False), ("req", "a", "2"),
                       ("req", "b", "1"), ("req", "c", "2"), ("rel", 0),
                       ("req", "d", "4"), ("rel", 1), ("tick", 0.0)],
}


def drive(pool, error_type, steps) -> list:
    """One record per step: what it returned and the pool's state."""
    gangs, slices, trail = [], [], []
    for step in steps:
        op, *args = step
        try:
            if op == "add":
                pool.add_slice(args[0], args[1], preemptible=args[2])
                slices.append(args[0])
                out = None
            elif op == "req":
                priority, restarts = (list(args[2:]) + [0, 0])[:2]
                gangs.append(pool.request_gang(
                    args[0], args[1], priority=priority,
                    max_restarts=restarts))
                out = None
            elif op == "rel":
                out = pool.release_gang(gangs[args[0]])
            elif op == "hb":
                out = pool.heartbeat(gangs[args[0]], args[1], args[2])
            elif op == "pre":
                out = pool.preempt_slice(args[0])
            else:
                timeout = args[1] if len(args) > 1 else 30.0
                by_id = {g: i for i, g in enumerate(gangs)}
                out = [(by_id.get(e.gang_id), e.kind, e.detail)
                       for e in pool.tick(args[0], heartbeat_timeout=timeout)]
        except error_type as exc:
            gangs.append(None) if op == "req" else None
            out = ("error", str(exc))
        state = []
        for gid in gangs:
            try:
                g = pool.gang(gid) if gid is not None else None
            except error_type as exc:
                state.append(("error", str(exc)))
                continue
            state.append(None if g is None else (
                g.state, g.slice, g.topology, g.offset, g.shape, g.chips,
                g.restarts, g.run_uuid))
        free = {name: pool.free_chips(name) for name in slices}
        trail.append((step, out, state, free))
    return trail


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_scenarios(name, ref_build):
    from polyaxon_tpu.native import SlicedError as RefError
    from polyaxon_tpu_torch.native import SlicePool, SlicedError

    ref = ref_pool(ref_build[0])
    try:
        want = drive(ref, RefError, SCENARIOS[name])
    finally:
        ref.close()
    with SlicePool() as pool:
        got = drive(pool, SlicedError, SCENARIOS[name])
    assert got == want
    assert any(rec[2] for rec in got)  # each scenario requests a gang


def test_daemon_line_protocol(ref_build):
    """The same script through both ``sliced`` binaries, the same
    replies line for line."""
    from polyaxon_tpu_torch.native import daemon_path

    script = ("ADD a 4x4 0\nADD gpu0 4 0\nADD a 2x2 0\nREQ run-1 2x2 0 0\n"
              "REQ run-2 2 5 1\nREQ run-3 9x9 0 0\nREQ bad 2xx 0 0\n"
              "INFO 1\nINFO 2\nINFO 99\nHB 2 0 1.5\nTICK 100 30\n"
              "PRE gpu0\nPRE nowhere\nTICK 101 30\nREL 1\nREL 1\nBOGUS\n"
              "QUIT\n")
    outs = [subprocess.run([binary], input=script, capture_output=True,
                           text=True, timeout=30).stdout
            for binary in (ref_build[1], daemon_path())]
    assert outs[0] == outs[1]
    lines = outs[1].splitlines()
    assert lines[:3] == ["ok", "ok", "err"]
    assert any("PLACED" in line for line in lines)


def _tpu_job(sleep=0.2, topology="2x2", preemptible=False):
    return {"kind": "component", "run": {
        "kind": "job",
        "environment": {"tpu": {"accelerator": "v5e", "topology": topology,
                                "preemptible": preemptible}},
        "container": {"command": [
            sys.executable, "-c", f"import time; time.sleep({sleep})"]}}}


def _ns(pkg):
    if pkg == "jax":
        from polyaxon_tpu.agent import Agent, SliceManager
        from polyaxon_tpu.controlplane import ControlPlane
    else:
        from polyaxon_tpu_torch.agent import Agent, SliceManager
        from polyaxon_tpu_torch.controlplane import ControlPlane
    return Agent, SliceManager, ControlPlane


def _conditions(plane, uuid):
    return [(c["type"], c.get("reason")) for c in plane.get_statuses(uuid)]


def _gates_capacity(pkg, plane, Agent, SliceManager):
    manager = SliceManager([("a", "2x2", False)])
    try:
        agent = Agent(plane, max_concurrent=8, slice_manager=manager)
        first = plane.submit(_tpu_job(sleep=1.0))
        second = plane.submit(_tpu_job(sleep=0.1))
        agent.reconcile_once()
        agent.reconcile_once()
        mid = (plane.get_run(first.uuid).status.value in ("running",
                                                          "starting"),
               plane.get_run(second.uuid).status.value)
        agent.run_until_done(second.uuid, timeout=60)
        agent.run_until_done(first.uuid, timeout=60)
        return mid, [_conditions(plane, r.uuid) for r in (first, second)]
    finally:
        manager.close()


def _unschedulable(pkg, plane, Agent, SliceManager):
    manager = SliceManager([("a", "2x2", False)])
    try:
        agent = Agent(plane, slice_manager=manager)
        record = plane.submit(_tpu_job(topology="8x8"))
        agent.reconcile_once()
        agent.reconcile_once()
        last = plane.get_statuses(record.uuid)[-1]
        return (plane.get_run(record.uuid).status.value, last.get("reason"),
                last.get("message"))
    finally:
        manager.close()


def _preemption_requeues(pkg, plane, Agent, SliceManager):
    manager = SliceManager([("spot", "2x2", True)])
    try:
        agent = Agent(plane, slice_manager=manager)
        record = plane.submit(_tpu_job(sleep=30, preemptible=True))
        end = time.monotonic() + 20
        while record.uuid not in agent.executor.active_runs:
            assert time.monotonic() < end
            agent.reconcile_once()
            time.sleep(0.05)
        evicted = manager.preempt_slice("spot")
        end = time.monotonic() + 20
        while True:
            agent.reconcile_once()
            types = [c[0] for c in _conditions(plane, record.uuid)]
            if "preempted" in types and "retrying" in types:
                break
            assert time.monotonic() < end
            time.sleep(0.05)
        plane.stop(record.uuid)
        agent.reconcile_once()
        seen = _conditions(plane, record.uuid)
        types = [c[0] for c in seen]
        return evicted, seen[:types.index("retrying") + 1]
    finally:
        manager.close()


@pytest.mark.parametrize("case", [_gates_capacity, _unschedulable,
                                  _preemption_requeues],
                         ids=["topology_gates_capacity",
                              "unschedulable_topology_fails",
                              "slice_preemption_requeues_run"])
@deadline(120)
def test_agent_integration(case, ref_build, tmp_path, monkeypatch):
    from polyaxon_tpu.native import sliced as ref

    # The JAX SliceManager's pools load the library built here.
    monkeypatch.setattr(ref, "_lib", ref_build[0])
    seen = {}
    for pkg in ("jax", "torch"):
        Agent, SliceManager, ControlPlane = _ns(pkg)
        plane = ControlPlane(str(tmp_path / pkg))
        seen[pkg] = case(pkg, plane, Agent, SliceManager)
    assert seen["torch"] == seen["jax"]


@deadline(120)
def test_pinned_cards_are_disjoint(tmp_path):
    """Two runs of topology ``"2"`` on slice ``"4"`` of four local
    devices hold disjoint cards (``POLYAXON_TPU_LOCAL_DEVICE_IDS`` in
    each run's process), a third waits QUEUED until one finishes, and
    the placement span names the pool."""
    from polyaxon_tpu_torch.agent import Agent, SliceManager
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.obs.trace import read_trace

    plane = ControlPlane(str(tmp_path / "home"))
    manager = SliceManager([("gpu0", "4", False)])
    try:
        agent = Agent(plane, max_concurrent=8, slice_manager=manager,
                      local_devices=4)
        code = ("import os, time; print('cards', "
                "os.environ['POLYAXON_TPU_LOCAL_DEVICE_IDS'], flush=True); "
                "time.sleep(0.5)")
        job = {"kind": "component", "run": {
            "kind": "job", "environment": {"tpu": {"topology": "2"}},
            "container": {"command": [sys.executable, "-c", code]}}}
        runs = [plane.submit(job) for _ in range(3)]
        agent.reconcile_once()
        agent.reconcile_once()
        statuses = [plane.get_run(r.uuid).status for r in runs]
        assert statuses[2] == V1Statuses.QUEUED, statuses
        held = [set(agent.executor._gangs[r.uuid].devices) for r in runs[:2]]
        assert held[0] | held[1] == {0, 1, 2, 3} and not held[0] & held[1]
        for r in runs:
            assert agent.run_until_done(r.uuid, timeout=60) == \
                V1Statuses.SUCCEEDED
        printed = []
        for r in runs:
            text, _ = plane.streams.read_logs(r.uuid, "main-0.log")
            printed.append(text.split()[1])
            span = [s for s in read_trace(plane.run_artifacts_dir(r.uuid))
                    if s.get("name") == "placement"][0]
            assert span["attributes"]["provider"] == "slice_pool"
        assert sorted(printed[:2]) == ["0,1", "2,3"]
        assert printed[2] in ("0,1", "2,3")
    finally:
        manager.close()
