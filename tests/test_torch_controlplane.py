"""The port's lifecycle, control plane, scheduler and admission
(``polyaxon_tpu_torch.lifecycle``, ``.controlplane``, ``.scheduling``)
against the JAX package's, on the CPU.

- ``can_transition`` over every pair of statuses, the status sets and
  ``StatusTracker`` sequences are equal in both packages.
- Each plane, on its own temporary home, gets the same submissions:
  every ``examples/*.yaml``, ``tests/fixtures/*.yaml`` and the two
  acceptance specs, with no preset and with each preset of
  ``tests/fixtures/presets``. Each is submitted, compiled and given one
  scheduler tick; the records (kind, status, conditions, spec, resolved
  spec, launch plan with the JAX launcher's module names mapped to the
  port's, params, meta) must be equal once run uuids and the home are
  named alike, or both planes must refuse with the same exception class
  and message.
- Scripted admission ticks give the same decisions (cases from
  ``tests/test_scheduling.py``, run on each package), and so do cron's
  ``next_fire`` on fixed times and join resolution (cases from
  ``tests/test_schedules_cache.py`` and ``tests/test_joins_events.py``),
  as do run memoization, hub refs and terminal hooks driven by each
  package's agent. ``tests/test_class_admission.py`` holds the serving
  engine's request classes, which the port has not reached (ROADMAP.md,
  Queue 1 item 5).
"""

import datetime as dt
import json
import os
import random
import time
from types import SimpleNamespace

import pytest

from tests.test_torch_compiler import RENAMES, comparable
from tests.test_torch_polyaxonfile import (PRESETS, SPECS, outcome,
                                           preset_list, spec_source)

PKGS = ("jax", "torch")
SEED = 0


def pkg_ns(pkg: str) -> SimpleNamespace:
    if pkg == "jax":
        from polyaxon_tpu import chaos, lifecycle
        from polyaxon_tpu.controlplane import ControlPlane, Scheduler
        from polyaxon_tpu.controlplane import cron, joins
        from polyaxon_tpu import scheduling
    else:
        from polyaxon_tpu_torch import chaos, lifecycle
        from polyaxon_tpu_torch.controlplane import ControlPlane, Scheduler
        from polyaxon_tpu_torch.controlplane import cron, joins
        from polyaxon_tpu_torch import scheduling
    return SimpleNamespace(
        pkg=pkg, chaos=chaos, lifecycle=lifecycle, cron=cron, joins=joins,
        scheduling=scheduling, ControlPlane=ControlPlane,
        Scheduler=Scheduler, S=lifecycle.V1Statuses)


@pytest.fixture(params=PKGS)
def ns(request):
    return pkg_ns(request.param)


@pytest.fixture()
def plane(ns, tmp_path):
    return ns.ControlPlane(str(tmp_path / "home"))


# ------------------------------------------------------------ lifecycle
STATUS_VALUES = [s.value for s in pkg_ns("jax").S]


def test_statuses_and_sets_equal():
    j, t = pkg_ns("jax").lifecycle, pkg_ns("torch").lifecycle
    assert [s.value for s in j.V1Statuses] == [s.value for s in t.V1Statuses]
    for name in ("DONE_STATUSES", "RUNNABLE_STATUSES", "PENDING_STATUSES",
                 "LIVE_STATUSES"):
        assert ({s.value for s in getattr(j, name)}
                == {s.value for s in getattr(t, name)}), name


@pytest.mark.parametrize("current", STATUS_VALUES)
def test_can_transition_row(current):
    """One row of the transition table: ``current`` to every status."""
    rows = []
    for pkg in PKGS:
        lc = pkg_ns(pkg).lifecycle
        rows.append([(lc.can_transition(lc.V1Statuses(current),
                                        lc.V1Statuses(t)),
                      lc.is_done(lc.V1Statuses(current)))
                     for t in STATUS_VALUES])
    assert rows[0] == rows[1]


TRACKER_SEQUENCES = {
    "happy": ["compiled", "queued", "scheduled", "starting", "running",
              "succeeded"],
    "preempted-requeued": ["compiled", "queued", "scheduled", "running",
                           "preempted", "retrying", "queued", "scheduled",
                           "running", "failed"],
    "stopped": ["compiled", "queued", "stopping", "stopped", "done",
                "running"],
    "illegal-hops": ["queued", "compiled", "running", "succeeded",
                     "failed"],
    "warning": ["compiled", "queued", "scheduled", "running", "warning",
                "running", "processing", "succeeded"],
    "cache": ["awaiting_cache", "succeeded", "skipped"],
}


@pytest.mark.parametrize("seq", sorted(TRACKER_SEQUENCES))
def test_status_tracker_sequence(seq):
    """Each hop of a sequence through ``StatusTracker.transition``: the
    new status and condition, or the same ``LifecycleError``; then the
    same forced hop."""
    seen = []
    for pkg in PKGS:
        lc = pkg_ns(pkg).lifecycle
        tracker = lc.StatusTracker()
        steps = []
        for target in TRACKER_SEQUENCES[seq]:
            try:
                cond = tracker.transition(lc.V1Statuses(target),
                                          reason="r", message="m")
                steps.append(("ok", cond.type.value, cond.reason,
                              cond.message, tracker.is_done))
            except lc.LifecycleError as exc:
                steps.append(("refused", str(exc)))
        tracker.transition(lc.V1Statuses.UNKNOWN, force=True)
        steps.append([c.type.value for c in tracker.conditions])
        seen.append(steps)
    assert seen[0] == seen[1]


# -------------------------------------------------- the planes, side by side
def _normalize(obj, home: str, uuids: dict):
    text = json.dumps(obj, sort_keys=True, default=str)
    for uuid, name in uuids.items():
        text = text.replace(uuid, name)
    return json.loads(text.replace(home, "HOME"))


class _SeededRandom(random.Random):
    """``random.Random`` whose unseeded instances start from SEED: an
    unseeded sweep's manager draws from ``random.Random(None)`` (the OS's
    entropy), which the two planes must share to be compared."""

    def __init__(self, x=None):
        super().__init__(SEED if x is None else x)


def plane_snapshot(pkg: str, spec: str, preset, home: str, monkeypatch):
    """Submit, compile and tick once on a fresh plane; every record,
    normalised, or the refusal."""
    monkeypatch.setattr(random, "Random", _SeededRandom)
    ns = pkg_ns(pkg)
    plane = ns.ControlPlane(home)
    submitted = outcome(lambda: plane.submit(
        spec_source(spec), presets=preset_list(preset)).uuid)
    if submitted[0] != "ok":
        return [submitted]
    compiled = outcome(lambda: plane.compile_run(submitted[1]).status.value)
    random.seed(SEED)  # an unseeded sweep's base seed, as in a tick
    ticked = outcome(lambda: ns.Scheduler(plane).tick())
    records = plane.list_runs()
    uuids = {r.uuid: f"RUN{i}" for i, r in enumerate(records)}
    renames = RENAMES if pkg == "jax" else {}
    out = [compiled, ticked]
    for r in records:
        plan = comparable(r.launch_plan, renames) if r.launch_plan else None
        out.append({
            "kind": str(r.kind), "status": r.status.value, "name": r.name,
            "conditions": [(c["type"], c.get("reason"), c.get("message"))
                           for c in plane.get_statuses(r.uuid)],
            "spec": r.spec, "resolved_spec": r.resolved_spec,
            "launch_plan": plan, "params": r.params, "meta": r.meta,
            "tags": r.tags, "pipeline": r.pipeline_uuid,
            "iteration": r.iteration})
    return _normalize(out, os.path.abspath(home), uuids)


CASES = [(s, p) for s in SPECS for p in PRESETS]


@pytest.mark.parametrize("spec,preset", CASES,
                         ids=[f"{s}|{p or 'none'}" for s, p in CASES])
def test_plane_records_equal(spec, preset, tmp_path, monkeypatch):
    jax_out = plane_snapshot("jax", spec, preset, str(tmp_path / "jax"),
                             monkeypatch)
    torch_out = plane_snapshot("torch", spec, preset, str(tmp_path / "torch"),
                               monkeypatch)
    assert jax_out == torch_out


# ------------------------------------------ scheduling (test_scheduling.py)
def job_spec(*, sleep=0.1, queue=None, priority_class=None, topology=None,
             preemptible=False):
    env = {}
    if priority_class:
        env["priorityClassName"] = priority_class
    if topology:
        env["tpu"] = {"accelerator": "v5e", "topology": topology,
                      "preemptible": preemptible}
    spec = {"kind": "operation", "component": {"run": {
        "kind": "job", **({"environment": env} if env else {}),
        "container": {"command": [
            "python", "-c", f"import time; time.sleep({sleep})"]}}}}
    if queue:
        spec["queue"] = queue
    return spec


def submit_queued(plane, project="default", **kwargs):
    record = plane.submit(job_spec(**kwargs), project=project)
    plane.compile_run(record.uuid)
    return plane.get_run(record.uuid)


def mark_running(ns, plane, record):
    for status in (ns.S.SCHEDULED, ns.S.STARTING, ns.S.RUNNING):
        plane.store.transition(record.uuid, status)
    return plane.get_run(record.uuid)


class TestCatalog:
    def test_priority_classes(self, ns):
        sch = ns.scheduling
        assert sch.resolve_priority_class(None) == \
            sch.PRIORITY_CLASSES["default"]
        assert sch.resolve_priority_class("CRITICAL") == 3
        with pytest.raises(sch.SchedulingError,
                           match="unknown priority class"):
            sch.resolve_priority_class("platinum")

    def test_gang_priority_queue_dominates_class(self, ns):
        gp = ns.scheduling.gang_priority
        assert gp(1, 0) > gp(0, 3)
        assert gp(0, 2) > gp(0, 1)

    def test_queue_crud_roundtrip(self, plane):
        plane.upsert_queue("prod", priority=10, concurrency=2,
                           preemptible=False)
        row = plane.store.get_queue("prod")
        assert row["priority"] == 10 and row["concurrency"] == 2
        plane.upsert_queue("prod", priority=20)
        assert plane.store.get_queue("prod")["priority"] == 20
        assert plane.delete_queue("prod")
        assert plane.store.get_queue("prod") is None
        with pytest.raises(ValueError, match="default queue"):
            plane.delete_queue("default")

    def test_quota_crud_roundtrip(self, plane):
        plane.set_quota("team-a", max_runs=3, max_chips=16, weight=2.0)
        row = plane.store.get_quota("team-a")
        assert row["max_runs"] == 3 and row["weight"] == 2.0
        assert plane.delete_quota("team-a")
        assert plane.store.get_quota("team-a") is None


class TestCompileValidation:
    def test_unknown_queue_fails_at_compile(self, ns, plane):
        record = plane.submit(job_spec(queue="nope"))
        with pytest.raises(ns.scheduling.SchedulingError,
                           match="unknown queue"):
            plane.compile_run(record.uuid)

    def test_unknown_priority_class_fails_at_compile(self, ns, plane):
        record = plane.submit(job_spec(priority_class="platinum"))
        with pytest.raises(ns.scheduling.SchedulingError,
                           match="unknown priority class"):
            plane.compile_run(record.uuid)

    def test_scheduler_tick_fails_bad_queue_run_not_loop(self, ns, plane):
        record = plane.submit(job_spec(queue="nope"))
        ns.Scheduler(plane).tick()
        assert plane.get_run(record.uuid).status == ns.S.FAILED
        last = plane.get_statuses(record.uuid)[-1]
        assert "unknown queue" in (last.get("message") or "")

    def test_compile_stamps_scheduling_meta(self, plane):
        plane.upsert_queue("prod", priority=7)
        record = submit_queued(plane, queue="prod", priority_class="high",
                               topology="2x2")
        assert record.meta["scheduling"] == {
            "queue": "prod", "priority_class": "high", "priority": 2,
            "chips": 4, "preemptible": False}

    def test_sched_info_fallback_without_stamp(self, ns, plane):
        plane.upsert_queue("prod", priority=7)
        record = submit_queued(plane, queue="prod", priority_class="high",
                               topology="2x2")
        meta = dict(record.meta)
        meta.pop("scheduling")
        plane.store.update_run(record.uuid, meta=meta)
        info = ns.scheduling.sched_info(plane.get_run(record.uuid))
        assert info.queue == "prod" and info.priority == 2
        assert info.chips == 4


class TestAdmission:
    def test_queue_priority_orders_admission(self, ns, plane):
        plane.upsert_queue("prod", priority=10)
        plane.upsert_queue("batch", priority=0)
        low = submit_queued(plane, queue="batch")
        high = submit_queued(plane, queue="prod")
        decision = ns.scheduling.AdmissionController(plane).plan(
            plane.list_runs(statuses=[ns.S.QUEUED]), capacity=2,
            active=set())
        assert [r.uuid for r, _ in decision.admitted] == [high.uuid,
                                                           low.uuid]

    def test_fair_share_converges_to_weights(self, ns, plane):
        plane.set_quota("heavy", weight=2.0)
        plane.set_quota("light", weight=1.0)
        for _ in range(9):
            submit_queued(plane, project="heavy")
        for _ in range(9):
            submit_queued(plane, project="light")
        controller = ns.scheduling.AdmissionController(plane)
        counts = {"heavy": 0, "light": 0}
        for _ in range(3):
            decision = controller.plan(plane.list_runs(
                statuses=[ns.S.QUEUED]), capacity=3, active=set())
            for record, _ in decision.admitted[:3]:
                mark_running(ns, plane, record)
                counts[record.project] += 1
        assert counts == {"heavy": 6, "light": 3}

    def test_quota_max_runs_blocks_with_visible_condition(self, ns, plane):
        plane.set_quota("team-a", max_runs=1)
        mark_running(ns, plane, submit_queued(plane, project="team-a"))
        blocked = submit_queued(plane, project="team-a")
        controller = ns.scheduling.AdmissionController(plane)
        decision = controller.plan([plane.get_run(blocked.uuid)],
                                   capacity=4, active=set())
        assert decision.admitted == []
        assert decision.blocked[blocked.uuid] == "QuotaExceeded"
        conditions = plane.get_statuses(blocked.uuid)
        assert conditions[-1]["type"] == "queued"
        assert conditions[-1]["reason"] == "QuotaExceeded"
        controller.plan([plane.get_run(blocked.uuid)], capacity=4,
                        active=set())
        assert len(plane.get_statuses(blocked.uuid)) == len(conditions)

    def test_quota_max_chips_blocks_topology_runs(self, ns, plane):
        plane.set_quota("team-a", max_chips=4)
        mark_running(ns, plane, submit_queued(plane, project="team-a",
                                              topology="2x2"))
        blocked = submit_queued(plane, project="team-a", topology="2x2")
        small = submit_queued(plane, project="team-a")
        decision = ns.scheduling.AdmissionController(plane).plan(
            [plane.get_run(blocked.uuid), plane.get_run(small.uuid)],
            capacity=4, active=set())
        assert [r.uuid for r, _ in decision.admitted] == [small.uuid]
        assert decision.blocked[blocked.uuid] == "QuotaExceeded"

    def test_queue_concurrency_cap(self, ns, plane):
        plane.upsert_queue("narrow", priority=0, concurrency=1)
        mark_running(ns, plane, submit_queued(plane, queue="narrow"))
        blocked = submit_queued(plane, queue="narrow")
        decision = ns.scheduling.AdmissionController(plane).plan(
            [plane.get_run(blocked.uuid)], capacity=4, active=set())
        assert decision.admitted == []
        assert decision.blocked[blocked.uuid] == "QueueSaturated"

    def test_starved_high_priority_picks_one_lowest_victim(self, ns, plane):
        plane.upsert_queue("batch", priority=0, preemptible=True)
        plane.upsert_queue("prod", priority=10)
        victims = [submit_queued(plane, queue="batch") for _ in range(2)]
        for v in victims:
            mark_running(ns, plane, v)
        high = submit_queued(plane, queue="prod", priority_class="critical")
        controller = ns.scheduling.AdmissionController(plane,
                                                       starvation_ticks=2)
        active = {v.uuid for v in victims}
        decision = controller.plan([plane.get_run(high.uuid)], capacity=0,
                                   active=active)
        assert decision.victims == []
        decision = controller.plan([plane.get_run(high.uuid)], capacity=0,
                                   active=active)
        assert len(decision.victims) == 1
        victim = plane.get_run(decision.victims[0])
        assert victim.uuid in active
        assert victim.meta["scheduling"]["evicted_for"] == high.uuid

    def test_non_preemptible_queue_is_never_victimized(self, ns, plane):
        plane.upsert_queue("prod", priority=10)
        low = mark_running(ns, plane, submit_queued(plane))
        high = submit_queued(plane, queue="prod")
        controller = ns.scheduling.AdmissionController(plane,
                                                       starvation_ticks=1)
        decision = controller.plan([plane.get_run(high.uuid)], capacity=0,
                                   active={low.uuid})
        assert decision.victims == []

    def test_quota_wall_never_triggers_preemption(self, ns, plane):
        plane.upsert_queue("batch", priority=0, preemptible=True)
        plane.upsert_queue("prod", priority=10)
        plane.set_quota("greedy", max_runs=1)
        low = mark_running(ns, plane, submit_queued(plane, queue="batch"))
        running = mark_running(ns, plane, submit_queued(plane,
                                                        project="greedy"))
        blocked = submit_queued(plane, project="greedy", queue="prod")
        controller = ns.scheduling.AdmissionController(plane,
                                                       starvation_ticks=1)
        for _ in range(3):
            decision = controller.plan([plane.get_run(blocked.uuid)],
                                       capacity=0,
                                       active={low.uuid, running.uuid})
        assert decision.victims == []
        assert decision.blocked[blocked.uuid] == "QuotaExceeded"

    def test_admission_fault_starves_named_queue(self, ns, plane):
        plane.upsert_queue("batch", priority=0)
        record = submit_queued(plane, queue="batch")
        other = submit_queued(plane)
        fault_plan = ns.chaos.install(ns.chaos.ChaosPlan.from_dict(
            {"faults": [{"seam": "admission", "op": "batch", "times": 2}]}))
        try:
            controller = ns.scheduling.AdmissionController(plane)
            for _ in range(2):
                decision = controller.plan(
                    [plane.get_run(record.uuid), plane.get_run(other.uuid)],
                    capacity=4, active=set())
                assert [r.uuid for r, _ in decision.admitted] == [other.uuid]
                assert decision.blocked[record.uuid] == "ChaosStarved"
            decision = controller.plan([plane.get_run(record.uuid)],
                                       capacity=4, active=set())
            assert [r.uuid for r, _ in decision.admitted] == [record.uuid]
            assert fault_plan.done
        finally:
            ns.chaos.uninstall()


def scripted_admission(pkg: str, home: str) -> list:
    """Queues, quotas, priorities and a preemptible flood through eight
    admission ticks; each tick's admitted, blocked and victim runs by
    submission index, and the conditions the ticks pinned."""
    ns = pkg_ns(pkg)
    plane = ns.ControlPlane(home)
    plane.upsert_queue("prod", priority=10, concurrency=2)
    plane.upsert_queue("batch", priority=0, preemptible=True)
    plane.set_quota("team-a", max_runs=2, weight=2.0)
    plane.set_quota("team-b", max_chips=8, weight=1.0)
    order = []
    for i in range(12):
        record = submit_queued(
            plane, project=("team-a", "team-b", "default")[i % 3],
            queue=("prod", "batch", None)[i % 3 if i < 9 else 1],
            priority_class=(None, "high", "low", "critical")[i % 4],
            topology="2x2" if i % 2 else None)
        order.append(record.uuid)
    index = {u: i for i, u in enumerate(order)}
    controller = ns.scheduling.AdmissionController(plane, starvation_ticks=2)
    active: set = set()
    out = []
    for tick in range(8):
        decision = controller.plan(plane.list_runs(statuses=[ns.S.QUEUED]),
                                   capacity=2 if tick % 3 else 0,
                                   active=active)
        admitted = [index[r.uuid] for r, _ in decision.admitted[:2]]
        for record, _ in decision.admitted[:2]:
            mark_running(ns, plane, record)
            active.add(record.uuid)
        for victim in decision.victims:
            active.discard(victim)
            plane.store.transition(victim, ns.S.PREEMPTED, force=True)
            plane.store.transition(victim, ns.S.QUEUED)
        out.append((admitted,
                    sorted((index[u], why) for u, why in
                           decision.blocked.items()),
                    sorted(index[v] for v in decision.victims)))
    out.append([[(c["type"], c.get("reason")) for c in
                 plane.get_statuses(u)] for u in order])
    stats = plane.scheduling_stats()
    for row in stats["queues"] + stats["quotas"]:
        row.pop("created_at", None)
        row.pop("updated_at", None)
    out.append(stats)
    return out


def test_scripted_admission_decisions_equal(tmp_path):
    runs = [scripted_admission(pkg, str(tmp_path / pkg)) for pkg in PKGS]
    assert runs[0] == runs[1]
    assert any(tick[0] for tick in runs[1][:8])  # something was admitted


# ------------------------------------------------------------------- cron
CRON_EXPRS = ["*/15 * * * *", "0 0 * * *", "5 4 1 * *", "0,30 9-11 * * *",
              "0 9 * * 1", "0 9 30 * 1", "0 0 1 1 *", "0 9 * * 5-7",
              "*/7 */5 */3 * 0-7", "59 23 29 2 *", "0 12 * 6-8 1-5"]
CRON_TIMES = [dt.datetime(2026, 7, 29, 10, 30), dt.datetime(2026, 7, 29, 10, 59),
              dt.datetime(2026, 12, 31, 23, 59), dt.datetime(2027, 2, 28, 0, 0),
              dt.datetime(2028, 2, 28, 23, 59)]


@pytest.mark.parametrize("expr", CRON_EXPRS)
def test_cron_next_fire_equal(expr):
    fires = []
    for pkg in PKGS:
        cron = pkg_ns(pkg).cron
        chain = []
        for t in CRON_TIMES:
            for _ in range(3):  # three fires on from each time
                t = cron.next_fire(expr, t)
                chain.append(t)
        fires.append((chain, sorted(cron.Cron(expr).dow)))
    assert fires[0] == fires[1]


class TestCron:
    def test_simple_fields(self, ns):
        t = dt.datetime(2026, 7, 29, 10, 30)
        nf = ns.cron.next_fire
        assert nf("*/15 * * * *", t) == dt.datetime(2026, 7, 29, 10, 45)
        assert nf("0 0 * * *", t) == dt.datetime(2026, 7, 30, 0, 0)
        assert nf("5 4 1 * *", t) == dt.datetime(2026, 8, 1, 4, 5)

    def test_dow_and_vixie_or(self, ns):
        t = dt.datetime(2026, 7, 29, 12, 0)
        assert ns.cron.next_fire("0 9 * * 1", t) == dt.datetime(2026, 8, 3,
                                                                 9, 0)
        assert ns.cron.next_fire("0 9 30 * 1", t) == dt.datetime(2026, 7, 30,
                                                                  9, 0)

    def test_sunday_as_7_and_ranges(self, ns):
        assert 0 in ns.cron.Cron("* * * * 7").dow
        assert ns.cron.Cron("0 9 * * 5-7").dow == {5, 6, 0}
        assert ns.cron.Cron("0 9 * * 0-7").dow == {0, 1, 2, 3, 4, 5, 6}

    @pytest.mark.parametrize("bad", ["* * * *", "61 * * * *",
                                     "*/0 * * * *"])
    def test_errors(self, ns, bad):
        with pytest.raises(ns.cron.CronError):
            ns.cron.Cron(bad)

    def test_invalid_cron_rejected_at_submit(self, ns, plane):
        with pytest.raises(ns.cron.CronError):
            plane.submit({"kind": "operation",
                          "schedule": {"kind": "cron", "cron": "99 * * * *"},
                          "component": {"run": {"kind": "job", "container": {
                              "command": ["python", "-c", "print(1)"]}}}})


# ------------------------------------------------------------------ joins
class TestQueryParsing:
    def test_fields(self, ns):
        assert ns.joins.parse_query("pipeline: abc, status: succeeded") == {
            "pipeline": "abc", "status": "succeeded"}

    def test_bad_clause(self, ns):
        with pytest.raises(ns.joins.JoinError, match="field: value"):
            ns.joins.parse_query("pipeline")

    def test_unknown_field(self, ns):
        with pytest.raises(ns.joins.JoinError,
                           match="unknown join query field"):
            ns.joins.parse_query("planet: mars")


WRITER = {"kind": "component",
          "inputs": [{"name": "score", "type": "float", "toEnv": "SCORE"}],
          "run": {"kind": "job", "container": {"command": [
              "python", "-c", "print('writer')"]}}}


def finished_writer(ns, plane, score: float, tag: str, status="succeeded"):
    """A WRITER run taken to ``status`` by hand, its outputs written as
    the run would write them."""
    record = plane.submit(WRITER, params={"score": score}, tags=[tag])
    plane.compile_run(record.uuid)
    mark_running(ns, plane, record)
    art = plane.run_artifacts_dir(record.uuid)
    os.makedirs(art, exist_ok=True)
    with open(os.path.join(art, "outputs.json"), "w") as fh:
        json.dump({"score": score}, fh)
    plane.store.transition(record.uuid, ns.S(status))
    return record.uuid


JOIN_SPECS = {
    "collect": [{"query": "status: succeeded, tags: trial",
                 "sort": "created_at",
                 "params": {"scores": {"value": "outputs.score"},
                            "run_uuids": {"value": "uuid"}}}],
    "limit-desc": [{"query": "status: succeeded, tags: trial",
                    "sort": "-created_at", "limit": 2,
                    "params": {"scores": {"value": "outputs.score"}}}],
    "failed-only": [{"query": "status: failed",
                     "params": {"scores": {"value": "outputs.score"},
                                "names": {"value": "name"}}}],
}


@pytest.mark.parametrize("case", sorted(JOIN_SPECS))
def test_join_resolution_equal(case, tmp_path):
    results = []
    for pkg in PKGS:
        ns = pkg_ns(pkg)
        plane = ns.ControlPlane(str(tmp_path / pkg))
        uuids = [finished_writer(ns, plane, s, "trial")
                 for s in (0.5, 0.25, 3.0)]
        uuids.append(finished_writer(ns, plane, 9.0, "other", "failed"))
        matched: list = []
        joined = ns.joins.resolve_joins(
            plane.store, plane.streams, JOIN_SPECS[case], project="default",
            matched=matched)
        names = {u: f"RUN{i}" for i, u in enumerate(uuids)}
        results.append([json.loads(_normalize_uuids(
            json.dumps(joined, sort_keys=True), names)),
            sorted(names[u] for u in matched)])
    assert results[0] == results[1]
    if case == "collect":
        assert results[1][0]["scores"] == [0.5, 0.25, 3.0]
    if case == "limit-desc":
        assert results[1][0]["scores"] == [3.0, 0.25]


def _normalize_uuids(text: str, names: dict) -> str:
    for uuid, name in names.items():
        text = text.replace(uuid, name)
    return text


# ------------------------------ cache and hub (test_schedules_cache.py)
def cached_op(lr: float, cache: bool = True) -> dict:
    op = {"kind": "operation",
          "params": {"lr": {"value": lr}},
          "component": {
              "inputs": [{"name": "lr", "type": "float", "toEnv": "LR"}],
              "run": {"kind": "job", "container": {"command": [
                  "python", "-c",
                  "import os, json\n"
                  "d = os.environ['POLYAXON_RUN_ARTIFACTS_PATH']\n"
                  "json.dump({'lr': os.environ['LR']}, "
                  "open(d+'/outputs.json','w'))\n"]}}}}
    if cache:
        op["cache"] = {"disable": False}
    return op


def write_hub(plane, name="cleanup"):
    hub = os.path.join(plane.home, "hub")
    os.makedirs(hub, exist_ok=True)
    with open(os.path.join(hub, f"{name}.yaml"), "w") as fh:
        fh.write(f"kind: component\nname: {name}\nrun:\n  kind: job\n"
                 "  container:\n"
                 "    command: ['python', '-c', 'print(\"hook ran\")']\n")


def agent_for(pkg: str, plane):
    if pkg == "jax":
        from polyaxon_tpu.agent import Agent
    else:
        from polyaxon_tpu_torch.agent import Agent
    return Agent(plane, max_concurrent=8)


class TestCacheAndHub:
    def test_identical_run_hits_cache(self, ns, plane):
        agent = agent_for(ns.pkg, plane)
        first = plane.submit(cached_op(0.1))
        assert agent.run_until_done(first.uuid, timeout=60,
                                    poll_seconds=0.05) == ns.S.SUCCEEDED
        second = plane.submit(cached_op(0.1))
        assert agent.run_until_done(second.uuid, timeout=60,
                                    poll_seconds=0.05) == ns.S.SUCCEEDED
        assert plane.get_run(second.uuid).meta.get("cache_hit_from") == \
            first.uuid
        assert "CacheHit" in [c["reason"]
                              for c in plane.get_statuses(second.uuid)]
        assert plane.streams.get_outputs(second.uuid) == {"lr": "0.1"}

    @pytest.mark.parametrize("second_lr,cache", [(0.2, True), (0.1, False)])
    def test_cache_misses(self, ns, plane, second_lr, cache):
        agent = agent_for(ns.pkg, plane)
        first = plane.submit(cached_op(0.1, cache))
        agent.run_until_done(first.uuid, timeout=60, poll_seconds=0.05)
        second = plane.submit(cached_op(second_lr, cache))
        agent.run_until_done(second.uuid, timeout=60, poll_seconds=0.05)
        assert "cache_hit_from" not in plane.get_run(second.uuid).meta

    def test_hub_ref_runs_and_missing_fails(self, ns, plane):
        if ns.pkg == "jax":
            from polyaxon_tpu.polyflow.operation import V1Operation
        else:
            from polyaxon_tpu_torch.polyflow.operation import V1Operation
        write_hub(plane)
        agent = agent_for(ns.pkg, plane)
        record = plane.submit(op=V1Operation(hub_ref="cleanup"))
        assert agent.run_until_done(record.uuid, timeout=60,
                                    poll_seconds=0.05) == ns.S.SUCCEEDED
        ghost = plane.submit(op=V1Operation(hub_ref="ghost"))
        assert agent.run_until_done(ghost.uuid, timeout=30,
                                    poll_seconds=0.05) == ns.S.FAILED

    def test_hook_spawns_once_on_success(self, ns, plane):
        write_hub(plane)
        agent = agent_for(ns.pkg, plane)
        record = plane.submit({
            "kind": "operation",
            "hooks": [{"trigger": "succeeded", "hubRef": "cleanup"},
                      {"trigger": "failed", "hubRef": "cleanup"}],
            "component": {"run": {"kind": "job", "container": {
                "command": ["python", "-c", "print('ok')"]}}}})
        assert agent.run_until_done(record.uuid, timeout=60,
                                    poll_seconds=0.05) == ns.S.SUCCEEDED
        deadline = time.monotonic() + 30
        while True:
            agent.reconcile_once()
            hooks = plane.list_runs(parent_uuid=record.uuid)
            if hooks and all(h.is_done for h in hooks):
                break
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert [h.status for h in hooks] == [ns.S.SUCCEEDED]
        agent.reconcile_once()
        assert len(plane.list_runs(parent_uuid=record.uuid)) == 1
