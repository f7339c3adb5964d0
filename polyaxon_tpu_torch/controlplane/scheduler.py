"""Background scheduler: compiles created runs, expands and advances
pipelines (DAG + matrix/tuner iterations).

haupt's orchestration/scheduler equivalent (SURVEY.md §2 "Scheduler",
§3.2, §3.4 [K]). Everything is driven by idempotent ``tick()`` passes
over the store — no celery; the agent loop (or a test) calls tick.

Matrix state machines live in the pipeline run's ``meta["tuner"]``:
  grid/random/mapping → one-shot fan-out with a concurrency window;
  hyperband           → per-(bracket, rung) advancement with
                         preemption-requeue (SURVEY §7 hard-part 4);
  bayes               → initial batch, then GP-suggested singles.

Port of ``polyaxon_tpu/controlplane/scheduler.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
from typing import Any, Optional

from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.controlplane.service import ControlPlane
from polyaxon_tpu_torch.controlplane.store import RunRecord
from polyaxon_tpu_torch.lifecycle import V1Statuses, now as _now
from polyaxon_tpu_torch.utils.retries import backoff_delay
from polyaxon_tpu_torch.polyaxonfile import get_operation
from polyaxon_tpu_torch.polyflow.matrix import (
    V1Asha,
    V1Bayes,
    V1GridSearch,
    V1Hyperband,
    V1Hyperopt,
    V1Iterative,
    V1Mapping,
    V1RandomSearch,
)
from polyaxon_tpu_torch.polyflow.operation import V1Operation, V1TriggerPolicy
from polyaxon_tpu_torch.polyflow.runs import V1RunKind
from polyaxon_tpu_torch.tune import (
    AshaManager,
    BayesManager,
    GridSearchManager,
    HyperbandManager,
    HyperoptManager,
    IterativeManager,
    MappingManager,
    Observation,
    RandomSearchManager,
    check_early_stopping,
)

logger = logging.getLogger(__name__)

_DONE = V1Statuses.terminal_values()


def _backoff_params() -> dict:
    """Requeue-backoff knobs (env-tunable; docs/robustness.md)."""
    return {
        "base": float(os.environ.get("POLYAXON_TPU_BACKOFF_BASE", "0.5")),
        "factor": float(os.environ.get("POLYAXON_TPU_BACKOFF_FACTOR", "2.0")),
        "max_delay": float(os.environ.get("POLYAXON_TPU_BACKOFF_MAX", "60")),
        "jitter": float(os.environ.get("POLYAXON_TPU_BACKOFF_JITTER", "0.25")),
    }


def _parse_ts(value: str) -> _dt.datetime:
    ts = _dt.datetime.fromisoformat(value)
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=_dt.timezone.utc)
    return ts


def _trigger_satisfied(policy: str, statuses: list[V1Statuses]) -> Optional[bool]:
    """True → start, False → won't ever start, None → keep waiting."""
    done = [s for s in statuses if s in _DONE]
    succeeded = [s for s in done if s == V1Statuses.SUCCEEDED]
    # Anything done-but-not-succeeded (incl. SKIPPED) blocks ALL_SUCCEEDED —
    # a skipped upstream must resolve the trigger, never stall it.
    failed = [s for s in done if s != V1Statuses.SUCCEEDED]
    policy = policy or V1TriggerPolicy.ALL_SUCCEEDED
    n = len(statuses)
    if policy == V1TriggerPolicy.ALL_SUCCEEDED:
        if failed:
            return False
        return True if len(succeeded) == n else None
    if policy == V1TriggerPolicy.ALL_FAILED:
        if succeeded:
            return False
        return True if len(failed) == n else None
    if policy == V1TriggerPolicy.ALL_DONE:
        return True if len(done) == n else None
    if policy == V1TriggerPolicy.ONE_SUCCEEDED:
        if succeeded:
            return True
        return False if len(done) == n else None
    if policy == V1TriggerPolicy.ONE_FAILED:
        if failed:
            return True
        return False if len(done) == n else None
    if policy == V1TriggerPolicy.ONE_DONE:
        return True if done else None
    return None


# Parent kinds the pipeline pass advances; matches the agent's skip set.
_PIPELINE_KINDS = ("dag", "matrix", "schedule")


class Scheduler:
    def __init__(self, plane: ControlPlane, *, legacy_scan: bool = False):
        self.plane = plane
        self.store = plane.store
        # FAILED runs that will never restart (no policy / no plan):
        # remembered so the failed pass stays O(new failures) per tick
        # instead of re-parsing every historical failure's spec.
        self._no_restart: set[str] = set()
        # Per-tick memo of pipeline-children lookups: a DAG/tuner tick
        # touches the same child list from several passes; within one
        # tick the store is only mutated by THIS thread, so the memo is
        # exact as long as every submit/stop path invalidates it.
        self._children_cache: dict[str, list[RunRecord]] = {}
        # Bench hook (sim --deopt / the measured A/B): replay the
        # pre-ISSUE-8 six-scans-per-tick behavior, uncached and
        # unbatched, so the budget gate has a "before" it can fail.
        self.legacy_scan = legacy_scan

    # ------------------------------------------------------------------ tick
    def tick(self) -> int:
        """One idempotent scheduling pass; returns number of actions.
        Wall time lands in the ``polyaxon_scheduler_tick_seconds``
        histogram — tick latency is the control plane's heartbeat."""
        import time as _time

        from polyaxon_tpu_torch.obs import metrics as obs_metrics

        t0 = _time.perf_counter()
        try:
            return self._tick()
        finally:
            obs_metrics.scheduler_tick_hist().observe(
                _time.perf_counter() - t0)

    def _tick(self) -> int:
        plan = chaos.active_plan()
        if plan is not None and plan.fire("tick", "skip") is not None:
            # Injected control-plane stall: this tick does nothing; all
            # progress must be recoverable by the next tick (ticks are
            # pure functions of store state).
            return 0
        if self.legacy_scan:
            return self._tick_legacy()
        self._children_cache.clear()
        # All of this tick's writes land in ONE commit: N transitions
        # cost one WAL fsync. Ticks stay idempotent, so a crash that
        # rolls the batch back just means the next tick redoes it.
        with self.store.transaction():
            return self._tick_fast()

    def _tick_fast(self) -> int:
        """One status-partitioned scan instead of six full-status
        queries (sized by the fleet sim — sim/fleet_curve.json): the
        QUEUED/RUNNING partition is kind-filtered AT THE SQL LAYER, so a
        10k-deep backlog of plain jobs contributes zero rows here, and
        lazy RunRecords defer each row's JSON until a pass touches it.
        FAILED is swept via a key-only uuid projection diffed against
        ``_no_restart`` — O(new failures), not O(every failure ever)."""
        snapshot = self.store.scan_runs([
            ([V1Statuses.CREATED, V1Statuses.PREEMPTED,
              V1Statuses.RETRYING], None),
            ([V1Statuses.QUEUED, V1Statuses.RUNNING], _PIPELINE_KINDS),
        ])
        actions = 0
        compiled_pipelines: list[str] = []
        for record in snapshot[V1Statuses.CREATED]:
            actions += self._tick_created(record, compiled_pipelines)
        pipelines = snapshot[V1Statuses.QUEUED] + snapshot[V1Statuses.RUNNING]
        if compiled_pipelines:
            # A pipeline compiled THIS tick is already QUEUED but missed
            # the snapshot above — fold it in so a fresh DAG/tuner still
            # fans out on the tick that compiled it (scan-era behavior).
            pipelines += [r for r in self.store.get_runs(compiled_pipelines)
                          if r.status in (V1Statuses.QUEUED,
                                          V1Statuses.RUNNING)]
        for record in pipelines:
            actions += self._tick_pipeline(record)
        for record in snapshot[V1Statuses.PREEMPTED]:
            actions += self._tick_preempted(record)
        failed_fresh = [u for u in self.store.list_run_uuids(
            statuses=[V1Statuses.FAILED]) if u not in self._no_restart]
        for record in self.store.get_runs(failed_fresh):
            actions += self._tick_failed(record)
        for record in snapshot[V1Statuses.RETRYING]:
            actions += self._tick_retrying(record)
        return actions

    def _tick_created(self, record: RunRecord,
                      compiled_pipelines: list[str]) -> int:
        verdict = self._events_satisfied(record)
        if verdict is None:
            return 0  # still waiting on referenced run events
        if verdict is False:
            self.store.transition(
                record.uuid, V1Statuses.UPSTREAM_FAILED,
                reason="EventNeverFires",
                message="referenced run finished without the awaited event")
            return 1
        try:
            self.plane.compile_run(record.uuid)
            if record.kind in _PIPELINE_KINDS:
                compiled_pipelines.append(record.uuid)
        except Exception as exc:
            # A bad spec (dangling connection, invalid topology...)
            # fails that run; it must not kill the scheduler loop.
            self.store.transition(
                record.uuid, V1Statuses.FAILED,
                reason="CompilationError", message=str(exc)[:500])
        return 1

    def _tick_pipeline(self, record: RunRecord) -> int:
        try:
            if record.kind == "matrix":
                return self._tick_matrix(record)
            if record.kind == V1RunKind.DAG:
                return self._tick_dag(record)
            if record.kind == "schedule":
                return self._tick_schedule(record)
        except Exception as exc:
            # A bad spec (invalid cron, broken matrix...) fails that
            # pipeline; it must never kill the reconcile loop.
            self.store.transition(
                record.uuid, V1Statuses.FAILED,
                reason="PipelineError", message=str(exc)[:500])
            return 1
        return 0

    def _tick_legacy(self) -> int:
        """Pre-ISSUE-8 tick: six separate full-status scans, every row
        eagerly fetched, one commit per transition. Kept as the sim's
        ``--deopt`` baseline and the measured A/B's 'before' side."""
        actions = 0
        for record in self.store.list_runs(statuses=[V1Statuses.CREATED]):
            actions += self._tick_created(record, [])
        for record in self.store.list_runs(
                statuses=[V1Statuses.QUEUED, V1Statuses.RUNNING]):
            if record.kind in _PIPELINE_KINDS:
                actions += self._tick_pipeline(record)
        for record in self.store.list_runs(statuses=[V1Statuses.PREEMPTED]):
            actions += self._tick_preempted(record)
        for record in self.store.list_runs(statuses=[V1Statuses.FAILED]):
            actions += self._tick_failed(record)
        for record in self.store.list_runs(statuses=[V1Statuses.RETRYING]):
            actions += self._tick_retrying(record)
        return actions

    # ------------------------------------------------- children memoization
    def _children(self, pipeline_uuid: str) -> list[RunRecord]:
        """Pipeline-children lookup, memoized for the current tick (the
        DAG/tuner passes re-list the same pipeline's children up to
        three times per tick). Every same-tick mutation path —
        ``_spawn_trial``, the DAG/schedule submits, early-stop — must
        call ``_invalidate_children``. Legacy mode bypasses the memo."""
        if self.legacy_scan:
            return self.store.list_runs(pipeline_uuid=pipeline_uuid)
        cached = self._children_cache.get(pipeline_uuid)
        if cached is None:
            cached = self.store.list_runs(pipeline_uuid=pipeline_uuid)
            self._children_cache[pipeline_uuid] = cached
        return cached

    def _invalidate_children(self, pipeline_uuid: Optional[str]) -> None:
        if pipeline_uuid:
            self._children_cache.pop(pipeline_uuid, None)

    # -------------------------------------------------------------- events
    def _events_satisfied(self, record: RunRecord) -> Optional[bool]:
        """Gate compilation on V1EventTrigger refs.

        True → proceed; None → keep waiting; False → can never fire
        (referenced run is terminal without any awaited status).
        Ref grammar: ``runs.<uuid>``; kinds are lifecycle status names
        (the upstream event vocabulary subset the embedded plane emits).
        """
        events = (record.spec or {}).get("events")
        if not events:
            return True
        for event in events:
            ref = event.get("ref") or ""
            if not ref.startswith("runs."):
                self.store.transition(
                    record.uuid, V1Statuses.FAILED, reason="InvalidEventRef",
                    message=f"event ref {ref!r} must be `runs.<uuid>`")
                return None
            target_uuid = ref[len("runs."):]
            try:
                target = self.store.get_run(target_uuid)
            except Exception:
                self.store.transition(
                    record.uuid, V1Statuses.FAILED, reason="InvalidEventRef",
                    message=f"event ref {ref!r}: run not found")
                return None
            kinds = {str(k).split(".")[-1] for k in event.get("kinds") or []}
            seen = {c["type"] for c in self.store.get_conditions(target_uuid)}
            if not kinds:  # no kinds = "any terminal event"
                if target.is_done:
                    continue
                return None
            if kinds & seen:
                continue
            if target.is_done:
                return False
            return None
        return True

    # ------------------------------------------------- requeue w/ backoff
    def _schedule_requeue(self, record: RunRecord, *, counter: str,
                          delays_key: str, reason: str,
                          force: bool = False) -> float:
        """Move a run into RETRYING with a persisted backoff gate.

        ``meta["backoff"]`` carries the state that makes ticks
        idempotent: per-cause attempt counters, the delay audit trail,
        and ``not_before`` — the wall-clock time before which the
        RETRYING pass refuses to requeue (so a crash-looping run cannot
        hot-loop the scheduler, and a requeued run is never re-popped
        early). Jitter is keyed by (uuid, attempt): recomputing the
        same requeue yields the same delay.
        """
        meta = dict(record.meta or {})
        backoff = dict(meta.get("backoff") or {})
        attempt = int(backoff.get(counter, 0))
        delay = backoff_delay(attempt, key=f"{record.uuid}:{counter}:{attempt}",
                              **_backoff_params())
        not_before = _now() + _dt.timedelta(seconds=delay)
        backoff[counter] = attempt + 1
        backoff[delays_key] = list(backoff.get(delays_key) or []) + [
            round(delay, 4)]
        backoff["not_before"] = not_before.isoformat()
        meta["backoff"] = backoff
        self.store.update_run(record.uuid, meta=meta)
        self.store.transition(
            record.uuid, V1Statuses.RETRYING, reason=reason,
            message=f"requeue attempt {attempt + 1} in {delay:.2f}s",
            force=force)
        # The requeue is a timeline annotation (obs.trace) + a counter:
        # a chaos drill's kill→retry reads off the run's waterfall, and
        # requeue volume per reason is a scrapeable signal.
        from polyaxon_tpu_torch.obs import metrics as obs_metrics
        from polyaxon_tpu_torch.obs import trace as obs_trace

        obs_metrics.requeues_total().inc(reason=reason)
        try:
            obs_trace.record_event(
                self.plane.run_artifacts_dir(record.uuid), record.uuid,
                "requeue", component="controlplane",
                attributes={"reason": reason, "counter": counter,
                            "attempt": attempt + 1,
                            "delay_s": round(delay, 4)})
        except OSError:
            logger.warning("could not record requeue span event for %s",
                           record.uuid, exc_info=True)
        return delay

    def _tick_retrying(self, record: RunRecord) -> int:
        """RETRYING → QUEUED once the backoff gate has passed."""
        backoff = (record.meta or {}).get("backoff") or {}
        not_before = backoff.get("not_before")
        if not_before and _now() < _parse_ts(not_before):
            return 0
        self.store.transition(record.uuid, V1Statuses.QUEUED)
        return 1

    # ------------------------------------------------------------ preemption
    def _tick_preempted(self, record: RunRecord) -> int:
        """Requeue preempted runs per termination policy (preemption does
        not consume a retry unless the spec says so — TPU-native rule).
        The requeue goes through the backoff gate so a flapping spot
        slice cannot hot-loop preempt→requeue→preempt."""
        # A run mid-resize is NOT a requeue candidate: the elastic
        # executor is shrinking/regrowing it in place (runtime.elastic)
        # and will either resume it RUNNING or clear the flag before the
        # PREEMPTED fallback reap — requeueing now would double-run it.
        if ((record.meta or {}).get("elastic") or {}).get("resizing"):
            return 0
        op = get_operation(record.spec)
        term = op.termination or (op.component.termination if op.component else None)
        counts = bool(term and term.preemption_counts_as_retry)
        max_retries = term.max_retries if term and term.max_retries is not None else 3
        if counts:
            if record.retries + 1 > max_retries:
                # Stamp the backoff state exhausted so the failure-
                # restart pass cannot resurrect a run whose preemption
                # budget is already spent.
                meta = dict(record.meta or {})
                meta["backoff"] = {**(meta.get("backoff") or {}),
                                   "exhausted": True}
                self.store.update_run(record.uuid, meta=meta)
                self.store.transition(record.uuid, V1Statuses.FAILED,
                                      reason="RetriesExhausted")
                return 1
            self.store.update_run(record.uuid, retries=record.retries + 1)
            record = self.store.get_run(record.uuid)
        # Control-plane-driven evictions (admission starvation valve —
        # scheduling/admission.py stamps the preemptor) requeue through
        # the same backoff gate but keep the audit trail visible.
        evicted_for = ((record.meta or {}).get("scheduling")
                       or {}).get("evicted_for")
        self._schedule_requeue(
            record, counter="preempts", delays_key="preempt_delays",
            reason="PreemptedForPriority" if evicted_for else "Preempted")
        return 1

    # ------------------------------------------------------ restart policy
    @staticmethod
    def _restart_policy(op: V1Operation) -> Optional[str]:
        """Normalized run-level restart policy: {never, on_failure,
        always} from the run environment (k8s spellings accepted)."""
        run = op.component.run if op.component else None
        env = getattr(run, "environment", None)
        policy = getattr(env, "restart_policy", None)
        if not policy:
            return None
        normalized = str(policy).replace("-", "_").lower()
        if normalized == "onfailure":
            normalized = "on_failure"
        return normalized

    def _tick_failed(self, record: RunRecord) -> int:
        """Enforce ``restart_policy`` ∈ {never, on_failure, always} for
        FAILED runs: requeue through the backoff gate until the retry
        budget (``termination.maxRetries``, default 3) is spent, then
        pin a terminal ``RetriesExhausted`` condition.

        Only runs that actually launched (have a plan) restart —
        re-running a spec that cannot compile converges to the same
        failure without doing work.
        """
        if record.uuid in self._no_restart:
            return 0
        backoff = (record.meta or {}).get("backoff") or {}
        if backoff.get("exhausted"):
            self._no_restart.add(record.uuid)
            return 0
        try:
            op = get_operation(record.spec)
        except Exception:  # noqa: BLE001 — an unparsable spec never restarts
            self._no_restart.add(record.uuid)
            return 0
        policy = self._restart_policy(op)
        if policy not in ("on_failure", "always") or not record.launch_plan:
            self._no_restart.add(record.uuid)
            return 0
        term = op.termination or (op.component.termination if op.component else None)
        max_retries = term.max_retries if term and term.max_retries is not None else 3
        attempts = int(backoff.get("restarts", 0))
        if attempts >= max_retries:
            meta = dict(record.meta or {})
            meta["backoff"] = {**backoff, "exhausted": True}
            self.store.update_run(record.uuid, meta=meta)
            self.store.transition(
                record.uuid, V1Statuses.FAILED, reason="RetriesExhausted",
                message=f"restart_policy={policy} consumed all "
                        f"{max_retries} retries", force=True)
            self._no_restart.add(record.uuid)
            return 1
        self.store.update_run(record.uuid, retries=attempts + 1)
        self._schedule_requeue(record, counter="restarts",
                               delays_key="delays",
                               reason="RestartPolicy", force=True)
        return 1

    # ------------------------------------------------------------------- dag
    @staticmethod
    def _validate_dag(dag) -> Optional[str]:
        """Unknown dependency names or cycles → error message, else None."""
        ops = [
            o if isinstance(o, V1Operation) else get_operation(dict(o))
            for o in dag.operations
        ]
        names = [o.name for o in ops]
        if len(set(names)) != len(names):
            dupes = {n for n in names if names.count(n) > 1}
            return f"duplicate operation names: {sorted(dupes)}"
        # Dedupe: a twice-listed dependency must not skew cycle detection.
        deps = {o.name: sorted(set(o.dependencies or [])) for o in ops}
        known = set(names)
        for name, dep_list in deps.items():
            unknown = [d for d in dep_list if d not in known]
            if unknown:
                return f"operation `{name}` depends on unknown ops: {unknown}"
        # Kahn's algorithm: leftover nodes ⇒ cycle.
        indeg = {n: len(deps[n]) for n in names}
        ready = [n for n, d in indeg.items() if d == 0]
        seen = 0
        while ready:
            node = ready.pop()
            seen += 1
            for other, dep_list in deps.items():
                if node in dep_list:
                    indeg[other] -= 1
                    if indeg[other] == 0:
                        ready.append(other)
        if seen != len(names):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            return f"dependency cycle among: {cyclic}"
        return None

    def _tick_dag(self, record: RunRecord) -> int:
        op = get_operation(record.spec)
        dag = op.component.run
        children = self._children(record.uuid)
        by_name = {c.name: c for c in children}
        actions = 0

        if record.status == V1Statuses.QUEUED:
            error = self._validate_dag(dag)
            if error:
                self.store.transition(record.uuid, V1Statuses.FAILED,
                                      reason="InvalidDag", message=error)
                return 1
            self.store.transition(record.uuid, V1Statuses.SCHEDULED)
            self.store.transition(record.uuid, V1Statuses.RUNNING,
                                  reason="PipelineRunning", force=True)
            actions += 1

        for op_data in dag.operations:
            child_op = op_data if isinstance(op_data, V1Operation) else get_operation(dict(op_data))
            cname = child_op.name
            if cname in by_name:
                continue
            deps = child_op.dependencies or []
            dep_statuses = [by_name[d].status for d in deps if d in by_name]
            if len(dep_statuses) < len(deps):
                continue  # upstream not created yet
            verdict = _trigger_satisfied(child_op.trigger, dep_statuses) if deps else True
            if verdict is None:
                continue
            if verdict is False:
                skip = bool(child_op.skip_on_upstream_skip) or any(
                    s == V1Statuses.SKIPPED for s in dep_statuses
                )
                created = self.plane.submit(
                    op=child_op, project=record.project, name=cname,
                    pipeline_uuid=record.uuid, parent_uuid=record.uuid,
                )
                self.store.transition(
                    created.uuid,
                    V1Statuses.SKIPPED if skip else V1Statuses.UPSTREAM_FAILED,
                    reason="UpstreamTrigger", force=True,
                )
                self._invalidate_children(record.uuid)
                actions += 1
                continue
            self.plane.submit(
                op=child_op, project=record.project, name=cname,
                pipeline_uuid=record.uuid, parent_uuid=record.uuid,
            )
            self._invalidate_children(record.uuid)
            actions += 1

        # Pipeline completion: every declared op exists and is done.
        children = self._children(record.uuid)
        declared = len(dag.operations)
        if len(children) == declared and all(c.is_done for c in children):
            failed = any(c.status in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED)
                         for c in children)
            stopped = any(c.status == V1Statuses.STOPPED for c in children)
            if failed:
                target = V1Statuses.FAILED
            elif stopped:  # cancelled work is not success
                target = V1Statuses.STOPPED
            else:
                target = V1Statuses.SUCCEEDED
            self.store.transition(record.uuid, target, reason="PipelineDone")
            actions += 1
        return actions

    # -------------------------------------------------------------- schedule
    def _tick_schedule(self, record: RunRecord, *, now=None) -> int:
        """Recurring parent run: fire child runs per its V1*Schedule.

        ``now`` is injectable for tests. ``last_fire`` advances to the
        computed fire time (not wall clock) so cadence never drifts.
        """
        import datetime as dt

        from polyaxon_tpu_torch.controlplane.cron import next_fire
        from polyaxon_tpu_torch.polyflow.schedules import (
            V1CronSchedule,
            V1DateTimeSchedule,
            V1IntervalSchedule,
        )

        def as_utc(value) -> dt.datetime:
            if isinstance(value, str):
                value = dt.datetime.fromisoformat(value)
            if value.tzinfo is None:
                return value.replace(tzinfo=dt.timezone.utc)
            return value.astimezone(dt.timezone.utc)

        op = get_operation(record.spec)
        sched = op.schedule
        meta = dict(record.meta or {})
        state = dict(meta.get("schedule") or {})
        fired = int(state.get("fired", 0))
        now = as_utc(now) if now is not None else dt.datetime.now(dt.timezone.utc)
        actions = 0

        if record.status == V1Statuses.QUEUED:
            self.store.transition(record.uuid, V1Statuses.SCHEDULED)
            self.store.transition(record.uuid, V1Statuses.RUNNING,
                                  reason="ScheduleActive", force=True)
            actions += 1

        created = as_utc(record.created_at)
        last_fire = as_utc(state["last_fire"]) if state.get("last_fire") else None

        # Next fire time per schedule kind (None ⇒ exhausted).
        next_at: dt.datetime | None
        if isinstance(sched, V1DateTimeSchedule):
            next_at = None if fired else as_utc(sched.start_at)
        elif isinstance(sched, V1IntervalSchedule):
            start = as_utc(sched.start_at) if sched.start_at else created
            next_at = start if (fired == 0 and sched.start_at) else (
                (last_fire or start) + dt.timedelta(seconds=sched.frequency))
        elif isinstance(sched, V1CronSchedule):
            base = last_fire or (as_utc(sched.start_at) if sched.start_at else created)
            next_at = next_fire(sched.cron, base)
        else:
            self.store.transition(record.uuid, V1Statuses.FAILED,
                                  reason="UnsupportedSchedule",
                                  message=type(sched).__name__)
            return actions + 1

        max_runs = getattr(sched, "max_runs", None)
        end_at = getattr(sched, "end_at", None)
        exhausted = (
            next_at is None
            or (max_runs is not None and fired >= max_runs)
            or (end_at is not None and next_at > as_utc(end_at))
        )
        children = self._children(record.uuid)
        if exhausted:
            if all(c.is_done for c in children):
                self.store.transition(record.uuid, V1Statuses.SUCCEEDED,
                                      reason="ScheduleDone",
                                      message=f"fired {fired} runs")
                actions += 1
            return actions

        if now < next_at:
            return actions
        if getattr(sched, "depends_on_past", None) and any(
                not c.is_done for c in children):
            return actions  # wait for the previous fire to finish

        child_op = op.clone()
        child_op.schedule = None
        child_op.name = None
        self.plane.submit(
            op=child_op, project=record.project,
            name=f"{record.name or 'scheduled'}-{fired}",
            pipeline_uuid=record.uuid, parent_uuid=record.uuid,
            iteration=fired,
        )
        self._invalidate_children(record.uuid)
        state.update({"fired": fired + 1, "last_fire": next_at.isoformat()})
        meta["schedule"] = state
        self.store.update_run(record.uuid, meta=meta)
        return actions + 1

    # ---------------------------------------------------------------- matrix
    def _observations(self, record: RunRecord, metric_name: str,
                      children: list[RunRecord]) -> list[Observation]:
        obs = []
        for child in children:
            params = (child.meta or {}).get("trial_params") or {}
            if child.status == V1Statuses.SUCCEEDED:
                value = self.plane.get_metric(child.uuid, metric_name)
                obs.append(Observation(params=params, metric=value,
                                       status="succeeded"))
            elif child.status == V1Statuses.PREEMPTED:
                obs.append(Observation(params=params, metric=None, status="preempted"))
            elif child.is_done:
                obs.append(Observation(params=params, metric=None, status="failed"))
        return obs

    def _spawn_trial(self, record: RunRecord, op: V1Operation, params: dict,
                     index: int, iteration: Optional[int] = None,
                     extra_meta: Optional[dict] = None) -> RunRecord:
        child_spec = op.clone()
        child_spec.matrix = None
        child_spec.name = None
        meta = {"trial_params": params, "trial_index": index}
        if extra_meta:
            meta.update(extra_meta)
        child = self.plane.submit(
            op=child_spec,
            project=record.project,
            name=f"{record.name or 'matrix'}-{index}",
            pipeline_uuid=record.uuid,
            parent_uuid=record.uuid,
            iteration=iteration,
            meta=meta,
        )
        self._invalidate_children(record.uuid)
        return child

    def _tick_matrix(self, record: RunRecord) -> int:
        op = get_operation(record.spec)
        matrix = op.matrix
        meta = dict(record.meta or {})
        tuner: dict[str, Any] = meta.get("tuner") or {}
        children = self._children(record.uuid)
        actions = 0

        if record.status == V1Statuses.QUEUED:
            self.store.transition(record.uuid, V1Statuses.SCHEDULED)
            self.store.transition(record.uuid, V1Statuses.RUNNING,
                                  reason="TunerRunning", force=True)
            actions += 1

        early = self._tick_early_stop(record, matrix, meta, children)
        if early is not None:
            return actions + early

        if isinstance(matrix, (V1GridSearch, V1RandomSearch, V1Mapping)):
            actions += self._tick_oneshot(record, op, matrix, tuner, meta, children)
        elif isinstance(matrix, V1Hyperband):
            actions += self._tick_hyperband(record, op, matrix, tuner, meta, children)
        elif isinstance(matrix, V1Asha):
            actions += self._tick_asha(record, op, matrix, tuner, meta, children)
        elif isinstance(matrix, V1Bayes):
            actions += self._tick_smbo(
                record, op, matrix, BayesManager(matrix), tuner, meta, children,
                num_initial=matrix.num_initial_runs,
                total_budget=matrix.num_initial_runs + matrix.max_iterations,
                reason="BayesDone")
        elif isinstance(matrix, V1Hyperopt):
            actions += self._tick_smbo(
                record, op, matrix, HyperoptManager(matrix), tuner, meta, children,
                num_initial=matrix.startup_trials,
                total_budget=matrix.total_budget,
                reason="HyperoptDone")
        elif isinstance(matrix, V1Iterative):
            actions += self._tick_iterative(record, op, matrix, tuner, meta, children)
        else:
            self.store.transition(record.uuid, V1Statuses.FAILED,
                                  reason="UnsupportedMatrix",
                                  message=f"{type(matrix).__name__}")
            actions += 1
        return actions

    def _tick_early_stop(self, record: RunRecord, matrix, meta: dict,
                         children: list[RunRecord]) -> Optional[int]:
        """Early-stopping policies: once triggered, stop in-flight trials
        and finish the sweep when they drain. Returns None when the sweep
        should keep ticking normally."""
        state = meta.get("early_stopped")
        if state is None:
            action = check_early_stopping(
                getattr(matrix, "early_stopping", None),
                lambda name: self._observations(record, name, children),
            )
            if action is None:
                return None
            meta["early_stopped"] = state = action
            self.store.update_run(record.uuid, meta=meta)
            for child in children:
                if not child.is_done:
                    self.plane.stop(child.uuid)
            self._invalidate_children(record.uuid)
        # Drain phase: wait for every child, then finish.
        if not all(c.is_done for c in children):
            return 0
        if state == "fail":
            self.store.transition(record.uuid, V1Statuses.FAILED,
                                  reason="FailureEarlyStopping")
        else:
            self.store.transition(record.uuid, V1Statuses.SUCCEEDED,
                                  reason="MetricEarlyStopping",
                                  message="target metric reached")
        return 1

    def _tick_iterative(self, record, op, matrix: V1Iterative, tuner, meta,
                        children) -> int:
        """Sequential suggest→run→observe loop (one trial per iteration,
        up to `concurrency` in flight)."""
        if matrix.tuner:
            # Upstream runs custom tuners as services; the embedded plane
            # only ships the builtin policy — fail loudly, never silently
            # substitute random search for the user's strategy.
            self.store.transition(
                record.uuid, V1Statuses.FAILED, reason="UnsupportedTuner",
                message="custom `tuner` services are not supported by the "
                        "embedded plane; omit `tuner` for builtin iteration")
            return 1
        manager = IterativeManager(matrix)
        tuner = tuner or {"spawned": 0}
        active = [c for c in children if not c.is_done]
        actions = 0
        if tuner["spawned"] >= matrix.max_iterations:
            return self._finish_if_done(record, children, matrix.max_iterations)
        concurrency = matrix.concurrency or 1
        while (tuner["spawned"] < matrix.max_iterations
               and len(active) < concurrency):
            params = manager.get_suggestion(tuner["spawned"])
            child = self._spawn_trial(record, op, params, tuner["spawned"],
                                      iteration=tuner["spawned"])
            active.append(child)
            tuner["spawned"] += 1
            actions += 1
        if actions:
            meta["tuner"] = tuner
            self.store.update_run(record.uuid, meta=meta)
        return actions

    def _finish_if_done(self, record: RunRecord, children: list[RunRecord],
                        expected: int) -> int:
        if len(children) >= expected and all(c.is_done for c in children):
            any_ok = any(c.status == V1Statuses.SUCCEEDED for c in children)
            any_stopped = any(c.status == V1Statuses.STOPPED for c in children)
            if any_ok or not children:  # degenerate empty sweep is not a failure
                target = V1Statuses.SUCCEEDED
            elif any_stopped:
                target = V1Statuses.STOPPED
            else:
                target = V1Statuses.FAILED
            self.store.transition(record.uuid, target, reason="TunerDone")
            return 1
        return 0

    def _tick_oneshot(self, record, op, matrix, tuner, meta, children) -> int:
        actions = 0
        if not tuner.get("suggested"):
            if isinstance(matrix, V1GridSearch):
                suggestions = GridSearchManager(matrix).get_suggestions()
            elif isinstance(matrix, V1RandomSearch):
                suggestions = RandomSearchManager(matrix).get_suggestions()
            else:
                suggestions = MappingManager(matrix).get_suggestions()
            tuner = {"suggested": True, "pending": suggestions, "spawned": 0,
                     "total": len(suggestions)}
        concurrency = matrix.concurrency or 0
        pending = list(tuner.get("pending") or [])
        active = len([c for c in children if not c.is_done])
        while pending and (not concurrency or active < concurrency):
            params = pending.pop(0)
            self._spawn_trial(record, op, params, tuner["spawned"])
            tuner["spawned"] += 1
            active += 1
            actions += 1
        tuner["pending"] = pending
        meta["tuner"] = tuner
        self.store.update_run(record.uuid, meta=meta)
        children = self._children(record.uuid)
        actions += self._finish_if_done(record, children, tuner.get("total", 0))
        return actions

    def _spawn_rung(self, record, op, manager: HyperbandManager, tuner, meta,
                    bracket: int, rung) -> int:
        """Spawn every trial of a rung, track uuids in tuner, persist meta."""
        tuner["rung_uuids"] = []
        for params in rung.suggestions:
            trial = dict(params)
            trial[manager.resource_param()] = rung.resource
            child = self._spawn_trial(
                record, op, trial, tuner["spawned"],
                iteration=rung.rung,
                extra_meta={"bracket": bracket, "rung": rung.rung},
            )
            tuner["rung_uuids"].append(child.uuid)
            tuner["spawned"] += 1
        meta["tuner"] = tuner
        self.store.update_run(record.uuid, meta=meta)
        return len(rung.suggestions)

    def _tick_hyperband(self, record, op, matrix: V1Hyperband, tuner, meta, children) -> int:
        manager = HyperbandManager(matrix)
        actions = 0
        if not tuner:
            bracket = manager.brackets()[0]
            rung = manager.first_rung(bracket)
            tuner = {"bracket": bracket, "rung": 0, "spawned": 0,
                     "rung_uuids": [], "bracket_index": 0}
            return self._spawn_rung(record, op, manager, tuner, meta, bracket, rung)

        rung_children = [c for c in children if c.uuid in set(tuner["rung_uuids"])]
        # Requeue preempted trials at the same rung with the same params.
        for child in rung_children:
            if child.status == V1Statuses.PREEMPTED:
                return 0  # scheduler's preemption pass requeues it in place
        if not all(c.is_done for c in rung_children):
            return 0

        obs = self._observations(record, matrix.metric.name, rung_children)
        s, i = tuner["bracket"], tuner["rung"]
        next_rung = manager.next_rung(s, i, obs)
        if next_rung is not None:
            tuner["rung"] = next_rung.rung
            return self._spawn_rung(record, op, manager, tuner, meta, s, next_rung)

        # Bracket exhausted → next bracket or done.
        brackets = manager.brackets()
        next_index = tuner["bracket_index"] + 1
        if next_index < len(brackets):
            bracket = brackets[next_index]
            rung = manager.first_rung(bracket)
            tuner.update({"bracket": bracket, "rung": 0,
                          "bracket_index": next_index})
            return self._spawn_rung(record, op, manager, tuner, meta, bracket, rung)

        all_children = self._children(record.uuid)
        any_ok = any(c.status == V1Statuses.SUCCEEDED for c in all_children)
        self.store.transition(
            record.uuid,
            V1Statuses.SUCCEEDED if any_ok else V1Statuses.FAILED,
            reason="HyperbandDone",
            message=None if any_ok else "all trials failed",
        )
        return actions + 1

    def _tick_asha(self, record, op, matrix: V1Asha, tuner, meta,
                   children) -> int:
        """Asynchronous successive halving: NO rung barrier. Every tick,
        (a) any completed trial ranking in the top 1/eta of COMPLETED
        trials at its rung is promoted to the next rung immediately, and
        (b) free concurrency slots are filled with fresh bottom-rung
        trials — so a straggler or preempted sibling (requeued in place
        by the scheduler's preemption pass) never stalls the sweep. The
        promotion set is recomputed from children state each tick; the
        tuner meta records what was already promoted so ticks stay
        idempotent."""
        import random as _random

        manager = AshaManager(matrix)
        tuner = tuner or {"spawned": 0, "promoted": {}}
        # Unseeded sweeps draw a base seed once (persisted in meta) so
        # re-launching explores NEW points while each sweep stays
        # tick-stable.
        if "seed" not in tuner:
            tuner["seed"] = (matrix.seed if matrix.seed is not None
                             else _random.randrange(2**31))
        actions = 0
        # Falsy concurrency = unlimited, like every other tuner here.
        concurrency = matrix.concurrency or float("inf")

        by_rung: dict[int, list[RunRecord]] = {}
        for child in children:
            by_rung.setdefault((child.meta or {}).get("rung", 0),
                               []).append(child)
        active = sum(1 for c in children if not c.is_done)

        # (a) promotions, bottom-up so a trial can climb one rung/tick.
        for rung_idx in sorted(by_rung):
            if rung_idx + 1 >= manager.n_rungs():
                continue  # top rung is terminal
            # "Completed" includes failed trials: they stay in the
            # rung-size denominator and rank worst (metric None) — the
            # paper's n, not just the success count.
            completed = [
                (c.uuid, (c.meta or {}).get("trial_params") or {},
                 self.plane.get_metric(c.uuid, matrix.metric.name)
                 if c.status == V1Statuses.SUCCEEDED else None)
                for c in by_rung[rung_idx]
                if c.is_done and c.status != V1Statuses.PREEMPTED
            ]
            already = set(tuner["promoted"].get(str(rung_idx), []))
            for uuid in manager.promotable(completed):
                if uuid in already or active >= concurrency:
                    continue
                params = next(p for u, p, _ in completed if u == uuid)
                trial = dict(params)
                trial[matrix.resource.name] = manager.rungs[rung_idx + 1]
                self._spawn_trial(
                    record, op, trial, tuner["spawned"],
                    iteration=rung_idx + 1,
                    extra_meta={"bracket": 0, "rung": rung_idx + 1,
                                "promoted_from": uuid})
                tuner["promoted"].setdefault(str(rung_idx), []).append(uuid)
                tuner["spawned"] += 1
                active += 1
                actions += 1

        # (b) fresh bottom-rung trials into remaining capacity.
        while (tuner.get("sampled", 0) < matrix.num_runs
               and active < concurrency):
            index = tuner.get("sampled", 0)
            trial = manager.sample_params(index, base_seed=tuner["seed"])
            trial[matrix.resource.name] = manager.rungs[0]
            self._spawn_trial(record, op, trial, tuner["spawned"],
                              iteration=0,
                              extra_meta={"bracket": 0, "rung": 0})
            tuner["sampled"] = index + 1
            tuner["spawned"] += 1
            active += 1
            actions += 1

        if actions:
            meta["tuner"] = tuner
            self.store.update_run(record.uuid, meta=meta)
            return actions

        # Done when the budget is drawn, everything finished, and the
        # pass above found nothing left to promote.
        if (tuner.get("sampled", 0) >= matrix.num_runs
                and children and all(c.is_done for c in children)):
            any_ok = any(c.status == V1Statuses.SUCCEEDED for c in children)
            self.store.transition(
                record.uuid,
                V1Statuses.SUCCEEDED if any_ok else V1Statuses.FAILED,
                reason="AshaDone",
                message=None if any_ok else "all trials failed",
            )
            return 1
        return 0

    def _tick_smbo(self, record, op, matrix, manager, tuner, meta, children,
                   *, num_initial: int, total_budget: int, reason: str) -> int:
        """Sequential model-based optimization loop shared by Bayes and
        Hyperopt sweeps: spawn the initial random batch (respecting the
        concurrency cap), then one model-guided suggestion per free
        concurrency slot until the budget is spent."""
        actions = 0
        concurrency = matrix.concurrency or 1
        if not tuner:
            tuner = {"spawned": 0, "phase": "initial",
                     "pending_initial": manager.initial_suggestions()}

        # Drain the startup batch first, never exceeding concurrency.
        pending = list(tuner.get("pending_initial") or [])
        if pending:
            active_n = len([c for c in children if not c.is_done])
            while pending and active_n < concurrency:
                self._spawn_trial(record, op, pending.pop(0),
                                  tuner["spawned"], iteration=0)
                tuner["spawned"] += 1
                active_n += 1
                actions += 1
            if actions:
                tuner["pending_initial"] = pending
                meta["tuner"] = tuner
                self.store.update_run(record.uuid, meta=meta)
            return actions

        active = [c for c in children if not c.is_done]
        obs = self._observations(record, matrix.metric.name, children)
        finished = [o for o in obs if o.status != "preempted"]
        if tuner["spawned"] >= total_budget:
            if not active:
                any_ok = any(c.status == V1Statuses.SUCCEEDED for c in children)
                self.store.transition(
                    record.uuid,
                    V1Statuses.SUCCEEDED if any_ok else V1Statuses.FAILED,
                    reason=reason,
                    message=None if any_ok else "all trials failed",
                )
                actions += 1
            return actions
        if len(active) >= concurrency:
            return 0
        if len(finished) < num_initial:
            return 0  # wait for the initial batch before modeling
        count = min(concurrency - len(active), total_budget - tuner["spawned"])
        for params in manager.get_suggestions(obs, count=count):
            self._spawn_trial(record, op, params, tuner["spawned"],
                              iteration=tuner["spawned"] - num_initial + 1)
            tuner["spawned"] += 1
            actions += 1
        meta["tuner"] = tuner
        self.store.update_run(record.uuid, meta=meta)
        return actions
