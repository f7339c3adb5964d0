"""The agent reconcile loop (SURVEY.md §2 "Agent", §3.2 spine 🔥).

Upstream: long-poll the control plane, apply Operation CRs, sync
statuses back. Here the control plane is embedded, the "cluster" is a
slice provider (LocalExecutor today; the C++ slice daemon fronts real
topologies), and one loop drives scheduler ticks + executor reconcile:

    queued runs   → executor.start (capacity permitting)
    running gangs → executor.poll  (reap → terminal statuses)
    pipelines     → scheduler.tick (DAG/tuner advancement)

Port of ``polyaxon_tpu/agent/agent.py``. Its executor is the port's
``LocalExecutor``; ``device`` is where in-process gangs train (the card
unless the caller names another). Not ported yet: the native slice pool
(``slice_manager``, ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

import time
from typing import Optional

from polyaxon_tpu_torch.controlplane.scheduler import Scheduler
from polyaxon_tpu_torch.controlplane.service import ControlPlane
from polyaxon_tpu_torch.agent.executor import LocalExecutor
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.polyflow.runs import V1RunKind
from polyaxon_tpu_torch.scheduling import AdmissionController

_PIPELINE_KINDS = {"matrix", V1RunKind.DAG, "schedule"}


class Agent:
    def __init__(
        self,
        plane: ControlPlane,
        *,
        executor: Optional[LocalExecutor] = None,
        max_concurrent: int = 4,
        in_process: bool = False,
        slice_manager=None,
        admission: Optional[AdmissionController] = None,
        device=None,
    ):
        if slice_manager is not None:
            raise NotImplementedError(
                "the native slice pool (Agent(slice_manager=...)) is not "
                "ported yet: ROADMAP.md, Queue 1 item 10")
        self.plane = plane
        self.scheduler = Scheduler(plane)
        self.executor = executor or LocalExecutor(
            plane, in_process=in_process, device=device)
        self.max_concurrent = max_concurrent
        self.admission = admission or AdmissionController(plane)
        self._notified: set[str] = set()
        self._notify_service = None  # built lazily from the home catalog
        self._history_refresh_t: Optional[float] = None

    def _notify_terminal_runs(self) -> int:
        """Fan out spec'd notifications for newly-terminal runs.

        Never raises: notification IO must not kill the reconcile loop
        (notifiers/service.py contract). Scans the NEWEST terminal runs
        so the set stays bounded no matter how much history accumulates;
        anything older than the window was handled by a prior pass (or a
        prior agent, per the persisted ``meta.notified`` flag).
        """
        from polyaxon_tpu_torch.lifecycle import V1Statuses

        sent = 0
        try:
            terminal = self.plane.list_runs(
                statuses=list(V1Statuses.terminal_values()),
                limit=500, newest_first=True)
            for record in terminal:
                if record.uuid in self._notified:
                    continue
                if (record.meta or {}).get("notified"):
                    self._notified.add(record.uuid)
                    continue  # sent by a previous agent incarnation
                notifications = (record.spec or {}).get("notifications")
                hooks = (record.spec or {}).get("hooks")
                if not notifications and not hooks:
                    self._notified.add(record.uuid)
                    continue
                if notifications:
                    if self._notify_service is None:
                        from polyaxon_tpu_torch.notifiers import NotificationService

                        self._notify_service = NotificationService(
                            self.plane.connections)
                    run_info = {
                        "uuid": record.uuid, "name": record.name,
                        "project": record.project, "kind": record.kind,
                        "finished_at": record.finished_at,
                    }
                    sent += self._notify_service.notify_terminal(
                        run_info, record.status, notifications)
                if hooks:
                    self._spawn_hooks(record, hooks)
                self._notified.add(record.uuid)
                meta = dict(record.meta or {})
                meta["notified"] = True
                self.plane.store.update_run(record.uuid, meta=meta)
        except Exception:
            import logging

            logging.getLogger(__name__).warning(
                "notification pass failed", exc_info=True)
        return sent

    def _spawn_hooks(self, record, hooks: list[dict]) -> int:
        """Terminal-status hooks: spawn the referenced hub component as a
        child run (upstream V1Hook semantics — SURVEY.md §2 lifecycle)."""
        from polyaxon_tpu_torch.lifecycle import V1Statuses as S
        from polyaxon_tpu_torch.polyflow.operation import V1Operation

        matches = {
            None: True, "done": True,
            "succeeded": record.status == S.SUCCEEDED,
            "failed": record.status in (S.FAILED, S.UPSTREAM_FAILED),
            "stopped": record.status == S.STOPPED,
        }
        spawned = 0
        for hook in hooks:
            trigger = (hook.get("trigger") or "done").lower()
            if not matches.get(trigger, False):
                continue
            hub_ref = hook.get("hubRef") or hook.get("hub_ref")
            if not hub_ref:
                continue  # connection-only hooks are notification aliases
            try:
                op = V1Operation(hub_ref=hub_ref, presets=hook.get("presets"))
                self.plane.submit(
                    op=op, project=record.project,
                    params=hook.get("params"),
                    name=f"{record.name or record.uuid}-hook",
                    parent_uuid=record.uuid,
                )
                spawned += 1
            except Exception as exc:
                import logging

                logging.getLogger(__name__).warning(
                    "hook %s for run %s failed to spawn: %s",
                    hub_ref, record.uuid, exc)
        return spawned

    def _record_placement_span(self, record, t0: float, *,
                               state: str, topology=None) -> None:
        """``placement`` span on the run's lifecycle timeline — written
        only when the decision lands (cleared or unplaceable), so each
        start attempt gets exactly one placement span, not one per
        pending tick."""
        from polyaxon_tpu_torch.obs import trace as obs_trace

        try:
            obs_trace.record_completed(
                self.plane.run_artifacts_dir(record.uuid), record.uuid,
                "placement", start=t0, end=time.time(), component="agent",
                status="error" if state == "unplaceable" else "ok",
                attributes={"state": state,
                            **({"topology": topology} if topology else {}),
                            "provider": "local"})
        except OSError:
            pass  # tracing must never block a start

    def _cleared_to_start(self, record) -> bool:
        """Placement: with no slice pool in the port (ROADMAP.md, Queue 1
        item 10) every admitted run is placed locally at once."""
        self._record_placement_span(record, time.time(), state="running")
        return True

    def _evaluate_alerts(self) -> None:
        """One alert-rule pass over the live registry (obs.rules): the
        reconcile loop is the evaluation clock, the same way the Borgmon
        lineage runs rules next to collection. Fired rules with
        ``annotate_runs`` stamp the live runs through the plane. Never
        raises — alerting must not take scheduling down."""
        try:
            from polyaxon_tpu_torch.obs import rules as obs_rules

            obs_rules.default_engine().evaluate(plane=self.plane)
        except Exception:  # noqa: BLE001 — fail-open observability
            import logging

            logging.getLogger(__name__).warning(
                "alert evaluation pass failed", exc_info=True)

    def _sample_history(self) -> None:
        """Feed the shared metrics-history ring (obs.history): refresh
        the per-project quota gauges from the admission live view, then
        let the ring take its cadence-gated sample — the reconcile loop
        is the sampling clock, exactly as it is the alert clock. Runs
        BEFORE ``_evaluate_alerts`` so the engine's forced sample sees
        current quota gauges. The refresh is paced by the agent's OWN
        cadence tracker, not ``history.due()``: an alert engine sharing
        the ring force-samples on every evaluate, which would keep
        ``due()`` False forever and freeze the gauges at their first
        value. Never raises — fail-open telemetry."""
        try:
            from polyaxon_tpu_torch.obs import history as obs_history
            from polyaxon_tpu_torch.obs import metrics as obs_metrics

            history = obs_history.default_history()
            now = time.monotonic()
            if (self._history_refresh_t is not None
                    and now - self._history_refresh_t < history.cadence):
                return
            self._history_refresh_t = now
            usage = obs_metrics.project_usage()
            limit = obs_metrics.project_quota_limit()
            live = self.admission.usage_snapshot()
            quotas = {q["project"]: q
                      for q in self.plane.store.list_quotas()}
            for project in set(live) | set(quotas):
                used = live.get(project) or {}
                quota = quotas.get(project) or {}
                usage.set(float(used.get("runs", 0)),
                          project=project, resource="runs")
                usage.set(float(used.get("chips", 0)),
                          project=project, resource="chips")
                limit.set(float(quota.get("max_runs") or 0),
                          project=project, resource="runs")
                limit.set(float(quota.get("max_chips") or 0),
                          project=project, resource="chips")
            history.sample()
        except Exception:  # noqa: BLE001 — fail-open observability
            import logging

            logging.getLogger(__name__).warning(
                "metrics-history sampling pass failed", exc_info=True)

    def reconcile_once(self) -> int:
        actions = self.scheduler.tick()
        actions += self.executor.poll()
        self._notify_terminal_runs()
        self._sample_history()
        self._evaluate_alerts()
        # Kind filter pushed into SQL (ISSUE 8): at 10k queued trials a
        # Python-side filter would deserialize every record per tick.
        queued = self.plane.list_runs(
            statuses=[V1Statuses.QUEUED],
            exclude_kinds=sorted(str(k) for k in _PIPELINE_KINDS),
            limit=100000)
        capacity = max(self.max_concurrent - len(self.executor.active_runs), 0)
        t_admission = time.time()
        decision = self.admission.plan(
            queued, capacity=capacity,
            active=set(self.executor.active_runs))
        t_admission_end = time.time()
        for victim in decision.victims:
            # Control-plane-driven priority preemption: kill the gang
            # (reaps PREEMPTED next poll → backoff requeue).
            if victim in self.executor.active_runs:
                self.executor.preempt(victim)
                actions += 1
        started = 0
        for record, info in decision.admitted:
            if started >= capacity:
                break
            # Scan PAST placement-pending runs until capacity fills: one
            # uncleared run must never waste a slot a clearable run
            # behind it could use (head-of-line fix).
            if not self._cleared_to_start(record):
                continue
            # The pass that cleared this run becomes its ``admission``
            # span: queue/class/priority attributes explain WHY it won
            # the slot (obs.trace).
            from polyaxon_tpu_torch.obs import trace as obs_trace

            try:
                obs_trace.record_completed(
                    self.plane.run_artifacts_dir(record.uuid), record.uuid,
                    "admission", start=t_admission, end=t_admission_end,
                    component="agent",
                    attributes={"queue": info.queue,
                                "priority_class": info.priority_class,
                                "priority": info.priority,
                                "capacity": capacity,
                                "queued": len(queued)})
            except OSError:
                pass
            self.executor.start(record.uuid)
            started += 1
            actions += 1
        # Stop requests for gangs we own.
        for record in self.plane.list_runs(statuses=[V1Statuses.STOPPING]):
            if record.uuid in self.executor.active_runs:
                self.executor.stop(record.uuid)
            elif record.kind in _PIPELINE_KINDS:
                children = self.plane.list_runs(pipeline_uuid=record.uuid)
                if all(c.is_done for c in children):
                    # polycheck: ignore[invariant-store-batch] -- independent per-run stop acks in a loop: each transition is atomic on its own; batching would couple unrelated runs' crash semantics
                    self.plane.store.transition(record.uuid, V1Statuses.STOPPED)
                    actions += 1
            else:
                self.plane.store.transition(record.uuid, V1Statuses.STOPPED)
                actions += 1
        return actions

    def run_until_done(
        self,
        run_uuid: str,
        *,
        timeout: float = 600.0,
        poll_seconds: float = 0.2,
    ) -> V1Statuses:
        """Drive reconcile until ``run_uuid`` (and, for pipelines, all
        descendants) reaches a terminal state."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.reconcile_once()
            record = self.plane.get_run(run_uuid)
            if record.is_done:
                children = self.plane.list_runs(pipeline_uuid=run_uuid)
                if all(c.is_done for c in children):
                    return record.status
            time.sleep(poll_seconds)
        raise TimeoutError(f"Run `{run_uuid}` did not finish within {timeout}s")

    def serve_forever(self, poll_seconds: float = 1.0) -> None:
        while True:
            did = self.reconcile_once()
            time.sleep(poll_seconds if not did else 0.05)
