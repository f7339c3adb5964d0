"""Weighted fair-share admission + priority preemption (ISSUE 2).

Replaces the agent's FIFO ``queued[:capacity]`` slice with a policy
pass in the Borg/Kubernetes shape (PAPERS.md): desired-state queues and
quotas enforced by an idempotent per-tick decision, priority preemption
as the pressure valve. Every decision is recomputed from store state,
so a restarted agent converges to the same admissions.

Ordering: eligible QUEUED runs are admitted by

    (queue priority desc, project fair-share deficit desc, age asc)

where the deficit of project *p* is ``weight_p / Σweights − share_p``
over the runs currently live plus the ones tentatively admitted earlier
in the same pass — classic weighted fair queueing, so two projects
flooding one queue converge to their quota weights.

Scale (ISSUE 8, sized by the fleet sim): the live view is INCREMENTAL —
a ``Store.transition`` listener feeds status deltas into an in-memory
``_LiveEntry`` map instead of a per-pass O(live+queued) rebuild, and a
periodic full rebuild (``POLYAXON_TPU_ADMISSION_REBUILD_TICKS``, default
50 passes) cross-checks the map against the store, counting any
divergence into ``polyaxon_admission_live_divergence_total`` (the sim
asserts it stays zero across a whole compressed day). The ranking loop
groups candidates by (queue, project): members of a group share every
component of the rank key except age — and within a group candidates
already sit in age order — so each round picks the global head by
scanning GROUP heads, O(candidates · groups) per pass instead of the
old full re-sort per admission, with byte-identical admission order.

Preemption: a run that stays admissible but capacity-starved for
``POLYAXON_TPU_STARVATION_TICKS`` consecutive passes picks ONE victim —
the lowest-effective-priority RUNNING run on a *preemptible* queue —
which the agent evicts (kill → PREEMPTED → PR 1 backoff requeue).
Quota walls never trigger preemption: exceeding tenants wait, loudly
(a ``reason=QuotaExceeded`` condition is pinned on the blocked run).

Chaos seam ``admission``: a fault ``{"seam": "admission", "op":
"<queue>"}`` starves that queue's candidates for ``times`` decisions,
so drills can prove starvation stays bounded and observable.

Port of ``polyaxon_tpu/scheduling/admission.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from collections import deque

from polyaxon_tpu_torch import chaos
from polyaxon_tpu_torch.controlplane.store import RunRecord
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.scheduling.catalog import (
    DEFAULT_QUEUE,
    RunSchedInfo,
    sched_info,
)

logger = logging.getLogger(__name__)

# Statuses that occupy capacity/quota (anything the executor may own).
LIVE_STATUSES = [
    V1Statuses.SCHEDULED,
    V1Statuses.STARTING,
    V1Statuses.RUNNING,
    V1Statuses.PROCESSING,
    V1Statuses.WARNING,
    V1Statuses.STOPPING,
]
_LIVE_SET = frozenset(LIVE_STATUSES)

_PIPELINE_KINDS = {"matrix", "dag", "schedule"}


def _starvation_ticks() -> int:
    try:
        return max(1, int(os.environ.get("POLYAXON_TPU_STARVATION_TICKS", "3")))
    except ValueError:
        return 3


def _rebuild_ticks() -> int:
    try:
        return max(1, int(os.environ.get(
            "POLYAXON_TPU_ADMISSION_REBUILD_TICKS", "50")))
    except ValueError:
        return 50


@dataclasses.dataclass
class AdmissionDecision:
    """One pass's verdict. ``admitted`` is ordered and may be longer
    than capacity: the agent starts entries until capacity is filled,
    skipping ones whose slice placement is still pending — so a single
    unplaceable run can never waste a slot a placeable one needs
    (head-of-line fix)."""

    admitted: list[tuple[RunRecord, RunSchedInfo]]
    victims: list[str]  # run uuids to preempt for starved high-priority work
    blocked: dict[str, str]  # run uuid -> reason (QuotaExceeded, ...)


@dataclasses.dataclass
class _LiveEntry:
    """The admission-relevant slice of one live run — everything a pass
    or victim selection reads, so neither ever refetches the record."""

    uuid: str
    project: str
    queue: str
    chips: int
    priority: int  # priority-class rank (catalog.RunSchedInfo.priority)
    status: V1Statuses
    started_at: str | None
    created_at: str


class AdmissionController:
    def __init__(self, plane, *, starvation_ticks: int | None = None,
                 incremental: bool = True,
                 rebuild_ticks: int | None = None):
        self.plane = plane
        self.store = plane.store
        self.starvation_ticks = starvation_ticks or _starvation_ticks()
        self._starved: dict[str, int] = {}  # uuid -> consecutive starved passes
        # Last reason pinned per still-queued run: re-pinning is skipped
        # without the old per-run last_condition query every pass.
        self._pinned: dict[str, str] = {}
        # ``incremental=False`` is the bench/deopt baseline: rebuild the
        # live view from the store every pass and rank with the original
        # full re-sort loop.
        self.incremental = incremental
        self.rebuild_ticks = rebuild_ticks or _rebuild_ticks()
        self._live: dict[str, _LiveEntry] = {}
        self._live_lock = threading.Lock()
        self._seeded = False
        self._passes = 0
        self.rebuild_checks = 0
        self.divergence_total = 0
        if self.incremental:
            self.store.add_transition_listener(self._on_transition)

    # ------------------------------------------------------------ helpers
    def _queue_row(self, queues: dict[str, dict], name: str) -> dict:
        row = queues.get(name)
        if row is not None:
            return row
        # Unknown queue (legacy run / deleted queue): schedule like the
        # implicit default — neutral priority, uncapped, non-preemptible.
        return {"name": name or DEFAULT_QUEUE, "priority": 0,
                "concurrency": None, "preemptible": False}

    def _pin_blocked(self, record: RunRecord, reason: str, message: str) -> None:
        """Surface WHY a run is still queued, once per block streak —
        re-pinning every tick would flood the condition history. The
        in-memory streak cache keeps repeat passes query-free; the store
        check only runs on the first sighting (e.g. agent restart)."""
        if self._pinned.get(record.uuid) == reason:
            return
        last = self.store.last_condition(record.uuid)
        if last is not None and last.get("reason") == reason:
            self._pinned[record.uuid] = reason
            return
        self.store.add_condition(
            record.uuid, V1Statuses.QUEUED.value, reason=reason,
            message=message)
        self._pinned[record.uuid] = reason

    # -------------------------------------------------- incremental live view
    def _entry_from_record(self, record: RunRecord) -> _LiveEntry:
        info = sched_info(record)
        return _LiveEntry(
            uuid=record.uuid, project=record.project, queue=info.queue,
            chips=info.chips, priority=info.priority, status=record.status,
            started_at=record.started_at, created_at=record.created_at)

    def _on_transition(self, event: dict) -> None:
        """Store delta feed: keep the live map exact without scans."""
        new = event["new"]
        uuid = event["uuid"]
        with self._live_lock:
            entry = self._live.get(uuid)
            if new in _LIVE_SET:
                if entry is not None:
                    entry.status = new
                    if new == V1Statuses.RUNNING and not entry.started_at:
                        entry.started_at = event["ts"]
                    return
            elif entry is not None:
                del self._live[uuid]
                return
            elif new not in _LIVE_SET:
                return
        # Entering the live set for the first time: one point lookup
        # (outside the map lock; transitions into live are bounded by
        # executor capacity per tick, not by queue depth).
        try:
            record = self.store.get_run(uuid)
        except KeyError:
            return
        if record.kind in _PIPELINE_KINDS:
            return
        entry = self._entry_from_record(record)
        entry.status = new
        if new == V1Statuses.RUNNING and not entry.started_at:
            entry.started_at = event["ts"]
        with self._live_lock:
            # Re-check: a racing terminal transition may have landed.
            if record.status in _LIVE_SET or new in _LIVE_SET:
                self._live[uuid] = entry

    def _rebuild_live(self) -> dict[str, _LiveEntry]:
        return {
            r.uuid: self._entry_from_record(r)
            for r in self.store.list_runs(
                statuses=LIVE_STATUSES,
                exclude_kinds=sorted(_PIPELINE_KINDS),
                limit=1000000)
        }

    def _live_view(self) -> dict[str, _LiveEntry]:
        """Current live entries. Incremental mode serves the in-memory
        map, re-seeding on first use and cross-checking it against a
        full store rebuild every ``rebuild_ticks`` passes — divergence
        is counted (metric + ``divergence_total``), logged, and healed
        by adopting the rebuilt view."""
        if not self.incremental:
            return self._rebuild_live()
        self._passes += 1
        if not self._seeded:
            # Seed OUTSIDE the lock: the scan is O(fleet) and every
            # store transition's _notify blocks on _live_lock (while
            # holding Store._lock), so holding it across list_runs
            # stalls every writer for the whole scan. Deltas that land
            # mid-rebuild win by uuid; drift in the other direction is
            # healed by the periodic divergence cross-check below.
            rebuilt = self._rebuild_live()
            with self._live_lock:
                if not self._seeded:
                    for uuid, entry in self._live.items():
                        rebuilt[uuid] = entry
                    self._live = rebuilt
                    self._seeded = True
        elif self._passes % self.rebuild_ticks == 0:
            rebuilt = self._rebuild_live()
            self.rebuild_checks += 1
            with self._live_lock:
                current = {
                    u: (e.project, e.queue, e.chips, e.status.value)
                    for u, e in self._live.items()}
            fresh = {u: (e.project, e.queue, e.chips, e.status.value)
                     for u, e in rebuilt.items()}
            diverged = (set(current.items()) ^ set(fresh.items()))
            if diverged:
                self.divergence_total += len(diverged)
                from polyaxon_tpu_torch.obs import metrics as obs_metrics

                obs_metrics.admission_divergence().inc(len(diverged))
                logger.warning(
                    "admission live-view divergence: %d entries disagree "
                    "with the store rebuild (delta feed bug?) — adopting "
                    "the rebuilt view", len(diverged))
            with self._live_lock:
                self._live = rebuilt
        with self._live_lock:
            return dict(self._live)

    def usage_snapshot(self) -> dict[str, dict[str, int]]:
        """{project: {"runs": n, "chips": n}} over the current live
        map — exactly the counts ``_admissible`` enforces quotas
        against, so the ``polyaxon_project_usage`` gauges (and the
        oracle's ``quota_violation`` invariant) see the same truth.
        O(live), no store scan, no pass-cadence side effects."""
        with self._live_lock:
            entries = list(self._live.values())
        usage: dict[str, dict[str, int]] = {}
        for entry in entries:
            row = usage.setdefault(entry.project, {"runs": 0, "chips": 0})
            row["runs"] += 1
            row["chips"] += entry.chips
        return usage

    # --------------------------------------------------------------- pass
    def plan(self, queued: list[RunRecord], *, capacity: int,
             active: set[str] | None = None) -> AdmissionDecision:
        """Decide this tick's admissions (ordered) and preemptions.

        ``queued``: eligible QUEUED run records (non-pipeline kinds).
        ``capacity``: free executor slots. ``active``: run uuids the
        executor currently owns (the only evictable victims).
        """
        if not queued:
            # Idle ticks stay cheap (no catalog/usage queries), and an
            # empty queue means nothing can be starved.
            self._starved.clear()
            self._pinned.clear()
            return AdmissionDecision(admitted=[], victims=[], blocked={})
        t0 = time.perf_counter()
        try:
            return self._plan(queued, capacity=capacity, active=active)
        finally:
            from polyaxon_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.admission_pass_hist().observe(
                time.perf_counter() - t0)

    def _plan(self, queued: list[RunRecord], *, capacity: int,
              active: set[str] | None = None) -> AdmissionDecision:
        queues = {q["name"]: q for q in self.store.list_queues()}
        quotas = {q["project"]: q for q in self.store.list_quotas()}
        live = self._live_view()

        # Usage (runs + chips per project, runs per queue), tentatively
        # extended as candidates are admitted within this pass.
        runs_by_project: dict[str, int] = {}
        chips_by_project: dict[str, int] = {}
        runs_by_queue: dict[str, int] = {}
        for entry in live.values():
            runs_by_project[entry.project] = (
                runs_by_project.get(entry.project, 0) + 1)
            chips_by_project[entry.project] = (
                chips_by_project.get(entry.project, 0) + entry.chips)
            runs_by_queue[entry.queue] = runs_by_queue.get(entry.queue, 0) + 1

        candidates = []
        for i, r in enumerate(queued):
            info = sched_info(r)
            info.queue_priority = self._queue_row(queues, info.queue)["priority"]
            candidates.append((i, r, info))
        blocked: dict[str, str] = {}

        def weight(project: str) -> float:
            quota = quotas.get(project)
            w = float(quota.get("weight") or 1.0) if quota else 1.0
            return max(w, 1e-9)

        active_projects = ({e.project for e in live.values()}
                           | {r.project for r in queued})
        weights = {p: weight(p) for p in active_projects}
        total_weight = sum(weights.values()) or 1.0
        total_live = sum(runs_by_project.values())

        usage = (runs_by_project, chips_by_project, runs_by_queue)
        if self.incremental:
            admitted = self._rank_grouped(
                candidates, queues, quotas, weights, total_weight,
                total_live, usage, blocked)
        else:
            admitted = self._rank_legacy(
                candidates, queues, quotas, weights, total_weight,
                usage, blocked)

        victims = self._select_victims(
            admitted[max(capacity, 0):], queues, live, active or set())

        # Admission outcomes feed the unified registry: per-reason
        # blocked counts, admissions (capped at real capacity — the
        # overflow tail is ranked, not admitted), and evictions.
        from polyaxon_tpu_torch.obs import metrics as obs_metrics

        outcomes = obs_metrics.admission_outcomes()
        n_admitted = len(admitted[:max(capacity, 0)])
        if n_admitted:
            outcomes.inc(n_admitted, outcome="admitted")
        for reason in blocked.values():
            outcomes.inc(outcome=reason)
        if victims:
            outcomes.inc(len(victims), outcome="victim")

        # Starvation counters/pin streaks only live for still-queued runs.
        queued_uuids = {r.uuid for r in queued}
        for uuid in list(self._starved):
            if uuid not in queued_uuids:
                del self._starved[uuid]
        for uuid in list(self._pinned):
            if uuid not in queued_uuids:
                del self._pinned[uuid]
        return AdmissionDecision(admitted=admitted, victims=victims,
                                 blocked=blocked)

    # ------------------------------------------------------------- ranking
    def _admissible(self, record: RunRecord, info: RunSchedInfo,
                    queue: dict, quotas: dict, usage, plan,
                    blocked: dict[str, str]) -> bool:
        """Examine one rank-order head: True → admit; False → the run
        was blocked (and recorded). Shared verbatim by both rankers so
        chaos firing order and pin semantics cannot drift."""
        runs_by_project, chips_by_project, runs_by_queue = usage
        if plan is not None and plan.fire(
                "admission", info.queue, detail=record.uuid) is not None:
            blocked[record.uuid] = "ChaosStarved"
            return False
        cap = queue.get("concurrency")
        if cap is not None and runs_by_queue.get(info.queue, 0) >= cap:
            blocked[record.uuid] = "QueueSaturated"
            self._pin_blocked(
                record, "QueueSaturated",
                f"queue `{info.queue}` at concurrency cap {cap}")
            return False
        quota = quotas.get(record.project)
        if quota is not None:
            max_runs = quota.get("max_runs")
            max_chips = quota.get("max_chips")
            used_runs = runs_by_project.get(record.project, 0)
            used_chips = chips_by_project.get(record.project, 0)
            if max_runs is not None and used_runs >= max_runs:
                blocked[record.uuid] = "QuotaExceeded"
                self._pin_blocked(
                    record, "QuotaExceeded",
                    f"project `{record.project}` at max_runs="
                    f"{max_runs} ({used_runs} live)")
                return False
            if (max_chips is not None
                    and used_chips + info.chips > max_chips):
                blocked[record.uuid] = "QuotaExceeded"
                self._pin_blocked(
                    record, "QuotaExceeded",
                    f"project `{record.project}` chips quota "
                    f"{used_chips}+{info.chips} > {max_chips}")
                return False
        return True

    def _rank_grouped(self, candidates, queues, quotas, weights,
                      total_weight, total_live, usage, blocked):
        """Admission ordering via (queue, project) groups.

        Every member of a group shares queue priority and project
        deficit, and group members sit in age order — so the globally
        best candidate is always some group's HEAD, found by scanning
        group heads (O(groups)) instead of re-sorting all remaining
        candidates (the old O(n log n) per admission). Admission order,
        block verdicts, and chaos firing order match the legacy ranker
        exactly; the fairness/starvation suites run against both."""
        runs_by_project, chips_by_project, runs_by_queue = usage
        groups: dict[tuple[str, str], deque] = {}
        for item in candidates:  # already in age order
            groups.setdefault((item[2].queue, item[1].project),
                              deque()).append(item)
        qprio = {key: self._queue_row(queues, key[0])["priority"]
                 for key in groups}
        plan = chaos.active_plan()
        admitted: list[tuple[RunRecord, RunSchedInfo]] = []
        while groups:
            best_key, best_rank = None, None
            for key, members in groups.items():
                project = key[1]
                share = (runs_by_project.get(project, 0) / total_live
                         if total_live else 0.0)
                deficit = weights[project] / total_weight - share
                rank = (-qprio[key], -deficit, members[0][0])
                if best_rank is None or rank < best_rank:
                    best_key, best_rank = key, rank
            members = groups[best_key]
            _, record, info = members.popleft()
            if not members:
                del groups[best_key]
            queue = self._queue_row(queues, info.queue)
            if not self._admissible(record, info, queue, quotas, usage,
                                    plan, blocked):
                continue
            admitted.append((record, info))
            runs_by_project[record.project] = (
                runs_by_project.get(record.project, 0) + 1)
            chips_by_project[record.project] = (
                chips_by_project.get(record.project, 0) + info.chips)
            runs_by_queue[info.queue] = runs_by_queue.get(info.queue, 0) + 1
            total_live += 1
        return admitted

    def _rank_legacy(self, candidates, queues, quotas, weights,
                     total_weight, usage, blocked):
        """The original full-re-sort ranking loop (pre-ISSUE-8), kept
        as the bench/deopt baseline the budget gate must fail on."""
        runs_by_project, chips_by_project, runs_by_queue = usage
        plan = chaos.active_plan()
        admitted: list[tuple[RunRecord, RunSchedInfo]] = []

        def deficit(project: str) -> float:
            total_live = sum(runs_by_project.values())
            share = (runs_by_project.get(project, 0) / total_live
                     if total_live else 0.0)
            return weights[project] / total_weight - share

        remaining = list(candidates)
        while remaining:
            # Re-rank each round: admissions shift the fair-share
            # deficits, which is exactly what makes this converge.
            remaining.sort(key=lambda item: (
                -self._queue_row(queues, item[2].queue)["priority"],
                -deficit(item[1].project),
                item[0],  # age: store order is (created_at, rowid)
            ))
            entry = remaining[0]
            _, record, info = entry
            remaining.remove(entry)
            queue = self._queue_row(queues, info.queue)
            if not self._admissible(record, info, queue, quotas, usage,
                                    plan, blocked):
                continue
            admitted.append((record, info))
            runs_by_project[record.project] = (
                runs_by_project.get(record.project, 0) + 1)
            chips_by_project[record.project] = (
                chips_by_project.get(record.project, 0) + info.chips)
            runs_by_queue[info.queue] = runs_by_queue.get(info.queue, 0) + 1
        return admitted

    # --------------------------------------------------------- preemption
    def _select_victims(self, overflow, queues,
                        live: dict[str, _LiveEntry],
                        active: set[str]) -> list[str]:
        """Pick victims for admissible-but-capacity-starved runs.

        One victim per starved run per tick, strictly lower effective
        priority, on a preemptible queue, currently owned by the
        executor — the gentlest eviction that unblocks the starved run.
        The victim pool is sorted once per pass (eff asc, youngest
        first within a tier), so the best victim for any starved run is
        the pool head iff its effective priority is strictly lower."""
        victims: list[str] = []
        if not overflow:
            self._starved.clear()
            return victims
        pool: list[tuple[tuple[int, int], str, _LiveEntry]] = []
        for entry in live.values():
            if entry.uuid not in active:
                continue
            if entry.status != V1Statuses.RUNNING:
                continue
            cqueue = self._queue_row(queues, entry.queue)
            if not cqueue["preemptible"]:
                continue
            eff = (cqueue["priority"], entry.priority)
            pool.append((eff, entry.started_at or entry.created_at, entry))
        # Lowest priority first; among equals the YOUNGEST start first
        # (least progress lost) — hence the descending timestamp.
        pool.sort(key=lambda item: item[1], reverse=True)
        pool.sort(key=lambda item: item[0])
        pool_dq = deque(pool)
        overflow_uuids = {r.uuid for r, _ in overflow}
        for record, info in overflow:
            ticks = self._starved.get(record.uuid, 0) + 1
            self._starved[record.uuid] = ticks
            if ticks < self.starvation_ticks:
                continue
            if not pool_dq:
                continue
            starved_eff = info.effective(
                self._queue_row(queues, info.queue)["priority"])
            eff, _, victim = pool_dq[0]
            if eff >= starved_eff:
                continue  # nothing strictly lower-priority to evict
            pool_dq.popleft()
            victims.append(victim.uuid)
            self._starved[record.uuid] = 0
            victim_record = self.store.get_run(victim.uuid)
            meta = dict(victim_record.meta or {})
            sched = dict(meta.get("scheduling") or {})
            sched["evicted_for"] = record.uuid
            meta["scheduling"] = sched
            self.store.update_run(victim.uuid, meta=meta)
            logger.info("admission: preempting %s (eff=%s) for starved %s "
                        "(eff=%s)", victim.uuid, eff, record.uuid,
                        starved_eff)
        # Drop counters for runs that were admitted within capacity.
        for uuid in list(self._starved):
            if uuid not in overflow_uuids:
                self._starved.pop(uuid, None)
        return victims
