"""SliceManager: bridges the agent reconcile loop and the native C++
slice pool (``polyaxon_tpu_torch/native/sliced.py``). Port of
``polyaxon_tpu/agent/slices.py``.

The agent asks it before starting any gang whose launch plan requests a
topology: placement either succeeds (the gang is pinned to chips of a
registered slice), stays pending (no capacity — the run stays QUEUED),
or triggers priority eviction of lower-priority gangs on preemptible
slices (victims transition PREEMPTED and the scheduler requeues them).
Heartbeats come from the agent's own poll of live gangs; a stale gang
follows the native restart policy and surfaces RESTART/FAILED events
back into run statuses.

On a GPU host a slice is the host's cards, as a one-dimensional
topology ``"N"`` (``--slice gpu0:4``), and a run's
``resources.topology`` ``"k"`` asks for k of them. The placement's
``chips`` are the indices, in the executor's pool of cards, of the cards
the run's processes share out (``LocalExecutor.start(chips=...)``), so
two placed runs never hold the same card.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from polyaxon_tpu_torch.native import SlicePool, SlicedError

logger = logging.getLogger(__name__)


def _chips_of(topology: str) -> int:
    n = 1
    for d in topology.lower().split("x"):
        n *= int(d)
    return n


class SliceManager:
    def __init__(
        self,
        slices: Optional[list[tuple[str, str, bool]]] = None,
        *,
        heartbeat_timeout: float = 60.0,
    ):
        self.pool = SlicePool()
        self.heartbeat_timeout = heartbeat_timeout
        self._gangs: dict[str, int] = {}  # run_uuid -> gang id
        self._slices: list[tuple[str, str, bool]] = list(slices or [])
        for name, topology, preemptible in self._slices:
            self.pool.add_slice(name, topology, preemptible=preemptible)

    def close(self) -> None:
        self.pool.close()

    # ------------------------------------------------------------ placement
    def ensure_placed(self, run_uuid: str, topology: Optional[str], *,
                      priority: Optional[int] = None, max_restarts: int = 0,
                      preemptible: bool = False) -> str:
        """Returns the gang state (``running`` means cleared to start).

        Runs without a topology request bypass placement entirely.
        ``priority`` is the scheduling catalog's gang priority (queue ×
        priority class — ``scheduling.gang_priority``); ``None`` falls
        back to the legacy preemptible/reserved split. 0 is a real
        priority (the ``low`` class on a priority-0 queue), not "unset".
        """
        if not topology:
            return "running"
        gang_id = self._gangs.get(run_uuid)
        if gang_id is not None:
            # A preempted/failed gang must be re-requested from scratch
            # (the scheduler requeued the run; chips were already vacated).
            try:
                state = self.pool.gang(gang_id).state
            except SlicedError:  # gang already erased pool-side
                state = "released"
            if state in ("preempted", "failed", "released"):
                self.release(run_uuid)
                gang_id = None
        if gang_id is None:
            try:
                gang_id = self.pool.request_gang(
                    run_uuid, topology,
                    priority=(priority if priority is not None
                              else (0 if preemptible else 1)),
                    max_restarts=max_restarts,
                )
            except SlicedError as exc:
                logger.warning("placement rejected for %s: %s", run_uuid, exc)
                return "unplaceable"
            self._gangs[run_uuid] = gang_id
        return self.pool.gang(gang_id).state

    def resize_placement(self, run_uuid: str, topology: str, *,
                         priority: Optional[int] = None,
                         max_restarts: int = 0,
                         preemptible: bool = False) -> str:
        """Partial vacate / regrow (elastic gangs): re-place
        a LIVE gang at a different topology without the all-or-nothing
        preempted→requeue round trip. The current subgrid is released
        and the new one requested in its place; a grow that does not
        place *immediately* (``unplaceable`` OR parked ``pending`` in
        the pool queue) restores the old placement, so the still-running
        gang never trains on chips it no longer holds — a queued resize
        would let the pool hand its working set to someone else."""
        if not topology:
            return "running"
        try:
            placed = self.placement(run_uuid)
        except SlicedError:  # gang erased pool-side (e.g. slice removed)
            placed = None
        old_topology = placed.topology if placed is not None else None
        self.release(run_uuid)
        state = self.ensure_placed(run_uuid, topology, priority=priority,
                                   max_restarts=max_restarts,
                                   preemptible=preemptible)
        if state != "running" and old_topology:
            # Roll back: drop the failed/queued request and re-pin the
            # old footprint — its chips were just freed, so the
            # original placement always fits again.
            self.release(run_uuid)
            self.ensure_placed(run_uuid, old_topology, priority=priority,
                               max_restarts=max_restarts,
                               preemptible=preemptible)
        return state

    def capacity_available(self, topology: str) -> bool:
        """Capacity-return notification: True when some registered
        slice has enough free chips for ``topology`` right now — the
        signal the agent polls to grow shrunk elastic gangs back. Free
        chips are necessary, not sufficient (contiguity is decided
        by the pool), so callers must treat a later placement rejection
        as a non-event."""
        need = _chips_of(topology)
        for name, _topo, _pre in self._slices:
            try:
                if self.pool.free_chips(name) >= need:
                    return True
            except SlicedError:
                continue
        return False

    def placement(self, run_uuid: str):
        gang_id = self._gangs.get(run_uuid)
        return self.pool.gang(gang_id) if gang_id is not None else None

    def tracked_runs(self) -> list[str]:
        return list(self._gangs)

    def release(self, run_uuid: str) -> None:
        gang_id = self._gangs.pop(run_uuid, None)
        if gang_id is not None:
            try:
                self.pool.release_gang(gang_id)
            except SlicedError:
                pass

    def stats(self) -> dict:
        """Pool state for the API/dashboard: per-slice capacity and the
        gangs currently placed (the operator view of the C++ pool)."""
        slices = []
        for name, topology, preemptible in self._slices:
            total = _chips_of(topology)
            try:
                free = self.pool.free_chips(name)
            except SlicedError:  # removed from the pool since init
                continue
            slices.append({"name": name, "topology": topology,
                           "preemptible": preemptible,
                           "free_chips": free, "total_chips": total})
        gangs = []
        # Snapshot: API handler threads poll this while the agent
        # thread mutates placements.
        for run_uuid, gang_id in list(self._gangs.items()):
            try:
                g = self.pool.gang(gang_id)
            except SlicedError:
                continue
            gangs.append({"run_uuid": run_uuid, "state": g.state,
                          "slice": g.slice, "topology": g.topology,
                          "chips": len(g.chips), "restarts": g.restarts})
        return {"slices": slices, "gangs": gangs}

    # -------------------------------------------------------------- signals
    def heartbeat(self, run_uuid: str, *, proc: int = 0,
                  now: Optional[float] = None) -> None:
        gang_id = self._gangs.get(run_uuid)
        if gang_id is not None:
            self.pool.heartbeat(gang_id, proc, time.time() if now is None else now)

    def preempt_slice(self, name: str) -> int:
        return self.pool.preempt_slice(name)

    # ------------------------------------------------------------ reconcile
    def tick(self, now: Optional[float] = None) -> dict[str, list[str]]:
        """Advance the native pool; returns {run_uuid: [event kinds]}."""
        events = self.pool.tick(
            time.time() if now is None else now,
            heartbeat_timeout=self.heartbeat_timeout,
        )
        by_gang = {gid: uuid for uuid, gid in self._gangs.items()}
        out: dict[str, list[str]] = {}
        for event in events:
            uuid = by_gang.get(event.gang_id)
            if uuid is not None:
                out.setdefault(uuid, []).append(event.kind)
        return out
