"""Serving fleet: N engine replicas behind one router, scaled by rules
(port of ``polyaxon_tpu/serving/fleet.py``, the same code under the
port's module names; on one card the replicas share it).

``ServingFleet`` owns the replica set and closes the loop the alert
engine already measures: the **autoscaler** grows/shrinks the fleet
from live rule state (``fleet-replica-hot``, ``serving-queue-
saturation``, ``serving-ttft-slo-burn``) instead of a load guess.

Two disciplines are non-negotiable, both inherited from the elastic
runtime (prewarm-before-commit):

* **Scale-up warms before admission routes to it.** A replica enters
  the router only in state ``ready``; the path there runs the model
  first (on the card that loads the kernels and warms the allocator).
  The cheap form is a **standby**: an engine built AND warmed at fleet
  start, promoted to ready in O(1) when the autoscaler fires. With no
  standby left, scale-up builds+warms a fresh replica on a background
  thread and commits only when warm. ``prewarm=False`` builds the
  standby cold, so its first routed request pays the warm-up.
* **Scale-down drains before release.** The victim leaves the router
  first (no new routes), then a background thread waits for its queue
  and live slots to empty before ``stop()`` — in-flight decode always
  finishes on the replica that admitted it.

Engines are injected via ``engine_factory`` so unit tests drive the
whole state machine with fakes at pure-Python speed; the real factory
(:func:`engine_factory`) builds paged-KV ``ContinuousBatchingEngine``
replicas.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, Optional, Sequence

from polyaxon_tpu_torch.obs import metrics as obs_metrics
from polyaxon_tpu_torch.obs import reqtrace
from polyaxon_tpu_torch.obs.trace import Span
from polyaxon_tpu_torch.serving.router import FleetRouter

# Rule ids whose firing state means "add capacity". The autoscaler
# consumes AlertEngine.active() — telemetry driving placement, not
# only verdicts.
SCALE_UP_RULES = frozenset((
    "fleet-replica-hot",
    "serving-queue-saturation",
    "serving-ttft-slo-burn",
))

REPLICA_STATES = ("warming", "standby", "ready", "draining", "released")


class Replica:
    """One engine + its lifecycle state and last-polled telemetry."""

    def __init__(self, rid: str):
        self.id = rid
        self.engine = None
        self.state = "warming"
        self.telemetry: dict = {}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Replica({self.id}, {self.state})"


def engine_factory(model: str = "llama_tiny", *, slots: int = 2,
                   kv: str = "paged", page_size: int = 4,
                   kv_pages: Optional[int] = None, device=None,
                   **engine_kw) -> Callable:
    """Real-engine factory: each call builds a fresh paged-KV
    ``ContinuousBatchingEngine`` replica (its own weights from seed 0)
    on ``device``."""
    def build(registry=None):
        from polyaxon_tpu_torch.serving.batching import (
            ContinuousBatchingEngine,
        )
        from polyaxon_tpu_torch.serving.server import load_params

        cfg, params = load_params(model, seed=0, device=device)
        return ContinuousBatchingEngine(
            model, cfg, params, slots=slots, kv=kv,
            page_size=page_size, kv_pages=kv_pages,
            registry=registry, device=device, **engine_kw)
    return build


class ServingFleet:
    """Replica set + router + SLO-driven autoscaler.

    ``replicas`` engines start ready (warmed when ``prewarm``),
    ``standby`` more are built warm but kept out of the router until a
    scale-up promotes them. ``maybe_scale(firing)`` is the control
    loop: call it with the alert engine's active rule ids.
    """

    def __init__(self, factory: Callable, *, replicas: int = 2,
                 standby: int = 0, min_replicas: int = 1,
                 max_replicas: int = 4, prewarm: bool = True,
                 warmup_rows: Optional[Sequence[Sequence[int]]] = None,
                 router: Optional[FleetRouter] = None,
                 cooldown: float = 5.0, idle_hold: float = 2.0,
                 registry=None, clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if replicas < min_replicas or replicas > max_replicas:
            raise ValueError("replicas must sit in "
                             "[min_replicas, max_replicas]")
        self._factory = factory
        self._initial = int(replicas)
        self._standby_n = int(standby)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.prewarm = bool(prewarm)
        self.warmup_rows = [list(r) for r in (warmup_rows or ())]
        self.router = router or FleetRouter()
        self.cooldown = float(cooldown)
        self.idle_hold = float(idle_hold)
        # Fleet-scoped telemetry: `_registry` is the shared
        # BASE registry (federation, rollups, component GC); the
        # fleet's own series record through a `fleet` view, the router
        # through a `router` view, and each engine replica gets its
        # own view in `_build` — every series carries the component
        # that produced it while rules keep judging the federated sum.
        self._registry = obs_metrics.base_registry(
            registry if registry is not None else obs_metrics.REGISTRY)
        self._obs = self._registry.scoped("fleet")
        if getattr(self.router, "_registry", None) is obs_metrics.REGISTRY:
            self.router._registry = self._registry.scoped("router")
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: dict[str, Replica] = {}
        self._next_id = 0
        self._threads: list[threading.Thread] = []
        self._last_scale = -float("inf")
        self._idle_since: Optional[float] = None
        self.scale_events: list[dict] = []

    # ------------------------------------------------------------ build
    def _new_replica(self) -> Replica:
        rep = Replica(f"r{self._next_id}")
        self._next_id += 1
        self._replicas[rep.id] = rep
        return rep

    def _warm(self, engine) -> None:
        """Compile every program traffic will need: two passes so both
        the full-prefill and the post-hit suffix-prefill programs (plus
        the decode step) are built before admission sees the replica."""
        if not self.warmup_rows:
            return
        for _ in range(2):
            engine.generate(self.warmup_rows, max_new_tokens=2,
                            klass="warmup")

    def _build(self, rep: Replica, *, warm: bool) -> None:
        view = self._registry.scoped(rep.id)
        try:
            rep.engine = self._factory(registry=view)
        except TypeError:
            # Legacy factories and test fakes take no kwargs; they
            # record unscoped — for a real engine that is exactly the
            # mute-replica failure the CI federated-view gate catches.
            rep.engine = self._factory()
        if warm:
            self._warm(rep.engine)

    def start(self) -> None:
        """Build the initial ready set + warm standbys (blocking — all
        warm-up cost lands here, before any traffic window opens)."""
        for _ in range(self._initial):
            rep = self._new_replica()
            self._build(rep, warm=self.prewarm)
            rep.state = "ready"
            self.router.add_replica(rep.id)
        for _ in range(self._standby_n):
            rep = self._new_replica()
            # prewarm=False leaves the standby unwarmed: promotion
            # commits a cold engine.
            self._build(rep, warm=self.prewarm)
            rep.state = "standby"
        self.poll()

    # ------------------------------------------------------------ state
    def _in_state(self, *states: str) -> list[Replica]:
        return sorted((r for r in self._replicas.values()
                       if r.state in states), key=lambda r: r.id)

    @property
    def ready(self) -> list[Replica]:
        return self._in_state("ready")

    # ------------------------------------------------------------- poll
    def poll(self) -> dict:
        """Refresh per-replica telemetry (the ONE polled surface —
        ``engine.health()``) and publish the fleet gauges. Returns
        ``{replica_id: health}`` for router consumption."""
        counts = {s: 0 for s in REPLICA_STATES}
        view: dict[str, dict] = {}
        for rep in self._replicas.values():
            counts[rep.state] += 1
            if rep.engine is None or rep.state == "released":
                continue
            try:
                rep.telemetry = rep.engine.health()
            except Exception:
                rep.telemetry = {"status": "error"}
            if rep.state == "ready":
                view[rep.id] = rep.telemetry
            # Prefill depth when the engine reports per-lane fields
            # — the same pressure signal the router spills
            # on; `queued` keeps older engines readable.
            depth = rep.telemetry.get("prefill_pending")
            if depth is None:
                depth = rep.telemetry.get("queued", 0)
            obs_metrics.fleet_replica_queue_depth(self._obs).set(
                depth, replica=rep.id)
        gauge = obs_metrics.fleet_replicas(self._obs)
        for state, n in counts.items():
            gauge.set(n, state=state)
        # Derived cross-component series (TTFT skew) refresh on the
        # same cadence as the raw gauges.
        obs_metrics.publish_fleet_rollups(self._registry)
        return view

    # ------------------------------------------------------------ serve
    def submit(self, tokens: Sequence[int], max_new_tokens: int, **kw):
        """Route one request and submit it to the chosen replica.
        Returns ``(request, decision)``.

        The fleet pre-generates the request id and closes a ``route``
        span under it before the hop, handing the engine the span
        record plus its span id as trace parent — the replica's
        ``request`` tree nests under the routing decision and ONE
        trace id yields one fleet-wide timeline."""
        with self._lock:
            telemetry = {r.id: r.telemetry for r in self.ready}
            decision = self.router.route(tokens, telemetry=telemetry)
            rep = self._replicas[decision.replica]
        rid = kw.pop("request_id", None) or reqtrace.new_request_id()
        span = Span(trace_id=rid, name="route", component="router",
                    attributes={
                        "decision": decision.reason,
                        "replica": decision.replica,
                        "prefix": decision.prefix,
                        "candidates": {
                            r: int((t or {}).get(
                                "prefill_pending",
                                (t or {}).get("queued", 0)) or 0)
                            for r, t in telemetry.items()},
                    })
        span.end = time.time()  # the decision is made; closed pre-hop
        try:
            req = rep.engine.submit(
                list(tokens), max_new_tokens, request_id=rid,
                trace_parent=span.span_id,
                route_record=span.to_record(), **kw)
        except TypeError:
            # Engine fakes without trace plumbing: the route context
            # drops; routing itself is unaffected.
            req = rep.engine.submit(list(tokens), max_new_tokens, **kw)
        return req, decision

    def generate(self, token_rows: Iterable[Sequence[int]],
                 max_new_tokens: int, timeout: Optional[float] = None,
                 **kw) -> list[list[int]]:
        """Blocking convenience: route each row, wait for all."""
        reqs = [self.submit(row, max_new_tokens, **kw)[0]
                for row in token_rows]
        return [r.wait(timeout=timeout) for r in reqs]

    # -------------------------------------------------------- autoscale
    def maybe_scale(self, firing: Iterable[str],
                    now: Optional[float] = None) -> Optional[dict]:
        """One control-loop step: grow on SLO-burn / saturation rule
        state, shrink after a sustained idle hold. Cooldown-gated in
        both directions so rule flap cannot thrash the fleet (the
        ``fleet-scale-flap`` rate rule watches the event counter as a
        second line of defense)."""
        now = self._clock() if now is None else now
        firing = set(firing)
        with self._lock:
            ready = self._in_state("ready")
            warming = self._in_state("warming")
            idle = all(
                (r.telemetry.get("queued", 0)
                 + r.telemetry.get("active", 0)) == 0 for r in ready)
        if idle:
            if self._idle_since is None:
                self._idle_since = now
        else:
            self._idle_since = None
        if now - self._last_scale < self.cooldown:
            return None
        if firing & SCALE_UP_RULES:
            if warming or len(ready) + len(warming) >= self.max_replicas:
                return None
            self._last_scale = now
            return self.scale_up()
        if (not firing and len(ready) > self.min_replicas
                and self._idle_since is not None
                and now - self._idle_since >= self.idle_hold):
            self._last_scale = now
            return self.scale_down()
        return None

    def _record(self, direction: str, outcome: str, replica: str,
                mode: str) -> dict:
        event = {"direction": direction, "outcome": outcome,
                 "replica": replica, "mode": mode}
        self.scale_events.append(event)
        obs_metrics.fleet_scale_events_total(self._obs).inc(
            direction=direction, outcome=outcome)
        return event

    def scale_up(self) -> dict:
        """Add capacity: promote a standby (already warm — O(1) commit)
        or build+warm a fresh replica off-thread, committing to the
        router only once warm. Admission NEVER routes to a replica the
        prewarm discipline hasn't finished with — unless ``prewarm``
        was disabled, which is the cold-scale red-team seam."""
        with self._lock:
            standbys = self._in_state("standby")
            if standbys:
                rep = standbys[0]
                rep.state = "ready"
                self.router.add_replica(rep.id)
                return self._record("up", "ok", rep.id, "promote")
            rep = self._new_replica()  # state: warming

        def build() -> None:
            try:
                self._build(rep, warm=self.prewarm)
            except Exception:
                with self._lock:
                    rep.state = "released"
                self._registry.drop_component(rep.id)
                self._record("up", "failed", rep.id, "build")
                return
            with self._lock:
                rep.state = "ready"
                self.router.add_replica(rep.id)
            self._record("up", "ok", rep.id, "build")

        t = threading.Thread(target=build, daemon=True,
                             name=f"fleet-warm-{rep.id}")
        self._threads.append(t)
        t.start()
        return {"direction": "up", "outcome": "pending",
                "replica": rep.id, "mode": "build"}

    def scale_down(self, timeout: float = 30.0) -> dict:
        """Shed capacity: newest ready replica leaves the router NOW
        (no new routes), then drains in-flight decode off-thread and
        only then stops — release never kills admitted work."""
        with self._lock:
            ready = self._in_state("ready")
            if len(ready) <= self.min_replicas:
                return self._record("down", "refused", "", "drain")
            rep = ready[-1]
            rep.state = "draining"
            self.router.remove_replica(rep.id)

        def drain() -> None:
            deadline = time.monotonic() + timeout
            outcome = "ok"
            while time.monotonic() < deadline:
                try:
                    h = rep.engine.health()
                except Exception:
                    break
                if h.get("queued", 0) + h.get("active", 0) == 0:
                    break
                time.sleep(0.02)
            else:
                outcome = "timeout"  # stop anyway; waiters get unblocked
            try:
                rep.engine.stop()
            except Exception:
                outcome = "failed"
            with self._lock:
                rep.state = "released"
            # A released replica's scoped series leave the registry:
            # a dead component must not pin a gauge rule or weight the
            # federated view (the Gauge.unset discipline, generalized
            # to every instrument the replica touched). The queue-depth
            # series is recorded BY the fleet ABOUT the replica (label,
            # not component), so it needs its own unset or the last
            # polled depth would keep feeding fleet-replica-hot.
            self._registry.drop_component(rep.id)
            obs_metrics.fleet_replica_queue_depth(self._obs).unset(
                replica=rep.id)
            self._record("down", outcome, rep.id, "drain")

        t = threading.Thread(target=drain, daemon=True,
                             name=f"fleet-drain-{rep.id}")
        self._threads.append(t)
        t.start()
        return {"direction": "down", "outcome": "pending",
                "replica": rep.id, "mode": "drain"}

    def wait_settled(self, timeout: float = 60.0) -> bool:
        """Join outstanding warm/drain threads (tests + lane teardown)."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)

    # -------------------------------------------------- request lookup
    def recent_requests(self) -> list[dict]:
        """Fleet-wide request listing (``GET /requests``): every
        replica's timeline ring, newest first, each row stamped with
        the replica that served it. Draining/released replicas keep
        answering while their engine object survives — a request that
        finished on a scale-down victim stays queryable."""
        rows: list[dict] = []
        for rep in sorted(self._replicas.values(), key=lambda r: r.id):
            eng = rep.engine
            if eng is None or not hasattr(eng, "recent_requests"):
                continue
            try:
                for row in eng.recent_requests():
                    rows.append({**row, "replica": rep.id})
            # polycheck: ignore[invariant-swallow] -- lookup fan-out races replica teardown; a dead ring contributes nothing, the listing must still render
            except Exception:  # noqa: BLE001
                continue
        rows.sort(key=lambda r: r.get("start") or 0, reverse=True)
        return rows

    def request_timeline(self, request_id: str) -> Optional[dict]:
        """Search every replica's ring for one trace id (``GET
        /requests/{id}/timeline``). First hit wins: eviction→readmit
        returns to the admitting engine, so a request id lives in
        exactly one ring and fan-out is a lookup, not a merge."""
        for rep in sorted(self._replicas.values(), key=lambda r: r.id):
            eng = rep.engine
            if eng is None or not hasattr(eng, "request_timeline"):
                continue
            try:
                timeline = eng.request_timeline(request_id)
            # polycheck: ignore[invariant-swallow] -- same teardown race as recent_requests; keep searching the other rings
            except Exception:  # noqa: BLE001
                continue
            if timeline:
                return timeline
        return None

    # ------------------------------------------------------------ stats
    def per_replica_telemetry(self) -> dict:
        """Per-component serving breakdown read straight from the
        scoped series: TTFT p50/p99 (ms, merged across classes) and
        preemption totals, keyed by replica id. Components that never
        observed TTFT (infrastructure views like ``fleet``/``router``)
        are excluded."""
        hist = obs_metrics.serving_ttft_hist(self._registry)
        p50 = hist.quantile_by_component(0.5)
        p99 = hist.quantile_by_component(0.99)
        preempt = obs_metrics.serving_preemptions_total(
            self._registry).total_by_component()
        out: dict[str, dict] = {}
        for comp in sorted(set(p50) | set(p99)):
            if not comp:
                continue
            out[comp] = {
                "ttft_p50_ms": (round(p50[comp] * 1e3, 3)
                                if comp in p50 else None),
                "ttft_p99_ms": (round(p99[comp] * 1e3, 3)
                                if comp in p99 else None),
                "preemptions": int(preempt.get(comp, 0.0)),
            }
        return out

    def fleet_snapshot(self) -> dict:
        """``GET /v1/fleet``: aggregate stats, the per-replica scoped
        breakdown, and the cross-replica skew rollup in one payload."""
        components = sorted(
            obs_metrics.serving_ttft_hist(
                self._registry).components() - {""})
        return {
            "stats": self.stats(),
            "per_replica": self.per_replica_telemetry(),
            # The skew ratio is defined only once >= 2 replicas have
            # TTFT samples (the rollup keeps the gauge unset below
            # that; value() reads absent series as 0.0).
            "ttft_skew": (obs_metrics.fleet_ttft_skew(
                self._registry).value() if len(components) >= 2
                else None),
            "components": components,
        }

    def stats(self) -> dict:
        """Fleet-wide aggregate: the acceptance surface. Prefix reuse
        is summed over replicas (hit rate = skipped/total prefill
        tokens fleet-wide) and ``kv_invariant_violations`` is the SUM
        over every replica's live ``check_invariants()``."""
        total = skipped = violations = readmit = 0
        preemptions: dict[str, int] = {}
        per_replica = {}
        for rep in self._replicas.values():
            if rep.engine is None:
                continue
            try:
                s = rep.engine.stats()
            # polycheck: ignore[invariant-swallow] -- a replica racing its own release (engine thread gone mid-stats) contributes nothing to the aggregate; the fleet-wide sums must still report
            except Exception:  # noqa: BLE001
                continue
            per_replica[rep.id] = {"state": rep.state,
                                   "served": s.get("requests_served", 0)}
            total += s.get("prefill_tokens_total", 0) or 0
            skipped += s.get("prefill_tokens_skipped", 0) or 0
            violations += s.get("kv_invariant_violations", 0) or 0
            readmit += s.get("readmit_suffix_tokens", 0) or 0
            for name, n in (s.get("preemptions") or {}).items():
                preemptions[name] = preemptions.get(name, 0) + n
        return {
            "replicas": per_replica,
            "states": {s: len(self._in_state(s)) for s in REPLICA_STATES},
            "prefill_tokens_total": total,
            "prefill_tokens_skipped": skipped,
            "prefix_hit_rate": (round(skipped / total, 4) if total
                                else None),
            "kv_invariant_violations": violations,
            "preemptions": preemptions,
            "readmit_suffix_tokens": readmit,
            "scale_events": list(self.scale_events),
            "router": self.router.stats(),
        }

    def stop(self) -> None:
        """Stop every engine (any state); idempotent."""
        self.wait_settled(timeout=5.0)
        for rep in self._replicas.values():
            if rep.engine is not None and rep.state != "released":
                try:
                    rep.engine.stop()
                # polycheck: ignore[invariant-swallow] -- teardown fan-out: one replica failing to stop must not strand the rest un-stopped; stop() is the last call on the fleet
                except Exception:  # noqa: BLE001
                    pass
                rep.state = "released"
        self.poll()
        # The derived skew gauge dies with the fleet (scoped series
        # survive for post-run oracle judgment, but a rollup over a
        # stopped fleet must not keep a rule evaluable).
        obs_metrics.fleet_ttft_skew(self._registry).unset()
