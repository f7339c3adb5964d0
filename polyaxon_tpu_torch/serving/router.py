"""Fleet front door: prefix-affinity routing over replicated engines
(port of ``polyaxon_tpu/serving/router.py``, the same code under the
port's module names).

The router answers one question per request — *which replica* — using
three signals in strict precedence order:

1. **Radix-prefix affinity.** The radix prefix tree makes prefill cost
   depend on *where* a prompt lands: a replica that already holds the
   prompt's prefix skips those tokens entirely. The router lifts that
   signal fleet-wide as a prefix→replica map (learned from its own
   routing history — the map IS the affinity): a request whose prefix
   was last served on replica 3 goes back to replica 3.
2. **Hotness-cap spill.** Affinity concentrates; one viral prefix must
   not melt a single replica. When the affinity target already owns
   more than ``hot_fraction`` of the recent routing window — or its
   polled pending queue is past ``spill_depth`` — the request spills
   to the prefix's consistent-hash owner instead: a deterministic
   second home, so the spilled prefix still warms ONE other radix
   tree rather than spraying across the fleet.
3. **Consistent hash.** No affinity entry (cold prefix) → the ring
   owner. Replica add/remove moves only ~1/N of the keyspace, so a
   scale event does not invalidate the whole fleet's cache placement.

Replica health gates every step: a replica that is not ready (warming,
draining, released) or reports no KV headroom is skipped, falling to
the least-loaded healthy replica (reason ``spill``).

Everything here is pure Python over ``hashlib`` — deterministic for a
fixed replica set + seed, no jax, testable at unit speed.
"""

from __future__ import annotations

import bisect
import collections
import hashlib
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from polyaxon_tpu_torch.obs import metrics as obs_metrics

# First-K tokens identify a shared prefix. 16 tokens spans the system
# prompt / few-shot preamble at real scale and the whole conversation
# stem at sim scale; radix granularity below that is noise to a router.
PREFIX_WINDOW = 16

ROUTE_REASONS = ("affinity", "hash", "spill")


def prefix_key(tokens: Sequence[int], window: int = PREFIX_WINDOW) -> str:
    """Stable hex digest of the first ``window`` tokens."""
    head = ",".join(str(int(t)) for t in tokens[:window])
    return hashlib.sha1(head.encode()).hexdigest()[:16]


class ConsistentHashRing:
    """Classic vnode consistent-hash ring over replica ids.

    ``vnodes`` virtual points per replica smooth the keyspace split;
    removal of one replica moves only that replica's arcs (~1/N of
    keys) to its ring successors — the property the fleet tests pin.
    Hashing is ``hashlib``-based so placement is stable across
    processes and runs (Python's ``hash()`` is salted per process).
    """

    def __init__(self, nodes: Iterable[str] = (), *, vnodes: int = 64,
                 seed: int = 0):
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        self._points: list[int] = []  # sorted vnode hashes
        self._owners: dict[int, str] = {}  # vnode hash -> replica id
        self._nodes: set[str] = set()
        for node in nodes:
            self.add(node)

    def _hash(self, key: str) -> int:
        digest = hashlib.sha1(f"{self.seed}:{key}".encode()).digest()
        return int.from_bytes(digest[:8], "big")

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            h = self._hash(f"{node}#{i}")
            # Collisions are ~impossible at 64-bit; deterministic
            # tie-break by id keeps add-order irrelevant anyway.
            if h in self._owners and self._owners[h] <= node:
                continue
            if h not in self._owners:
                bisect.insort(self._points, h)
            self._owners[h] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for h, owner in list(self._owners.items()):
            if owner == node:
                del self._owners[h]
                idx = bisect.bisect_left(self._points, h)
                if idx < len(self._points) and self._points[idx] == h:
                    del self._points[idx]

    @property
    def nodes(self) -> frozenset:
        return frozenset(self._nodes)

    def owner(self, key: str) -> Optional[str]:
        """First vnode clockwise of ``hash(key)``, or None when empty."""
        if not self._points:
            return None
        h = self._hash(key)
        idx = bisect.bisect_right(self._points, h)
        if idx == len(self._points):
            idx = 0
        return self._owners[self._points[idx]]


@dataclass
class RouteDecision:
    replica: str
    reason: str  # affinity | hash | spill
    prefix: str


class FleetRouter:
    """Prefix-affinity router with hotness-cap spill and hash fallback.

    ``route(tokens, telemetry=...)`` returns a :class:`RouteDecision`.
    ``telemetry`` maps replica id → its ``health()`` dict (one polled
    surface — queue depth, KV headroom, radix hit rate); replicas
    absent from the map are assumed healthy, replicas whose payload
    says not-ok are skipped. ``blind=True`` is the red-team seam: the
    affinity map AND the hash are ignored and requests round-robin
    across ready replicas — prefix locality collapses, which is
    exactly what the ci.sh ``route-blind`` inject must demonstrate.
    """

    def __init__(self, replicas: Iterable[str] = (), *, vnodes: int = 64,
                 seed: int = 0, prefix_window: int = PREFIX_WINDOW,
                 hot_fraction: float = 0.5, recent: int = 128,
                 hot_min: int = 16, spill_depth: Optional[int] = 8,
                 blind: bool = False, registry=None):
        self.ring = ConsistentHashRing(replicas, vnodes=vnodes, seed=seed)
        self.prefix_window = int(prefix_window)
        self.hot_fraction = float(hot_fraction)
        self.hot_min = int(hot_min)
        self.spill_depth = spill_depth if spill_depth is None \
            else int(spill_depth)
        self.blind = bool(blind)
        self._registry = registry or obs_metrics.REGISTRY
        self._affinity: dict[str, str] = {}  # prefix -> replica id
        self._recent: collections.deque = collections.deque(maxlen=recent)
        self._rr = 0  # round-robin cursor (blind mode)
        self.routed_total: collections.Counter = collections.Counter()

    # ------------------------------------------------------------ fleet
    def add_replica(self, replica: str) -> None:
        self.ring.add(replica)

    def remove_replica(self, replica: str) -> None:
        self.ring.remove(replica)
        # Drop the departed replica's affinity entries so its prefixes
        # re-home via the ring instead of bouncing off the dead id.
        self._affinity = {p: r for p, r in self._affinity.items()
                          if r != replica}

    @property
    def replicas(self) -> frozenset:
        return self.ring.nodes

    # ----------------------------------------------------------- health
    @staticmethod
    def _healthy(replica: str, telemetry: Optional[dict]) -> bool:
        if not telemetry or replica not in telemetry:
            return True
        view = telemetry[replica] or {}
        if view.get("status", "ok") != "ok":
            return False
        headroom = view.get("kv_headroom")
        if headroom is not None and headroom.get("free", 1) <= 0:
            return False
        return True

    def _ready(self, telemetry: Optional[dict]) -> list[str]:
        return sorted(r for r in self.ring.nodes
                      if self._healthy(r, telemetry))

    @staticmethod
    def _least_loaded(candidates: list[str],
                      telemetry: Optional[dict]) -> str:
        def load(r: str) -> tuple:
            view = (telemetry or {}).get(r) or {}
            return (view.get("queued", 0) + view.get("active", 0), r)
        return min(candidates, key=load)

    # ------------------------------------------------------------ route
    def route(self, tokens: Sequence[int], *,
              telemetry: Optional[dict] = None) -> RouteDecision:
        ready = self._ready(telemetry)
        if not ready:
            raise RuntimeError("no healthy replicas to route to")
        key = prefix_key(tokens, self.prefix_window)

        if self.blind:
            # Red-team mode: ignore the prefix signal entirely.
            replica = ready[self._rr % len(ready)]
            self._rr += 1
            return self._commit(replica, "hash", key, learn=False)

        target = self._affinity.get(key)
        if target is not None and target in ready:
            owner = self.ring.owner(key)
            crowded = (self._hot(target)
                       or self._pressured(target, telemetry))
            if not crowded or owner == target:
                # At its hash home the cap is a no-op (there is no
                # deterministic second home to send it to — sustained
                # heat there is the AUTOSCALER's problem, and a
                # scale-up moves ~1/N of ring ownership, which is what
                # un-sticks a viral prefix: see the branch below).
                return self._commit(target, "affinity", key)
            # Hotness cap tripped on a prefix whose affinity drifted
            # off its hash home (typically: ownership moved under it
            # when a replica joined/left): spill it back to the ring
            # owner — the deterministic second home (tests pin this).
            if owner in ready:
                return self._commit(owner, "spill", key, learn=False)
            return self._commit(self._least_loaded(ready, telemetry),
                                "spill", key, learn=False)

        owner = self.ring.owner(key)
        if owner in ready:
            return self._commit(owner, "hash", key)
        # Ring owner unhealthy/draining: deflect to least-loaded.
        return self._commit(self._least_loaded(ready, telemetry),
                            "spill", key)

    def _pressured(self, replica: str,
                   telemetry: Optional[dict]) -> bool:
        """Queue-depth half of the hotness cap: a target whose PREFILL
        backlog is past ``spill_depth`` is deflected exactly like a
        routing-share hog — this is what lets a freshly-committed
        replica actually RELIEVE a spike (ring ownership moved ~1/N of
        prefixes onto it; pressure unsticks their affinity).

        Prefill depth, not total queue depth: a replica
        whose slots are merely decode-busy admits new work next tick —
        spilling away from it would shred affinity for nothing. Falls
        back to `queued` for engines predating the per-lane fields.

        Per-class saturation also counts: a replica whose
        `interactive` pending has reached its class cap sheds the very
        requests the fleet most wants served, even when the aggregate
        prefill_pending looks fine — treat it as pressured so urgent
        traffic deflects before it 503s. This guard is cap-relative,
        so it applies whether or not a global spill_depth is set."""
        view = (telemetry or {}).get(replica) or {}
        pending = view.get("class_pending") or {}
        caps = view.get("class_caps") or {}
        cap = caps.get("interactive")
        if cap is not None and pending.get("interactive", 0) >= cap:
            return True
        if self.spill_depth is None:
            return False
        depth = view.get("prefill_pending")
        if depth is None:
            depth = view.get("queued", 0)
        return depth > self.spill_depth

    def _hot(self, replica: str) -> bool:
        # The cap needs a populated window to mean anything: the first
        # few routes of a quiet fleet trivially give one replica 100%
        # share, and spilling THOSE would defeat affinity entirely.
        if len(self._recent) < self.hot_min:
            return False
        share = sum(1 for r in self._recent if r == replica)
        return share / len(self._recent) > self.hot_fraction

    def _commit(self, replica: str, reason: str, key: str,
                learn: bool = True) -> RouteDecision:
        if learn:
            self._affinity[key] = replica
        self._recent.append(replica)
        self.routed_total[reason] += 1
        obs_metrics.fleet_routed_total(self._registry).inc(reason=reason)
        return RouteDecision(replica=replica, reason=reason, prefix=key)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "replicas": sorted(self.ring.nodes),
            "affinity_entries": len(self._affinity),
            "routed": dict(self.routed_total),
            "blind": self.blind,
        }
