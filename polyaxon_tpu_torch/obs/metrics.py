"""Unified metrics registry with Prometheus text exposition (ISSUE 5).

One process-global :data:`REGISTRY` replaces the hand-rolled gauge
strings that used to live in ``api/server.py``: every layer registers
typed instruments (counters, gauges, histograms) by name and the
``/metrics`` routes (control-plane API server AND the serving server)
render the whole registry in the Prometheus text format
(``text/plain; version=0.0.4``). Instruments are get-or-create — the
first caller wins the type/labels/buckets, a conflicting re-register
raises — so instrumentation sites stay one-liners:

    from polyaxon_tpu_torch.obs import metrics
    metrics.scheduler_tick_hist().observe(dt)
    metrics.admission_outcomes().inc(outcome="admitted")

Everything is stdlib + thread-safe (the API handler threads scrape
while the agent/runtime threads record). The metric CATALOG — the
accessor functions at the bottom — is the single source of truth for
names, label sets, and bucket layouts (docs/observability.md mirrors
it), and :func:`ensure_core_metrics` pre-registers the families so a
fresh scrape exposes a stable schema before any sample lands.

Fleet scoping (ISSUE 20): :meth:`MetricsRegistry.scoped` returns a
view that stamps a ``component`` identity (a replica id, "router",
"fleet", a sim agent) on every series recorded through it — the same
instrument, an extra hidden dimension, so the alert engine and the
oracle keep judging ONE family while ``federate()`` / the component
helpers give the per-replica breakdown. Unscoped recording is
byte-identical to before: the component dimension only appears on a
family once something scoped lands in it.

Port of ``polyaxon_tpu/obs/metrics.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Any, Iterable, Optional

# Latency buckets in seconds: sub-ms store hits through minute-scale
# compiles. The +Inf bucket is implicit.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _fmt_value(value: float) -> str:
    """Prometheus sample rendering: integral values print as integers
    (scrape consumers — and this repo's own tests — parse counts with
    int())."""
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, bool):
        return str(int(value))
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _escape_label(value: Any) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labelnames: tuple[str, ...], labelvalues: tuple[str, ...],
               extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"'
             for k, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


# Per-instrument cap on distinct label sets: a request-path label
# (user-supplied queue names, artifact paths...) must not grow the
# registry without bound. Series past the cap fold into one `other`
# row and count into polyaxon_metrics_dropped_labels_total.
DEFAULT_MAX_SERIES = 64
OVERFLOW_LABEL = "other"
DROPPED_LABELS_METRIC = "polyaxon_metrics_dropped_labels_total"


class _Metric:
    """Base: one named family with a fixed label set."""

    type = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 max_series: int = DEFAULT_MAX_SERIES):
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.max_series = max_series
        # Set by the owning registry: called (outside the series lock)
        # once per observation folded into the overflow row.
        self._on_drop = None
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], Any] = {}
        if not labelnames:
            # Label-less instruments expose their single series from
            # birth: a scrape sees the family with a zero sample, not a
            # bare HELP/TYPE header.
            self._series[()] = self._zero()

    def _zero(self):
        return 0.0

    def _key(self, labels: dict[str, Any],
             component: str = "") -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} takes labels {self.labelnames}, "
                f"got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.labelnames)
        # The component identity rides as a hidden trailing element so
        # unscoped series keep their historical keys untouched.
        return key + (str(component),) if component else key

    def _split_key(self, key: tuple[str, ...]
                   ) -> tuple[tuple[str, ...], str]:
        """(base label values, component) — component is "" for a
        series recorded outside any scoped view."""
        n = len(self.labelnames)
        return (key[:n], key[n]) if len(key) > n else (key, "")

    def _admit(self, key: tuple[str, ...]) -> tuple[tuple[str, ...], bool]:
        """Cardinality cap, checked under ``self._lock``: an existing
        series always passes; a NEW series past ``max_series`` folds
        into the ``other`` row (created on first overflow — it does not
        count against the cap, so the fold always lands). The fold
        keeps the component suffix, so per-replica accounting survives
        an overflowing base label."""
        if key in self._series or len(self._series) < self.max_series:
            return key, False
        base = (OVERFLOW_LABEL,) * len(self.labelnames)
        return base + key[len(self.labelnames):], True

    def _dropped(self) -> None:
        if self._on_drop is not None:
            try:
                self._on_drop(self.name)
            except Exception as exc:  # accounting stays passive
                logging.getLogger(__name__).debug(
                    "on_drop hook failed for %s: %s", self.name, exc)

    def clear(self) -> None:
        """Drop all label series (scrape-time gauges rebuilt from store
        state call this so deleted queues/projects don't linger)."""
        with self._lock:
            self._series.clear()
            if not self.labelnames:
                self._series[()] = self._zero()

    def remove(self, **labels: Any) -> None:
        """Drop one series so readers see *no value* rather than a
        stale one (:meth:`Gauge.unset` generalized to every type, ISSUE
        20): a released replica's counters and histograms must vanish
        with it, or a dead component's last totals pin rules and skew
        rollups forever."""
        self._remove(labels, "")

    def _remove(self, labels: dict[str, Any], component: str) -> None:
        with self._lock:
            self._series.pop(self._key(labels, component), None)

    def components(self) -> set[str]:
        """Every component identity with at least one live series (""
        = unscoped). The federated-view gate and the skew rollup read
        this."""
        with self._lock:
            return {self._split_key(k)[1] for k in self._series}

    def _drop_component(self, component: str) -> int:
        if not component:
            return 0
        with self._lock:
            doomed = [k for k in self._series
                      if self._split_key(k)[1] == component]
            for k in doomed:
                del self._series[k]
        return len(doomed)

    # -- exposition --------------------------------------------------------
    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type}"]
        with self._lock:
            for values, sample in sorted(self._series.items()):
                lines.extend(self._render_series(values, sample))
        return lines

    def _component_extra(self, component: str) -> str:
        return (f'component="{_escape_label(component)}"'
                if component else "")

    def _render_series(self, values, sample) -> list[str]:
        base, comp = self._split_key(values)
        return [f"{self.name}"
                f"{_label_str(self.labelnames, base, extra=self._component_extra(comp))}"
                f" {_fmt_value(sample)}"]

    def snapshot(self) -> dict:
        with self._lock:
            # The component dimension appears in the declared label
            # list only once a scoped series exists — an all-unscoped
            # family snapshots exactly as it always has (keys
            # included), so nothing downstream moves until a fleet
            # actually records.
            scoped = any(len(k) > len(self.labelnames)
                         for k in self._series)
            labels = list(self.labelnames) + (
                ["component"] if scoped else [])
            return {
                "type": self.type,
                "labels": labels,
                "series": {",".join(k) if k else "": self._snap_sample(v)
                           for k, v in self._series.items()},
            }

    def _snap_sample(self, sample):
        return sample


class Counter(_Metric):
    type = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._inc(amount, labels, "")

    def _inc(self, amount: float, labels: dict[str, Any],
             component: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels, component)
        with self._lock:
            key, dropped = self._admit(key)
            self._series[key] = self._series.get(key, 0.0) + amount
        if dropped:
            self._dropped()

    def value(self, **labels: Any) -> float:
        return self._value(labels, "")

    def _value(self, labels: dict[str, Any], component: str) -> float:
        with self._lock:
            return float(
                self._series.get(self._key(labels, component), 0.0))

    def total_by_component(self) -> dict[str, float]:
        """Sum across base label sets per component — the per-replica
        breakdown read (bench --fleet, /v1/fleet)."""
        totals: dict[str, float] = {}
        with self._lock:
            for key, v in self._series.items():
                comp = self._split_key(key)[1]
                totals[comp] = totals.get(comp, 0.0) + float(v)
        return totals


class Gauge(_Metric):
    type = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._set(value, labels, "")

    def _set(self, value: float, labels: dict[str, Any],
             component: str) -> None:
        key = self._key(labels, component)
        with self._lock:
            key, dropped = self._admit(key)
            self._series[key] = float(value)
        if dropped:
            self._dropped()

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._inc(amount, labels, "")

    def _inc(self, amount: float, labels: dict[str, Any],
             component: str) -> None:
        key = self._key(labels, component)
        with self._lock:
            key, dropped = self._admit(key)
            self._series[key] = self._series.get(key, 0.0) + amount
        if dropped:
            self._dropped()

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def unset(self, **labels: Any) -> None:
        """Drop the series so readers see *no value* rather than a
        stale one — for gauges whose meaning is scoped to a live
        process (a stopped engine's rolling window describes nothing;
        alert rules treat a missing series as not-breaching, which a
        parked last value would not be)."""
        self._remove(labels, "")

    def value(self, **labels: Any) -> float:
        return self._value(labels, "")

    def _value(self, labels: dict[str, Any], component: str) -> float:
        with self._lock:
            return float(
                self._series.get(self._key(labels, component), 0.0))


class _HistSample:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    type = "histogram"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...],
                 buckets: Iterable[float] = LATENCY_BUCKETS,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        super().__init__(name, help, labelnames, max_series=max_series)

    def _zero(self):
        return _HistSample(len(self.buckets) + 1)  # + the +Inf bucket

    def observe(self, value: float, **labels: Any) -> None:
        self._observe(value, labels, "")

    def _observe(self, value: float, labels: dict[str, Any],
                 component: str) -> None:
        key = self._key(labels, component)
        value = float(value)
        with self._lock:
            key, dropped = self._admit(key)
            sample = self._series.get(key)
            if sample is None:
                sample = self._series[key] = self._zero()
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    idx = i
                    break
            sample.counts[idx] += 1
            sample.sum += value
            sample.count += 1
        if dropped:
            self._dropped()

    def quantile(self, q: float, **labels: Any) -> Optional[float]:
        """Prometheus-style ``histogram_quantile(q)`` over the le-bucket
        counts: rank ``q*count`` lands in a bucket, the estimate is a
        linear interpolation within it (the lowest bucket interpolates
        from 0). A rank landing in the +Inf bucket clamps to the
        largest finite bound — the data says "beyond the layout", and a
        finite, monotone answer beats a fabricated one. ``None`` when
        the series has no observations (or does not exist). Shared by
        the alert-rule engine (obs.rules), the trace analyzer
        (obs.analyze), and bench reporting."""
        return self._quantile(q, labels, "")

    def _quantile(self, q: float, labels: dict[str, Any],
                  component: str) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        key = self._key(labels, component)
        with self._lock:
            sample = self._series.get(key)
            if sample is None or sample.count == 0:
                return None
            counts = list(sample.counts)
            total = sample.count
        return self._quantile_from(counts, total, q)

    def _quantile_from(self, counts: list, total: int,
                       q: float) -> float:
        rank = q * total
        cumulative = 0
        for i, n in enumerate(counts):
            prev = cumulative
            cumulative += n
            if n and cumulative >= rank:
                if i == len(self.buckets):
                    return self.buckets[-1]  # +Inf clamps to last bound
                hi = self.buckets[i]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                return lo + (hi - lo) * max(rank - prev, 0.0) / n
        return self.buckets[-1]  # unreachable with count > 0

    def quantile_max(self, q: float) -> Optional[float]:
        """Worst-series quantile: max of :meth:`quantile` across every
        series — base label sets AND components (the rules engine's
        view of a labeled histogram when a rule names no labels).
        ``None`` when nothing has samples."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            data = [(list(s.counts), s.count)
                    for s in self._series.values() if s.count]
        values = [self._quantile_from(c, t, q) for c, t in data]
        return max(values) if values else None

    def quantile_merged(self, q: float, **labels: Any) -> Optional[float]:
        """Quantile over the union of every component's series for one
        base label set (labels optional: empty = the whole family) —
        the FEDERATED read: one fleet-wide distribution out of
        per-replica series."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if labels:
            base = self._key(labels)
        counts = [0] * (len(self.buckets) + 1)
        total = 0
        with self._lock:
            for key, sample in self._series.items():
                if labels and self._split_key(key)[0] != base:
                    continue
                for i, n in enumerate(sample.counts):
                    counts[i] += n
                total += sample.count
        if total == 0:
            return None
        return self._quantile_from(counts, total, q)

    def quantile_by_component(self, q: float) -> dict[str, float]:
        """{component: quantile} with each component's series merged
        across base label sets — the per-replica skew/breakdown read.
        Components with no observations are omitted."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        merged: dict[str, tuple[list, int]] = {}
        with self._lock:
            for key, sample in self._series.items():
                if sample.count == 0:
                    continue
                comp = self._split_key(key)[1]
                counts, total = merged.get(
                    comp, ([0] * (len(self.buckets) + 1), 0))
                for i, n in enumerate(sample.counts):
                    counts[i] += n
                merged[comp] = (counts, total + sample.count)
        return {comp: self._quantile_from(c, t, q)
                for comp, (c, t) in merged.items()}

    def _render_series(self, values, sample: _HistSample) -> list[str]:
        lines = []
        cumulative = 0
        base_values, comp = self._split_key(values)
        comp_extra = self._component_extra(comp)
        bounds = [*(_fmt_value(b) for b in self.buckets), "+Inf"]
        for bound, n in zip(bounds, sample.counts):
            cumulative += n
            extra = f'le="{bound}"'
            if comp_extra:
                extra = f"{comp_extra},{extra}"
            labels = _label_str(self.labelnames, base_values, extra=extra)
            lines.append(f"{self.name}_bucket{labels} {cumulative}")
        base = _label_str(self.labelnames, base_values, extra=comp_extra)
        lines.append(f"{self.name}_sum{base} {_fmt_value(sample.sum)}")
        lines.append(f"{self.name}_count{base} {sample.count}")
        return lines

    def _snap_sample(self, sample: _HistSample) -> dict:
        return {"count": sample.count, "sum": round(sample.sum, 6),
                "buckets": dict(zip(
                    [*(_fmt_value(b) for b in self.buckets), "+Inf"],
                    sample.counts))}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: tuple[str, ...], **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or (
                        existing.labelnames != labelnames):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.type}{existing.labelnames}")
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            if name != DROPPED_LABELS_METRIC:
                metric._on_drop = self._count_dropped
            self._metrics[name] = metric
            return metric

    def _count_dropped(self, name: str) -> None:
        """One folded observation on ``name`` — its own cardinality is
        bounded by the instrument count, so the accounting counter gets
        a cap far above any real registry and no drop hook (the fold of
        folds would recurse)."""
        self.counter(
            DROPPED_LABELS_METRIC,
            "Observations folded into the `other` series by the "
            "per-instrument label-cardinality cap",
            ("metric",), max_series=4096).inc(metric=name)

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = (),
                max_series: int = DEFAULT_MAX_SERIES) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(labelnames),
                                   max_series=max_series)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = (),
              max_series: int = DEFAULT_MAX_SERIES) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(labelnames),
                                   max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: Iterable[float] = LATENCY_BUCKETS,
                  max_series: int = DEFAULT_MAX_SERIES) -> Histogram:
        return self._get_or_create(Histogram, name, help, tuple(labelnames),
                                   buckets=buckets, max_series=max_series)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def scoped(self, component: str) -> "ScopedRegistry":
        """A view of THIS registry that stamps ``component`` on every
        series recorded through it — same instruments, one extra
        hidden dimension. The view is stateless (accessors re-resolve
        the base instrument per call), so it survives a
        :meth:`reset`."""
        return ScopedRegistry(self, component)

    def drop_component(self, component: str) -> int:
        """Drop every series ``component`` ever recorded, across all
        instruments — Replica release calls this so a dead replica's
        series cannot pin a rule or skew a federated read. Returns the
        number of series dropped."""
        if not component:
            return 0
        with self._lock:
            metrics = list(self._metrics.values())
        return sum(m._drop_component(str(component)) for m in metrics)

    def federate(self) -> dict:
        """Snapshot-shaped fleet aggregation: the component dimension
        collapsed per family — counters and histogram buckets summed,
        gauges merged as max (the alert engine's worst-series view).
        Each family also reports the ``components`` that contributed,
        which is what the mute-replica red-team gate checks."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: dict[str, Any] = {}
        for m in metrics:
            snap = m.snapshot()
            merged: dict[str, Any] = {}
            comps: set[str] = set()
            n = len(m.labelnames)
            for key, sample in snap["series"].items():
                parts = key.split(",") if key else []
                base, comp = parts[:n], (parts[n] if len(parts) > n
                                         else "")
                comps.add(comp)
                skey = ",".join(base)
                merged[skey] = merge_snap_samples(
                    m.type, [merged[skey], sample]
                ) if skey in merged else sample
            out[m.name] = {"type": m.type,
                           "labels": list(m.labelnames),
                           "components": sorted(comps),
                           "series": merged}
        return out

    def reset(self) -> None:
        """Drop every instrument AND its samples (test-visible): the
        process-global REGISTRY otherwise leaks series across tests —
        get-or-create re-creates families fresh on next touch, so a
        reset between tests is safe for every accessor-style caller.
        The default metrics-history ring is derived state over this
        registry, so resetting the global REGISTRY drops it too."""
        with self._lock:
            self._metrics.clear()
        if self is REGISTRY:
            from polyaxon_tpu_torch.obs import history as obs_history

            obs_history.reset_default()

    def render(self) -> str:
        """The whole registry in Prometheus text-format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump for perf sweeps / bench records."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {m.name: m.snapshot() for m in metrics}

    def snapshot_delta(self, baseline: Optional[dict]) -> dict:
        """Registry movement since ``baseline`` (a prior
        :meth:`snapshot`): see :func:`snapshot_delta` for the shape.
        The flight recorder's per-run metric deltas and the telemetry
        oracle's delta-mode invariants both read this."""
        return snapshot_delta(self.snapshot(), baseline)


def series_delta(now: Any, then: Any):
    """Movement of one snapshot series sample: counters/gauges as value
    deltas, histogram samples as count/sum deltas. ``None`` when the
    series did not move (so callers can report changed series only)."""
    if isinstance(now, dict):  # histogram series
        base = then if isinstance(then, dict) else {"count": 0, "sum": 0.0}
        d_count = now["count"] - base.get("count", 0)
        if d_count <= 0:
            return None
        return {"count": d_count,
                "sum": round(now["sum"] - base.get("sum", 0.0), 6)}
    delta = float(now) - float(then or 0.0)
    return delta if delta != 0.0 else None


def snapshot_delta(snapshot: dict, baseline: Optional[dict]) -> dict:
    """Pure delta between two registry snapshots: changed series only.
    Without a baseline the snapshot is returned whole, flagged as
    absolute — consumers (postmortems, oracle evidence) can always tell
    which semantics they are reading."""
    if baseline is None:
        return {"absolute": True, "snapshot": snapshot}
    deltas: dict[str, Any] = {}
    for name, family in snapshot.items():
        base_series = (baseline.get(name) or {}).get("series") or {}
        changed = {}
        for key, sample in family["series"].items():
            delta = series_delta(sample, base_series.get(key))
            if delta is not None:
                changed[key] = delta
        if changed:
            deltas[name] = {"type": family["type"],
                            "labels": family.get("labels") or [],
                            "series": changed}
    return {"absolute": False, "deltas": deltas}


def merge_snap_samples(metric_type: str, samples: list) -> Any:
    """Merge snapshot-shaped series samples of one family: counters
    sum, gauges take max (matching the alert engine's across-series
    read), histograms merge bucket counts / sum / count. The oracle's
    subset-label selection and :meth:`MetricsRegistry.federate` share
    this so a federated judgment and a federated export can never
    disagree."""
    if not samples:
        return None
    if isinstance(samples[0], dict):  # histogram snap samples
        buckets: dict[str, float] = {}
        count = 0
        total = 0.0
        for s in samples:
            count += s.get("count", 0)
            total += s.get("sum", 0.0)
            for b, n in (s.get("buckets") or {}).items():
                buckets[b] = buckets.get(b, 0) + n
        return {"count": count, "sum": round(total, 6),
                "buckets": buckets}
    values = [float(s or 0.0) for s in samples]
    if metric_type == "gauge":
        return max(values)
    return sum(values)


def series_key_labels(labelnames: Iterable[str], key: str) -> dict:
    """Parse a snapshot series key back into {label: value} plus the
    hidden ``component`` (always "" when the series was recorded
    unscoped). ``labelnames`` is the family's declared label list —
    with or without the trailing "component" entry, and regardless of
    whether the key itself carries a component part."""
    names = [n for n in labelnames if n != "component"]
    parts = key.split(",") if key else []
    out = {name: (parts[i] if i < len(parts) else "")
           for i, name in enumerate(names)}
    out["component"] = parts[len(names)] if len(parts) > len(names) else ""
    return out


def match_series(labelnames: Iterable[str], key: str,
                 selector: Optional[dict]) -> bool:
    """Subset label match: every selector entry must equal the series'
    value for that dimension; dimensions the selector does not name —
    the component dimension above all — are wildcards. This is how a
    ``{class: interactive}`` rule or invariant keeps selecting every
    replica's series once the fleet records scoped."""
    if not selector:
        return True
    got = series_key_labels(labelnames, key)
    return all(str(got.get(k, "")) == str(v) for k, v in selector.items())


class ScopedCounter:
    """Component-stamping proxy over a :class:`Counter`."""

    def __init__(self, base: Counter, component: str):
        self._base = base
        self.component = component

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._base._inc(amount, labels, self.component)

    def value(self, **labels: Any) -> float:
        return self._base._value(labels, self.component)

    def remove(self, **labels: Any) -> None:
        self._base._remove(labels, self.component)


class ScopedGauge:
    """Component-stamping proxy over a :class:`Gauge`."""

    def __init__(self, base: Gauge, component: str):
        self._base = base
        self.component = component

    def set(self, value: float, **labels: Any) -> None:
        self._base._set(value, labels, self.component)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._base._inc(amount, labels, self.component)

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self._base._inc(-amount, labels, self.component)

    def unset(self, **labels: Any) -> None:
        self._base._remove(labels, self.component)

    def remove(self, **labels: Any) -> None:
        self._base._remove(labels, self.component)

    def value(self, **labels: Any) -> float:
        return self._base._value(labels, self.component)


class ScopedHistogram:
    """Component-stamping proxy over a :class:`Histogram`."""

    def __init__(self, base: Histogram, component: str):
        self._base = base
        self.component = component

    @property
    def buckets(self):
        return self._base.buckets

    def observe(self, value: float, **labels: Any) -> None:
        self._base._observe(value, labels, self.component)

    def quantile(self, q: float, **labels: Any) -> Optional[float]:
        return self._base._quantile(q, labels, self.component)

    def remove(self, **labels: Any) -> None:
        self._base._remove(labels, self.component)


class ScopedRegistry:
    """A component-identity view over a parent registry (ISSUE 20):
    ``REGISTRY.scoped(component="r3")`` hands a replica an object that
    quacks like the registry for the catalog accessors, while every
    counter/gauge/histogram it vends stamps the component on the
    series it records. The view holds NO series of its own — the base
    instrument is resolved in the parent per call, so views stay valid
    across a parent :meth:`MetricsRegistry.reset`."""

    def __init__(self, parent: MetricsRegistry, component: str):
        if not str(component):
            raise ValueError("scoped registry needs a component name")
        self.parent = parent
        self.component = str(component)

    def scoped(self, component: str) -> "ScopedRegistry":
        return ScopedRegistry(self.parent, component)

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = (),
                max_series: int = DEFAULT_MAX_SERIES) -> ScopedCounter:
        return ScopedCounter(
            self.parent.counter(name, help, labelnames,
                                max_series=max_series), self.component)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = (),
              max_series: int = DEFAULT_MAX_SERIES) -> ScopedGauge:
        return ScopedGauge(
            self.parent.gauge(name, help, labelnames,
                              max_series=max_series), self.component)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: Iterable[float] = LATENCY_BUCKETS,
                  max_series: int = DEFAULT_MAX_SERIES) -> ScopedHistogram:
        return ScopedHistogram(
            self.parent.histogram(name, help, labelnames, buckets=buckets,
                                  max_series=max_series), self.component)

    def get(self, name: str) -> Optional[_Metric]:
        return self.parent.get(name)


def base_registry(registry: Any) -> MetricsRegistry:
    """The concrete :class:`MetricsRegistry` behind ``registry``,
    unwrapping a scoped view — for fleet-level reads (rollups,
    federation) that must see every component."""
    return getattr(registry, "parent", registry)


# The process-global default registry every subsystem records into.
REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------- catalog
# Accessor per family: ONE place owns each name/labels/buckets tuple, so
# the instrumentation site and the scrape route can never disagree.

def scheduler_tick_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_scheduler_tick_seconds",
        "Control-plane scheduler tick duration")


def admission_outcomes(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_admission_outcomes_total",
        "Admission-pass verdicts per run "
        "(admitted/QueueSaturated/QuotaExceeded/ChaosStarved/victim)",
        ("outcome",))


def requeues_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_requeues_total",
        "Backoff-gated requeues by reason (restart policy, preemption)",
        ("reason",))


def retry_attempts(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_retry_attempts_total",
        "Transient-failure retries through utils.retries.with_retries")


def store_op_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_store_op_seconds",
        "Artifact-store operation latency",
        ("op", "scheme"))


# sqlite statements live in the µs–ms range; the default latency layout
# would collapse the whole control-plane story into its first bucket.
_RUNSTORE_BUCKETS = (0.00001, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                     0.0025, 0.005, 0.01, 0.025, 0.1, 0.5, 2.5)


def runstore_op_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_runstore_op_seconds",
        "Control-plane run-store (sqlite) statement latency by SQL verb",
        ("op",), buckets=_RUNSTORE_BUCKETS)


def admission_pass_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_admission_pass_seconds",
        "Admission controller plan() pass duration")


def admission_divergence(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_admission_live_divergence_total",
        "Incremental admission live-view entries that disagreed with a "
        "periodic full rebuild (anything nonzero is a delta-feed bug)")


def training_step_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_training_step_seconds",
        "Mean device step time per metrics-emission window")


def serving_queue_depth(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_queue_depth",
        "Continuous-batching pending-request queue depth")


def serving_request_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_serving_request_seconds",
        "Serving request latency, submit to retire")


# Per-token/engine-tick latencies sit an order of magnitude under the
# request-level layout: sub-ms decode steps through second-scale stalls.
_SERVING_TOKEN_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                          0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def serving_ttft_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    """Time-to-first-token (submit → first emitted token), the
    interactive-SLO number, labeled by request class (`batch` until
    ROADMAP item 1 lands the per-class policy). The 0.5 bound anchors
    the serving-ttft-slo-burn rule's `le`."""
    return registry.histogram(
        "polyaxon_serving_ttft_seconds",
        "Time to first token (submit to first emitted token) by "
        "request class",
        ("class",))


def serving_tpot_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_serving_tpot_seconds",
        "Time per output token after the first (decode cadence) by "
        "request class",
        ("class",), buckets=_SERVING_TOKEN_BUCKETS)


def serving_queue_wait_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_serving_queue_wait_seconds",
        "Pending-queue wait (submit to admission dequeue) by request "
        "class",
        ("class",))


def serving_rejected_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_rejected_total",
        "Requests shed before admission (queue_full = 503 + "
        "Retry-After, shutdown = submit after stop)",
        ("reason",))


def serving_admissions_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_admissions_total",
        "Slot-admission outcomes (admitted / deferred = paged "
        "backpressure requeue / failed = admission prefill error)",
        ("outcome",))


def serving_evictions_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_evictions_total",
        "Live rows evicted mid-generation (pool_exhausted = paged KV "
        "pool ran dry)",
        ("reason",))


def serving_class_pending(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_class_pending",
        "Pending (queued, not yet admitted) requests per request class "
        "— the per-class admission backlog the router's pressure guard "
        "reads against the class cap",
        ("class",))


def serving_preemptions_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_preemptions_total",
        "Preemptive slot/KV evictions by victim class and the blocked "
        "resource that triggered them (slots = no free decode slot, "
        "kv_pages = pool could not admit the urgent prefill)",
        ("class", "reason"))


def serving_readmit_suffix_tokens_total(
        registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_readmit_suffix_tokens_total",
        "Novel prompt tokens prefilled when a preempted request "
        "re-admits — the committed radix prefix serves the rest, so "
        "this counter is the real recompute cost of eviction")


def serving_tick_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_serving_engine_tick_seconds",
        "Continuous-batching engine loop iteration duration (admission "
        "+ prefill chunk + decode step)",
        buckets=_SERVING_TOKEN_BUCKETS)


def serving_batch_slots(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_batch_slots",
        "Engine batch composition per tick (decode = live rows, "
        "prefill = chunked-prefill reservations, free)",
        ("state",))


def serving_kv_pages(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_kv_pages",
        "Paged-KV pool pages by state (used / free; free includes "
        "retired-but-resident prefix pages)",
        ("state",))


def serving_prefix_hits_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_prefix_hits_total",
        "Radix prefix-cache admission outcomes (full = whole prefill "
        "served from cache / partial = some pages matched, incl. "
        "copy-on-write forks / miss = no shareable prefix matched)",
        ("outcome",))


def serving_prefix_cached_tokens(
        registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_prefix_cached_tokens",
        "Prefill tokens served from the radix prefix cache instead of "
        "recomputed (the cross-request KV-reuse dividend)")


def serving_prefix_hit_rate(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_prefix_hit_rate",
        "Rolling fraction of prefill tokens served from the radix "
        "prefix cache (last 64 prefill admissions; unset until the "
        "window has enough samples, so cold starts cannot page)")


def serving_radix_nodes(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_radix_nodes",
        "Radix prefix-tree node count (one node per shared page run)")


def serving_radix_pages(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_radix_pages",
        "Radix-tree-owned KV pages by state (referenced = also held by "
        "a live slot, resident = retired but shareable until LRU "
        "eviction reclaims them)",
        ("state",))


def serving_lane_ticks_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_lane_ticks_total",
        "Engine ticks in which each scheduling lane ran a device "
        "program (prefill = staged suffix-chunk programs within the "
        "lane budget, decode = a decode step or speculative round) — "
        "the disaggregated scheduler's share-of-tick observable",
        ("lane",))


def serving_handoff_pages_total(
        registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_handoff_pages_total",
        "KV pages transferred prefill lane → decode slot at handoff "
        "(a block-table row move arbitrated by the radix tree: "
        "refcount/ownership transfer plus at most the admission-time "
        "CoW fork, never a recompute)")


def serving_spec_draft_len(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_serving_spec_draft_len",
        "Draft length k the speculation policy chose for the current "
        "decode-lane tick (k_max = idle headroom, shrinking under "
        "prefill backlog, 0 = disabled while the TTFT budget burns)")


def serving_decode_tpot_hist(
        registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_serving_decode_tpot_seconds",
        "Decode-lane inter-step gap (wall time between consecutive "
        "decode-lane steps, idle periods excluded): the per-token "
        "cadence a live request feels, inflated exactly when prefill "
        "work occupies ticks the decode batch needed — judged by the "
        "decode-tpot-interference rule and the storm-window oracle "
        "invariant",
        buckets=_SERVING_TOKEN_BUCKETS)


def perf_overlap_ratio(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_perf_overlap_ratio",
        "Collective-overlap ratio per audited schedule (hidden fraction "
        "of total estimated collective time in the compiled step; from "
        "the AOT TPU overlap audit, `perf --audit`)",
        ("schedule",))


def perf_async_collectives_total(
        registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_perf_async_collectives_total",
        "Async-scheduled collective transfers censused in the compiled "
        "step per audited schedule, by collective kind",
        ("schedule", "kind"))


def ensure_perf_metrics(registry: MetricsRegistry = REGISTRY) -> None:
    """Pre-register the perf-audit families (idempotent) — populated by
    ``python -m polyaxon_tpu_torch.perf --audit`` after an AOT overlap
    measurement, and budgeted by the ``overlap-regression`` rule."""
    perf_overlap_ratio(registry)
    perf_async_collectives_total(registry)


def ensure_serving_metrics(registry: MetricsRegistry = REGISTRY) -> None:
    """Pre-register the serving families (idempotent) so a serving
    /metrics scrape exposes the full SLO schema before traffic lands —
    and so :func:`catalog_metric_names` sees one source of truth."""
    serving_queue_depth(registry)
    serving_request_hist(registry)
    serving_ttft_hist(registry)
    serving_tpot_hist(registry)
    serving_queue_wait_hist(registry)
    serving_rejected_total(registry)
    serving_admissions_total(registry)
    serving_evictions_total(registry)
    serving_class_pending(registry)
    serving_preemptions_total(registry)
    serving_readmit_suffix_tokens_total(registry)
    serving_tick_hist(registry)
    serving_batch_slots(registry)
    serving_kv_pages(registry)
    serving_prefix_hits_total(registry)
    serving_prefix_cached_tokens(registry)
    serving_prefix_hit_rate(registry)
    serving_radix_nodes(registry)
    serving_radix_pages(registry)
    serving_trace_dumps_total(registry)
    serving_lane_ticks_total(registry)
    serving_handoff_pages_total(registry)
    serving_spec_draft_len(registry)
    serving_decode_tpot_hist(registry)


def alert_history_evictions(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_alert_history_evictions_total",
        "Fired/resolved alert transitions evicted from the bounded "
        "alert-engine history ring (oldest-out past the cap) — nonzero "
        "means `plx ops alerts` history is no longer the full episode "
        "record")


def oracle_verdicts_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_oracle_verdicts_total",
        "Telemetry-oracle invariant verdicts by outcome "
        "(pass / fail / skip) across every evaluation surface "
        "(plx ops verify, GET .../verify, the sim gauntlet)",
        ("verdict",))


def elastic_resizes_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_elastic_resizes_total",
        "Elastic gang resize attempts by direction (shrink / grow) and "
        "outcome (ok / failed) — runtime.elastic",
        ("direction", "outcome"))


def elastic_resize_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_elastic_resize_seconds",
        "Wall seconds per elastic resize attempt (prewarm + commit)")


def checkpoint_restore_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_checkpoint_restore_seconds",
        "Wall seconds per checkpoint restore by winning tier (0 = "
        "in-memory replica, 1 = local-disk spill, 2 = fsspec store) — "
        "budgeted by the checkpoint-restore-slow rule and the "
        "restore-budget-during-storm oracle invariant",
        ("tier",))


def checkpoint_save_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_checkpoint_save_seconds",
        "Wall seconds per checkpoint save by tier (0 / 1 / 2) and mode "
        "(sync = on the step loop, async = publisher thread off it)",
        ("tier", "mode"))


def serving_trace_dumps_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_serving_trace_dumps_total",
        "Request-timeline ring dumps written at engine shutdown "
        "(ok / failed) — the serving counterpart of postmortem.json",
        ("outcome",))


def fleet_replicas(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_fleet_replicas",
        "Serving-fleet replicas by lifecycle state (warming / standby / "
        "ready / draining / released) — serving.fleet.ServingFleet",
        ("state",))


def fleet_routed_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_fleet_routed_total",
        "Fleet router decisions by reason (affinity = prefix→replica "
        "map hit, hash = consistent-hash placement, spill = hotness-cap "
        "or unhealthy-owner deflection) — serving.router.FleetRouter",
        ("reason",))


def fleet_scale_events_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_fleet_scale_events_total",
        "Autoscaler scale events by direction (up / down) and outcome "
        "(ok / failed / refused / timeout) — watched by the "
        "fleet-scale-flap rate rule",
        ("direction", "outcome"))


def fleet_replica_queue_depth(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_fleet_replica_queue_depth",
        "Pending-queue depth per serving replica as the fleet poll saw "
        "it last — the fleet-replica-hot threshold rule judges the "
        "hottest series (alert-engine gauges take max across series)",
        ("replica",))


def fleet_ttft_skew(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_fleet_ttft_skew",
        "Max/median of per-replica TTFT p99 across the fleet's scoped "
        "component series (polyaxon_serving_ttft_seconds merged per "
        "component) — 1.0 is a balanced fleet; the fleet-replica-skew "
        "rule fires on a hot outlier. Unset while fewer than two "
        "components have samples, and a released replica's dropped "
        "series leave the ratio, so a dead replica cannot pin the rule")


def publish_fleet_rollups(registry: Any = REGISTRY) -> None:
    """Recompute the fleet-level derived series from the scoped
    per-component series — called from ``ServingFleet.poll`` (and the
    gauntlet's skew drill). Accepts a scoped view and unwraps it: a
    rollup is by definition a fleet-wide read."""
    base = base_registry(registry)
    by_comp = {c: v for c, v
               in serving_ttft_hist(base).quantile_by_component(
                   0.99).items() if c}
    gauge = fleet_ttft_skew(base)
    if len(by_comp) < 2:
        gauge.unset()
        return
    vals = sorted(by_comp.values())
    mid = len(vals) // 2
    median = (vals[mid] if len(vals) % 2
              else (vals[mid - 1] + vals[mid]) / 2.0)
    gauge.set(max(vals) / median if median > 0 else 0.0)


def ensure_fleet_metrics(registry: MetricsRegistry = REGISTRY) -> None:
    """Pre-register the serving-fleet families (idempotent) — one
    source of truth for :func:`catalog_metric_names`."""
    fleet_replicas(registry)
    fleet_routed_total(registry)
    fleet_scale_events_total(registry)
    fleet_replica_queue_depth(registry)
    fleet_ttft_skew(registry)


def history_samples_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_history_samples_total",
        "Metrics-history sampling passes by outcome (ok / error — the "
        "sampler is fail-open, so errors are counted, not raised)",
        ("outcome",))


def history_points(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_history_points",
        "Points retained in the metrics-history ring by tier (recent = "
        "full-cadence ring, coarse = downsampled old samples)",
        ("tier",))


def history_series(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_history_series",
        "Distinct (metric, label-set) series tracked by the "
        "metrics-history ring (capped; overflow series are dropped and "
        "counted in polyaxon_history_evictions_total)")


def history_windows(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_history_windows",
        "Named window markers held by the metrics history "
        "(mark_window; bounded ring, oldest-out)")


def history_coarsened_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_history_coarsened_total",
        "Samples migrated from the full-cadence recent ring into the "
        "coarse tier (one survivor per coarsening interval)")


def history_evictions_total(registry: MetricsRegistry = REGISTRY) -> Counter:
    return registry.counter(
        "polyaxon_history_evictions_total",
        "Metrics-history data dropped to hold the memory ceiling, by "
        "reason (point = aged out of both tiers, series = over the "
        "series cap, window = window-marker ring overflow)",
        ("reason",))


def history_sample_hist(registry: MetricsRegistry = REGISTRY) -> Histogram:
    return registry.histogram(
        "polyaxon_history_sample_seconds",
        "Wall seconds per metrics-history sampling pass (registry "
        "snapshot + changed-series append)",
        buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1))


def project_usage(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_project_usage",
        "Live per-project resource usage as admission accounts it "
        "(resource = runs | chips), sampled into the metrics history "
        "for the quota_violation oracle invariant",
        ("project", "resource"))


def project_quota_limit(registry: MetricsRegistry = REGISTRY) -> Gauge:
    return registry.gauge(
        "polyaxon_project_quota_limit",
        "Configured per-project quota ceiling (resource = runs | "
        "chips); 0 or absent means uncapped",
        ("project", "resource"))


def ensure_history_metrics(registry: MetricsRegistry = REGISTRY) -> None:
    """Pre-register the metrics-history self-accounting families and
    the quota usage/limit gauges the history sampler records
    (idempotent) — one source of truth for :func:`catalog_metric_names`."""
    history_samples_total(registry)
    history_points(registry)
    history_series(registry)
    history_windows(registry)
    history_coarsened_total(registry)
    history_evictions_total(registry)
    history_sample_hist(registry)
    project_usage(registry)
    project_quota_limit(registry)


def ensure_core_metrics(registry: MetricsRegistry = REGISTRY) -> None:
    """Pre-register the documented families (idempotent) so /metrics
    exposes a stable schema — including at least one histogram — even
    before the first sample lands."""
    scheduler_tick_hist(registry)
    admission_outcomes(registry)
    requeues_total(registry)
    retry_attempts(registry)
    store_op_hist(registry)
    runstore_op_hist(registry)
    admission_pass_hist(registry)
    admission_divergence(registry)
    training_step_hist(registry)
    alert_history_evictions(registry)
    oracle_verdicts_total(registry)
    elastic_resizes_total(registry)
    elastic_resize_hist(registry)
    checkpoint_restore_hist(registry)
    checkpoint_save_hist(registry)


# Families registered at scrape time (api/server.py) rather than by an
# accessor above — listed so the rule-schema validator knows the FULL
# metric vocabulary, not just the accessor catalog.
SCRAPE_TIME_METRICS = (
    "polyaxon_runs",
    "polyaxon_queue_depth",
    "polyaxon_queue_running",
    "polyaxon_uptime_seconds",
    "polyaxon_tpu_info",
)


def catalog_metric_names() -> set[str]:
    """Every metric name this codebase can expose — the closed
    vocabulary ``obs.rules`` validates rule specs against (an alert on
    a typo'd name would never fire; CI fails it instead)."""
    scratch = MetricsRegistry()
    ensure_core_metrics(scratch)
    ensure_serving_metrics(scratch)
    ensure_fleet_metrics(scratch)
    ensure_perf_metrics(scratch)
    ensure_history_metrics(scratch)
    names = set(scratch._metrics)
    names.update(SCRAPE_TIME_METRICS)
    names.add(DROPPED_LABELS_METRIC)
    return names
