"""Temporal telemetry: a bounded metrics-history ring over the registry
(port of ``polyaxon_tpu/obs/history.py``, the same code under the port's
module names).

The registry (obs.metrics) is cumulative-only — it can answer "how many
requeues ever" but not "was serving p99 under SLO *during* the storm".
:class:`MetricsHistory` closes that gap: periodic samples of the live
registry, recorded as absolute per-series values but *admitted* by the
``snapshot_delta`` primitive — a series only gets a new point when it
moved (or when it is first seen, so every series has an anchor point
and windowed deltas never hide a counter's birth value).

Memory is fixed by construction, not by hope:

- per series, a full-cadence ``recent`` ring (``recent_points`` cap)
  whose overflow *coarsens* into a second ring — one survivor per
  ``coarse_interval`` — so old history thins to coarse resolution
  instead of disappearing (``coarse_points`` cap bounds that tier too);
- a ``max_series`` cap on distinct (metric, label-set) series;
- a bounded ring of **named window markers** (``mark_window``) that
  chaos plans and drills emit so judgments can be scoped to a phase
  of the run ("storm", "replay", ...).

Everything is fail-open (a sampling error is counted, never raised)
and self-accounted via the catalogued ``polyaxon_history_*`` families.

The process-global :func:`default_history` over ``REGISTRY`` is the
one sampling path shared by the agent reconcile hook, the alert
engine's rate/burn windows (obs.rules), ``query_history``, and the
oracle's ``metric_during`` / ``slo_during`` /
``quota_violation`` invariants (obs.oracle).

Because samples are cumulative values, windowed math is subtraction:
the histogram distribution *inside* a window is the bucket-wise
difference between the carry-forward sample at the window's end and
the one at its start; a counter's in-window movement is a value
difference; a gauge's worst instant is the max over in-window points
plus the carry-in. The pure ``windowed_*`` helpers at module bottom
implement that over the JSON shape ``to_json`` emits (and
``TelemetryBundle`` carries), so replayed bundles judge identically
to live ones.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Optional

from polyaxon_tpu_torch.obs import metrics as obs_metrics

DEFAULT_CADENCE = 1.0
DEFAULT_RECENT_POINTS = 256
DEFAULT_COARSE_POINTS = 128
DEFAULT_MAX_SERIES = 512
DEFAULT_MAX_WINDOWS = 64


class _SeriesRing:
    """One series' two-tier point storage: (t, sample) tuples where the
    sample is the registry snapshot value — a float for counter/gauge
    series, the ``{count, sum, buckets}`` dict for histogram series."""

    __slots__ = ("recent", "coarse")

    def __init__(self):
        self.recent: deque = deque()
        self.coarse: deque = deque()

    def merged(self) -> list:
        return list(self.coarse) + list(self.recent)

    def __len__(self) -> int:
        return len(self.recent) + len(self.coarse)


class MetricsHistory:
    """Bounded ring of periodic registry samples + named window markers."""

    def __init__(self, registry: obs_metrics.MetricsRegistry = None, *,
                 cadence: float = DEFAULT_CADENCE,
                 recent_points: int = DEFAULT_RECENT_POINTS,
                 coarse_points: int = DEFAULT_COARSE_POINTS,
                 coarse_interval: Optional[float] = None,
                 max_series: int = DEFAULT_MAX_SERIES,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 clock: Callable[[], float] = time.time):
        self.registry = registry if registry is not None else obs_metrics.REGISTRY
        self.cadence = float(cadence)
        self.recent_points = int(recent_points)
        self.coarse_points = int(coarse_points)
        self.coarse_interval = (float(coarse_interval)
                                if coarse_interval is not None
                                else self.cadence * 8.0)
        self.max_series = int(max_series)
        self.max_windows = int(max_windows)
        self.clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str], _SeriesRing] = {}
        self._families: dict[str, dict] = {}  # name -> {type, labels}
        self._refused: set[tuple[str, str]] = set()  # over-cap series, counted once
        self._windows: deque = deque()
        self._last_snap: Optional[dict] = None
        self._first_t: Optional[float] = None
        self._last_t: Optional[float] = None
        self._samples = 0

    # -- sampling ----------------------------------------------------------
    def due(self, now: Optional[float] = None) -> bool:
        if self._last_t is None:
            return True
        if now is None:
            now = self.clock()
        return now - self._last_t >= self.cadence

    def sample(self, now: Optional[float] = None, *,
               force: bool = False) -> bool:
        """One sampling pass; returns True if a sample was recorded.
        Fail-open: an exception is counted into
        ``polyaxon_history_samples_total{outcome="error"}``, not raised."""
        try:
            return self._sample(now, force)
        except Exception:
            try:
                obs_metrics.history_samples_total(self.registry).inc(
                    outcome="error")
            except Exception:
                pass
            import logging
            logging.getLogger(__name__).warning(
                "metrics-history sample failed (fail-open)", exc_info=True)
            return False

    def _sample(self, now: Optional[float], force: bool) -> bool:
        if now is None:
            now = self.clock()
        t0 = time.perf_counter()
        with self._lock:
            if not force and self._last_t is not None and (
                    now - self._last_t < self.cadence):
                return False
            if self._last_t is not None and now < self._last_t:
                return False  # clock went backwards: drop, don't reorder
            snap = self.registry.snapshot()
            last = self._last_snap
            coarsened = evicted_points = refused_series = 0
            for name, family in snap.items():
                base = ((last.get(name) or {}).get("series")
                        if last is not None else None)
                fam_meta = self._families.get(name)
                if fam_meta is not None:
                    labels = list(family.get("labels") or [])
                    if fam_meta.get("labels") != labels:
                        # A family grows the hidden component dimension
                        # the moment something scoped records into it —
                        # keep the cached label list current so reads
                        # parse scoped keys correctly.
                        fam_meta["labels"] = labels
                for key, sample in family["series"].items():
                    if base is not None and key in base and (
                            obs_metrics.series_delta(
                                sample, base[key]) is None):
                        continue  # unchanged: carry-forward covers it
                    sid = (name, key)
                    ring = self._series.get(sid)
                    if ring is None:
                        if len(self._series) >= self.max_series:
                            if sid not in self._refused:
                                self._refused.add(sid)
                                refused_series += 1
                            continue
                        ring = self._series[sid] = _SeriesRing()
                        if fam_meta is None:
                            fam_meta = self._families[name] = {
                                "type": family["type"],
                                "labels": list(family.get("labels") or [])}
                    ring.recent.append((now, sample))
                    while len(ring.recent) > self.recent_points:
                        old = ring.recent.popleft()
                        if (not ring.coarse or old[0] - ring.coarse[-1][0]
                                >= self.coarse_interval):
                            if len(ring.coarse) >= self.coarse_points:
                                ring.coarse.popleft()
                                evicted_points += 1
                            ring.coarse.append(old)
                            coarsened += 1
                        else:
                            evicted_points += 1
            self._last_snap = snap
            self._last_t = now
            if self._first_t is None:
                self._first_t = now
            self._samples += 1
            n_series = len(self._series)
            n_recent = sum(len(r.recent) for r in self._series.values())
            n_coarse = sum(len(r.coarse) for r in self._series.values())
            n_windows = len(self._windows)
        # Self-accounting AFTER the snapshot + append (outside the data
        # pass so the pass never observes its own movement mid-flight).
        reg = self.registry
        obs_metrics.history_samples_total(reg).inc(outcome="ok")
        obs_metrics.history_series(reg).set(n_series)
        obs_metrics.history_windows(reg).set(n_windows)
        obs_metrics.history_points(reg).set(n_recent, tier="recent")
        obs_metrics.history_points(reg).set(n_coarse, tier="coarse")
        if coarsened:
            obs_metrics.history_coarsened_total(reg).inc(coarsened)
        if evicted_points:
            obs_metrics.history_evictions_total(reg).inc(
                evicted_points, reason="point")
        if refused_series:
            obs_metrics.history_evictions_total(reg).inc(
                refused_series, reason="series")
        obs_metrics.history_sample_hist(reg).observe(
            time.perf_counter() - t0)
        return True

    # -- named windows -----------------------------------------------------
    def mark_window(self, name: str, *, start: Any = None,
                    end: Any = None) -> Optional[dict]:
        """Open and/or close a named window. ``start``/``end`` accept a
        float timestamp or ``True`` (= clock now); a bare call opens the
        window now; ``end`` alone closes the most recent open window of
        that name (or records a zero-length one — closing what was never
        opened is a caller bug this plane absorbs, not raises)."""
        try:
            now = self.clock()
            t_start = (now if start is True else
                       float(start) if start is not None else None)
            t_end = (now if end is True else
                     float(end) if end is not None else None)
            evicted = 0
            with self._lock:
                if t_start is None and t_end is None:
                    t_start = now
                if t_start is not None:
                    win = {"name": str(name), "start": t_start,
                           "end": t_end}
                    if len(self._windows) >= self.max_windows:
                        self._windows.popleft()
                        evicted = 1
                    self._windows.append(win)
                else:
                    win = None
                    for w in reversed(self._windows):
                        if w["name"] == name and w["end"] is None:
                            w["end"] = t_end
                            win = w
                            break
                    if win is None:
                        win = {"name": str(name), "start": t_end,
                               "end": t_end}
                        if len(self._windows) >= self.max_windows:
                            self._windows.popleft()
                            evicted = 1
                        self._windows.append(win)
            if evicted:
                obs_metrics.history_evictions_total(self.registry).inc(
                    evicted, reason="window")
            from polyaxon_tpu_torch.obs import trace as obs_trace
            obs_trace.add_event(
                f"window.{name}",
                phase="start" if t_end is None else
                      ("end" if t_start is None else "complete"),
                window=name)
            return win
        except Exception:
            import logging
            logging.getLogger(__name__).warning(
                "mark_window(%r) failed (fail-open)", name, exc_info=True)
            return None

    def window(self, name: str):
        """Context manager: ``with history.window("storm"): ...``"""
        hist = self

        class _Window:
            def __enter__(self):
                hist.mark_window(name, start=True)
                return self

            def __exit__(self, *exc):
                hist.mark_window(name, end=True)
                return False

        return _Window()

    def windows(self) -> list[dict]:
        with self._lock:
            return [dict(w) for w in self._windows]

    def window_bounds(self, name: str) -> Optional[tuple[float, float]]:
        """(start, end) of the most recent window named ``name``; an
        open window ends at the last sample (or now)."""
        with self._lock:
            for w in reversed(self._windows):
                if w["name"] == name:
                    end = w["end"]
                    if end is None:
                        end = self._last_t if self._last_t is not None \
                            else self.clock()
                    return (w["start"], end)
        return None

    # -- queries (engine hot path works on the object, not the JSON) ------
    def family(self, metric: str) -> Optional[dict]:
        with self._lock:
            meta = self._families.get(metric)
            return dict(meta) if meta else None

    def points(self, metric: str, key: str = "", *,
               start: Optional[float] = None,
               end: Optional[float] = None) -> list:
        """[(t, sample)] for one series, in-window plus one carry-in
        point before ``start`` (windowed math needs the left baseline)."""
        with self._lock:
            ring = self._series.get((metric, key))
            if ring is None:
                return []
            pts = ring.merged()
        if end is not None:
            pts = [p for p in pts if p[0] <= end]
        if start is not None:
            carry = None
            for p in pts:
                if p[0] < start:
                    carry = p
                else:
                    break
            pts = ([carry] if carry else []) + [
                p for p in pts if p[0] >= start]
        return pts

    def series_keys(self, metric: str) -> list[str]:
        with self._lock:
            return [k for (m, k) in self._series if m == metric]

    def _value_at(self, pts: list, t: float):
        """Carry-forward: the newest sample at-or-before ``t``."""
        value = None
        for pt, sample in pts:
            if pt <= t:
                value = sample
            else:
                break
        return value

    def counter_total_at(self, metric: str, labels: Optional[dict],
                         t: float) -> Optional[float]:
        """The rules-engine counter read, reconstructed at time ``t``:
        labeled → carry-forward values summed across every series the
        labels subset-match (a fleet's per-component series federate
        into one total); unlabeled → the sum across all series
        (histogram series contribute their count). A
        series with no point at-or-before ``t`` did not exist yet and
        contributes 0 (counters are born at zero). ``None`` when the
        metric has no series at all by ``t``."""
        with self._lock:
            meta = self._families.get(metric)
            if meta is None:
                return None
            total = 0.0
            seen = False
            for (m, key), ring in self._series.items():
                if m != metric:
                    continue
                # Subset match: unnamed dimensions — the hidden
                # component above all — wildcard, so a labeled read
                # sums every replica's series (the federated total).
                if labels and not obs_metrics.match_series(
                        meta["labels"], key, labels):
                    continue
                sample = self._value_at(ring.merged(), t)
                if sample is None:
                    continue
                seen = True
                total += (float(sample["count"])
                          if isinstance(sample, dict) else float(sample))
            return total if seen else None

    def bucket_counts_at(self, metric: str, le: float,
                         t: float) -> Optional[tuple[float, float]]:
        """(good, total) cumulative histogram counts at time ``t``,
        summed across series — the burn-rate read. ``None`` when ``le``
        matches no bucket bound or nothing was observed by ``t``."""
        good = total = 0.0
        seen = False
        with self._lock:
            for (m, _k), ring in self._series.items():
                if m != metric:
                    continue
                sample = self._value_at(ring.merged(), t)
                if not isinstance(sample, dict):
                    continue
                counts = sample_slo_counts(sample, le)
                if counts is None:
                    return None  # le is not a bound of this layout
                seen = True
                good += counts[0]
                total += counts[1]
        return (good, total) if seen else None

    def first_time(self, metric: str,
                   labels: Optional[dict] = None) -> Optional[float]:
        """Earliest retained point time for the rule's selection — the
        left-edge floor for windowed rates (data older than this was
        never recorded, not zero)."""
        with self._lock:
            meta = self._families.get(metric)
            if meta is None:
                return None
            first = None
            for (m, key), ring in self._series.items():
                if m != metric:
                    continue
                if labels and not obs_metrics.match_series(
                        meta["labels"], key, labels):
                    continue
                pts = ring.merged()
                if pts and (first is None or pts[0][0] < first):
                    first = pts[0][0]
            return first

    # -- accounting / lifecycle -------------------------------------------
    def coverage(self) -> dict:
        with self._lock:
            return {"start": self._first_t, "end": self._last_t,
                    "samples": self._samples}

    def point_count(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._series.values())

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def max_points(self) -> int:
        """The hard memory ceiling, in points: no sequence of samples
        can retain more than this."""
        return self.max_series * (self.recent_points + self.coarse_points)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._families.clear()
            self._refused.clear()
            self._windows.clear()
            self._last_snap = None
            self._first_t = self._last_t = None
            self._samples = 0

    # -- export ------------------------------------------------------------
    def to_json(self, metrics: Optional[list[str]] = None) -> dict:
        """The serialized history the oracle judges and the API serves:
        coverage, window markers, and per-series [t, sample] points
        (coarse tier first, then full-cadence recent)."""
        with self._lock:
            series: dict[str, dict] = {}
            for (name, key), ring in self._series.items():
                if metrics is not None and name not in metrics:
                    continue
                fam = series.get(name)
                if fam is None:
                    meta = self._families.get(name) or {}
                    fam = series[name] = {
                        "type": meta.get("type"),
                        "labels": list(meta.get("labels") or []),
                        "series": {}}
                fam["series"][key] = [[t, s] for t, s in ring.merged()]
            return {
                "cadence": self.cadence,
                "coarse_interval": self.coarse_interval,
                "coverage": {"start": self._first_t, "end": self._last_t,
                             "samples": self._samples},
                "windows": [dict(w) for w in self._windows],
                "series": series,
            }


# ---------------------------------------------------------------- default
_DEFAULT: Optional[MetricsHistory] = None
_DEFAULT_LOCK = threading.Lock()


def default_history() -> MetricsHistory:
    """The process-global history over ``REGISTRY`` — the one sampling
    path the agent hook, the alert engine, the API, and the oracle
    share."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsHistory(obs_metrics.REGISTRY)
        return _DEFAULT


def set_default_history(history: Optional[MetricsHistory]) -> None:
    """Swap (or clear, with None) the process default — tests and drills
    pin a history with injectable clock/cadence."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = history


def reset_default() -> None:
    """Drop the default ring's contents (``REGISTRY.reset()`` calls
    this: the history is derived state over the registry)."""
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _DEFAULT.reset()


def history_for(registry: obs_metrics.MetricsRegistry) -> MetricsHistory:
    """The shared default for the global registry; a private ring for
    anything else (unit-test registries must not cross-pollinate)."""
    if registry is obs_metrics.REGISTRY:
        return default_history()
    return MetricsHistory(registry)


# ------------------------------------------------- pure windowed helpers
# These operate on the ``to_json`` shape so the oracle judges a live
# bundle and a deserialized (replayed) one identically.

def sample_slo_counts(sample: dict, le: float) -> Optional[tuple[float, float]]:
    """(good, total) from one histogram sample dict: good = cumulative
    count at the bucket bound matching ``le``; None when ``le`` is not
    a bound of the layout."""
    cumulative = 0.0
    matched = None
    for bound, n in sample["buckets"].items():
        cumulative += n
        if bound == "+Inf":
            continue
        try:
            if abs(float(bound) - le) < 1e-12:
                matched = cumulative
                break
        except ValueError:
            continue
    if matched is None:
        return None
    return (float(matched), float(sample["count"]))


def value_at(points: list, t: float):
    """Carry-forward value of a [t, sample] point list at ``t`` (None
    before the first point)."""
    value = None
    for pt in points:
        if pt[0] <= t:
            value = pt[1]
        else:
            break
    return value


def window_bounds(hist: dict, name: str) -> Optional[tuple[float, float]]:
    """(start, end) of the most recent window named ``name`` in a
    serialized history; an open window ends at coverage end."""
    for w in reversed(hist.get("windows") or []):
        if w.get("name") == name:
            end = w.get("end")
            if end is None:
                end = (hist.get("coverage") or {}).get("end")
            if end is None:
                return None
            return (float(w["start"]), float(end))
    return None


def trailing_bounds(hist: dict, span: float) -> Optional[tuple[float, float]]:
    """The trailing ``span`` seconds before coverage end."""
    cov = hist.get("coverage") or {}
    if cov.get("end") is None:
        return None
    end = float(cov["end"])
    return (end - float(span), end)


def select_series_points(hist: dict, metric: str,
                         labels: Optional[dict]) -> Optional[dict]:
    """{key: points} for the invariant's selection: a labels dict
    subset-matches (dimensions it does not name — the fleet's hidden
    component dimension above all — are wildcards, so one selector
    gathers every replica's series); no labels means every series of
    the family."""
    family = (hist.get("series") or {}).get(metric)
    if not family:
        return None
    if labels:
        labelnames = family.get("labels") or []
        out = {key: pts
               for key, pts in (family.get("series") or {}).items()
               if pts and obs_metrics.match_series(labelnames, key, labels)}
        return out or None
    return dict(family.get("series") or {})


def windowed_hist_sample(points: list, start: float,
                         end: float) -> Optional[dict]:
    """The in-window distribution of one histogram series: bucket-wise
    difference between the carry-forward samples at ``end`` and at
    ``start``. None when the series has no sample by ``end``."""
    last = value_at(points, end)
    if not isinstance(last, dict):
        return None
    base = value_at(points, start)
    base_buckets = base["buckets"] if isinstance(base, dict) else {}
    base_count = base["count"] if isinstance(base, dict) else 0
    base_sum = base["sum"] if isinstance(base, dict) else 0.0
    return {
        "count": last["count"] - base_count,
        "sum": round(last["sum"] - base_sum, 6),
        "buckets": {b: n - base_buckets.get(b, 0)
                    for b, n in last["buckets"].items()},
    }


def windowed_counter_delta(points: list, start: float,
                           end: float) -> Optional[float]:
    """A counter series' movement inside the window (births inside the
    window count from zero)."""
    last = value_at(points, end)
    if last is None:
        return None
    base = value_at(points, start)
    last_v = (float(last["count"]) if isinstance(last, dict)
              else float(last))
    base_v = (float(base["count"]) if isinstance(base, dict)
              else float(base)) if base is not None else 0.0
    return max(last_v - base_v, 0.0)


def windowed_gauge_extent(points: list, start: float, end: float,
                          agg: str = "max") -> Optional[float]:
    """A gauge's worst (max) / best (min) / final (last) value over the
    window, carry-in included — "was the queue ever past X during the
    storm" is a max over sampled instants."""
    carry = value_at(points, start)
    values = [float(v) for t, v in points
              if start <= t <= end and not isinstance(v, dict)]
    if carry is not None and not isinstance(carry, dict):
        values.insert(0, float(carry))
    if not values:
        return None
    if agg == "min":
        return min(values)
    if agg == "last":
        return values[-1]
    return max(values)


def query_history(hist: dict, *, name: Optional[str] = None,
                  window: Optional[str] = None,
                  labels: Optional[dict] = None) -> dict:
    """Read-side view over a :meth:`MetricsHistory.to_json` snapshot —
    the one query a history surface serves.

    ``window`` is either a marked window name (most recent occurrence)
    or a trailing span string (``"15m"``); scoped series get the
    carry-forward value at scope start prepended so a plot starts at
    the right level. Without ``name``, returns the family catalog only.
    Raises ``ValueError`` on an unknown metric/window — surfaces decide
    the status code / exit posture.
    """
    bounds = None
    if window:
        bounds = window_bounds(hist, window)
        if bounds is None:
            from polyaxon_tpu_torch.obs import rules as obs_rules

            try:
                span = obs_rules.parse_window(window, field_name="window")
            except obs_rules.RuleError:
                raise ValueError(
                    f"window {window!r} is neither a marked window nor "
                    "a span like 30s/15m/2h")
            bounds = trailing_bounds(hist, span)
        if bounds is None:
            raise ValueError(
                f"history has no coverage yet for window {window!r}")
    out: dict = {
        "cadence": hist.get("cadence"),
        "coverage": hist.get("coverage"),
        "windows": list(hist.get("windows") or []),
    }
    if bounds is not None:
        out["scope"] = {"window": window,
                        "start": bounds[0], "end": bounds[1]}
    if name is None:
        out["metrics"] = sorted(hist.get("series") or {})
        return out
    family = (hist.get("series") or {}).get(name)
    selected = select_series_points(hist, name, labels)
    if not family or not selected:
        want = f" with labels {labels}" if labels else ""
        raise ValueError(f"no sampled series for metric {name!r}{want}")
    series: dict = {}
    for key, points in selected.items():
        if bounds is not None:
            start, end = bounds
            scoped = [list(p) for p in points if start <= p[0] <= end]
            carry = value_at(points, start)
            if carry is not None and (not scoped or scoped[0][0] > start):
                scoped.insert(0, [start, carry])
            points = scoped
        series[key] = points
    out["metric"] = {"name": name, "type": family.get("type"),
                     "labels": list(family.get("labels") or []),
                     "series": series}
    return out
