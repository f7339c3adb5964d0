"""Minimal 5-field cron parser for V1CronSchedule (no external deps —
croniter is not in the TPU-VM image).

Supported per field: ``*``, ``*/n``, ``a``, ``a-b``, ``a-b/n``, and
comma lists thereof. Fields: minute hour day-of-month month day-of-week
(0=Sunday, 7 accepted as Sunday). Matching semantics follow vixie-cron:
when BOTH day-of-month and day-of-week are restricted, a time matches
if EITHER does.

Port of ``polyaxon_tpu/controlplane/cron.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import datetime as dt
from typing import Optional

_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))


class CronError(ValueError):
    pass


def _parse_field(text: str, lo: int, hi: int, *, dow: bool = False) -> set[int]:
    # Day-of-week accepts 7 as Sunday (vixie-cron): parse with hi=7 and
    # fold 7→0 AFTER range expansion so "5-7" (Fri-Sun) and "0-7" work.
    parse_hi = 7 if dow else hi
    values: set[int] = set()
    for part in text.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, step_text = part.split("/", 1)
            try:
                step = int(step_text)
            except ValueError as exc:
                raise CronError(f"bad step {step_text!r}") from exc
            if step <= 0:
                raise CronError(f"step must be positive, got {step}")
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            try:
                start, end = int(a), int(b)
            except ValueError as exc:
                raise CronError(f"bad range {part!r}") from exc
        else:
            try:
                start = end = int(part)
            except ValueError as exc:
                raise CronError(f"bad value {part!r}") from exc
        if not (lo <= start <= parse_hi and lo <= end <= parse_hi and start <= end):
            raise CronError(f"value {part!r} outside [{lo}, {parse_hi}]")
        values.update(range(start, end + 1, step))
    if dow:
        values = {v % 7 for v in values}
    return values


class Cron:
    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise CronError(
                f"cron {expr!r} must have 5 fields (minute hour dom month dow)")
        self.minutes = _parse_field(fields[0], *_RANGES[0])
        self.hours = _parse_field(fields[1], *_RANGES[1])
        self.dom = _parse_field(fields[2], *_RANGES[2])
        self.months = _parse_field(fields[3], *_RANGES[3])
        self.dow = _parse_field(fields[4], *_RANGES[4], dow=True)
        self.dom_star = fields[2] == "*"
        self.dow_star = fields[4] == "*"

    def _day_matches(self, t: dt.datetime) -> bool:
        dom_ok = t.day in self.dom
        dow_ok = (t.weekday() + 1) % 7 in self.dow  # python Mon=0 → cron Sun=0
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok  # vixie-cron OR semantics

    def matches(self, t: dt.datetime) -> bool:
        return (t.minute in self.minutes and t.hour in self.hours
                and t.month in self.months and self._day_matches(t))

    def next_after(self, after: dt.datetime) -> dt.datetime:
        """First matching minute strictly after ``after`` (≤ 4 years out)."""
        t = after.replace(second=0, microsecond=0) + dt.timedelta(minutes=1)
        limit = after + dt.timedelta(days=365 * 4 + 1)
        while t <= limit:
            if t.month not in self.months:
                # jump to the 1st of the next month
                year, month = t.year + (t.month == 12), t.month % 12 + 1
                t = t.replace(year=year, month=month, day=1, hour=0, minute=0)
                continue
            if not self._day_matches(t):
                t = (t + dt.timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if t.hour not in self.hours:
                t = (t + dt.timedelta(hours=1)).replace(minute=0)
                continue
            if t.minute not in self.minutes:
                t += dt.timedelta(minutes=1)
                continue
            return t
        raise CronError(f"no matching time within 4 years after {after}")


def next_fire(expr: str, after: dt.datetime) -> dt.datetime:
    return Cron(expr).next_after(after)
