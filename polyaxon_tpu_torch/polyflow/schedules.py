"""Schedules for recurring/deferred operations (parity: ``polyflow/schedules`` [K]).

Port of ``polyaxon_tpu/polyflow/schedules.py``, the same code under the
port's module names.
"""

from __future__ import annotations

import datetime as _dt
from typing import Literal, Optional, Union

from polyaxon_tpu_torch.schemas.base import BaseSchema


class V1CronSchedule(BaseSchema):
    kind: Literal["cron"] = "cron"
    cron: str
    start_at: Optional[_dt.datetime] = None
    end_at: Optional[_dt.datetime] = None
    max_runs: Optional[int] = None
    depends_on_past: Optional[bool] = None


class V1IntervalSchedule(BaseSchema):
    kind: Literal["interval"] = "interval"
    frequency: int  # seconds
    start_at: Optional[_dt.datetime] = None
    end_at: Optional[_dt.datetime] = None
    max_runs: Optional[int] = None
    depends_on_past: Optional[bool] = None

    def next_after(self, t: _dt.datetime) -> _dt.datetime:
        return t + _dt.timedelta(seconds=self.frequency)


class V1DateTimeSchedule(BaseSchema):
    kind: Literal["datetime"] = "datetime"
    start_at: _dt.datetime


Schedule = Union[V1CronSchedule, V1IntervalSchedule, V1DateTimeSchedule]
