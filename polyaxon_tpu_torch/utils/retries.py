"""Unified retry/backoff layer (ISSUE 1 tentpole).

One policy shared by every layer that survives cluster weather: the
scheduler's restart-policy requeues, the fs layer's object-store ops,
and the executor's init-phase artifact downloads. Two primitives:

- :func:`backoff_delay` — exponential backoff with DETERMINISTIC jitter:
  the jitter fraction is a hash of ``(key, attempt)``, so a scheduler
  tick that recomputes a run's delay gets the same number every time
  (idempotent ticks), while different runs decorrelate. Delays are
  strictly monotone in ``attempt`` (growth factor dominates the jitter
  band), which run ``meta["backoff"]["delays"]`` audits rely on.
- :func:`with_retries` — bounded attempts around a callable with typed
  transient-vs-permanent classification: permanent errors raise on the
  first attempt, transient ones retry through the backoff schedule.

Port of ``polyaxon_tpu/utils/retries.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import hashlib
import logging
import time
from typing import Any, Callable, Iterable, Optional, Type, Union

Classifier = Union[Callable[[BaseException], bool],
                   Iterable[Type[BaseException]]]


def _jitter_fraction(key: Optional[str], attempt: int) -> float:
    """Deterministic fraction in [0, 1) from (key, attempt); random when
    no key is given (callers without an identity to pin)."""
    if key is None:
        import random

        return random.random()
    digest = hashlib.sha256(f"{key}:{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


def backoff_delay(
    attempt: int,
    *,
    base: float = 0.5,
    factor: float = 2.0,
    max_delay: float = 60.0,
    jitter: float = 0.25,
    key: Optional[str] = None,
) -> float:
    """Delay in seconds before retry number ``attempt`` (0-based).

    ``base * factor**attempt``, capped at ``max_delay``, stretched by up
    to ``jitter`` fraction. Jitter only ADDS (never subtracts) so the
    sequence stays strictly increasing until the cap.
    """
    raw = min(base * (factor ** max(attempt, 0)), max_delay)
    return raw * (1.0 + max(jitter, 0.0) * _jitter_fraction(key, attempt))


def is_transient_default(exc: BaseException) -> bool:
    """Default classification: network/timeout shapes are transient,
    missing-resource and usage errors are permanent."""
    if isinstance(exc, (FileNotFoundError, IsADirectoryError,
                        NotADirectoryError, PermissionError)):
        return False
    if isinstance(exc, (TimeoutError, ConnectionError, InterruptedError,
                        OSError)):
        return True
    return False


def with_retries(
    fn: Callable[[], Any],
    *,
    attempts: int = 3,
    base: float = 0.1,
    factor: float = 2.0,
    max_delay: float = 5.0,
    jitter: float = 0.25,
    transient: Optional[Classifier] = None,
    key: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Call ``fn()`` with up to ``attempts`` tries.

    ``transient`` is either an exception-type tuple/list or a predicate;
    anything it rejects (or any exception when classification says
    permanent) re-raises immediately. The final transient failure
    re-raises as-is — callers see the real error, not a wrapper.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if transient is None:
        classify = is_transient_default
    elif callable(transient):
        classify = transient
    else:
        types = tuple(transient)
        classify = lambda exc: isinstance(exc, types)  # noqa: E731

    for attempt in range(attempts):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classified below
            if attempt + 1 >= attempts or not classify(exc):
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            _note_retry(attempt, exc, key)
            sleep(backoff_delay(attempt, base=base, factor=factor,
                                max_delay=max_delay, jitter=jitter, key=key))


def _note_retry(attempt: int, exc: BaseException,
                key: Optional[str]) -> None:
    """Observability tap on every transient retry: bump the unified
    registry's counter and annotate the active lifecycle span (so a
    chaos-injected store fault shows up as fault + retry ON the phase
    it hit). Passive by contract — never raises into the retry loop."""
    try:
        from polyaxon_tpu_torch.obs import metrics as obs_metrics
        from polyaxon_tpu_torch.obs import trace as obs_trace

        obs_metrics.retry_attempts().inc()
        obs_trace.add_event(
            "retry", attempt=attempt + 1,
            error=f"{type(exc).__name__}: {exc}"[:200],
            **({"key": key} if key else {}))
    except Exception as obs_exc:  # observability stays passive
        logging.getLogger(__name__).debug(
            "retry observability tap failed: %s", obs_exc)
