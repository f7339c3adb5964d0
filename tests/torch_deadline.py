"""A per-test wall-clock deadline without a pytest plugin: the test body
runs under ``SIGALRM``, whose handler raises ``TimeoutError`` in the
test's own thread, so a supervised gang's ``finally`` kills its ranks
and the test fails instead of hanging its worker."""

import functools
import signal


def deadline(seconds: int):
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            def on_alarm(signum, frame):
                raise TimeoutError(
                    f"{fn.__name__} passed its {seconds} s deadline")

            old = signal.signal(signal.SIGALRM, on_alarm)
            signal.alarm(seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return inner
    return wrap
