"""Interval re-execution wrapper for watchdog runs.

``python -m polyaxon_tpu_torch.utils.watchloop <interval_seconds> -- cmd ...``
runs the command, sleeps, and repeats until SIGTERM/SIGINT (the
executor's stop path). A failing iteration ends the loop with the
child's exit code so the run transitions to failed.

Port of ``polyaxon_tpu/utils/watchloop.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import signal
import subprocess
import sys
import time


def main(argv: list[str]) -> int:
    if len(argv) < 3 or argv[1] != "--":
        print("usage: watchloop <interval_seconds> -- cmd ...", file=sys.stderr)
        return 2
    interval = float(argv[0])
    cmd = argv[2:]

    stopping = False
    child: subprocess.Popen | None = None

    def _stop(signum, frame):
        nonlocal stopping
        stopping = True
        # Forward to the active child so a long-running iteration ends
        # promptly instead of outliving the stop request.
        if child is not None and child.poll() is None:
            child.terminate()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)

    while not stopping:
        child = subprocess.Popen(cmd)
        if stopping and child.poll() is None:
            # Signal landed between the loop check and the assignment —
            # the handler had nothing to terminate, so do it here.
            child.terminate()
        rc = child.wait()
        if stopping:
            return 0  # stop requested mid-iteration: clean shutdown
        if rc != 0:
            return rc
        # Sleep in small increments so a stop signal lands promptly.
        deadline = time.monotonic() + interval
        while not stopping and time.monotonic() < deadline:
            time.sleep(min(0.5, max(deadline - time.monotonic(), 0.01)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
