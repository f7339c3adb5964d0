"""``python -m polyaxon_tpu_torch.sidecar`` — the sidecar process entrypoint
spawned next to each run's main process by the executor.

Port of ``polyaxon_tpu/sidecar/__main__.py``, the same code under the port's
module names.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

from polyaxon_tpu_torch.sidecar.sync import SidecarSync


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--store-dir", required=True)
    parser.add_argument("--interval", type=float, default=5.0)
    args = parser.parse_args()

    sync = SidecarSync(args.run_dir, args.store_dir, args.interval)
    stop = {"flag": False}

    def handle(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)

    while not stop["flag"]:
        try:
            sync.sync_once()
        except Exception as exc:
            print(f"sidecar sync error: {exc}", file=sys.stderr)
        time.sleep(args.interval)
    sync.sync_once()
    return 0


if __name__ == "__main__":
    sys.exit(main())
