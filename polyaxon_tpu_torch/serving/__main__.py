"""``python -m polyaxon_tpu_torch.serving --model llama3_8b --batching
continuous --kv paged`` — serve a model on the GPU over HTTP (it
raises without one).

The flags are those of ``python -m polyaxon_tpu.serving``; the ones whose
feature is not ported yet are accepted and refused with a clear error
(the tuning knobs of those features are not accepted at all). SIGINT and
SIGTERM stop the server and exit with 0.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def main() -> int:
    parser = argparse.ArgumentParser(prog="polyaxon_tpu_torch.serving")
    parser.add_argument("--model", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batching", default="continuous",
                        choices=["static", "continuous"])
    parser.add_argument("--slots", type=int, default=4)
    parser.add_argument("--kv", default="paged", choices=["dense", "paged"])
    parser.add_argument("--kv-page-size", type=int, default=16)
    parser.add_argument("--kv-pages", type=int, default=None)
    parser.add_argument("--no-prefix-cache", action="store_true")
    parser.add_argument("--max-pending", type=int, default=None)
    # The port's engine is the FIFO-with-cache-affinity scheduler without
    # request traces, which is what these three flags ask the JAX server
    # for: accepted, and true of every port run.
    for flag in ("--no-class-admission", "--no-preemption",
                 "--no-request-tracing"):
        parser.add_argument(flag, action="store_true")
    # Features not ported yet: naming one is an error.
    unported = ("--mesh", "--quantize", "--draft-model", "--draft-checkpoint",
                "--prefill-chunk", "--prefill-slots", "--trace-dump")
    for flag in unported:
        parser.add_argument(flag, default=None)
    parser.add_argument("--class-max-pending", action="append", default=[])
    args = parser.parse_args()
    named = [flag for flag in unported
             if getattr(args, flag[2:].replace("-", "_")) is not None]
    if args.class_max_pending:
        named.append("--class-max-pending")
    if args.kv != "paged":
        named.append("--kv dense")
    if named:
        parser.error(f"not ported to polyaxon_tpu_torch yet: {named}")

    logging.basicConfig(level=logging.INFO)
    from polyaxon_tpu_torch.serving.server import ServingServer

    with ServingServer(args.model, args.checkpoint, host=args.host,
                       port=args.port, seed=args.seed,
                       batching=args.batching, slots=args.slots,
                       kv=args.kv, page_size=args.kv_page_size,
                       kv_pages=args.kv_pages,
                       prefix_cache=not args.no_prefix_cache,
                       max_pending=args.max_pending) as s:
        # Installed explicitly: a shell starts a background job with
        # SIGINT ignored, and Python then never raises KeyboardInterrupt.
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        print(f"serving {args.model} at {s.url}", flush=True)
        while not stop.wait(1.0):
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
