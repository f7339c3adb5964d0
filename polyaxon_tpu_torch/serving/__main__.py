"""``python -m polyaxon_tpu_torch.serving --model llama3_8b [--checkpoint
d]`` — serve a model on the GPU over HTTP (it raises without one).

The flags and defaults are those of ``python -m polyaxon_tpu.serving``
(the static engine over a dense cache unless ``--batching continuous``).
It serves the llama, MoE and t5 families, and a LoRA checkpoint (the
adapters merged at load, ``--lora-alpha`` the fallback for a checkpoint
without metadata). SIGINT and SIGTERM stop the server and exit with 0.

``--mesh tp=2`` (any axes and their products; -1 absorbs the rest)
serves sharded over a gang of processes, one card each, started alike
with the bootstrap's env contract (``POLYAXON_TPU_COORDINATOR``
``host:port``, ``POLYAXON_TPU_NUM_PROCESSES``,
``POLYAXON_TPU_PROCESS_ID``, ``POLYAXON_TPU_LOCAL_DEVICE_IDS``; NCCL on
the cards): rank 0 binds the port, the others follow it
(``serving/gang.py``).
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from polyaxon_tpu_torch.parallel.mesh import parse_mesh_axes


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="polyaxon_tpu_torch.serving")
    parser.add_argument("--model", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batching", default="static",
                        choices=["static", "continuous"],
                        help="continuous = slot-pool batcher: concurrent "
                             "requests interleave token-by-token")
    parser.add_argument("--slots", type=int, default=4,
                        help="KV-cache slots for --batching continuous")
    parser.add_argument("--mesh", default=None,
                        help="shard weights over a gang of processes, one "
                             "card each, e.g. 'tp=4' or 'fsdp=-1' (-1 = "
                             "every process)")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="weight-only quantization at load (int8 + "
                             "per-channel scales)")
    parser.add_argument("--kv", default="dense", choices=["dense", "paged"],
                        help="KV layout for continuous batching: paged = "
                             "shared page pool + block tables")
    parser.add_argument("--kv-page-size", type=int, default=16)
    parser.add_argument("--kv-pages", type=int, default=None)
    parser.add_argument("--no-prefix-cache", action="store_true",
                        help="(paged kv) disable radix-tree prefix sharing")
    parser.add_argument("--draft-model", default=None,
                        help="speculative-decoding draft (both engines; "
                             "lossless for greedy requests; the "
                             "continuous pool becomes greedy-only)")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="(continuous, dense kv) stream long prompts "
                             "into the pool this many tokens per loop "
                             "iteration; with --prefill-slots, the lane's "
                             "chunk")
    parser.add_argument("--prefill-slots", type=int, default=None,
                        help="(continuous, paged kv) prefill-lane rows "
                             "that stream prompts in suffix chunks and "
                             "hand their KV pages to the decode pool")
    parser.add_argument("--prefill-lane-budget", type=int, default=1,
                        help="(with --prefill-slots) max lane chunks per "
                             "engine tick while decode rows are live")
    parser.add_argument("--draft-checkpoint", default=None)
    parser.add_argument("--spec-k", type=int, default=4)
    parser.add_argument("--lora-alpha", type=float, default=16.0,
                        help="alpha when --checkpoint is a LoRA fine-tune")
    parser.add_argument("--max-pending", type=int, default=None,
                        help="(continuous) pending-queue cap; saturated "
                             "generate requests answer 503 + Retry-After")
    parser.add_argument("--no-class-admission", action="store_true",
                        help="(continuous) one FIFO-with-cache-affinity "
                             "queue for every request class, no "
                             "preemption")
    parser.add_argument("--class-max-pending", action="append", default=[],
                        metavar="CLASS=N",
                        help="(continuous) per-class pending cap, e.g. "
                             "interactive=64; repeatable")
    parser.add_argument("--no-preemption", action="store_true",
                        help="(continuous) keep class-aware ranking but "
                             "never evict a live slot")
    parser.add_argument("--no-request-tracing", action="store_true",
                        help="(continuous) disable per-request span "
                             "timelines; the SLO histograms keep flowing")
    parser.add_argument("--trace-dump", default=None, metavar="PATH",
                        help="(continuous) persist the request-timeline "
                             "ring to PATH on engine shutdown")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    class_caps = {}
    for spec in args.class_max_pending:
        name, sep, cap = spec.partition("=")
        if not sep or not name or not cap.isdigit():
            parser.error(f"--class-max-pending expects CLASS=N, got "
                         f"{spec!r}")
        class_caps[name] = int(cap)
    mesh_axes = None
    if args.mesh:
        try:
            mesh_axes = parse_mesh_axes(args.mesh)
        except ValueError as exc:
            parser.error(str(exc))

    logging.basicConfig(level=logging.INFO)
    from polyaxon_tpu_torch.serving.server import ServingServer

    with ServingServer(args.model, args.checkpoint,
                       host=args.host, port=args.port, seed=args.seed,
                       batching=args.batching, slots=args.slots,
                       mesh_axes=mesh_axes, quantize=args.quantize,
                       kv=args.kv, page_size=args.kv_page_size,
                       kv_pages=args.kv_pages,
                       prefix_cache=not args.no_prefix_cache,
                       draft_model=args.draft_model,
                       draft_checkpoint=args.draft_checkpoint,
                       spec_k=args.spec_k, lora_alpha=args.lora_alpha,
                       prefill_chunk=args.prefill_chunk,
                       prefill_slots=args.prefill_slots,
                       prefill_lane_budget=args.prefill_lane_budget,
                       max_pending=args.max_pending,
                       class_admission=not args.no_class_admission,
                       class_max_pending=class_caps or None,
                       preemption=not args.no_preemption,
                       request_tracing=not args.no_request_tracing,
                       trace_dump_path=args.trace_dump) as s:
        if not s.is_leader:
            s.follow()  # until rank 0 stops
            return 0
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
