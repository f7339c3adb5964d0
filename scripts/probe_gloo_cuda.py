"""Which collectives a gloo group carries for CUDA tensors, with two
processes sharing one card (NCCL refuses two ranks on one device).

    python3 scripts/probe_gloo_cuda.py

Starts two processes on ``cuda:0`` over a gloo group at a free loopback
port and tries, on CUDA tensors, ``all_reduce``, ``broadcast``,
``all_gather``, ``all_gather_into_tensor`` and ``broadcast_object_list``,
each checked against its expected result. Prints one JSON line per rank
(``{"rank": r, "ops": {op: "ok" | error}}``) and the card's
``nvidia-smi`` name and power limit. Exits 0 when it ran, whatever the
ops gave; ``chip_smoke.py`` phase 19 reads the same probe
(``probe_ops``) to choose how to run its tp2 gang.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "broadcast_object_list")


def probe_ops(torch, dist) -> dict:
    """Each op's outcome in this rank of a two-rank group: "ok", or the
    error (a wrong result counts as one)."""
    rank = dist.get_rank()
    out = {}

    def run(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as exc:  # noqa: BLE001 — the probe's answer
            out[name] = f"{type(exc).__name__}: {str(exc)[:200]}"

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 4, t.tolist()

    def broadcast():
        t = torch.full((4,), float(rank + 7), device="cuda")
        dist.broadcast(t, src=0)
        assert t.tolist() == [7.0] * 4, t.tolist()

    def all_gather():
        parts = [torch.empty(2, device="cuda") for _ in range(2)]
        dist.all_gather(parts, torch.full((2,), float(rank), device="cuda"))
        assert [p.tolist() for p in parts] == [[0.0, 0.0], [1.0, 1.0]]

    def all_gather_into_tensor():
        whole = torch.empty(4, device="cuda")
        dist.all_gather_into_tensor(
            whole, torch.full((2,), float(rank), device="cuda"))
        assert whole.tolist() == [0.0, 0.0, 1.0, 1.0], whole.tolist()

    def broadcast_object_list():
        box = [{"rank": rank}] if rank == 0 else [None]
        dist.broadcast_object_list(box, src=0)
        assert box[0] == {"rank": 0}, box

    for name, fn in zip(OPS, (all_reduce, broadcast, all_gather,
                              all_gather_into_tensor,
                              broadcast_object_list)):
        run(name, fn)
    return out


def _rank(rank: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        print(json.dumps({"rank": rank, "ops": probe_ops(torch, dist)}),
              flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if len(sys.argv) == 3:
        _rank(int(sys.argv[1]), int(sys.argv[2]))
        return 0
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), str(port)]) for r in range(2)]
    codes = [p.wait(timeout=300) for p in procs]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    return max(codes)


if __name__ == "__main__":
    raise SystemExit(main())
