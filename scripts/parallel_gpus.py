"""Data and context parallelism across the cards of one host.

    python3 scripts/parallel_gpus.py [--gpus 4]

Starts one process per card (the port's bootstrap: an NCCL group over a
loopback coordinator, each process on ``cuda:<rank>``) and, on a mesh
over all of them:

1. ring and Ulysses attention on llama3_1b's 32,768-token row (B=1,
   32:8 heads, D=64, bf16, each rank its sequence shard), forward and
   backward, gathered and held against ``flash_attention`` on the whole
   row on rank 0 (``chip_smoke.py``'s output and gradient tolerances),
   each timed over 5 calls;
2. ``examples/longcontext_ring.yaml``'s runtime (llama3_1b, 32,768
   tokens, ring, remat full) at dp1 x cp<n>, 4 steps;
3. llama3_1b at fsdp<n> (lm_synthetic rows of 4,096 tokens, two per
   process, flash, remat dots), 4 steps;
4. the runtime of 2. at fsdp2 x cp<n/2> (the fsdp gathers and the ring's
   transfers in one backward), 4 steps.

Throughput and MFU count the tokens a step trains: under cp the ranks
of a batch shard cut the same rows into sequence shards.

Every process draws the same rows, as the reference's processes do, so
a gang's first step computes the loss and gradient norm of one
process's rows: each gang's one-step run is held against the same job
run first on one card in this process (``chip_smoke.py``'s
TRAIN_LOSS_REL_TOL and TRAIN_GRAD_REL_TOL). Prints the cards' names
and power limits, one JSON line per run and check, and exits non-zero
on any disagreement.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 0
SEQ = 32_768
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 64
STEPS = 4
FSDP_SEQ = 4096
FSDP_ROWS = 2  # per process
REPS = 5

LONGCTX = {"model": "llama3_1b", "dataset": "lm_synthetic", "seq_len": SEQ,
           "attention_impl": "ring", "remat": "full", "steps": STEPS,
           "log_every": 1, "prefetch": 0}
FSDP = {"model": "llama3_1b", "dataset": "lm_synthetic",
        "seq_len": FSDP_SEQ, "attention_impl": "flash", "remat": "dots",
        "steps": STEPS, "log_every": 1, "prefetch": 0}


def _train(job: dict) -> dict:
    """``run_torchjob`` on ``job``; rank 0's emissions, throughput and
    last metrics (a one-step run's: the first step's), every rank's peak
    memory."""
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    emitted: list = []
    torch.cuda.reset_peak_memory_stats()
    result = run_torchjob(job, device="cuda",
                          on_metrics=lambda s, v: emitted.append(
                              {"step": s, **v}))
    peak = torch.cuda.max_memory_allocated() / 1e9
    peaks = [peak]
    if dist.is_initialized():
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
    return {"emitted": emitted, "tokens_per_s": result.throughput,
            "final": result.final_metrics, "peak_GB": peaks}


def _attention(rank: int, n: int, impl: str) -> dict:
    """One impl's check and time; the result on rank 0."""
    import torch
    import torch.distributed as dist

    import chip_smoke
    from polyaxon_tpu_torch.ops.flash import flash_attention
    from polyaxon_tpu_torch.ops.ring import ring_attention
    from polyaxon_tpu_torch.ops.ulysses import ulysses_attention
    from polyaxon_tpu_torch.parallel.mesh import build_mesh, use_mesh

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(1, SEQ, h, HEAD_DIM, generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for h in (HEADS, KV_HEADS, KV_HEADS, HEADS))
    shard = slice(rank * SEQ // n, (rank + 1) * SEQ // n)
    local = [x[:, shard].contiguous().requires_grad_(True)
             for x in (q, k, v)]
    mesh = build_mesh(axes={"cp": n}, device_type="cuda")
    if impl == "ring":
        def attn(*a):
            return ring_attention(*a, causal=True)
    else:
        def attn(*a):
            return ulysses_attention(*a, causal=True, attn_impl="flash")

    def call():
        o = attn(*local)
        return o, torch.autograd.grad(o, local, do[:, shard].contiguous())

    with use_mesh(mesh):
        o, grads = call()
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(REPS):
            call()
        torch.cuda.synchronize()
        dist.barrier()
        ms = 1e3 * (time.perf_counter() - t0) / REPS

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=1)

    got = [gather(t) for t in (o, *grads)]
    if rank:
        return {}
    whole = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref_o = flash_attention(*whole, causal=True)
    ref = [ref_o, *torch.autograd.grad(ref_o, whole, do)]
    errs = {}
    ok = chip_smoke.close(got[0], ref[0])
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref):
        errs[name] = (g.float() - r.float()).abs().max().item()
        if name != "o":
            ok = ok and chip_smoke._bwd_close(g, r)
    return {"check": f"{impl} attention", "cp": n, "seq": SEQ,
            "ms_fwd_bwd": ms, "max_abs_err": errs, "held": bool(ok)}


def _jobs(n: int) -> dict:
    """Each gang's (axes over n cards, runtime, rows per process)."""
    return {"cp": ({"dp": 1, "cp": n}, LONGCTX, 1),
            "fsdp": ({"fsdp": n}, FSDP, FSDP_ROWS),
            "fsdp_cp": ({"fsdp": 2, "cp": n // 2}, LONGCTX, 1)}


def _worker(rank: int, n: int, coordinator: str, out_path: str) -> None:
    import torch

    from polyaxon_tpu_torch.parallel import bootstrap

    os.environ[bootstrap.ENV_LOCAL_DEVICE_IDS] = str(rank)
    bootstrap.initialize(bootstrap.ProcessGroup(coordinator, n, rank, False),
                         device="cuda")
    try:
        lines = [_attention(rank, n, impl) for impl in ("ring", "ulysses")]
        for name, (axes, runtime, rows) in _jobs(n).items():
            for steps in (1, STEPS):
                torch.cuda.empty_cache()
                run = _train({"mesh": {"axes": axes}, "runtime": dict(
                    runtime, steps=steps, global_batch_size=n * rows)})
                lines.append({"gang": name, "steps": steps, **run})
        if rank == 0:
            with open(out_path, "w") as fh:
                fh.writelines(json.dumps(line) + "\n" for line in lines)
    finally:
        bootstrap.shutdown()


def _held(label: str, gang: dict, one: dict) -> dict:
    import chip_smoke

    g, o = gang["final"], one["final"]
    loss_rel = abs(g["loss"] - o["loss"]) / abs(o["loss"])
    norm_rel = abs(g["grad_norm"] - o["grad_norm"]) / abs(o["grad_norm"])
    return {"check": f"{label} first step against one card",
            "loss": [g["loss"], o["loss"]], "loss_rel": loss_rel,
            "grad_norm": [g["grad_norm"], o["grad_norm"]],
            "grad_norm_rel": norm_rel,
            "held": loss_rel <= chip_smoke.TRAIN_LOSS_REL_TOL
            and norm_rel <= chip_smoke.TRAIN_GRAD_REL_TOL}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gpus", type=int, default=4)
    n = parser.parse_args().gpus

    import torch
    import torch.multiprocessing as mp

    from polyaxon_tpu_torch.parallel import bootstrap

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"needs {n} CUDA devices", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)
    from polyaxon_tpu_torch.ops import _build

    _build.build_all()
    one = {}
    for name, (axes, runtime, rows) in _jobs(n).items():
        one[name] = _train({"mesh": {"axes": {a: 1 for a in axes}},
                            "runtime": dict(runtime, steps=1,
                                            global_batch_size=rows)})
        print(json.dumps({"one card": name, **one[name]}), flush=True)
        torch.cuda.empty_cache()

    out_path = os.path.join(REPO, "chiprun_out", "parallel_gpus.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    mp.start_processes(_worker, nprocs=n, start_method="spawn",
                       args=(n, f"127.0.0.1:{bootstrap.free_port()}", out_path))
    with open(out_path) as fh:
        lines = [json.loads(line) for line in fh]
    checks = []
    for line in lines:
        print(json.dumps(line), flush=True)
        if "check" in line:
            checks.append(line)
        elif line["steps"] == 1:
            checks.append(_held(f"{n}-card {line['gang']}", line,
                                one[line["gang"]]))
            print(json.dumps(checks[-1]), flush=True)
    # The two attention checks and each gang's first step.
    ok = len(checks) == 2 + len(_jobs(n)) and all(c["held"] for c in checks)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
