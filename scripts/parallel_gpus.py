"""Data, context, tensor, pipeline and expert parallelism across the
cards of one host.

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
   transfers in one backward), 4 steps;
5. the runtime of 3. at tp<n> and at dp2 x tp<n/2> (the llama block's
   column- and row-parallel projections, vocab-parallel embedding and
   cross entropy), 4 steps;
6. the runtime of 3. at pp<n>, <n> stages of 4 microbatches,
   double-buffered, four rows per process, 4 steps (held against the
   unpipelined job on one card);
7. ``examples/moe_expert_parallel.yaml``'s runtime (moe_8x200m, seq
   2,048) at dp1 x ep<n>: held at capacity 8.0 (no drops) on two rows
   per process, timed for 4 steps at the example's 1.25 on eight rows
   per process in two microbatches;
8. llama3_8b at tp<n>, one 4,096-token row per process (flash, remat
   full), 4 steps: its f32 weights and adamw moments (about 128 GB) do
   not fit one card, so it is held to finite losses and its per-card
   peak memory, and not against one card;
9. the runtime of 3. with adafactor at fsdp<n> (its factored moments
   and RMS reduced over the shards), 4 steps;
10. resnet50 at dp<n> (imagenet_synthetic, 32 images per process), its
   BatchNorm statistics over the global batch, 4 steps;
11. sharded serving (``ServingServer(mesh_axes={"tp": n})``, the paged
   continuous engine, 8 prompts of the 16-request mix, 32 tokens each):
   llama3_8b, its tokens held against the unsharded paged engine on one
   card on every row clear of near-ties (``chip_smoke.py`` phase 19's
   rule), and mixtral_8x7b at its full 32 layers (about 93 GB of bf16
   weights, 23 GB a card), which no card holds alone: held to
   well-formed tokens; tokens/s, the median decode step and each card's
   peak memory.

12. the axis pairs (``n`` = 4): ``pp_fsdp`` and ``pp_tp``, llama3_8b at
   full width and depth as a 2-stage pipeline of 4 microbatches (four
   4,096-token rows per process, remat full, adafactor: with AdamW the
   f32 state of the whole layer stack, which pp keeps on every stage as
   the reference stores it, is 64 GB a card at pp2 x fsdp2) at pp2 x
   fsdp2 and pp2 x tp2, each first step held against the same job at
   tp4 (``tp4_8b``, run first in the gang); ``tp_cp``, the runtime of 2.
   at tp2 x cp2, and ``tp_ep`` and ``ep_fsdp``, the runtime of 7. at
   tp2 x ep2 and fsdp2 x ep2, each held against one card; and
   ``serve_mixtral_ep``, mixtral_8x7b at its 32 layers served at ep<n>
   (each card its 8/n experts, about 23 GB, beside the replicated
   attention; decode through the dense dispatch), held to well-formed
   tokens.
13. ``elastic``, from this process through the port's plane, NCCL on
   every card and no command rewritten: (i) ``examples/packed_pretrain
   .yaml`` as a one-process plan (the gpu preset, checkpointing off),
   which the agent starts as one launcher that spans the host's cards
   as a local gang of n ranks at fsdp<n>: its first step held against
   the same job on one card, then 4 steps timed; (ii) the elastic drill:
   llama3_1b at full depth with adafactor (its factored moments keep a
   checkpoint at the parameters' 5 GB), ``{dp: 2, fsdp: n/2}``,
   checkpoints every 2 steps, run by the in-process agent over the n
   cards with chaos slice loss after the first checkpoint and capacity
   back after the third, so it trains dp2 → dp1 → dp2 with the
   default one-step prewarm child at each target; every emitted loss
   held against an unresized run of the same job, and each resize's
   seconds printed (forced save, prewarm, relaunch, restore).

``--gangs NAME,...`` runs only those (``attention``, the training
gangs' names, ``serve_8b``, ``serve_mixtral``, ``serve_mixtral_ep``,
``elastic``).

Throughput and MFU count the tokens a step trains: the ranks of a
replica axis (tp, sp, pp) train the same rows, and under cp the ranks
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
import gc
import json
import math
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
PIPE = dict(FSDP, pipeline_microbatches=4, pipeline_double_buffer=True)
PIPE_ROWS = 4  # per process: one per microbatch
MOE = {"model": "moe_8x200m", "dataset": "lm_synthetic", "seq_len": 2048,
       "attention_impl": "flash", "steps": STEPS, "log_every": 1,
       "prefetch": 0}
# Rows per process: the example's global batch of 32 over 4 cards, in
# microbatches of 4 rows as phase 11 of chip_smoke.py trains it on one
# card; held at no-drop capacity on 2 rows (its expert buffers are 6.4x
# the default's).
MOE_ROWS, MOE_ACCUM, MOE_HELD_ROWS = 8, 2, 2
LLAMA8B = {"model": "llama3_8b", "dataset": "lm_synthetic",
           "seq_len": FSDP_SEQ, "attention_impl": "flash", "remat": "full",
           "steps": STEPS, "log_every": 1, "prefetch": 0}
ADAFACTOR = dict(FSDP, optimizer="adafactor")
RESNET = {"model": "resnet50", "dataset": "imagenet_synthetic",
          "steps": STEPS, "log_every": 1, "prefetch": 0}
RESNET_ROWS = 32  # per process
# The pipelined llama3_8b gangs: 4 microbatches of one row each per
# process, adafactor (the f32 layer stack stays whole on every stage).
PIPE_8B = dict(LLAMA8B, optimizer="adafactor", pipeline_stages=2,
               pipeline_microbatches=4, pipeline_double_buffer=True)
# name: (model, mesh axes over n cards)
SERVE = {"serve_8b": ("llama3_8b", "tp"),
         "serve_mixtral": ("mixtral_8x7b", "tp"),
         "serve_mixtral_ep": ("mixtral_8x7b", "ep")}
SERVE_PROMPTS, SERVE_NEW, SERVE_HELD = 8, 32, 9


def _train(job: dict) -> dict:
    """``run_torchjob`` on ``job``; rank 0's emissions, throughput and
    last metrics (a one-step run's: the first step's), every rank's peak
    memory."""
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    emitted: list = []
    torch.cuda.reset_peak_memory_stats()
    # One card outside a gang (a gang's ranks ignore ``devices``).
    result = run_torchjob(job, device="cuda", devices=[0],
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
    """Each gang: its axes over n cards, runtime, rows per process, the
    runtime of its one-step run and of the same job on one card (None:
    not held against one card), and of its timed run, with the rows per
    process of the timed run where they differ."""
    moe_held = dict(MOE, capacity_factor=8.0)
    # llama3_8b first among the training gangs, on cards that hold
    # nothing yet (each rank draws only its shards of the f32 model).
    out = {"tp_8b": {"axes": {"tp": n}, "rows": 1, "held": None,
                     "one": None, "timed": LLAMA8B}}
    jobs = {"cp": ({"dp": 1, "cp": n}, LONGCTX, 1),
            "fsdp": ({"fsdp": n}, FSDP, FSDP_ROWS),
            "fsdp_cp": ({"fsdp": 2, "cp": n // 2}, LONGCTX, 1),
            "tp": ({"tp": n}, FSDP, FSDP_ROWS),
            "dp_tp": ({"dp": 2, "tp": n // 2}, FSDP, FSDP_ROWS)}
    out.update({name: {"axes": axes, "rows": rows, "held": runtime,
                       "one": runtime, "timed": runtime}
                for name, (axes, runtime, rows) in jobs.items()})
    out["pp"] = {"axes": {"pp": n}, "rows": PIPE_ROWS,
                 "held": dict(PIPE, pipeline_stages=n), "one": FSDP,
                 "timed": dict(PIPE, pipeline_stages=n)}
    out["ep"] = {"axes": {"dp": 1, "ep": n}, "rows": MOE_HELD_ROWS,
                 "held": moe_held, "one": moe_held,
                 "timed": dict(MOE, grad_accum_steps=MOE_ACCUM),
                 "timed_rows": MOE_ROWS}
    out["fsdp_adafactor"] = {"axes": {"fsdp": n}, "rows": FSDP_ROWS,
                             "held": ADAFACTOR, "one": ADAFACTOR,
                             "timed": ADAFACTOR}
    out["resnet_dp"] = {"axes": {"dp": n}, "rows": RESNET_ROWS,
                        "held": RESNET, "one": RESNET, "timed": RESNET}
    # The axis pairs: the pipelined llama3_8b gangs held against the same
    # job at tp<n> (``against``), the rest against one card.
    tp_8b = {k: v for k, v in PIPE_8B.items() if not k.startswith("pipe")}
    out["tp4_8b"] = {"axes": {"tp": n}, "rows": PIPE_ROWS, "held": tp_8b,
                     "one": None, "timed": None}
    for name, axes in (("pp_fsdp", {"pp": 2, "fsdp": n // 2}),
                       ("pp_tp", {"pp": 2, "tp": n // 2})):
        out[name] = {"axes": axes, "rows": PIPE_ROWS, "held": PIPE_8B,
                     "one": None, "against": "tp4_8b", "timed": PIPE_8B}
    out["tp_cp"] = {"axes": {"cp": 2, "tp": n // 2}, "rows": 1,
                    "held": LONGCTX, "one": LONGCTX, "timed": LONGCTX}
    for name, axes in (("tp_ep", {"ep": 2, "tp": n // 2}),
                       ("ep_fsdp", {"fsdp": n // 2, "ep": 2})):
        out[name] = {"axes": axes, "rows": MOE_HELD_ROWS, "held": moe_held,
                     "one": moe_held,
                     "timed": dict(MOE, grad_accum_steps=MOE_ACCUM),
                     "timed_rows": MOE_ROWS}
    return out


def _serve(rank: int, n: int, model: str, axis: str, prompts: list) -> dict:
    """``model`` served over ``axis`` of n ranks: rank 0's engine on
    ``prompts``, the tokens, tokens/s, the median decode step, every
    rank's load time and peak memory (on rank 0)."""
    import torch
    import torch.distributed as dist

    from polyaxon_tpu_torch.serving.server import ServingServer

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ServingServer(model, seed=SEED, mesh_axes={axis: n},
                           batching="continuous", kv="paged", slots=8,
                           device="cuda")
    load_s = time.perf_counter() - t0
    out: dict = {}
    if server.is_leader:
        with server:
            t1 = time.perf_counter()
            reqs = [server.engine.submit(p, SERVE_NEW) for p in prompts]
            outs = [r.wait(timeout=1200) for r in reqs]
            wall = time.perf_counter() - t1
            stats = server.engine.stats()
        out = {"serve": model, "axes": {axis: n}, "outs": outs,
               "tokens_per_s": sum(map(len, outs)) / wall,
               "decode_step_ms_median": stats["decode_step_ms_median"],
               "decode_steps": stats["decode_steps"],
               "model_calls": server.gang.calls}
    else:
        server.follow()
    torch.cuda.synchronize()
    mine = (load_s, torch.cuda.max_memory_allocated() / 1e9)
    both = [None] * n
    dist.all_gather_object(both, mine)
    out.update(load_s=[b[0] for b in both], peak_GB=[b[1] for b in both])
    del server
    return out


def _worker(rank: int, n: int, coordinator: str, out_path: str,
            gangs: tuple, prompts: list) -> None:
    import torch

    from polyaxon_tpu_torch.parallel import bootstrap

    os.environ[bootstrap.ENV_LOCAL_DEVICE_IDS] = str(rank)
    bootstrap.initialize(bootstrap.ProcessGroup(coordinator, n, rank, False),
                         device="cuda")
    try:
        lines = ([_attention(rank, n, impl) for impl in ("ring", "ulysses")]
                 if "attention" in gangs else [])
        for name, (model, axis) in SERVE.items():
            if name in gangs:
                gc.collect()
                torch.cuda.empty_cache()
                lines.append(dict(_serve(rank, n, model, axis,
                                         prompts[model]), gang=name))
        for name, job in _jobs(n).items():
            if name not in gangs:
                continue
            timed_rows = job.get("timed_rows", job["rows"])
            for steps, runtime, rows in ((1, job["held"], job["rows"]),
                                         (STEPS, job["timed"], timed_rows)):
                if runtime is None:
                    continue
                gc.collect()  # the last run's state sits in cycles
                torch.cuda.empty_cache()
                run = _train({"mesh": {"axes": job["axes"]},
                              "runtime": dict(runtime, steps=steps,
                                              global_batch_size=n * rows)})
                lines.append({"gang": name, "steps": steps,
                              "axes": job["axes"], **run})
        if rank == 0:
            with open(out_path, "w") as fh:
                fh.writelines(json.dumps(line) + "\n" for line in lines)
    finally:
        bootstrap.shutdown()


ELASTIC_EXAMPLE = "examples/packed_pretrain.yaml"
GPU_PRESET = "tests/fixtures/presets/gpu.yaml"
ELASTIC_TIMED_STEPS = 4
ELASTIC_STEPS = 10
ELASTIC_TIMEOUT = 1200


def _elastic_drill(n: int) -> dict:
    return {
        "kind": "operation",
        "termination": {"maxRetries": 1},
        "component": {"name": "elastic-drill", "run": {
            "kind": "jaxjob", "numProcesses": 1,
            "mesh": {"axes": {"dp": 2, "fsdp": n // 2}},
            "checkpointing": {"enabled": True, "intervalSteps": 2,
                              "maxToKeep": 3, "asyncSave": False,
                              "restoreOnStart": True},
            "runtime": dict(ADAFACTOR, steps=ELASTIC_STEPS,
                            global_batch_size=n * FSDP_ROWS, seed=SEED),
        }},
    }


def _plane_run(plane, agent, spec, label: str, **submit) -> tuple:
    """``spec`` submitted to the port's plane and run by ``agent`` to
    SUCCEEDED (else the rank logs' tails raise); (record, artifacts dir,
    losses by step, wall seconds)."""
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    record = plane.submit(spec, **submit)
    t0 = time.perf_counter()
    status = agent.run_until_done(record.uuid, timeout=ELASTIC_TIMEOUT)
    wall = time.perf_counter() - t0
    art = plane.run_artifacts_dir(record.uuid)
    if status != V1Statuses.SUCCEEDED:
        logs = os.path.join(art, "logs")
        tails = "".join(open(os.path.join(logs, f), errors="replace")
                        .read()[-3000:] for f in sorted(os.listdir(logs)))
        raise RuntimeError(f"{label} ended {status.value}: "
                           f"{plane.get_statuses(record.uuid)[-1]}\n{tails}")
    losses = {e["step"]: e["value"] for e in plane.streams.get_metrics(
        record.uuid, ["loss"])["loss"]}
    return plane.get_run(record.uuid), art, losses, wall


def _meshes(art: str) -> list:
    with open(os.path.join(art, "logs", "rank-0.log"),
              errors="replace") as fh:
        return [ln.split("mesh axes=")[1].strip() for ln in fh
                if "mesh axes=" in ln]


def _elastic(n: int) -> list:
    """The ``elastic`` gang's checks, run from this process."""
    import copy
    import shutil
    import tempfile

    import torch

    import chip_smoke
    from polyaxon_tpu_torch import chaos
    from polyaxon_tpu_torch.agent import Agent
    from polyaxon_tpu_torch.compiler import ENV_JAXJOB_SPEC
    from polyaxon_tpu_torch.controlplane import ControlPlane
    from polyaxon_tpu_torch.obs.trace import read_trace
    from polyaxon_tpu_torch.runtime import tiers

    checks = []
    tmp = tempfile.mkdtemp(prefix="parallel-gpus-elastic-")
    try:
        # (i) One plan process over every card.
        corpus = os.path.join(tmp, "corpus.txt")
        chip_smoke.write_corpus(corpus, chip_smoke.CORPUS_ROWS * 4096, SEED)
        plane = ControlPlane(os.path.join(tmp, "home"))
        agent = Agent(plane)
        lines = {}
        for steps in (1, ELASTIC_TIMED_STEPS):
            preset = {"isPreset": True, "patchStrategy": "post_merge",
                      "runPatch": {"numProcesses": 1,
                                   "checkpointing": {"enabled": False},
                                   "runtime": {"steps": steps,
                                               "log_every": 1}}}
            record, art, _, wall = _plane_run(
                plane, agent, os.path.join(REPO, ELASTIC_EXAMPLE),
                f"{ELASTIC_EXAMPLE} ({steps} steps)",
                params={"corpus": corpus},
                presets=[os.path.join(REPO, GPU_PRESET), preset])
            outputs = plane.streams.get_outputs(record.uuid)
            lines[steps] = {"outputs": outputs, "wall_s": wall,
                            "meshes": _meshes(art),
                            "ranks": sorted(f for f in os.listdir(
                                os.path.join(art, "logs"))
                                if f.startswith("rank-")),
                            "job": json.loads(record.launch_plan[
                                "processes"][0]["env"][ENV_JAXJOB_SPEC])}
        job = lines[1]["job"]
        one = _train(dict(job, runtime=dict(job["runtime"],
                                            grad_accum_steps=4)))
        first = lines[1]["outputs"]
        held = _held(f"{n}-card one-process {ELASTIC_EXAMPLE}",
                     {"final": {"loss": first["final_loss"],
                                "grad_norm": first["final_grad_norm"]}},
                     one)
        timed = lines[ELASTIC_TIMED_STEPS]
        held.update(
            meshes=lines[1]["meshes"], ranks=lines[1]["ranks"],
            tokens_per_s=timed["outputs"]["throughput"],
            timed_wall_s=timed["wall_s"])
        held["held"] = (held["held"] and lines[1]["meshes"]
                        == [f"{{'fsdp': {n}}} devices={n}"]
                        and len(lines[1]["ranks"]) == n)
        checks.append(held)
        print(json.dumps(held), flush=True)
        shutil.rmtree(os.path.join(tmp, "home"), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

        # (ii) The drill over every card, and the same job unresized.
        plane = ControlPlane(os.path.join(tmp, "home2"))
        agent = Agent(plane, in_process=True)
        ref = copy.deepcopy(_elastic_drill(n))
        ref["component"]["run"]["checkpointing"] = {"enabled": False}
        _, _, want, ref_wall = _plane_run(plane, agent, ref, "unresized")
        chaos.install(chaos.ChaosPlan.from_dict({"seed": SEED, "faults": [
            {"seam": "slice-loss", "op": "kill",
             "config": {"min_checkpoints": 1}},
            {"seam": "slice-loss", "op": "restore",
             "config": {"min_checkpoints": 3}}]}))
        try:
            record, art, got, wall = _plane_run(plane, agent,
                                                _elastic_drill(n), "elastic")
        finally:
            chaos.uninstall()
            tiers.TIER0.clear()
        audit = record.meta.get("elastic") or {}
        trace = read_trace(art)
        segments = chip_smoke._segments(trace)
        resizes = sorted((r for r in trace if r.get("name") == "resize"
                          and r.get("end") is not None),
                         key=lambda r: r["start"])
        parts = []
        for i, rz in enumerate(resizes[:len(segments) - 1]):
            before, after = segments[i], segments[i + 1]
            final = [c for c in before["saves"]
                     if c["attributes"].get("final")]
            restore = after["restore"] or {}
            parts.append({
                "direction": rz["attributes"]["direction"],
                "at_step": rz["attributes"]["from_step"],
                "forced_save_s": final[-1]["duration_ms"] / 1e3
                if final else None,
                "prewarm_s": rz["duration_ms"] / 1e3,
                "relaunch_s": (restore["start"] - rz["end"]
                               if restore else None),
                "restore_s": restore.get("duration_ms", 0) / 1e3,
                "restore_tier": (restore.get("attributes") or {}).get(
                    "restore_tier")})
        rel = {s: abs(got[s] - want[s]) / abs(want[s])
               for s in got if s in want}
        worst = max(rel.values(), default=float("inf"))
        stops = [json.loads(ln)["outputs"]["stop_check_ms"]
                 for ln in open(os.path.join(art, "logs", "rank-0.log"),
                                errors="replace")
                 if ln.startswith('{"outputs"')]
        check = {
            "check": f"{n}-card elastic drill dp2 x fsdp{n // 2} -> dp1 -> "
                     f"dp2 against the unresized run",
            "attempts": [(a["direction"], a["outcome"], a["from_devices"],
                          a["to_devices"], a.get("duration_s"))
                         for a in audit.get("attempts", [])],
            "meshes": _meshes(art),
            "segments": [{"devices": s["devices"], "steps": s["steps"],
                          "step_ms": s["step_ms"]} for s in segments],
            "resizes": parts, "losses": got, "unresized": want,
            "loss_rel": rel, "stop_check_ms": stops,
            "restore": record.meta.get("checkpoint"),
            "wall_s": wall, "unresized_wall_s": ref_wall,
            "held": ([(a["direction"], a["outcome"])
                      for a in audit.get("attempts", [])]
                     == [("shrink", "ok"), ("grow", "ok")]
                     and record.retries == 0
                     and plane.streams.get_outputs(
                         record.uuid)["steps"] == ELASTIC_STEPS
                     and len(rel) >= 3 and set(got) <= set(want)
                     and worst <= chip_smoke.TRAIN_LOSS_REL_TOL
                     and all(map(math.isfinite, got.values())))}
        checks.append(check)
        print(json.dumps(check), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return checks


def _held(label: str, gang: dict, one: dict,
          against: str = "one card") -> dict:
    import chip_smoke

    g, o = gang["final"], one["final"]
    loss_rel = abs(g["loss"] - o["loss"]) / abs(o["loss"])
    norm_rel = abs(g["grad_norm"] - o["grad_norm"]) / abs(o["grad_norm"])
    return {"check": f"{label} first step against {against}",
            "loss": [g["loss"], o["loss"]], "loss_rel": loss_rel,
            "grad_norm": [g["grad_norm"], o["grad_norm"]],
            "grad_norm_rel": norm_rel,
            "held": loss_rel <= chip_smoke.TRAIN_LOSS_REL_TOL
            and norm_rel <= chip_smoke.TRAIN_GRAD_REL_TOL}


def _reference_8b(prompts: list) -> dict:
    """llama3_8b's unsharded paged engine on one card: its tokens, and
    which of each row's first SERVE_HELD tokens are clear of a near-tie
    (``chip_smoke.py`` phase 19's rule)."""
    import torch

    import chip_smoke
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    cfg, params = load_params("llama3_8b", seed=SEED, device="cuda")
    eng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=8,
                                   kv="paged", page_size=16, device="cuda")
    try:
        outs = [r.wait(timeout=1200) for r in
                [eng.submit(p, SERVE_NEW) for p in prompts]]
    finally:
        eng.stop()
    clear = []
    for p, o in zip(prompts, outs):
        lw = chip_smoke._gang_logits(torch, llama, cfg, params, p,
                                     o[:SERVE_HELD], device="cuda")
        top2 = torch.topk(lw, 2, dim=-1).values
        clear.append(((top2[:, 0] - top2[:, 1])
                      >= chip_smoke._tie_tol(torch, lw)).tolist())
    return {"outs": outs, "clear": clear}


def _served(line: dict, reference: dict, vocab: int) -> dict:
    """A served run's check: well-formed tokens, and against the one-card
    reference (when there is one) equal over each row's first
    SERVE_HELD tokens up to a first divergence at a near-tie."""
    outs = line["outs"]
    ok = all(len(o) == SERVE_NEW and all(0 <= t < vocab for t in o)
             for o in outs)
    parted = {}
    if reference is not None:
        for i, (a, b) in enumerate(zip(outs, reference["outs"])):
            j = next((t for t, (x, y) in enumerate(zip(
                a[:SERVE_HELD], b[:SERVE_HELD])) if x != y), None)
            if j is not None:
                parted[i] = j
                ok = ok and not reference["clear"][i][j]
    axes = "x".join(f"{a}{k}" for a, k in line["axes"].items())
    return {"check": f"{axes} serving {line['serve']}",
            "tokens_per_s": line["tokens_per_s"],
            "decode_step_ms_median": line["decode_step_ms_median"],
            "peak_GB": line["peak_GB"], "load_s": line["load_s"],
            "rows_parted": parted,
            "against": "one card" if reference is not None else None,
            "held": bool(ok)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gpus", type=int, default=4)
    parser.add_argument("--gangs", default=None,
                        help="comma-separated runs (default: all)")
    args = parser.parse_args()
    n = args.gpus
    gangs = tuple(args.gangs.split(",") if args.gangs else
                  ("attention", *_jobs(n), *SERVE, "elastic"))

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
    import chip_smoke

    from polyaxon_tpu_torch.models import family_of

    vocab = {m: family_of(m).CONFIGS[m].vocab_size
             for m, _ in SERVE.values()}
    prompts = {m: chip_smoke.make_prompts(v)[:SERVE_PROMPTS]
               for m, v in vocab.items()}
    reference = {}
    if "serve_8b" in gangs:
        reference["llama3_8b"] = _reference_8b(prompts["llama3_8b"])
        gc.collect()
        torch.cuda.empty_cache()
    one = {}
    jobs = _jobs(n)
    if {"pp_fsdp", "pp_tp"} & set(gangs) and "tp4_8b" not in gangs:
        gangs = ("tp4_8b", *gangs)  # what the pipelined gangs are held to
    for name, job in jobs.items():
        if job["one"] is None or name not in gangs:
            continue
        one[name] = _train({"mesh": {"axes": {a: 1 for a in job["axes"]}},
                            "runtime": dict(job["one"], steps=1,
                                            global_batch_size=job["rows"])})
        print(json.dumps({"one card": name, **one[name]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    checks = _elastic(n) if "elastic" in gangs else []
    out_path = os.path.join(REPO, "chiprun_out", "parallel_gpus.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    lines = []
    if set(gangs) - {"elastic"}:
        mp.start_processes(_worker, nprocs=n, start_method="spawn",
                           args=(n, f"127.0.0.1:{bootstrap.free_port()}",
                                 out_path, gangs, prompts))
        with open(out_path) as fh:
            lines = [json.loads(line) for line in fh]
    for line in lines:
        print(json.dumps(line), flush=True)
        if "check" in line:
            checks.append(line)
        elif "serve" in line:
            checks.append(_served(line, reference.get(line["serve"])
                                  if line["gang"] == "serve_8b" else None,
                                  vocab[line["serve"]]))
            print(json.dumps(checks[-1]), flush=True)
        elif line["steps"] == 1 and line["gang"] in one:
            checks.append(_held(f"{n}-card {line['gang']}", line,
                                one[line["gang"]]))
            print(json.dumps(checks[-1]), flush=True)
        elif line["steps"] == 1 and "against" in jobs[line["gang"]]:
            against = jobs[line["gang"]]["against"]
            first = next(x for x in lines if x.get("gang") == against)
            checks.append(_held(f"{n}-card {line['gang']}", line, first,
                                f"the same job at {against}"))
            print(json.dumps(checks[-1]), flush=True)
        elif line["gang"] == "tp_8b":
            losses = [e["loss"] for e in line["emitted"]]
            checks.append({"check": f"{n}-card tp_8b finite", "losses": losses,
                           "peak_GB": line["peak_GB"],
                           "held": len(losses) == STEPS - 1 and all(
                               map(math.isfinite, losses))})
            print(json.dumps(checks[-1]), flush=True)
    # The two attention checks, each held gang's first step, the
    # llama3_8b run, each served model and the two elastic checks.
    want = (2 * ("attention" in gangs) + 2 * ("elastic" in gangs)
            + sum(1 for name, job in jobs.items()
                  if name in gangs and (job["one"] is not None
                                        or "against" in job))
            + ("tp_8b" in gangs) + sum(1 for s in SERVE if s in gangs))
    ok = len(checks) == want and all(c["held"] for c in checks)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
