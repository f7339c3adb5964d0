#!/usr/bin/env python3
"""Compare checkouts on one GPU: the wall time of each phase of their
``chip_smoke.py``, or of the LoRA phase's training alone.

    python3 scripts/smoke_phases.py ROOT [ROOT ...] --out DIR
    python3 scripts/smoke_phases.py ROOT [ROOT ...] --out DIR --lora
    python3 scripts/smoke_phases.py ROOT [ROOT ...] --out DIR --call NAME

Each ROOT is a checkout; each runs in a fresh process, in the order
given (list one twice to interleave, e.g. ``A B B A``).

- By default the checkout's ``chip_smoke.py`` runs whole, with every
  module-level function that its ``main()`` reaches timed (a call inside
  another timed call is recorded beside its depth). Its output goes to
  ``DIR/<i>.log``; the calls to ``DIR/<i>.json``.
- With ``--lora``, only the training of the LoRA phase: the runtime of
  ``examples/lora_finetune.yaml`` as the checkout's ``lora_phase`` sets
  it (llama3_8b at full depth, LORA_STEPS steps of LORA_BATCH rows in
  microbatches of one), without checkpoints, through the checkout's
  ``compile_example`` and ``launch_in_process``; each step's time and
  tokens/s go to ``DIR/<i>.json``.
- With ``--call NAME``, one phase function of the checkout's script
  (e.g. ``moe_training``, ``ep_replay``) after its kernels are built,
  its arguments by name (``torch``, ``llama``, ``flash``, ``paged``);
  its output goes to ``DIR/<i>.log``, its wall time to ``DIR/<i>.json``.

The last line is one JSON object: per run, its root and its phase (or
step) times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r'''
import functools, inspect, json, os, sys, time
root, out, mode = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
os.chdir(root)
import chip_smoke as cs

if mode.startswith("call:"):
    import torch
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.ops import _build, flash, paged_attention
    _build.build_all()
    fn = getattr(cs, mode[len("call:"):])
    args = {"torch": torch, "llama": llama, "flash": flash,
            "paged": paged_attention}
    t0 = time.perf_counter()
    fn(*(args[p] for p in inspect.signature(fn).parameters))
    rec = {"call": fn.__name__, "s": round(time.perf_counter() - t0, 3)}
elif mode == "lora":
    import tempfile
    import torch
    from polyaxon_tpu_torch.ops import _build
    _build.build_all()
    runtime = {"steps": cs.LORA_STEPS, "global_batch_size": cs.LORA_BATCH,
               "grad_accum_steps": cs.LORA_BATCH, "log_every": 1}
    job = cs.compile_example(cs.LORA_EXAMPLE, "lora", axes=("fsdp",),
                             runtime=runtime)
    job["checkpointing"] = {"enabled": False}
    with tempfile.TemporaryDirectory() as tmp:
        emitted, outputs, launches, wall = cs.launch_in_process(job, tmp,
                                                                "lora")
    rec = {"step_ms": [e["step_time_ms"] for e in emitted],
           "tokens_per_s": [e["tokens_per_sec"] for e in emitted],
           "throughput": outputs["throughput"], "wall_s": wall,
           "launches": launches}
else:
    calls, depth, t_start = [], [0], time.perf_counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                calls.append({"name": name, "depth": depth[0],
                              "start_s": round(t0 - t_start, 3),
                              "s": round(time.perf_counter() - t0, 3)})
        return run

    for name, fn in list(vars(cs).items()):
        if (inspect.isfunction(fn) and fn.__module__ == cs.__name__
                and name not in ("main", "fail") and not name.startswith("_")):
            setattr(cs, name, timed(name, fn))
    try:
        cs.main()
    finally:
        rec = {"calls": calls, "total_s": round(time.perf_counter() - t_start, 3)}
with open(out, "w") as fh:
    json.dump(rec, fh)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--lora", action="store_true")
    ap.add_argument("--call", metavar="NAME")
    args = ap.parse_args()
    mode = ("call:" + args.call if args.call else
            "lora" if args.lora else "whole")
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    runs, rc = [], 0
    for i, root in enumerate(args.roots):
        root = os.path.abspath(root)
        rec_path = os.path.join(args.out, f"{i}.json")
        with open(os.path.join(args.out, f"{i}.log"), "w") as log:
            proc = subprocess.run(
                [sys.executable, "-u", "-c", _CHILD, root, rec_path, mode],
                stdout=log, stderr=subprocess.STDOUT, cwd=root)
        rec = {}
        if os.path.exists(rec_path):
            with open(rec_path) as fh:
                rec = json.load(fh)
        rc = rc or proc.returncode
        if "calls" in rec:
            # main()'s own calls and theirs, in the order they ended.
            rec["phases_s"] = [[c["name"], c["depth"], c["s"]]
                               for c in rec.pop("calls") if c["depth"] <= 1]
        runs.append({"root": root, "rc": proc.returncode, **rec})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
