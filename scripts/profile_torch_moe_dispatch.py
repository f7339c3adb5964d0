#!/usr/bin/env python3
"""Time and profile the ragged MoE dispatch of checkouts on one GPU.

    python3 scripts/profile_torch_moe_dispatch.py ROOT [ROOT ...]

For each checkout, in a fresh process: ``models/moe.py``'s
``_moe_ragged_sharded`` at moe_8x200m's training microbatch (4 x 2048
tokens, D=1024, 8 experts, top-2, bf16, layer 0's weights from seed 0)
on one device, forward and backward: the median of 20 calls by CUDA
events, then one profiled call (``torch.profiler``): the kernels it
launches and the device time of the 15 longest. One JSON line per
checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r'''
import dataclasses, json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from polyaxon_tpu_torch.models import moe

cfg = dataclasses.replace(moe.CONFIGS["moe_8x200m"], n_layers=1)
params = moe.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                  device="cuda", param_dtype=torch.bfloat16)["params"]
w = [params["layers"][k][0].detach().requires_grad_(True)
     for k in ("router", "w_gate", "w_up", "w_down")]
gen = torch.Generator(device="cuda").manual_seed(1)
x = torch.randn(4 * 2048, cfg.dim, generator=gen, device="cuda",
                dtype=torch.bfloat16).requires_grad_(True)


def call():
    out, aux = moe._moe_ragged_sharded(cfg, x, *w)
    (out.float().sum() + aux).backward()


for _ in range(3):
    call()
times = []
for _ in range(20):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    call()
    b.record()
    torch.cuda.synchronize()
    times.append(a.elapsed_time(b))
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    call()
    torch.cuda.synchronize()
kernels = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
kernels.sort(key=lambda e: -e.self_device_time_total)
print(json.dumps({
    "root": root, "ms_median": sorted(times)[len(times) // 2],
    "ms_all": [round(t, 3) for t in times],
    "kernel_launches": sum(e.count for e in kernels),
    "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
    "top": [[e.key[:70], e.count, round(e.self_device_time_total / 1e3, 4)]
            for e in kernels[:15]]}), flush=True)
'''


def main() -> int:
    rc = 0
    for root in sys.argv[1:]:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root], cwd=root,
                              capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("{")), None)
        print(line or json.dumps({"root": root, "rc": proc.returncode,
                                  "stderr": proc.stderr[-2000:]}),
              flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
