#!/usr/bin/env python3
"""Where a llama3_8b serving step spends its time in the PyTorch port.

    python3 scripts/profile_torch_serving.py [--rows 8] [--pos 1000]

On one GPU: random bf16 llama3_8b weights (seeded), a paged KV pool
holding ``--rows`` rows at ragged positions around ``--pos``, then

- the decode step (``decode_step_paged``, every layer through the paged
  decode kernel): host wall time per step over 20 steps, then one
  ``torch.profiler`` window of 5 steps giving device busy time per step,
  the device idle share and device time by kernel;
- the prefill pass (``paged_prefill_kv``) of one 2048-token prompt,
  measured the same way (flash kernel against the projections).

Prints one line per measurement and the card's name and power limit.
Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _category(name: str) -> str:
    low = name.lower()
    if "paged_decode_kernel" in low:  # the merge runs inside it
        return "paged_decode kernel"
    if "flash_fwd_kernel" in low:
        return "flash_fwd kernel"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
        return "matmul (cuBLAS)"
    if "index" in low or "scatter" in low or "gather" in low:
        return "index/scatter"
    if "reduce" in low:
        return "reductions"
    return "elementwise/other"


def profile(torch, fn, steps: int, label: str) -> None:
    """Host wall time per call over 20 unprofiled calls, then one
    profiler window of ``steps`` calls: device time by category and by
    kernel, and the device idle share of the unprofiled wall time (the
    profiler itself slows the host side)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / 20
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit(f"{label}: the profiler saw no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_cat: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        by_cat[_category(e.name)] += e.time_range.elapsed_us()
        by_name[e.name] += e.time_range.elapsed_us()
    busy = busy_us / 1e6 / steps
    print(f"{label}: host_wall_ms_per_call={plain_wall * 1e3:.3f} "
          f"device_busy_ms_per_call={busy * 1e3:.3f} "
          f"device_idle_share={1 - busy / plain_wall:.3f} "
          f"profiled_wall_ms_per_call={wall * 1e3 / steps:.3f} "
          f"kernels_per_call={len(kernels) / steps:.0f}", flush=True)
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label} {cat}: {us / 1e3 / steps:.3f} ms/call "
              f"({us / busy_us:.1%})", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {label} top: {us / 1e3 / steps:.3f} ms/call {name[:90]}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--pos", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.serving.server import load_params

    cfg, params = load_params("llama3_8b", seed=args.seed, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    B, page = args.rows, 16
    pos = torch.tensor([max(args.pos + 97 * i - 48 * B, 0) for i in range(B)],
                       dtype=torch.long, device="cuda")
    maxp = int(pos.max()) // page + 2
    cache = llama.paged_init_cache(cfg, B * maxp + 1, page, device="cuda")
    for t in cache.values():
        t.normal_(generator=gen)
    tables = torch.arange(1, B * maxp + 1, device="cuda").reshape(B, maxp)
    tokens = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                           device="cuda")

    def step():
        llama.decode_step_paged(cfg, params, cache, tokens, pos, tables)

    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"decode rows={B} positions={pos.tolist()} weights_GB="
          f"{weights / 1e9:.2f}", flush=True)
    with torch.no_grad():
        profile(torch, step, 5, "decode")
        prompt = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen,
                               device="cuda")
        profile(torch, lambda: llama.paged_prefill_kv(cfg, params, prompt),
                3, "prefill2048")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(out, flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
