#!/usr/bin/env python3
"""Where a training step spends its time in the PyTorch port.

    python3 scripts/profile_torch_training.py [--model gemma_2b] [--accum 4] [--steps 2]

On one GPU, a training step of ``chip_smoke.py``'s main path: llama3_1b
(global batch 16) or gemma_2b (global batch 4) at full width and depth
(f32 master weights from a seed, bf16 compute), packed 4096-token rows
(``lm_packed_synthetic``) in ``--accum`` microbatches, remat "dots", flash
attention (forward and backward kernels), adamw. After one warm-up step
it prints

- the host wall time per step over ``--steps`` unprofiled steps, with
  tokens/s and MFU against the card's dense bf16 peak;
- one ``torch.profiler`` step: device busy time, the device idle share
  of the unprofiled step, and device time by kernel class (matmul, the
  flash forward kernel, the two flash backward kernels, the optimizer
  update, and the elementwise rest: norms, RoPE, activations, casts, the
  loss, gradient assembly), then the top kernels;
- peak device memory, and the card's name and power limit.

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


# Global batch of each model's training setup in ``chip_smoke.py``.
BATCH = {"llama3_1b": 16, "gemma_2b": 4}


def _category(name: str) -> str:
    low = name.lower()
    if "flash_bwd" in low:
        return "flash_bwd kernels"
    if "flash_fwd_kernel" in low:
        return "flash_fwd kernel"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
        return "matmul (cuBLAS)"
    return "elementwise/other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(BATCH), default="llama3_1b")
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from polyaxon_tpu_torch.models import get_model, llama
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic
    from polyaxon_tpu_torch.runtime.flops import (peak_flops,
                                                  train_flops_per_token)
    from polyaxon_tpu_torch.runtime.optim import build_optimizer, tree_leaves
    from polyaxon_tpu_torch.runtime.step import build_init, build_train_step

    seq, batch = 4096, BATCH[args.model]
    model_def = get_model(args.model, remat="dots", attention_impl="flash",
                          max_seq_len=seq)
    opt = build_optimizer(RuntimeConfig.from_dict(dict(
        model=args.model, steps=10, learning_rate=3e-4,
        lr_schedule="cosine")))
    update = opt.update

    def annotated_update(*a, **kw):
        with record_function("optimizer"):
            return update(*a, **kw)

    opt.update = annotated_update
    state = build_init(model_def, opt, device="cuda")(args.seed)
    step = build_train_step(model_def, opt, accum_steps=args.accum)
    stream = lm_packed_synthetic(
        batch, seq_len=seq, vocab_size=llama.CONFIGS[args.model].vocab_size,
        seed=args.seed)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(stream).items()}
               for _ in range(2)]

    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batches[0])  # warm-up: kernel builds, caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, metrics = step(state, batches[i % 2])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    tokens = batch * seq
    flops = train_flops_per_token(args.model, seq, n_params) * tokens
    peak = peak_flops(torch.cuda.get_device_name(0))
    print(f"train {args.model} accum={args.accum} tokens_per_step={tokens}: "
          f"host_wall_ms_per_step={wall * 1e3:.1f} "
          f"tokens_per_s={tokens / wall:.1f} "
          f"mfu={flops / wall / peak if peak else float('nan'):.4f} "
          f"loss={float(metrics['loss']):.5f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batches[0])
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        sys.exit("the profiler saw no device activity")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_cat: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        by_cat[_category(e.name)] += e.time_range.elapsed_us()
        by_name[e.name] += e.time_range.elapsed_us()
    # The optimizer's kernels are elementwise ones launched inside its
    # annotation: move their time out of the elementwise class.
    opt_us = sum(e.device_time_total for e in events
                 if e.name == "optimizer"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    by_cat["optimizer (adamw + clip)"] = opt_us
    by_cat["elementwise/other"] -= opt_us
    busy = busy_us / 1e6
    print(f"profile: device_busy_ms_per_step={busy * 1e3:.1f} "
          f"device_idle_share={max(0.0, 1 - busy / wall):.3f} "
          f"kernels_per_step={len(kernels)}", flush=True)
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {us / 1e3:.1f} ms/step ({us / busy_us:.1%})",
              flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  top: {us / 1e3:.1f} ms/step {name[:90]}", flush=True)
    print(f"max_memory_allocated_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(out, flush=True)


if __name__ == "__main__":
    main()
