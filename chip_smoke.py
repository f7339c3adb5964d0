#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``polyaxon_tpu_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which must pass:

1. Build every kernel of the serving and training paths from
   ``ops/csrc`` with nvcc (all builds in parallel) and hold each kernel
   against its plain PyTorch version at the paths' shapes: the flash
   forward at llama3_8b prefill (a ragged length and 2048), at the
   llama3_1b training microbatch (B=4, S=4096, D=64, packed segments) and
   at gemma_2b's (S=4096, D=256, MQA 8:1, causal and with a window); paged
   decode at four cases (``decode_cases``: llama3_8b at 8 ragged rows
   with a hole and an idle row, at 8 long rows, gemma_2b's MQA, llama3_1b
   at 64 rows; one split and several must both be held, two calls must
   agree bitwise), timed by CUDA-graph replay with a cold L2, and two
   streams launching multi-split decode at once, in a loop (each must
   match the plain version); the flash backward pair at llama3_1b's packed training microbatch (B=4,
   the dK/dV kernel's in-block group loop, as training runs it), at the
   same row alone (B=1), at gemma_2b's packed shape and at a ragged length
   with GQA 4:1 at head_dim 128 (these three through its head-split grid;
   each case prints its split count, and both grids must be held). Times
   each kernel, its plain version
   and, where one PyTorch call computes the same function,
   ``F.scaled_dot_product_attention`` (forward or backward) as a
   yardstick the port never calls; the backward pair also with the
   training path's packed segments.
2. The serving path: ``ContinuousBatchingEngine`` over llama3_8b at full
   width and depth (random bf16 weights from a seed), 16 requests of
   mixed lengths, some sharing a prefix. The kernels' launch counts are
   zeroed just before and read just after; both must have moved, and the
   page pool's invariants must hold. The first admission's prefill KV
   and first decode logits are then held against the plain path.
3. ``ServingServer`` answers two concurrent ``POST /v1/generate``.
4. The training path: ``run_torchjob`` trains llama3_1b at full width
   and depth (f32 master weights from a seed, bf16 compute) on packed
   4096-token rows, global batch 16 in 4 microbatches, remat "dots",
   flash attention, adamw with a cosine schedule, for 6 steps. The three
   flash counters are zeroed just before and read just after: each
   backward kernel must run once per layer and microbatch, and every
   loss and gradient norm must be finite.
5. First-step parity: one packed 1x4096 microbatch through the kernel
   path (remat "none" and "dots") and the plain path (einsum attention)
   from the same weights; the loss and three named gradients must agree.
   Each backward call of a kernel run must agree, on its own inputs, with
   the plain backward that rounds P and dS to bf16 as the kernels do, and
   the kernel path's gradients with those of the forward kernel and the
   f32 plain backward.
6. The training path at head_dim 256: ``run_torchjob`` trains gemma_2b at
   full width and depth (18 layers, MQA 8:1, 2.51 B parameters) on packed
   4096-token rows, global batch 4 in 4 microbatches, for 3 steps, with
   the counters checked as in phase 4.
7. The checkpoint drill: phase 4's job with checkpoints every 2 steps
   (one kept, saved asynchronously), launched as
   ``python -m polyaxon_tpu_torch.runtime.launch`` in a temporary
   artifacts directory and SIGKILLed as soon as the store lists a
   committed step, then started again on the same directory: it must
   restore that step from the spill or the store, reach step 6 and exit
   0, with each backward kernel launched once per layer, microbatch and
   step it trained. Its losses are held against an uninterrupted run at
   its depth (phase 4's at full depth; bitwise if a second uninterrupted
   run repeats the first bitwise, else within three times the two runs'
   spread), the tracking record is read back (loss
   events, outputs, statuses, GPU memory samples), the checkpoint is
   restored here and its leaf CRC-32s held against the manifest, and
   tier 0 is timed here (the replica a spill restore promotes, then a
   snapshot published as the replica), with no further disk write. The
   drill's files go to a fresh temporary directory; its depth is cut
   only if three checkpoints do not fit in the free disk or in
   DRILL_DISK_BUDGET, or the launcher's snapshot in host memory.
8. The paged engine serves the drill's checkpoint: two requests of 16
   new tokens (flash forward and paged decode at head_dim 64, counters
   zeroed before and read after), then the first admission against the
   plain path.
9. Polyaxonfile to launcher: ``examples/packed_pretrain.yaml``, as it is,
   compiled by the port's ``polyaxonfile`` and ``compiler`` with the gpu
   preset and H100_PRESET (one process, phase 4's steps and
   microbatches) on a synthetic text corpus from SEED (``lm_text_packed``,
   the bytes tokenizer), in a fresh temporary directory. The plan must
   hold one process that runs the port's launcher; that process is run as
   the JAX package's executor runs one (its env, the coordinator
   placeholder replaced, its log under ``<artifacts>/logs``). It must
   exit 0 with statuses running then succeeded, a finite loss event per
   trained step, 6 steps in its outputs and a committed step 6, restored
   here and held against the manifest's CRC-32s; each backward kernel
   launched once per layer, microbatch and step, the forward twice as
   often. Its tokens/s and MFU print beside phase 4's. The depth is cut
   only if one checkpoint does not fit, by the drill's rule.

Prints the card, the toolchain, per-phase lines, then a ``kernels`` JSON
line, the ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
without a GPU or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request

SEED = 0
# Tolerances, stated once. bf16 outputs carry 2^-8 relative rounding
# (one ulp is 1.6e-2 at |o| in [2, 4), where an early causal row that
# sees few keys can sit); the kernels also round P to bf16 for the
# tensor-core P@V product and sum in another order than the plain
# versions (which compute in f32 from the same bf16 inputs). So outputs
# pass at |kernel - plain| <= ATOL + RTOL * |plain|: about two ulps.
OUT_ATOL = 1e-2
OUT_RTOL = 1e-2
FLASH_LSE_ATOL = 2e-3    # f32 lse; only the product order differs
# Model-level: 32 bf16 layers amplify those roundings; relative to the
# largest reference magnitude.
MODEL_REL_TOL = 5e-2
# Backward kernels: gradients are sums of up to S * n_rep bf16-rounded
# products (P and dS are rounded to bf16 for the tensor cores), so the
# absolute tolerance is relative to the largest reference value:
# |kernel - plain| <= BWD_ATOL_REL * max|plain| + BWD_RTOL * |plain|.
BWD_ATOL_REL = 1e-2
BWD_RTOL = 2e-2
# Training parity through 16 bf16 layers, kernel path against the plain
# path: the loss to TRAIN_LOSS_REL_TOL relative, each named gradient to
# TRAIN_GRAD_REL_TOL in relative Frobenius norm (|a - b| / |b|).
# The readings on an H100 (PERF.md): loss 7.7e-6; gradients 2.3e-2, all
# but 1e-4 of it also there with the forward kernel and the f32 plain
# backward, i.e. from the forward's roundings (the plain path rounds its
# logits to bf16) amplified through 16 bf16 layers. The gradient
# tolerance is 1.5x its reading.
TRAIN_LOSS_REL_TOL = 5e-3
TRAIN_GRAD_REL_TOL = 3.5e-2
# The backward kernels alone, 1.5x their readings: the kernel path
# against the forward kernel with the f32 plain backward (read 1.35e-2 at
# layer 0, as much as rounding P and dS to bf16 in the plain backward
# moves it: 1.34e-2), and each layer's backward call against
# ``flash_bwd_plain_bf16`` on the same inputs, as max|err| / max|plain|
# (read at most 5.2e-3; the tolerance is one bf16 ulp at the largest
# value).
TRAIN_BWD_REL_TOL = 2e-2
TRAIN_LAYER_BWD_TOL = 2.0 ** -7

# The training main path, modeled on examples/packed_pretrain.yaml (see
# PERF.md section 4 for the two cuts: synthetic packed data, and the
# global batch of 16 taken in 4 microbatches to fit one card).
TRAIN_LAYERS = 16
TRAIN_STEPS = 6
TRAIN_ACCUM = 4
TRAIN_JOB = {
    "kind": "jaxjob",
    "mesh": {"axes": {"fsdp": -1}},
    "checkpointing": {"enabled": False},
    "runtime": {
        "model": "llama3_1b", "dataset": "lm_packed_synthetic",
        "steps": TRAIN_STEPS, "seq_len": 4096, "global_batch_size": 16,
        "grad_accum_steps": TRAIN_ACCUM, "learning_rate": 3e-4,
        "lr_schedule": "cosine", "optimizer": "adamw", "remat": "dots",
        "attention_impl": "flash", "log_every": 1, "seed": SEED,
    },
}
# gemma_2b at full width and depth (head_dim 256, MQA 8:1, 2.51 B
# parameters), the same recipe at global batch 4 in 4 microbatches of 1
# (PERF.md section 4), for 3 steps.
GEMMA_LAYERS = 18
GEMMA_STEPS = 3
GEMMA_ACCUM = 4
GEMMA_JOB = {
    "kind": "jaxjob",
    "mesh": {"axes": {"fsdp": -1}},
    "checkpointing": {"enabled": False},
    "runtime": {
        "model": "gemma_2b", "dataset": "lm_packed_synthetic",
        "steps": GEMMA_STEPS, "seq_len": 4096, "global_batch_size": 4,
        "grad_accum_steps": GEMMA_ACCUM, "learning_rate": 3e-4,
        "lr_schedule": "cosine", "optimizer": "adamw", "remat": "dots",
        "attention_impl": "flash", "log_every": 1, "seed": SEED,
    },
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def card_peaks(name: str) -> tuple[float, float, str]:
    """(dense bf16 FLOP/s, HBM bytes/s, label) of the card, from
    NVIDIA's data sheets (SXM parts; PCIe and NVL parts have their own)."""
    if "H200" in name:
        return 989e12, 4.8e12, "H200 SXM"
    if "PCIe" in name:
        return 756e12, 2.0e12, "H100 PCIe"
    if "NVL" in name:
        return 835e12, 3.9e12, "H100 NVL"
    return 989e12, 3.35e12, "H100 SXM"


def close(got, want) -> bool:
    import torch

    return torch.allclose(got.float(), want.float(), atol=OUT_ATOL,
                          rtol=OUT_RTOL)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ kernels
def check_flash(torch, flash, peaks, gen):
    """Kernel vs plain at the paths' shapes: llama3_8b prefill (S=1000 and
    S=2048, D=128; the kernels line's record is S=2048), the llama3_1b
    training microbatch (D=64, held with packed segments, timed without)
    and gemma_2b's (D=256, MQA 8:1, causal and with a 1024 window). Each
    timed case prints kernel, plain, SDPA and bound ms and TFLOP/s."""
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    worst = 0.0
    rec = None
    for S in (1000, 2048):
        args = _flash_inputs(torch, gen, 1, S, 32, 8, 128)
        worst = max(worst, hold_flash(torch, flash, f"llama3_8b S={S}",
                                      *args))
        rec = time_flash(torch, flash, peaks, f"llama3_8b S={S}", *args)
        del args
    rec["max_abs_err"] = worst

    segs = torch.from_numpy(next(lm_packed_synthetic(
        4, seq_len=4096, vocab_size=128_256, seed=SEED))["segments"]).cuda()
    args = _flash_inputs(torch, gen, 4, 4096, 32, 8, 64)
    rec["max_abs_err"] = max(rec["max_abs_err"], hold_flash(
        torch, flash, "llama3_1b B=4 S=4096 D=64 packed", *args, seg=segs))
    time_flash(torch, flash, peaks, "llama3_1b B=4 S=4096 D=64", *args)
    del args
    args = _flash_inputs(torch, gen, 1, 4096, 8, 1, 256)
    for window in (None, 1024):
        label = f"gemma_2b S=4096 D=256 window={window}"
        rec["max_abs_err"] = max(rec["max_abs_err"], hold_flash(
            torch, flash, label, *args, window=window))
        time_flash(torch, flash, peaks, label, *args, window=window)
    del args
    torch.cuda.empty_cache()
    return rec


def _flash_inputs(torch, gen, B, S, H, KV, D):
    return tuple(torch.randn(B, S, n, D, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for n in (H, KV, KV))


def hold_flash(torch, flash, label, q, k, v, *, seg=None, window=None):
    """The forward kernel against ``flash_fwd_plain`` (causal); fails on
    a disagreement, returns the max abs error of o."""
    D = q.shape[-1]
    o, lse = flash.flash_attention_with_lse(q, k, v, causal=True,
                                            window=window, segment_ids=seg)
    torch.cuda.synchronize()
    po, plse = flash.flash_fwd_plain(q, k, v, causal=True, scale=D ** -0.5,
                                     window=window, segment_ids=seg)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail(f"flash kernel produced non-finite values ({label})")
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    if not close(o, po) or err_lse > FLASH_LSE_ATOL:
        fail(f"flash kernel disagrees with its plain version ({label}): "
             f"o max abs err {err_o} (atol {OUT_ATOL} + rtol {OUT_RTOL}), "
             f"lse err {err_lse} (tol {FLASH_LSE_ATOL})")
    print(f"flash {label}{' packed' if seg is not None else ''}: "
          f"max_abs_err o={err_o:.3e} lse={err_lse:.3e}", flush=True)
    del o, lse, po, plse
    torch.cuda.empty_cache()
    return err_o


def time_flash(torch, flash, peaks, label, q, k, v, *, window=None):
    """Kernel, plain and (without a window) SDPA times of the causal
    forward, and its bound; returns the record."""
    import torch.nn.functional as F

    B, S, H, D = q.shape
    KV = k.shape[2]
    ms = time_ms(lambda: flash.flash_attention_with_lse(
        q, k, v, causal=True, window=window), reps=20)
    plain_ms = time_ms(lambda: flash.flash_fwd_plain(
        q, k, v, causal=True, scale=D ** -0.5, window=window), reps=3,
        warmup=1)
    lib_ms = None
    if window is None:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
        del qt, kt, vt
    # Visible (row, col) pairs: the causal triangle, cut to the band.
    pairs = sum(min(r + 1, window or r + 1) for r in range(S))
    flops = 4.0 * B * H * pairs * D
    nbytes = (2.0 * (2 * B * S * H * D + 2 * B * S * KV * D)
              + 4.0 * B * H * S)  # q, k, v read; o, lse written
    bound_ms = max(flops / peaks[0], nbytes / peaks[1]) * 1e3
    by = "operations" if flops / peaks[0] >= nbytes / peaks[1] else "bytes"
    lib = f"{lib_ms:.4f}" if lib_ms is not None else "none"
    print(f"flash {label} B={B} H={H} KV={KV}: kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} sdpa_ms={lib} bound_ms={bound_ms:.4f} "
          f"({by}) kernel_TFLOPs={flops / ms / 1e9:.1f}", flush=True)
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms}


# Paged decode cases (label, B, H, KV, Hd, page, maxp, positions, holes as
# (row, table slot)): a. llama3_8b at 8 rows, ragged up to 2,047, a hole
# and an idle row (the kernels line's record); b. llama3_8b at 8 long
# rows (6,000 to 8,191); c. gemma_2b's MQA (8 q heads on 1 kv head,
# head_dim 256), ragged up to 8,191; d. llama3_1b at 64 rows, positions
# seeded uniform in 0..2,047 (a grid that fills the card: one split).
def decode_cases():
    import numpy as np

    d_pos = np.random.default_rng(SEED).integers(0, 2048, 64).tolist()
    return (
        ("a llama3_8b B=8", 8, 32, 8, 128, 16, 128,
         [2047, 1000, 517, 1533, 64, 1999, 1200, -1], [(1, 20)]),
        ("b llama3_8b long B=8", 8, 32, 8, 128, 16, 512,
         [8191, 6000, 7013, 6544, 8000, 6321, 7777, 7400], [(2, 100)]),
        ("c gemma_2b B=8", 8, 8, 1, 256, 16, 512,
         [8191, 4000, 1033, 6133, 257, 7999, 4800, -1], []),
        ("d llama3_1b B=64", 64, 32, 8, 64, 16, 128, d_pos, []),
    )


# Enough copies of (q, K pool, V pool) that one graph replay touches four
# times the 50 MB L2 between two uses of a copy: every launch reads its
# K/V from HBM, as the engine's decode step does (a whole model's weights
# stream between two calls of one layer).
COLD_BYTES = 200e6


def decode_case(torch, gen, label, B, H, KV, Hd, page, maxp, pos, holes):
    """Tables over a pool of just the live pages (a seeded permutation),
    the holes punched, and as many input copies as ``COLD_BYTES`` needs.
    Also the bytes and operations of the bound."""
    pos_t = torch.tensor(pos, dtype=torch.int32)
    pages = [p // page + 1 if p >= 0 else 0 for p in pos]
    P = sum(pages) + 1
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    tables = torch.full((B, maxp), -1, dtype=torch.int32)
    used = 0
    for b, n in enumerate(pages):
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    for b, j in holes:
        tables[b, j] = -1
    # Bytes this run's data needs: each visible K/V token row once (holes
    # and columns past pos excluded), q, tables and pos read, out written.
    live = 0
    for b, p in enumerate(pos):
        for j in range(pages[b]):
            if int(tables[b, j]) >= 0:
                live += min(page, p - j * page + 1)
    kv_bytes = 2.0 * live * KV * Hd * 2
    copies = max(2, math.ceil(COLD_BYTES / kv_bytes))
    ins = [tuple(torch.randn(*shape, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
                 for shape in ((B, H, Hd), (P, page, KV, Hd),
                               (P, page, KV, Hd)))
           for _ in range(copies)]
    return {"label": label, "shape": (B, H, KV, Hd, page, maxp),
            "ins": ins, "tables": tables.cuda(), "pos": pos_t.cuda(),
            "live_tokens": live,
            "bytes": kv_bytes + 2.0 * 2 * B * H * Hd + 4.0 * B * (maxp + 1),
            "flops": 4.0 * live * H * Hd}


def time_decode(torch, paged, case, reps: int = 20):
    """(graph ms, eager ms) of the wrapper at one case. Graph: ``reps``
    launches captured in one CUDA graph, rotating through the case's
    input copies (cold L2), timed over 3 replays by CUDA events. Eager:
    50 launches from Python on one copy (warm L2), the host-bound way the
    engine calls it today."""
    tables, pos = case["tables"], case["pos"]
    fns = [lambda c=c: paged.paged_decode_attention(*c, tables, pos)
           for c in case["ins"]]
    # Warm up on the capture stream, so its merge-counter buffer exists
    # before the capture and the graph holds kernel launches only.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph_ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return graph_ms, time_ms(fns[0], reps=50)


def check_paged(torch, paged, peaks, gen):
    """The decode kernel against ``paged_decode_plain`` at the four
    ``decode_cases``: finite, within OUT_ATOL/OUT_RTOL, idle rows exactly
    zero, two calls bitwise equal; one case with one split and one with
    more must be held. Each case prints its split count, the graph (cold
    L2) and eager times, the bound and the achieved GB/s. Returns case
    a's record, with the worst error over the cases."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, rec, kinds = 0.0, None, set()
    for spec in decode_cases():
        case = decode_case(torch, gen, *spec)
        label, (B, H, KV, Hd, page, maxp) = case["label"], case["shape"]
        tables, pos = case["tables"], case["pos"]
        q, kp, vp = case["ins"][0]
        splits = paged.decode_splits(B, H, KV, page, maxp, sms)
        out = paged.paged_decode_attention(q, kp, vp, tables, pos)
        again = paged.paged_decode_attention(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        ref = paged.paged_decode_plain(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"paged decode kernel produced non-finite values ({label})")
        idle = (pos < 0).nonzero().flatten().tolist()
        if idle and out[idle].abs().max().item() != 0.0:
            fail(f"paged decode kernel: idle row is not zero ({label})")
        if not torch.equal(out, again):
            fail(f"paged decode kernel: two calls differ ({label})")
        err = (out.float() - ref.float()).abs().max().item()
        if not close(out, ref):
            fail(f"paged decode kernel disagrees with its plain version "
                 f"({label}): max abs err {err} (atol {OUT_ATOL} + rtol "
                 f"{OUT_RTOL})")
        worst = max(worst, err)
        kinds.add(splits > 1)
        del out, again, ref
        ms, eager_ms = time_decode(torch, paged, case)
        t_ops, t_bytes = case["flops"] / peaks[0], case["bytes"] / peaks[1]
        bound_ms = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"paged_decode {label} H={H} KV={KV} Hd={Hd} maxp={maxp}: "
              f"splits={splits} max_abs_err={err:.3e} kernel_ms={ms:.4f} "
              f"(graph, cold L2, {len(case['ins'])} input copies) "
              f"eager_ms={eager_ms:.4f} (50 host-issued launches, warm L2) "
              f"bound_ms={bound_ms:.4f} ({by}) live_tokens="
              f"{case['live_tokens']} bytes={case['bytes'] / 1e6:.1f}MB "
              f"achieved_GBps={case['bytes'] / ms / 1e6:.1f}", flush=True)
        if rec is None:
            plain_ms = time_ms(lambda: paged.paged_decode_plain(
                q, kp, vp, tables, pos), reps=5, warmup=1)
            rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": by, "library_ms": None}
            print(f"paged_decode {label}: plain_ms={plain_ms:.4f}",
                  flush=True)
        del case, q, kp, vp
        torch.cuda.empty_cache()
    if kinds != {False, True}:
        fail("the held decode cases do not cover both grids (one split "
             "and several)")
    rec["max_abs_err"] = worst
    return rec


DECODE_STREAM_ITERS = 100


def check_decode_streams(torch, paged, gen):
    """Two streams launch multi-split decode at once, in a loop: case a
    (llama3_8b, 8 rows) on one and case c (gemma_2b MQA) on the other.
    Each stream keeps its own merge counters, so every output must match
    the plain version (OUT_ATOL/OUT_RTOL) and its stream's first output
    bitwise."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    specs = [decode_cases()[0], decode_cases()[2]]
    cases, refs = [], []
    for spec in specs:
        case = decode_case(torch, gen, *spec)
        B, H, KV, Hd, page, maxp = case["shape"]
        if paged.decode_splits(B, H, KV, page, maxp, sms) < 2:
            fail(f"two-stream decode check: case {case['label']} runs one "
                 "split; it needs several")
        args = (*case["ins"][0], case["tables"], case["pos"])
        cases.append(args)
        refs.append(paged.paged_decode_plain(*args))
        del case
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(DECODE_STREAM_ITERS):
        for i, (st, args) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(st):
                outs[i].append(paged.paged_decode_attention(*args))
    torch.cuda.synchronize()
    for spec, ref, got in zip(specs, refs, outs):
        if not close(got[0], ref):
            err = (got[0].float() - ref.float()).abs().max().item()
            fail(f"two-stream decode ({spec[0]}): disagrees with its plain "
                 f"version, max abs err {err}")
        differ = sum(not torch.equal(o, got[0]) for o in got)
        if differ:
            fail(f"two-stream decode ({spec[0]}): {differ} of {len(got)} "
                 "launches differ from the first")
    print(f"paged_decode two streams: {DECODE_STREAM_ITERS} concurrent "
          f"multi-split launches per stream ({specs[0][0]} | {specs[1][0]})"
          f", all equal to the plain version and bitwise to each other",
          flush=True)
    del cases, refs, outs
    torch.cuda.empty_cache()


def _bwd_close(got, want) -> bool:
    import torch

    want = want.float()
    return torch.allclose(got.float(), want, rtol=BWD_RTOL,
                          atol=BWD_ATOL_REL * want.abs().max().item())


def _bwd_inputs(torch, flash, gen, B, S, H, KV, D, seg, dlse: bool):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    do = torch.randn(B, S, H, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    o, lse = flash.flash_fwd_cuda(q, k, v, causal=True, scale=D ** -0.5,
                                  segment_ids=seg)
    dl = (0.1 * torch.randn(B, H, S, generator=gen, device="cuda")
          if dlse else None)
    return q, k, v, seg, o, lse, do, dl


def flash_bwd_plain_bf16(q, k, v, segment_ids, o, lse, do, dlse, *,
                         causal: bool, scale: float, window=None):
    """``flash_bwd_plain`` with the kernels' two roundings: P and dS are
    rounded to bf16 where they enter the tensor-core products
    (dV = bf16(P)^T dO, dK = bf16(dS)^T Q, dQ = bf16(dS) K); all else
    is f32, as in the plain version. What the kernels should compute up
    to the order of their f32 sums."""
    import torch
    from polyaxon_tpu_torch.ops import flash

    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    qf = q.float()
    kf, vf = flash._expand_kv(k, n_rep), flash._expand_kv(v, n_rep)
    dof = torch.zeros_like(qf) if do is None else do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    mask = flash._plain_mask(sq, sk, causal, window, segment_ids,
                             segment_ids, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf).mul_(scale)
    p = torch.where(mask, s.sub_(lse[..., None]).exp_(), 0.0)
    del s
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = ds.sub_(delta[..., None]).mul_(p).mul_(scale).bfloat16().float()
    p = p.bfloat16().float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(
        b, sk, kv, n_rep, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(
        b, sk, kv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_flash_bwd(torch, flash, peaks, gen):
    """Both backward kernels against ``flash_bwd_plain`` in bf16, then
    timed. Returns the two records for the kernels line."""
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    segs = {b: torch.from_numpy(next(lm_packed_synthetic(
        b, seq_len=4096, vocab_size=128_256, seed=SEED))["segments"]).cuda()
        for b in (1, 4)}
    split_fn = flash._bwd_entries()[2]
    worst = {"dkdv": 0.0, "dq": 0.0}
    splits = set()
    for label, shape, s in (
            ("llama3_1b packed B=4 S=4096 H32 KV8 D64",
             (4, 4096, 32, 8, 64), segs[4]),
            ("llama3_1b packed B=1 S=4096 H32 KV8 D64",
             (1, 4096, 32, 8, 64), segs[1]),
            ("ragged S=1000 GQA 4:1 D128", (1, 1000, 32, 8, 128), None),
            ("gemma_2b packed S=4096 H8 KV1 D256", (1, 4096, 8, 1, 256),
             segs[1])):
        args = _bwd_inputs(torch, flash, gen, *shape, s, dlse=True)
        B, S, H, KV, D = shape
        n_split = split_fn(B, S, H, KV, D)
        splits.add(n_split > 1)
        got = flash.flash_bwd_cuda(*args, causal=True, scale=D ** -0.5)
        torch.cuda.synchronize()
        want = flash.flash_bwd_plain(*args, causal=True, scale=D ** -0.5)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(g).all():
                fail(f"flash backward {name} non-finite ({label})")
            errs[name] = (g.float() - w.float()).abs().max().item()
            if not _bwd_close(g, w):
                fail(f"flash backward {name} disagrees with its plain "
                     f"version ({label}): max abs err {errs[name]}, max "
                     f"|plain| {w.float().abs().max().item()} (atol "
                     f"{BWD_ATOL_REL} * max|plain| + rtol {BWD_RTOL})")
        worst["dq"] = max(worst["dq"], errs["dq"])
        worst["dkdv"] = max(worst["dkdv"], errs["dk"], errs["dv"])
        del want
        emul = flash_bwd_plain_bf16(*args, causal=True, scale=D ** -0.5)
        emul_errs = " ".join(
            f"{n}={(g.float() - w.float()).abs().max().item():.3e}"
            for n, g, w in zip(("dq", "dk", "dv"), got, emul))
        print(f"flash_bwd {label} (dkdv_head_split={n_split}): "
              f"max_abs_err dq={errs['dq']:.3e} "
              f"dk={errs['dk']:.3e} dv={errs['dv']:.3e}; against the plain "
              f"version with P and dS in bf16: {emul_errs}", flush=True)
        del args, got, emul
        torch.cuda.empty_cache()
    if splits != {False, True}:
        fail("the held backward cases do not cover both dK/dV grids "
             "(in-block group loop and head split)")

    # Times at one microbatch of each training path (llama3_1b: B=4,
    # S=4096, D=64, the kernels line's record; gemma_2b: B=1, S=4096,
    # D=256), no segments, no lse cotangent, so SDPA's backward is the
    # same function; then the pair again with the path's packed segments.
    recs = time_flash_bwd(torch, flash, peaks, gen, 4, 4096, 32, 8, 64,
                          segs[4])
    time_flash_bwd(torch, flash, peaks, gen, 1, 4096, 8, 1, 256, segs[1])
    for name in recs:
        recs[name]["max_abs_err"] = worst[name]
    return recs


def time_flash_bwd(torch, flash, peaks, gen, B, S, H, KV, D, seg):
    """Times of the backward pair, its plain version and SDPA's backward
    at one causal shape, and of the pair with the packed segments ``seg``
    [B, S]; returns the two kernels' records (without max_abs_err)."""
    import torch.nn.functional as F

    args = _bwd_inputs(torch, flash, gen, B, S, H, KV, D, None, dlse=False)
    kw = dict(causal=True, scale=D ** -0.5)
    run_dkdv, run_dq, _ = flash._bwd_launchers(*args, **kw)
    dkdv_ms = time_ms(run_dkdv, reps=20)
    dq_ms = time_ms(run_dq, reps=20)
    pair_ms = time_ms(lambda: flash.flash_bwd_cuda(*args, **kw), reps=20)
    plain_ms = time_ms(lambda: flash.flash_bwd_plain(*args, **kw), reps=3,
                       warmup=1)
    q, k, v, _, _, _, do, _ = args
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(
        ot, (qt, kt, vt), dot, retain_graph=True), reps=20)
    pairs = B * H * S * (S + 1) / 2  # visible (q, key) pairs, causal
    qbytes, kvbytes, rowbytes = 2.0 * B * S * H * D, 2.0 * B * S * KV * D, \
        4.0 * B * H * S
    inputs = 2 * qbytes + 2 * kvbytes + 2 * rowbytes  # q, do, k, v, lse, dd
    # Products of head_dim per pair each kernel does: dQ recomputes S and
    # dP; at head_dim 256 the two consumer warpgroups of a block each own
    # half of the output's columns and both compute S and dP.
    done = {"dkdv": 6, "dq": 5} if D == 256 else {"dkdv": 4, "dq": 3}
    recs = {}
    # The pair's minimal work, split so that the two bounds add up to it:
    # 5 products of head_dim per visible pair (S and dP once, then dV, dK
    # and dQ), each input read once and each output written once. dK/dV
    # is charged S, dP, dV, dK and the inputs; dQ only its own product and
    # its output.
    for name, n_prod, nbytes, ms in (
            ("dkdv", 4, inputs + 2 * kvbytes, dkdv_ms),
            ("dq", 1, qbytes, dq_ms)):
        flops = 2.0 * D * n_prod * pairs
        t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
        recs[name] = {"ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "library_ms": lib_ms}
        print(f"flash_bwd {name} B={B} S={S} H={H} KV={KV} D={D}: "
              f"kernel_ms={ms:.4f} "
              f"bound_ms={recs[name]['bound_ms']:.4f} "
              f"({recs[name]['bound_by']}) TFLOPs_done="
              f"{2.0 * D * done[name] * pairs / ms / 1e9:.1f}", flush=True)
    del args, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    args = _bwd_inputs(torch, flash, gen, B, S, H, KV, D, seg, dlse=False)
    packed_ms = time_ms(lambda: flash.flash_bwd_cuda(*args, **kw), reps=20)
    print(f"flash_bwd pair B={B} S={S} H={H} KV={KV} D={D}: "
          f"wrapper_ms={pair_ms:.4f} "
          f"(dkdv+dq {dkdv_ms + dq_ms:.4f}) packed_wrapper_ms="
          f"{packed_ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_bwd_ms={lib_ms:.4f} bound_ms="
          f"{recs['dkdv']['bound_ms'] + recs['dq']['bound_ms']:.4f} "
          f"(5 products) dkdv_head_split="
          f"{flash._bwd_entries()[2](B, S, H, KV, D)}", flush=True)
    del args
    torch.cuda.empty_cache()
    return recs


# -------------------------------------------------------------- model
def make_prompts(vocab: int):
    """16 prompts of mixed lengths: six share a 256-token system prefix
    (radix hits on whole pages), two more share it up to a mid-page
    point (copy-on-write forks)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    system = rng.integers(0, vocab, 256).tolist()
    lengths = [1000, 37, 512, 300, 2047, 64, 800, 129]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    for n in (40, 90, 200, 7, 333, 64):
        prompts.append(system + rng.integers(0, vocab, n).tolist())
    for n in (120, 15):
        prompts.append(system[:200] + rng.integers(0, vocab, n).tolist())
    return prompts


def compare_first_admission(torch, llama, cfg, params, prompt):
    """The first admission's prefill KV and first decode logits through
    the kernels ("auto") against the plain path (einsum prefill, gather
    decode), on one fresh pool."""
    page = 16
    P = len(prompt) - 1
    n_pages = -(-(P + 1) // page) + 1
    tables = torch.full((1, n_pages), -1, dtype=torch.long, device="cuda")
    tables[0, :n_pages - 1] = torch.arange(1, n_pages, device="cuda")
    row = torch.tensor([prompt[:-1]], dtype=torch.long, device="cuda")
    tok = torch.tensor([prompt[-1]], dtype=torch.long, device="cuda")
    pos = torch.tensor([P], dtype=torch.long, device="cuda")
    plain = dataclasses.replace(cfg, attention_impl="xla",
                                paged_attention_impl="gather")
    results = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        cache = llama.paged_init_cache(c, n_pages, page, device="cuda")
        k, v = llama.paged_prefill_kv(c, params, row)
        llama.paged_insert_prefill(cache, k, v, tables[0], page)
        logits, _ = llama.decode_step_paged(c, params, cache, tok, pos,
                                            tables)
        torch.cuda.synchronize()
        results[name] = (k, v, logits)
        del cache
    out = {}
    for i, what in enumerate(("k", "v", "logits")):
        a, b = results["kernel"][i].float(), results["plain"][i].float()
        if not torch.isfinite(a).all():
            fail(f"first admission: non-finite {what} on the kernel path")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        out[what] = rel
        if rel > MODEL_REL_TOL:
            fail(f"first admission {what}: kernel path vs plain path "
                 f"relative max err {rel} (tol {MODEL_REL_TOL})")
    same_argmax = bool(results["kernel"][2].argmax() ==
                       results["plain"][2].argmax())
    print(f"first admission (prompt {len(prompt)}): rel err k={out['k']:.3e} "
          f"v={out['v']:.3e} logits={out['logits']:.3e} "
          f"same_argmax={same_argmax}", flush=True)


def time_prefill(torch, llama, flash, cfg, params):
    """Device time of one 2,048-token llama3_8b prompt pass (the prefill's
    KV, 32 flash forward launches), by CUDA events."""
    row = torch.randint(0, cfg.vocab_size, (1, 2048), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED))
    before = flash.launches
    ms = time_ms(lambda: llama.paged_prefill_kv(cfg, params, row), reps=5,
                 warmup=1)
    per = (flash.launches - before) // 6
    print(f"prefill llama3_8b 2048 tokens: ms={ms:.2f} "
          f"flash_fwd_launches_per_prefill={per}", flush=True)


def run_engine(flash, paged, cfg, params):
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine

    prompts = make_prompts(cfg.vocab_size)
    eng = ContinuousBatchingEngine("llama3_8b", cfg, params, slots=8,
                                   kv="paged", page_size=16, device="cuda")
    try:
        flash.launches = 0
        paged.launches = 0
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 32) for p in prompts]
        outs = [r.wait(timeout=900) for r in reqs]
        wall = time.perf_counter() - t0
        counts = {"flash_fwd": flash.launches,
                  "paged_decode": paged.launches}
        stats = eng.stats()
        bad = eng.check_invariants()
    finally:
        eng.stop()
    if bad:
        fail(f"page pool invariants broken: {bad[:5]}")
    for p, o in zip(prompts, outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"engine output malformed for a prompt of {len(p)}: {o}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"main path never launched the {name} kernel")
    tokens = sum(len(o) for o in outs)
    print(f"engine llama3_8b: requests={len(prompts)} tokens={tokens} "
          f"wall_s={wall:.3f} tokens_per_s={tokens / wall:.1f} "
          f"decode_step_ms_median={stats['decode_step_ms_median']:.3f} "
          f"decode_steps={stats['decode_steps']} "
          f"avg_occupancy={stats['avg_occupancy']} "
          f"prefill_tokens={stats['prefill_tokens_total']} "
          f"skipped={stats['prefill_tokens_skipped']} "
          f"cow_forks={stats['kv_cow_forks']} launches={counts}",
          flush=True)
    return counts, prompts[0]


def run_http(flash, paged):
    from polyaxon_tpu_torch.serving.server import ServingServer

    results, errors = [None, None], []

    def post(i, url):
        body = json.dumps({"tokens": [[7 + i, 8, 9, 10 + i] * (5 + i)],
                           "max_new_tokens": 8}).encode()
        req = urllib.request.Request(
            f"{url}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                results[i] = json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(f"{type(exc).__name__}: {exc}")

    before = (flash.launches, paged.launches)
    with ServingServer("llama3_8b", seed=SEED, slots=4,
                       device="cuda") as srv:
        threads = [threading.Thread(target=post, args=(i, srv.url))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail("HTTP requests did not finish")
        with urllib.request.urlopen(f"{srv.url}/v1/stats") as resp:
            served = json.loads(resp.read())["requests_served"]
    if errors:
        fail(f"HTTP generate failed: {errors}")
    if any(r is None or len(r["tokens"][0]) != 8 for r in results) \
            or served != 2:
        fail(f"HTTP answers malformed: {results}, served {served}")
    moved = (flash.launches > before[0], paged.launches > before[1])
    if not all(moved):
        fail("HTTP path did not launch both kernels")
    print(f"http: 2 POST /v1/generate answered, served={served}",
          flush=True)


def run_training(torch, flash, job, layers):
    """One training main path; returns its launch counts and the loss of
    each emitted step."""
    from polyaxon_tpu_torch.runtime.loop import run_torchjob

    rt = job["runtime"]
    steps, accum = rt["steps"], rt["grad_accum_steps"]
    emitted = []
    torch.cuda.reset_peak_memory_stats()
    flash.launches = flash.bwd_dkdv_launches = flash.bwd_dq_launches = 0
    t0 = time.perf_counter()
    result = run_torchjob(job, on_metrics=lambda s, v: emitted.append((s, v)))
    wall = time.perf_counter() - t0
    counts = {"flash_fwd": flash.launches,
              "flash_bwd_dkdv": flash.bwd_dkdv_launches,
              "flash_bwd_dq": flash.bwd_dq_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for step, vals in emitted:
        print(f"train {rt['model']} step {step}: loss={vals['loss']:.5f} "
              f"grad_norm={vals['grad_norm']:.5f} "
              f"step_ms={vals['step_time_ms']:.1f} "
              f"tokens_per_s={vals['tokens_per_sec']:.1f} "
              f"mfu={vals.get('mfu', float('nan')):.4f}", flush=True)
    if len(emitted) != steps - 1 or result.steps != steps:
        fail(f"{rt['model']} training ran {result.steps} steps with "
             f"{len(emitted)} emissions")
    for step, vals in emitted:
        if not (math.isfinite(vals["loss"])
                and math.isfinite(vals["grad_norm"])):
            fail(f"{rt['model']} training step {step}: non-finite loss or "
                 f"grad norm {vals}")
    # remat "dots" recomputes the forward kernel once in the backward.
    want_bwd = layers * accum * steps
    if counts != {"flash_fwd": 2 * want_bwd, "flash_bwd_dkdv": want_bwd,
                  "flash_bwd_dq": want_bwd}:
        fail(f"{rt['model']} training main path launches {counts}; each "
             f"backward kernel must run {want_bwd} times (layers x "
             f"microbatches x steps), the forward twice as often")
    last = emitted[-1][1]
    print(f"train {rt['model']}: steps={result.steps} tokens_per_step="
          f"{result.units_per_step} tokens_per_s={result.throughput:.1f} "
          f"step_ms={last['step_time_ms']:.1f} mfu={last.get('mfu')} "
          f"first_step_s={result.compile_time_s:.1f} wall_s={wall:.1f} "
          f"max_memory_allocated_GB={peak_gb:.2f} "
          f"final_loss={result.final_metrics['loss']:.5f} launches={counts}",
          flush=True)
    return counts, {step: vals["loss"] for step, vals in emitted}, result


def first_step_parity(torch, llama, flash):
    """Loss and three named gradients of one packed 1x4096 microbatch,
    through the kernel path (remat none and dots) against the plain path
    (einsum attention under remat full: every remat mode computes the
    same values, and "full" keeps the plain path's [S, S] f32
    intermediates to one layer at a time).

    Then the witness of where the gradient gap comes from: each backward
    call of a kernel run against ``flash_bwd_plain_bf16`` on the same
    inputs, and runs of the forward kernel with the plain backward
    (``flash_bwd_impl="xla"``), in f32 and with P and dS rounded to bf16
    as the kernels round them."""
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        lm_packed_synthetic(1, seq_len=4096, vocab_size=128_256,
                            seed=SEED + 1)).items()}
    base = llama.CONFIGS["llama3_1b"]
    params = llama.init(base, torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda")["params"]
    for t in _leaves(params):
        t.requires_grad_(True)
    names = (("wq", 0), ("wk", 0), ("w_down", TRAIN_LAYERS - 1))

    def run(**overrides):
        cfg = dataclasses.replace(base, **overrides)
        loss, _, _ = llama.apply(cfg, {"params": params, "state": {}}, batch)
        loss.backward()
        grads = {f"{n}[{i}]": params["layers"][n].grad[i].float().clone()
                 for n, i in names}
        for t in _leaves(params):
            t.grad = None
        torch.cuda.synchronize()
        return loss.item(), grads

    def rel(got, want):
        return {k: ((g - want[k]).norm() / want[k].norm()).item()
                for k, g in got.items()}

    def show(rels):
        return " ".join(f"{k}={v:.3e}" for k, v in rels.items())

    ref_loss, ref = run(attention_impl="xla", remat="full")
    kernel = {}
    for remat in ("none", "dots"):
        loss, got = run(attention_impl="flash", remat=remat)
        kernel[remat] = got
        loss_rel = abs(loss - ref_loss) / abs(ref_loss)
        for key, g in got.items():
            if not torch.isfinite(g).all():
                fail(f"first-step parity: non-finite grad {key} ({remat})")
        rels = rel(got, ref)
        print(f"first-step parity remat={remat}: loss kernel={loss:.6f} "
              f"plain={ref_loss:.6f} rel={loss_rel:.3e} grad rel "
              f"{show(rels)}", flush=True)
        if loss_rel > TRAIN_LOSS_REL_TOL or max(rels.values()) \
                > TRAIN_GRAD_REL_TOL:
            fail(f"first-step parity ({remat}): loss rel {loss_rel} (tol "
                 f"{TRAIN_LOSS_REL_TOL}), grad rel {rels} (tol "
                 f"{TRAIN_GRAD_REL_TOL})")

    # The witness of the gradient gap's cause. (1) Every backward call of
    # a kernel run is held, on its own inputs (the model's activations and
    # packed segments), against the plain backward with the kernels' bf16
    # roundings: a mis-masked tile shows here, before 16 layers of bf16
    # rounding blur it. (2) Runs with the forward kernel and a plain
    # backward, in f32 and with those roundings, split the model-level gap
    # between the forward and the backward.
    layer_errs = []
    kernel_bwd = flash.flash_bwd_cuda

    def held(*args, **kw):
        got = kernel_bwd(*args, **kw)
        want = flash_bwd_plain_bf16(*args, **kw)
        layer_errs.append([((g.float() - w.float()).abs().max()
                            / w.float().abs().max()).item()
                           for g, w in zip(got, want)])
        return got

    def swapped(name, fn, **overrides):
        real = getattr(flash, name)
        setattr(flash, name, fn)  # the name _FlashFn.backward calls
        try:
            return run(**overrides)[1]
        finally:
            setattr(flash, name, real)

    swapped("flash_bwd_cuda", held, attention_impl="flash", remat="none")
    bwd_f32 = run(attention_impl="flash", flash_bwd_impl="xla",
                  remat="none")[1]
    bwd_bf16 = swapped("flash_bwd_plain", flash_bwd_plain_bf16,
                       attention_impl="flash", flash_bwd_impl="xla",
                       remat="none")
    worst = [max(e[i] for e in layer_errs) for i in range(3)]
    print(f"parity witness, each of {len(layer_errs)} backward calls held "
          f"against the plain backward with P and dS in bf16, worst "
          f"max|err| / max|plain|: dq={worst[0]:.3e} dk={worst[1]:.3e} "
          f"dv={worst[2]:.3e}", flush=True)
    bwd_rel = rel(kernel["none"], bwd_f32)
    print(f"parity witness, grad rel: forward kernel + f32 plain backward "
          f"against the plain path: {show(rel(bwd_f32, ref))}; plain "
          f"backward with P and dS in bf16 against it in f32: "
          f"{show(rel(bwd_bf16, bwd_f32))}; kernel path against the f32 "
          f"plain backward: {show(bwd_rel)}", flush=True)
    if len(layer_errs) != TRAIN_LAYERS \
            or not max(worst) <= TRAIN_LAYER_BWD_TOL:
        fail(f"first-step parity: {len(layer_errs)} backward calls held, "
             f"worst relative error {worst} (tol {TRAIN_LAYER_BWD_TOL})")
    if not max(bwd_rel.values()) <= TRAIN_BWD_REL_TOL:
        fail(f"first-step parity: the kernel path's gradients differ from "
             f"the f32 plain backward's by {bwd_rel} (tol "
             f"{TRAIN_BWD_REL_TOL})")
    del params


# ------------------------------------------------------ checkpoint drill
# TRAIN_JOB with checkpoints every 2 steps, one kept in the store, saved
# asynchronously.
DRILL_CKPT = {"enabled": True, "intervalSteps": 2, "maxToKeep": 1,
              "asyncSave": True}
# Room the drill's files need on the disk at once, in units of one
# checkpoint's bytes: the store's step, the older step the spill's hard
# links keep after the store has pruned it (SPILL_KEEP = 2), and the step
# being written.
DRILL_FILE_STATES = 3
# The most disk the drill's files may take at once, whatever is free:
# machines that run this script may cap how far a job's disk use grows
# (at 45 GiB on some), and the builds and logs need a little of that.
DRILL_DISK_BUDGET = 44 * 2**30
# Host memory left free beside the launcher's page-locked snapshot
# buffer (one checkpoint).
DRILL_HOST_MARGIN = 10e9
# The launcher's restart: ``launch.main()``, as ``python -m`` runs it,
# then the process's kernel launch counts on one JSON line.
DRILL_CHILD = (
    "import json, sys\n"
    "from polyaxon_tpu_torch.ops import flash\n"
    "from polyaxon_tpu_torch.runtime import launch\n"
    "rc = launch.main()\n"
    "print(json.dumps({'launches': {'flash_fwd': flash.launches, "
    "'flash_bwd_dkdv': flash.bwd_dkdv_launches, "
    "'flash_bwd_dq': flash.bwd_dq_launches}}), flush=True)\n"
    "sys.exit(rc)\n")
# The tolerance on a resumed loss when two uninterrupted runs differ:
# this many times their largest difference (the resumed run is one more
# sample of the same spread).
DRILL_SPREAD_FACTOR = 3.0
SERVE_NEW_TOKENS = 16


def _store_steps(ckdir: str) -> list[int]:
    try:
        return sorted(int(n) for n in os.listdir(ckdir) if n.isdigit())
    except OSError:
        return []


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as fh:
            return fh.read()[-n:]
    except OSError:
        return ""


def _json_lines(path: str) -> list[dict]:
    out = []
    with open(path, errors="replace") as fh:
        for line in fh:
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


def fit_depth(torch, llama, free_disk: float, free_host: float,
              file_states: int, label: str):
    """llama3_1b's depth for a phase that keeps ``file_states``
    checkpoints on the disk at once: TRAIN_LAYERS, cut only if those do
    not fit in the free disk or in DRILL_DISK_BUDGET, or the launcher's
    snapshot does not fit in the host's available memory less
    DRILL_HOST_MARGIN (a cut is printed). Returns (layers, checkpoint
    bytes)."""
    cfg = llama.CONFIGS["llama3_1b"]
    meta = llama.init(cfg, torch.Generator(), device="meta")["params"]
    per_layer = sum(t.numel() for t in meta["layers"].values()) \
        // cfg.n_layers
    other = sum(t.numel() for t in _leaves(meta)) - per_layer * cfg.n_layers

    def state_bytes(layers):  # f32 params, adamw mu and nu
        return 12 * (other + per_layer * layers)

    def fits(layers):
        files = file_states * state_bytes(layers)
        return (files <= min(free_disk, DRILL_DISK_BUDGET)
                and state_bytes(layers) <= free_host - DRILL_HOST_MARGIN)

    layers = TRAIN_LAYERS
    while layers > 1 and not fits(layers):
        layers -= 1
    if layers < TRAIN_LAYERS:
        print(f"{label}: {file_states} checkpoints of "
              f"{state_bytes(TRAIN_LAYERS) / 1e9:.2f} GB do not fit in "
              f"{min(free_disk, DRILL_DISK_BUDGET) / 1e9:.1f} GB of disk "
              f"({free_disk / 1e9:.1f} GB free, budget "
              f"{DRILL_DISK_BUDGET / 1e9:.1f} GB), or a snapshot in "
              f"{free_host / 1e9:.1f} GB of host memory: depth cut from "
              f"{TRAIN_LAYERS} to {layers} layers, width kept", flush=True)
    return layers, state_bytes(layers)


def drill_job(torch, llama, free_disk: float, free_host: float):
    """The drill's job and its depth: TRAIN_JOB with DRILL_CKPT at full
    width, at ``fit_depth``'s depth for DRILL_FILE_STATES checkpoints.
    Returns (job, layers, checkpoint bytes)."""
    layers, nbytes = fit_depth(torch, llama, free_disk, free_host,
                               DRILL_FILE_STATES, "checkpoint drill")
    job = json.loads(json.dumps(TRAIN_JOB))
    job["checkpointing"] = dict(DRILL_CKPT)
    if layers < TRAIN_LAYERS:
        job["runtime"]["n_layers"] = layers
    return job, layers, nbytes


def device_crcs(torch, state) -> list[int]:
    """CRC-32 of each leaf's bytes, copied off the card through one
    page-locked buffer (scalars as the int64 the store keeps)."""
    import zlib

    import numpy as np
    from polyaxon_tpu_torch.runtime import checkpoint as ck

    buf = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    out = []
    for _, leaf in ck.flatten(state):
        if not isinstance(leaf, torch.Tensor):
            out.append(ck.crc32(np.asarray(leaf, np.int64)))
            continue
        flat, crc = leaf.detach().reshape(-1).view(torch.uint8), 0
        for off in range(0, flat.numel(), buf.numel()):
            m = min(buf.numel(), flat.numel() - off)
            buf[:m].copy_(flat[off:off + m])
            crc = zlib.crc32(buf.numpy()[:m], crc)
        out.append(crc)
    return out


def restore_checked(torch, llama, job, ckdir: str, label: str):
    """Restore the newest committed step of ``job``'s checkpoints in this
    process, into a state initialised from another seed, and hold each
    leaf's CRC-32 against the manifest. Returns (the manager, the state,
    the step, the CRC-32s, the tier the restore came from); the caller
    closes the manager."""
    from polyaxon_tpu_torch.models import get_model
    from polyaxon_tpu_torch.runtime import checkpoint as ck
    from polyaxon_tpu_torch.runtime.config import RuntimeConfig
    from polyaxon_tpu_torch.runtime.optim import build_optimizer
    from polyaxon_tpu_torch.runtime.step import build_init

    rcfg = RuntimeConfig.from_dict(job["runtime"])
    model_def = get_model(rcfg.model,
                          **rcfg.model_overrides(llama.LlamaConfig))
    state = build_init(model_def, build_optimizer(rcfg),
                       device="cuda")(SEED + 1)
    mgr = ck.TieredCheckpointManager(
        ckdir, ck.CheckpointSpec.from_dict(job["checkpointing"]))
    try:
        state = mgr.restore(state)
        tier = mgr.last_restore_tier
        step = mgr.latest_step()
        manifest = ck.read_manifest(ckdir, step)
        got = device_crcs(torch, state)
        want = [e["crc32"] for e in manifest["leaves"]]
        if got != want or state["step"] != TRAIN_STEPS:
            bad = [e["path"] for e, g in zip(manifest["leaves"], got)
                   if e["crc32"] != g]
            fail(f"{label}: restored step {state['step']}; leaves that "
                 f"differ from the manifest of step {step}: {bad[:5]}")
    except BaseException:
        mgr.close()
        raise
    return mgr, state, step, want, tier


def checkpoint_drill(torch, flash, paged, llama, train_losses,
                     train_result):
    """The launcher checkpoints llama3_1b's training, is SIGKILLed once
    the store lists a committed step, and is started again on the same
    directory: it must resume from that step and finish. Then the
    resumed losses, the restored bytes and the tracking record are held,
    the checkpoint is served, and a save and restore in this process
    time tier 0. Returns the launch counts of the resumed run and of the
    serving engine."""
    import shutil
    import signal

    from polyaxon_tpu_torch.runtime import tiers
    from polyaxon_tpu_torch.tracking import events

    import tempfile

    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-drill-")
    try:
        return _drill(torch, flash, paged, llama, train_losses, train_result,
                      tmp, repo, tiers, events, signal)
    finally:
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)


def _drill(torch, flash, paged, llama, train_losses, train_result, tmp,
           repo, tiers, events, signal):
    import shutil

    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    free_disk = shutil.disk_usage(tmp).free
    free_host = meminfo()["MemAvailable"]
    job, layers, nbytes = drill_job(torch, llama, free_disk, free_host)
    print(f"checkpoint drill: llama3_1b {layers} layers, "
          f"{nbytes / 1e9:.3f} GB per checkpoint (f32 params, adamw mu "
          f"and nu), files under {tmp} ({free_disk / 1e9:.1f} GB free "
          f"disk, budget {DRILL_DISK_BUDGET / 1e9:.1f} GB), "
          f"{free_host / 1e9:.1f} GB host memory available", flush=True)
    # Two uninterrupted runs measure the run-to-run spread of the loss
    # (the embedding's backward accumulates with atomics), at the drill's
    # depth.
    ref_job = dict(job, checkpointing={"enabled": False})
    refs, ref_result = [], train_result
    if layers == TRAIN_LAYERS:
        refs.append(train_losses)
    while len(refs) < 2:
        _, losses, ref_result = run_training(torch, flash, ref_job, layers)
        refs.append(losses)
        torch.cuda.empty_cache()
    spread = max(abs(refs[0][s] - refs[1][s]) for s in refs[0])
    print(f"checkpoint drill: two uninterrupted runs differ by at most "
          f"{spread:.3e} in loss over steps {sorted(refs[0])}", flush=True)

    art = os.path.join(tmp, "run")
    ckdir = os.path.join(art, "checkpoints")
    env = dict(os.environ, POLYAXON_JAXJOB_SPEC=json.dumps(job),
               POLYAXON_RUN_ARTIFACTS_PATH=art, POLYAXON_RUN_UUID="drill")
    logs = {k: os.path.join(tmp, f"{k}.log") for k in
            ("first.out", "first.err", "second.out", "second.err")}

    # How far the disk's use grows while the launchers run, sampled.
    disk0, disk_peak = shutil.disk_usage(tmp).used, [0]
    watching = threading.Event()

    def watch_disk():
        while not watching.wait(0.2):
            disk_peak[0] = max(disk_peak[0],
                               shutil.disk_usage(tmp).used - disk0)

    watcher = threading.Thread(target=watch_disk, daemon=True)
    watcher.start()

    # 1. The first run, killed once a step is committed.
    t0 = time.perf_counter()
    with open(logs["first.out"], "w") as out, \
            open(logs["first.err"], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "polyaxon_tpu_torch.runtime.launch"],
            cwd=repo, env=env, stdout=out, stderr=err,
            start_new_session=True)
        try:
            while not _store_steps(ckdir):
                if proc.poll() is not None:
                    fail(f"checkpoint drill: the launcher exited "
                         f"({proc.returncode}) before a step was "
                         f"committed:\n{_tail(logs['first.err'])}")
                if time.perf_counter() - t0 > 600:
                    fail("checkpoint drill: no step committed in 600 s")
                time.sleep(0.02)
            committed = _store_steps(ckdir)
            os.killpg(proc.pid, signal.SIGKILL)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    t_kill = time.perf_counter() - t0
    left = sorted(os.listdir(ckdir))
    spill_left = sorted(os.listdir(os.path.join(ckdir, tiers.SPILL_DIRNAME))
                        ) if os.path.isdir(os.path.join(
                            ckdir, tiers.SPILL_DIRNAME)) else []
    first_losses = {r["step"]: r["loss"] for r in
                    _json_lines(logs["first.out"]) if "loss" in r}
    print(f"checkpoint drill: SIGKILL {t_kill:.1f}s after start, store "
          f"steps {committed}; left in the store {left}, in the spill "
          f"{spill_left}; losses before the kill {first_losses}",
          flush=True)

    # 2. The restart on the same directory.
    t0 = time.perf_counter()
    with open(logs["second.out"], "w") as out, \
            open(logs["second.err"], "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", DRILL_CHILD],
                                cwd=repo, env=env, stdout=out, stderr=err,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            fail("checkpoint drill: the restarted launcher ran over 900 s")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    t_second = time.perf_counter() - t0
    watching.set()
    watcher.join()
    print(f"checkpoint drill: the disk's use grew by at most "
          f"{disk_peak[0] / 1e9:.2f} GB while the launchers ran "
          f"({DRILL_FILE_STATES} checkpoints: "
          f"{DRILL_FILE_STATES * nbytes / 1e9:.2f} GB; budget "
          f"{DRILL_DISK_BUDGET / 1e9:.2f} GB)", flush=True)
    if rc != 0:
        fail(f"checkpoint drill: the restarted launcher exited {rc}:\n"
             f"{_tail(logs['second.err'])}")
    lines = _json_lines(logs["second.out"])
    outputs = next((r["outputs"] for r in lines if "outputs" in r), None)
    launches = next((r["launches"] for r in lines if "launches" in r), None)
    if outputs is None or launches is None:
        fail(f"checkpoint drill: no result from the restarted launcher:\n"
             f"{_tail(logs['second.out'])}")
    restored = outputs["restored_from_step"]
    if not (restored is not None and 2 <= restored < TRAIN_STEPS
            and outputs["restore_tier"] in (tiers.TIER_LOCAL,
                                            tiers.TIER_STORE)
            and outputs["steps"] == TRAIN_STEPS):
        fail(f"checkpoint drill: the restart restored step {restored} from "
             f"tier {outputs['restore_tier']} and reached step "
             f"{outputs['steps']} (want 2 <= step < {TRAIN_STEPS}, tier 1 or "
             f"2, {TRAIN_STEPS} steps)")
    want_bwd = layers * TRAIN_ACCUM * (TRAIN_STEPS - restored)
    if launches != {"flash_fwd": 2 * want_bwd, "flash_bwd_dkdv": want_bwd,
                    "flash_bwd_dq": want_bwd}:
        fail(f"checkpoint drill: the resumed run launched {launches}; each "
             f"backward kernel must run {want_bwd} times")

    # 3. The resumed losses against the uninterrupted runs.
    resumed = {r["step"]: r["loss"] for r in lines if "loss" in r}
    if sorted(resumed) != list(range(restored + 1, TRAIN_STEPS)):
        fail(f"checkpoint drill: the resumed run emitted steps "
             f"{sorted(resumed)}")
    tol = 0.0 if spread == 0.0 else DRILL_SPREAD_FACTOR * spread
    worst = 0.0
    for step, loss in {**first_losses, **resumed}.items():
        diff = abs(loss - refs[0][step])
        worst = max(worst, diff) if step in resumed else worst
        if diff > tol:
            fail(f"checkpoint drill: step {step} loss {loss!r} against the "
                 f"uninterrupted {refs[0][step]!r}: diff {diff:.3e} (tol "
                 f"{tol:.3e}: {'bitwise' if tol == 0 else 'run spread'})")
    print(f"checkpoint drill: restart restored step {restored} from tier "
          f"{outputs['restore_tier']} in "
          f"{outputs['checkpoint']['restore_s']} s (reference budget "
          f"{tiers.RESTORE_BUDGET_P99_SECONDS} s p99), ran to step "
          f"{outputs['steps']} in {t_second:.1f}s; resumed losses "
          f"{resumed}, max diff to the uninterrupted run {worst:.3e} (tol "
          f"{tol:.3e}, {'bitwise' if tol == 0 else 'run spread'}); "
          f"launches {launches}", flush=True)
    prep = [line.rsplit(" in ", 1)[-1].strip() for line in
            open(logs["second.err"], errors="replace")
            if "snapshot buffer ready" in line]
    print(f"checkpoint drill: the restarted launcher's snapshot buffer "
          f"(page locking) took {prep}", flush=True)
    cp = outputs["checkpoint"]
    stalls = [w + s for w, s in zip(cp["save_wait_s"], cp["snapshot_s"])]
    loop_stall = sum(stalls[:-1])  # the last is the final, forced save
    timed = round(outputs["throughput"] * outputs["wall_time"]
                  / outputs["units_per_step"])
    with_stall = (outputs["units_per_step"] * timed
                  / (outputs["wall_time"] + loop_stall)) if timed else 0.0
    # The steady state, which the resumed run's few steps cannot show: a
    # save every intervalSteps steps takes its snapshot, and waits for the
    # previous commit whenever that outlasts the steps between two saves.
    n_saves = len(cp["snapshot_s"])
    commits = [sum(v[k] for v in cp["commit_s"].values() if k < len(v))
               for k in range(n_saves)]
    t_between = (DRILL_CKPT["intervalSteps"] * outputs["units_per_step"]
                 / outputs["throughput"])
    t_commit = sum(commits) / n_saves
    t_snap = sum(cp["snapshot_s"]) / n_saves
    steady = t_between / (t_snap + max(t_between, t_commit))
    print(f"checkpoint drill: bytes={cp['bytes']} per checkpoint; per "
          f"save: wait_s={cp['save_wait_s']} snapshot_s={cp['snapshot_s']} "
          f"commit_s={commits} (by tier {cp['commit_s']}); publish_errors="
          f"{cp['publish_errors']}", flush=True)
    print(f"checkpoint drill: tokens_per_s over the resumed run's {timed} "
          f"timed steps: {outputs['throughput']:.1f} with the saves off the "
          f"clock, {with_stall:.1f} with the step loop's save stalls (the "
          f"final save's wait, {cp['save_wait_s'][-1]:.3f}s, falls after "
          f"the loop), uninterrupted {ref_result.throughput:.1f}; steady "
          f"state from the measured times (a save every "
          f"{t_between:.3f}s of steps, snapshot {t_snap:.3f}s, commit "
          f"{t_commit:.3f}s): {steady:.4f} of the uninterrupted rate, "
          f"{steady * ref_result.throughput:.1f} tokens/s", flush=True)
    if cp["publish_errors"]:
        fail("checkpoint drill: a checkpoint commit failed")

    # 5. The tracking record, through the port's own reader.
    loss_events = events.read_events(art, "metric", "loss")
    with open(os.path.join(art, "outputs.json")) as fh:
        tracked = json.load(fh)
    statuses = [r["status"] for r in events.read_jsonl(
        os.path.join(art, "statuses.jsonl"))]
    hbm = [r["value"] for r in events.read_events(art, "system",
                                                  "gpu0_hbm_used_gb")]
    if not (loss_events and tracked["steps"] == TRAIN_STEPS
            and tracked["restored_from_step"] == restored
            and statuses[-1] == "succeeded"
            and hbm and max(hbm) * 2**30 > nbytes):
        fail(f"checkpoint drill: tracking record: {len(loss_events)} loss "
             f"events, outputs steps {tracked.get('steps')} restored "
             f"{tracked.get('restored_from_step')}, statuses {statuses}, "
             f"gpu0_hbm_used_gb samples {hbm}")
    print(f"checkpoint drill: tracking record: {len(loss_events)} loss "
          f"events, outputs steps={tracked['steps']} restored_from_step="
          f"{tracked['restored_from_step']}, statuses {statuses}, "
          f"{len(hbm)} gpu0_hbm_used_gb samples (max {max(hbm):.2f} GiB), "
          f"system metrics {events.list_event_names(art, 'system')}",
          flush=True)

    # 4. The restored bytes, in this process, against the manifest.
    mgr, state, step, want, first_tier = restore_checked(
        torch, llama, job, ckdir, "checkpoint drill")
    try:
        state = mgr.restore(state, step=step)  # the store, explicitly
        print(f"checkpoint drill: restored step {step} here from tier "
              f"{first_tier}, then from the store; {len(want)} leaf "
              f"CRC-32s equal the manifest's", flush=True)

        serve_counts = serve_checkpoint(torch, flash, paged, llama, ckdir,
                                        layers)

        # 6. Tier 0, twice. First the replica the spill restore above
        # promoted (pageable host memory). Then a save's first half: the
        # snapshot into the page-locked buffer, published as the replica,
        # and its restore. The save's disk commits are the launcher's,
        # measured above; none is repeated here.
        def restore_from_memory(what):
            restored = mgr.restore(state)
            if mgr.last_restore_tier != tiers.TIER_MEMORY:
                fail(f"checkpoint drill: the restore of {what} came from "
                     f"tier {mgr.last_restore_tier}, not memory")
            if device_crcs(torch, restored) != want:
                fail(f"checkpoint drill: the restore of {what} changed the "
                     f"bytes")
            return restored

        state = restore_from_memory("the promoted replica")
        tiers.TIER0.drop(mgr.directory)
        t0 = time.perf_counter()
        mgr.prepare(state)
        t_prep = time.perf_counter() - t0
        t0 = time.perf_counter()
        arrays, snap_manifest = mgr._snapshot(step, state)
        t_snap = time.perf_counter() - t0
        t0 = time.perf_counter()
        tiers.TIER0.publish(mgr.directory, step,
                            {f"leaf_{i}": a for i, a in enumerate(arrays)},
                            snap_manifest)
        t_pub = time.perf_counter() - t0
        del arrays
        state = restore_from_memory("the snapshot")
        print(f"checkpoint drill: here, host buffer {t_prep:.2f}s (page "
              f"locking, once per manager); snapshot {t_snap:.3f}s; tier-0 "
              f"publish {t_pub:.6f}s; restore_s by tier "
              f"{mgr.restore_seconds} (tier 0: the promoted replica, then "
              f"the page-locked snapshot; reference budget "
              f"{tiers.RESTORE_BUDGET_P99_SECONDS} s p99)", flush=True)
    finally:
        mgr.close()
    del state
    torch.cuda.empty_cache()
    return launches, serve_counts


def serve_checkpoint(torch, flash, paged, llama, ckdir, layers):
    """The paged engine serves the drill's checkpoint: two requests of
    SERVE_NEW_TOKENS new tokens through the flash forward and paged
    decode (head_dim 64), then the first admission against the plain
    path. Returns the engine's launch counts."""
    from polyaxon_tpu_torch.serving.batching import ContinuousBatchingEngine
    from polyaxon_tpu_torch.serving.server import load_params

    import numpy as np

    name = "llama3_1b"
    if layers < TRAIN_LAYERS:  # a cut drill: serve the cut model
        name = f"llama3_1b_{layers}l"
        llama.CONFIGS[name] = dataclasses.replace(llama.CONFIGS["llama3_1b"],
                                                  n_layers=layers)
    t0 = time.perf_counter()
    cfg, params = load_params(name, checkpoint=ckdir, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in
               (700, 129)]
    eng = ContinuousBatchingEngine(name, cfg, params, slots=2, kv="paged",
                                   page_size=16, max_len=4096,
                                   device="cuda")
    try:
        flash.launches = 0
        paged.launches = 0
        reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in prompts]
        outs = [r.wait(timeout=600) for r in reqs]
        counts = {"flash_fwd": flash.launches,
                  "paged_decode": paged.launches}
    finally:
        eng.stop()
    for o in outs:
        if len(o) != SERVE_NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in o):
            fail(f"serving the drill's checkpoint: malformed output {o}")
    for kernel, n in counts.items():
        if n <= 0:
            fail(f"serving the drill's checkpoint never launched {kernel}")
    print(f"serve checkpoint: {name} loaded in {t_load:.1f}s, "
          f"{len(prompts)} requests x {SERVE_NEW_TOKENS} new tokens, "
          f"launches {counts}", flush=True)
    compare_first_admission(torch, llama, cfg, params, prompts[1])
    del params
    torch.cuda.empty_cache()
    return counts


# --------------------------------------- Polyaxonfile → plan → launcher
PACKED_EXAMPLE = "examples/packed_pretrain.yaml"
GPU_PRESET = "tests/fixtures/presets/gpu.yaml"
# chip_smoke's own preset over the example: one process (the example's
# v5e 2x4 topology compiles to two, and the port trains on one card),
# phase 4's 6 steps of 4 microbatches, and a loss every step (phase 4's
# cadence, so that the two phases' tokens/s compare).
H100_PRESET = {"isPreset": True, "patchStrategy": "post_merge",
               "runPatch": {"numProcesses": 1, "runtime": {
                   "steps": TRAIN_STEPS, "grad_accum_steps": TRAIN_ACCUM,
                   "log_every": 1}}}
# The corpus: at least this many rows of the example's 4096 tokens (the
# bytes tokenizer: one token per byte), in documents of CORPUS_DOC_WORDS
# words drawn from a Zipf-like vocabulary of CORPUS_VOCAB random words.
CORPUS_ROWS = 1024
CORPUS_VOCAB = 20_000
CORPUS_DOC_WORDS = (20, 160)


def write_corpus(path: str, min_bytes: int, seed: int) -> tuple[int, int]:
    """A synthetic text corpus from ``seed``: documents of lowercase words
    separated by blank lines, at least ``min_bytes`` long. Returns (bytes,
    documents)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    vocab = np.array([letters[rng.integers(0, 26, n)].tobytes().decode()
                      for n in rng.integers(1, 11, CORPUS_VOCAB)])
    weights = 1.0 / np.arange(1, CORPUS_VOCAB + 1)
    cdf = np.cumsum(weights) / weights.sum()
    size = docs = 0
    with open(path, "w") as fh:
        while size < min_bytes:
            n = int(rng.integers(*CORPUS_DOC_WORDS))
            words = vocab[np.searchsorted(cdf, rng.random(n), side="right")]
            doc = " ".join(words) + "\n\n"
            fh.write(doc)
            size += len(doc)
            docs += 1
    return size, docs


def compiled_launch(torch, llama, train_result):
    """Phase 9: ``examples/packed_pretrain.yaml`` compiled by the port
    (the gpu preset and H100_PRESET, a synthetic corpus from SEED) and
    its plan's process run as the JAX package's executor starts one
    (``polyaxon_tpu/agent/executor.py:311-343``). Checks the tracking
    record, the committed checkpoint and the kernels' launches; prints
    the numbers beside phase 4's. Returns the process's launch counts."""
    import shutil
    import tempfile

    from polyaxon_tpu_torch.runtime import tiers

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-plan-")
    try:
        return _compiled_launch(torch, llama, train_result, tmp)
    finally:
        tiers.TIER0.clear()
        shutil.rmtree(tmp, ignore_errors=True)


def _compiled_launch(torch, llama, train_result, tmp):
    import shutil
    import signal

    from polyaxon_tpu_torch.compiler import (COORDINATOR_PLACEHOLDER,
                                             ENV_JAXJOB_SPEC,
                                             compile_operation)
    from polyaxon_tpu_torch.polyaxonfile import (check_polyaxonfile,
                                                 resolve_operation_context)
    from polyaxon_tpu_torch.runtime.flops import (peak_flops,
                                                  train_flops_per_token)
    from polyaxon_tpu_torch.tracking import events
    from polyaxon_tpu_torch.tracking.systemmetrics import meminfo

    repo = os.path.dirname(os.path.abspath(__file__))
    label = "compiled plan"
    t_phase = time.perf_counter()

    # 1. The corpus, in this phase's own directory: the token caches are
    # written beside it.
    corpus = os.path.join(tmp, "corpus.txt")
    t0 = time.perf_counter()
    nbytes, ndocs = write_corpus(corpus, CORPUS_ROWS * 4096, SEED)
    print(f"{label}: corpus of {nbytes} bytes, {ndocs} documents, written "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    # The depth: full unless one checkpoint (the final save; the spill
    # hard-links the store's files) does not fit, by the drill's rule.
    layers, ckpt_bytes = fit_depth(torch, llama, shutil.disk_usage(tmp).free,
                                   meminfo()["MemAvailable"], 1, label)
    preset = json.loads(json.dumps(H100_PRESET))
    if layers < TRAIN_LAYERS:
        preset["runPatch"]["runtime"]["n_layers"] = layers

    # 2. Compile with the port's package alone.
    t0 = time.perf_counter()
    op = check_polyaxonfile([os.path.join(repo, PACKED_EXAMPLE)],
                            params={"corpus": corpus},
                            presets=[os.path.join(repo, GPU_PRESET), preset])
    resolved = resolve_operation_context(op, run_uuid="packed",
                                         project_name="chip-smoke")
    plan = compile_operation(resolved, run_uuid="packed",
                             artifacts_root=os.path.join(tmp, "runs"),
                             project="chip-smoke")
    t_compile = time.perf_counter() - t0

    # 3. What compilation produced.
    launcher = [sys.executable, "-m", "polyaxon_tpu_torch.runtime.launch"]
    if plan.num_processes != 1 or len(plan.processes) != 1:
        fail(f"{label}: {plan.num_processes} processes, want 1")
    proc = plan.processes[0]
    if list(proc.command) + list(proc.args) != launcher:
        fail(f"{label}: the process runs {proc.command + proc.args}, not "
             f"the port's launcher {launcher}")
    job = json.loads(proc.env[ENV_JAXJOB_SPEC])
    print(f"{label}: {PACKED_EXAMPLE} + {GPU_PRESET} + H100_PRESET compiled "
          f"in {t_compile * 1e3:.1f} ms: kind {plan.run_kind}, "
          f"{plan.num_processes} process, command {proc.command[1:]}, "
          f"resources {plan.resources.to_dict()}, init "
          f"{[p.kind for p in plan.init]}, sidecars "
          f"{[c.kind for c in plan.sidecars]}; runtime {job['runtime']}; "
          f"mesh {job.get('mesh')}; checkpointing {job['checkpointing']}",
          flush=True)

    # 4. The plan's process, as the executor starts it: its env over this
    # process's, the coordinator placeholder at 127.0.0.1, its working
    # directory (the checkout when it names none, as this script runs
    # from one), output to <artifacts>/logs/main-0.log. Only the main
    # process runs: the plan's init phases (here `auth`) are the agent's
    # (ROADMAP.md, Queue 1 item 4b). ``launch.main()`` runs through
    # DRILL_CHILD, which prints the process's kernel launches.
    env = dict(os.environ)
    env.update(proc.env)
    for key, value in env.items():
        if COORDINATOR_PLACEHOLDER in value:
            env[key] = value.replace(COORDINATOR_PLACEHOLDER, "127.0.0.1")
    art = plan.artifacts_dir
    os.makedirs(os.path.join(art, "logs"), exist_ok=True)
    log = os.path.join(art, "logs", f"main-{proc.index}.log")
    t0 = time.perf_counter()
    with open(log, "ab") as out:
        child = subprocess.Popen([sys.executable, "-c", DRILL_CHILD],
                                 cwd=proc.working_dir or repo, env=env,
                                 stdout=out, stderr=subprocess.STDOUT,
                                 start_new_session=True)
        try:
            rc = child.wait(timeout=900)
        except subprocess.TimeoutExpired:
            fail(f"{label}: the launcher ran over 900 s")
        finally:
            if child.poll() is None:
                os.killpg(child.pid, signal.SIGKILL)
                child.wait()
    wall = time.perf_counter() - t0

    # 5. The result.
    if rc != 0:
        fail(f"{label}: the launcher exited {rc}:\n{_tail(log)}")
    lines = _json_lines(log)
    outputs = next((r["outputs"] for r in lines if "outputs" in r), None)
    launches = next((r["launches"] for r in lines if "launches" in r), None)
    if outputs is None or launches is None:
        fail(f"{label}: no result from the launcher:\n{_tail(log)}")
    statuses = [r["status"] for r in events.read_jsonl(
        os.path.join(art, "statuses.jsonl"))]
    losses = {r["step"]: r["value"] for r in
              events.read_events(art, "metric", "loss")}
    with open(os.path.join(art, "outputs.json")) as fh:
        tracked = json.load(fh)
    if (statuses != ["running", "succeeded"]
            or sorted(losses) != list(range(1, TRAIN_STEPS))
            or not all(math.isfinite(v) for v in losses.values())
            or tracked["steps"] != TRAIN_STEPS):
        fail(f"{label}: tracking record: statuses {statuses}, loss events "
             f"{losses}, outputs steps {tracked.get('steps')}")
    ckdir = os.path.join(art, "checkpoints")
    if TRAIN_STEPS not in _store_steps(ckdir):
        fail(f"{label}: no committed step {TRAIN_STEPS} in {ckdir}: "
             f"{_store_steps(ckdir)}")
    want_bwd = layers * TRAIN_ACCUM * TRAIN_STEPS
    if launches != {"flash_fwd": 2 * want_bwd, "flash_bwd_dkdv": want_bwd,
                    "flash_bwd_dq": want_bwd}:
        fail(f"{label}: the launcher launched {launches}; each backward "
             f"kernel must run {want_bwd} times (layers x microbatches x "
             f"steps), the forward twice as often")
    t0 = time.perf_counter()
    mgr, state, step, want, tier = restore_checked(torch, llama, job, ckdir,
                                                   label)
    t_check = time.perf_counter() - t0
    restore_s = mgr.restore_seconds
    mgr.close()
    del state
    torch.cuda.empty_cache()
    print(f"{label}: exit 0, statuses {statuses}, loss events "
          f"{ {s: round(v, 5) for s, v in sorted(losses.items())} }, "
          f"outputs steps={tracked['steps']}; step {step} restored here "
          f"from tier {tier} (restore_s {restore_s}; with the state's "
          f"init and the CRC check {t_check:.1f}s), {len(want)} leaf "
          f"CRC-32s equal the manifest's; launches {launches}", flush=True)
    # The launcher's own log lines, timestamped: where its start-up goes.
    for line in open(log, errors="replace"):
        if " INFO " in line or " WARNING " in line:
            print(f"  {label} log: {line.rstrip()}", flush=True)

    # 6. The numbers, beside phase 4's on synthetic packed data. MFU over
    # the timed steps, for both: tokens/s x training FLOPs per token over
    # the card's bf16 peak.
    seq = job["runtime"]["seq_len"]
    peak = peak_flops(torch.cuda.get_device_name(0))

    def mfu(result_throughput, n_params):
        return (result_throughput * train_flops_per_token(
            "llama3_1b", seq, n_params) / peak) if peak else float("nan")

    cp = outputs["checkpoint"]
    prep = [line.rsplit(" in ", 1)[-1].strip() for line in
            open(log, errors="replace") if "snapshot buffer ready" in line]
    print(f"{label}: llama3_1b {layers} layers on {ndocs} text documents: "
          f"tokens_per_s={outputs['throughput']:.1f} mfu="
          f"{mfu(outputs['throughput'], outputs['param_count']):.4f} over "
          f"the timed steps (phase 4, synthetic packed rows: "
          f"tokens_per_s={train_result.throughput:.1f} mfu="
          f"{mfu(train_result.throughput, train_result.param_count):.4f}); "
          f"first_step_s={outputs['compile_time_s']:.1f} process wall_s="
          f"{wall:.1f}; checkpoint bytes={cp['bytes']} (predicted "
          f"{ckpt_bytes}); page locking {prep}; save wait_s="
          f"{cp['save_wait_s']} snapshot_s={cp['snapshot_s']} commit_s="
          f"{cp['commit_s']}; final_loss="
          f"{outputs['final_metrics']['loss']:.5f}; phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    if cp["publish_errors"]:
        fail(f"{label}: a checkpoint commit failed")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "polyaxon_tpu_torch")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, repo)
    from polyaxon_tpu_torch.models import llama
    from polyaxon_tpu_torch.ops import _build, flash, paged_attention
    from polyaxon_tpu_torch.serving.server import load_params

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    peaks = card_peaks(name)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"card: {smi} | peaks used: {peaks[2]} "
          f"{peaks[0] / 1e12:.0f} TFLOP/s bf16, {peaks[1] / 1e12:.2f} TB/s",
          flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc "
          f"{nvcc.strip().splitlines()[-1] if nvcc.strip() else '?'}",
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for kernel, log in logs.items():
        for line in log.splitlines():  # per instantiation; spills if any
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill stores" not in line):
                print(f"  ptxas[{kernel}] {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    flash_rec = check_flash(torch, flash, peaks, gen)
    paged_rec = check_paged(torch, paged_attention, peaks, gen)
    check_decode_streams(torch, paged_attention, gen)
    bwd_recs = check_flash_bwd(torch, flash, peaks, gen)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params = load_params("llama3_8b", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"weights: llama3_8b {n_params / 1e9:.2f}B params bf16, "
          f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s, "
          f"attention_impl={cfg.attention_impl} "
          f"paged_attention_impl={cfg.paged_attention_impl}", flush=True)
    counts, first_prompt = run_engine(flash, paged_attention, cfg, params)
    compare_first_admission(torch, llama, cfg, params, first_prompt)
    time_prefill(torch, llama, flash, cfg, params)
    del params
    torch.cuda.empty_cache()

    run_http(flash, paged_attention)

    train_counts, train_losses, train_result = run_training(
        torch, flash, TRAIN_JOB, TRAIN_LAYERS)
    torch.cuda.empty_cache()
    first_step_parity(torch, llama, flash)
    torch.cuda.empty_cache()
    gemma_counts = run_training(torch, flash, GEMMA_JOB, GEMMA_LAYERS)[0]
    torch.cuda.empty_cache()

    drill_counts = checkpoint_drill(torch, flash, paged_attention, llama,
                                    train_losses, train_result)
    torch.cuda.empty_cache()
    plan_counts = compiled_launch(torch, llama, train_result)

    # Each kernel's launches are the sum over the main-path runs that
    # reach it (each printed above): the engine, the two training runs,
    # the resumed launcher of the checkpoint drill, the engine serving
    # its checkpoint and the compiled plan's launcher.
    runs = (counts, train_counts, gemma_counts, *drill_counts, plan_counts)

    def total(name):
        return sum(run.get(name, 0) for run in runs)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:177",
             launches=total("flash_fwd"), **_ordered(flash_rec)),
        dict(name="paged_decode", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="polyaxon_tpu/ops/paged_attention.py:39",
             launches=total("paged_decode"), **_ordered(paged_rec)),
        dict(name="flash_bwd_dkdv", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:417",
             launches=total("flash_bwd_dkdv"),
             **_ordered(bwd_recs["dkdv"])),
        dict(name="flash_bwd_dq", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:484",
             launches=total("flash_bwd_dq"), **_ordered(bwd_recs["dq"])),
    ]
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


def _ordered(rec: dict) -> dict:
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {k: rec[k] for k in keys}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
