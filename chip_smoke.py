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
   agree bitwise), timed by CUDA-graph replay with a cold L2; the
   flash backward pair at llama3_1b's packed training microbatch (B=4,
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
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    """One training main path; returns its launch counts."""
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
    return counts


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

    train_counts = run_training(torch, flash, TRAIN_JOB, TRAIN_LAYERS)
    torch.cuda.empty_cache()
    first_step_parity(torch, llama, flash)
    torch.cuda.empty_cache()
    gemma_counts = run_training(torch, flash, GEMMA_JOB, GEMMA_LAYERS)
    torch.cuda.empty_cache()

    # flash_fwd runs on every path: its launches are the three main-path
    # runs' sum, the backward kernels' the two training runs' (each
    # printed above).
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:177",
             launches=counts["flash_fwd"] + train_counts["flash_fwd"]
             + gemma_counts["flash_fwd"],
             **_ordered(flash_rec)),
        dict(name="paged_decode", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="polyaxon_tpu/ops/paged_attention.py:39",
             launches=counts["paged_decode"], **_ordered(paged_rec)),
        dict(name="flash_bwd_dkdv", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:417",
             launches=train_counts["flash_bwd_dkdv"]
             + gemma_counts["flash_bwd_dkdv"],
             **_ordered(bwd_recs["dkdv"])),
        dict(name="flash_bwd_dq", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_bwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:484",
             launches=train_counts["flash_bwd_dq"]
             + gemma_counts["flash_bwd_dq"],
             **_ordered(bwd_recs["dq"])),
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
