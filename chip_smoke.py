#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``polyaxon_tpu_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, each of which must pass:

1. Build every kernel of the serving path from ``ops/csrc`` with nvcc
   (all builds in parallel) and hold each kernel against its plain
   PyTorch version at the path's shapes (llama3_8b prefill attention at
   a ragged length and at 2048; paged decode over 8 rows with ragged
   positions, a hole and an idle row). Times the kernel, its plain
   version and, for flash, ``F.scaled_dot_product_attention`` as a
   yardstick the port never calls.
2. Drive the main path: ``ContinuousBatchingEngine`` over llama3_8b at
   full width and depth (random bf16 weights from a seed), 16 requests
   of mixed lengths, some sharing a prefix. The kernels' launch counts
   are zeroed just before and read just after; both must have moved, and
   the page pool's invariants must hold. The first admission's prefill
   KV and first decode logits are then held against the plain path.
3. ``ServingServer`` answers two concurrent ``POST /v1/generate``.

Prints the card, the toolchain, per-phase lines, then a ``kernels`` JSON
line, the ``nvidia-smi`` name/power line, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line,
without a GPU or outside a checkout.
"""

from __future__ import annotations

import dataclasses
import json
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
    """Kernel vs plain at llama3_8b prefill shapes; returns the record
    for the kernels line (timed at S=2048) and prints each length."""
    import torch.nn.functional as F

    B, H, KV, D = 1, 32, 8, 128
    worst = 0.0
    rec = None
    for S in (1000, 2048):
        q = torch.randn(B, S, H, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        o, lse = flash.flash_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        po, plse = flash.flash_fwd_plain(q, k, v, causal=True,
                                         scale=D ** -0.5)
        torch.cuda.synchronize()
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            fail(f"flash kernel produced non-finite values at S={S}")
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        if not close(o, po) or err_lse > FLASH_LSE_ATOL:
            fail(f"flash kernel disagrees with its plain version at S={S}: "
                 f"o max abs err {err_o} (atol {OUT_ATOL} + rtol "
                 f"{OUT_RTOL}), lse err {err_lse} (tol {FLASH_LSE_ATOL})")
        worst = max(worst, err_o)
        ms = time_ms(lambda: flash.flash_attention_with_lse(
            q, k, v, causal=True), reps=20)
        plain_ms = time_ms(lambda: flash.flash_fwd_plain(
            q, k, v, causal=True, scale=D ** -0.5), reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), reps=20)
        pairs = S * (S + 1) // 2  # visible (row, col) pairs, causal
        flops = 4.0 * B * H * pairs * D
        nbytes = (2.0 * (2 * B * S * H * D + 2 * B * S * KV * D)
                  + 4.0 * B * H * S)  # q, k, v read; o, lse written
        bound_ms = max(flops / peaks[0], nbytes / peaks[1]) * 1e3
        by = "operations" if flops / peaks[0] >= nbytes / peaks[1] else "bytes"
        print(f"flash S={S}: max_abs_err o={err_o:.3e} lse={err_lse:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"sdpa_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
              f"kernel_TFLOPs={flops / ms / 1e9:.1f}", flush=True)
        rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": by, "library_ms": lib_ms}
        del q, k, v, o, lse, po, plse, qt, kt, vt
    rec["max_abs_err"] = worst
    return rec


def check_paged(torch, paged, peaks, gen):
    """Kernel vs plain: 8 rows, page 16, llama3_8b heads, ragged
    positions up to 2047, one hole inside a live row, one idle row."""
    B, H, KV, Hd, page, maxp = 8, 32, 8, 128, 16, 128
    pos = torch.tensor([2047, 1000, 517, 1533, 64, 1999, 1200, -1],
                       dtype=torch.int32)
    P = B * maxp + 1
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        SEED)) + 1
    tables = torch.full((B, maxp), -1, dtype=torch.int32)
    used = 0
    for b in range(B):
        n = int(pos[b]) // page + 1 if pos[b] >= 0 else 0
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    tables[1, 20] = -1  # a hole inside row 1's live range
    # Bytes this run's data needs: each visible K/V token row once (holes
    # and columns past pos excluded), q, tables and pos read, out written.
    live_tokens = 0
    for b in range(B):
        p = int(pos[b])
        for j in range(p // page + 1 if p >= 0 else 0):
            if int(tables[b, j]) >= 0:
                live_tokens += min(page, p - j * page + 1)
    q = torch.randn(B, H, Hd, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(P, page, KV, Hd, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(P, page, KV, Hd, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    tables, pos = tables.cuda(), pos.cuda()
    out = paged.paged_decode_attention(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    ref = paged.paged_decode_plain(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("paged decode kernel produced non-finite values")
    if out[B - 1].abs().max().item() != 0.0:
        fail("paged decode kernel: idle row is not zero")
    err = (out.float() - ref.float()).abs().max().item()
    if not close(out, ref):
        fail(f"paged decode kernel disagrees with its plain version: "
             f"max abs err {err} (atol {OUT_ATOL} + rtol {OUT_RTOL})")
    ms = time_ms(lambda: paged.paged_decode_attention(q, kp, vp, tables,
                                                      pos), reps=50)
    plain_ms = time_ms(lambda: paged.paged_decode_plain(
        q, kp, vp, tables, pos), reps=5, warmup=1)
    nbytes = (2.0 * live_tokens * KV * Hd * 2 + 2.0 * 2 * B * H * Hd
              + 4.0 * B * (maxp + 1))
    flops = 4.0 * live_tokens * (H // KV) * KV * Hd
    bound_ms = max(flops / peaks[0], nbytes / peaks[1]) * 1e3
    by = "operations" if flops / peaks[0] >= nbytes / peaks[1] else "bytes"
    print(f"paged_decode: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({by}) "
          f"live_tokens={live_tokens} "
          f"achieved_GBps={nbytes / ms / 1e6:.1f}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


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
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params = load_params("llama3_8b", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"weights: llama3_8b {n_params / 1e9:.2f}B params bf16, init "
          f"{time.perf_counter() - t0:.1f}s, "
          f"attention_impl={cfg.attention_impl} "
          f"paged_attention_impl={cfg.paged_attention_impl}", flush=True)
    counts, first_prompt = run_engine(flash, paged_attention, cfg, params)
    compare_first_admission(torch, llama, cfg, params, first_prompt)
    del params
    torch.cuda.empty_cache()

    run_http(flash, paged_attention)

    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="polyaxon_tpu/ops/flash.py:177",
             launches=counts["flash_fwd"], **_ordered(flash_rec)),
        dict(name="paged_decode", route="cuda",
             source="polyaxon_tpu_torch/ops/csrc/paged_decode.cu",
             replaces="polyaxon_tpu/ops/paged_attention.py:39",
             launches=counts["paged_decode"], **_ordered(paged_rec)),
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
