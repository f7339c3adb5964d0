#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card: the kernel checks
of ``chip_smoke.py`` (build, hold against the plain versions, time
kernel, plain version and library call) without the serving and training
phases, then the flash forward alone at the paths' shapes.

    python3 scripts/bench_torch_kernels.py [CHECKOUT]

CHECKOUT (default: this repository) is the root of a checkout whose
``chip_smoke.py`` and ``polyaxon_tpu_torch`` are used, so two versions can
be compared in one run on the same card: run it on parent, change,
change, parent. Prints one ``RESULT`` JSON line per kernel record, one
per forward shape (``FWD_SHAPES``, timed by this script through the
checkout's ``flash_attention_with_lse``), one per backward shape
(``BWD_SHAPES``, the dK/dV and dQ pair through the checkout's
``flash_bwd_cuda``) and one per decode case (``DECODE_SHAPES``, the cases
of this repository's ``chip_smoke.decode_cases``, timed through the
checkout's ``paged_decode_attention`` by this repository's
``chip_smoke.time_decode``: a CUDA graph of 20 launches rotating through
enough input copies that every launch reads its K/V from HBM, beside 50
eager launches), so every checkout is timed at the same shapes and by
the same clock.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

# (label, B, S, H, KV, D, packed): llama3_8b prefill, the llama3_1b
# training microbatch without and with the training path's packed
# segments (``lm_packed_synthetic``), gemma_2b's; all causal.
FWD_SHAPES = (
    ("llama3_8b S=2048 D=128", 1, 2048, 32, 8, 128, False),
    ("llama3_1b B=4 S=4096 D=64", 4, 4096, 32, 8, 64, False),
    ("llama3_1b B=4 S=4096 D=64 packed", 4, 4096, 32, 8, 64, True),
    ("gemma_2b S=4096 D=256", 1, 4096, 8, 1, 256, False),
)
# The backward pair at one microbatch of each training path, without and
# with its packed segments; all causal, no lse cotangent.
BWD_SHAPES = (
    ("llama3_1b B=4 S=4096 D=64", 4, 4096, 32, 8, 64, False),
    ("llama3_1b B=4 S=4096 D=64 packed", 4, 4096, 32, 8, 64, True),
    ("gemma_2b S=4096 D=256", 1, 4096, 8, 1, 256, False),
    ("gemma_2b S=4096 D=256 packed", 1, 4096, 8, 1, 256, True),
)
# The paged decode cases, by the first letter of their label in
# ``chip_smoke.decode_cases``: a. llama3_8b, 8 ragged rows (the kernels
# line's case); b. 8 long rows; c. gemma_2b's MQA; d. llama3_1b, 64 rows.
DECODE_SHAPES = ("a", "b", "c", "d")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _here_smoke():
    """This repository's ``chip_smoke`` (the decode cases and their
    timer), whatever checkout is measured."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from polyaxon_tpu_torch.ops import _build, flash, paged_attention
    from polyaxon_tpu_torch.runtime.data import lm_packed_synthetic

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    _build.build_all()
    peaks = chip_smoke.card_peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    print(chip_smoke.smi_line(), flush=True)
    records = [
        ("flash_fwd", chip_smoke.check_flash(torch, flash, peaks, gen)),
        ("paged_decode", chip_smoke.check_paged(torch, paged_attention,
                                                peaks, gen))]
    if hasattr(chip_smoke, "check_flash_bwd"):  # checkouts with training
        bwd = chip_smoke.check_flash_bwd(torch, flash, peaks, gen)
        records += [(f"flash_bwd_{k}", rec) for k, rec in bwd.items()]
    for name, rec in records:
        print("RESULT " + json.dumps({"checkout": root, "kernel": name,
                                      **rec}), flush=True)
    def inputs(B, S, H, KV, D, packed):
        q, k, v, do = (torch.randn(B, S, n, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)
                       for n in (H, KV, KV, H))
        seg = torch.from_numpy(next(lm_packed_synthetic(
            B, seq_len=S, vocab_size=128_256, seed=chip_smoke.SEED))[
                "segments"]).cuda() if packed else None
        return q, k, v, do, seg

    for label, B, S, H, KV, D, packed in FWD_SHAPES:
        q, k, v, _, seg = inputs(B, S, H, KV, D, packed)
        ms = chip_smoke.time_ms(lambda: flash.flash_attention_with_lse(
            q, k, v, causal=True, segment_ids=seg), reps=20)
        flops = 4.0 * B * H * S * (S + 1) / 2 * D
        print("RESULT " + json.dumps({
            "checkout": root, "kernel": "flash_fwd", "shape": label,
            "ms": ms, "TFLOPs": flops / ms / 1e9}), flush=True)
        del q, k, v, seg
        torch.cuda.empty_cache()
    for label, B, S, H, KV, D, packed in BWD_SHAPES:
        q, k, v, do, seg = inputs(B, S, H, KV, D, packed)
        kw = dict(causal=True, scale=D ** -0.5)
        o, lse = flash.flash_fwd_cuda(q, k, v, segment_ids=seg, **kw)
        ms = chip_smoke.time_ms(lambda: flash.flash_bwd_cuda(
            q, k, v, seg, o, lse, do, None, **kw), reps=20)
        # The pair's minimum: 5 products of head_dim per causal pair.
        flops = 10.0 * B * H * S * (S + 1) / 2 * D
        print("RESULT " + json.dumps({
            "checkout": root, "kernel": "flash_bwd_pair", "shape": label,
            "ms": ms, "TFLOPs_5_products": flops / ms / 1e9}), flush=True)
        del q, k, v, do, seg, o, lse
        torch.cuda.empty_cache()

    here = _here_smoke()
    for spec in here.decode_cases():
        if spec[0][0] not in DECODE_SHAPES:
            continue
        case = here.decode_case(torch, gen, *spec)
        ms, eager_ms = here.time_decode(torch, paged_attention, case)
        print("RESULT " + json.dumps({
            "checkout": root, "kernel": "paged_decode",
            "shape": case["label"], "graph_ms_cold_l2": ms,
            "eager_ms": eager_ms, "GBps": case["bytes"] / ms / 1e6}),
            flush=True)
        del case
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
