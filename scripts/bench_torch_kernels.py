#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card: the kernel checks
of ``chip_smoke.py`` (build, hold against the plain versions, time
kernel, plain version and library call) without the serving and training
phases.

    python3 scripts/bench_torch_kernels.py [CHECKOUT]

CHECKOUT (default: this repository) is the root of a checkout whose
``chip_smoke.py`` and ``polyaxon_tpu_torch`` are used, so two versions can
be compared in one run on the same card: run it on parent, change,
change, parent. Prints one ``RESULT`` JSON line per kernel.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from polyaxon_tpu_torch.ops import _build, flash, paged_attention

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


if __name__ == "__main__":
    main()
