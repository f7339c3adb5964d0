#!/usr/bin/env python3
"""Host-side costs behind the port's checkpoints, on one GPU::

    python3 scripts/bench_torch_checkpoint_io.py [--gib 4]

For a buffer of ``--gib`` GiB, prints (seconds, and GB/s where it
applies):
- device → host copies into pageable memory (``.cpu()``) and into
  page-locked memory, and host → device from it;
- getting page-locked memory: fresh ``np.empty`` pages registered with
  ``cudaHostRegister`` (what the checkpoint's snapshot buffer does),
  against ``cudaHostAlloc`` (PyTorch's ``pin_memory``, which rounds the
  size up to a power of two);
- bf16 matmuls on the card alone and while another thread registers
  four times the buffer (whether registration can hide behind work);
- CRC-32 of the buffer, one thread and eight.

The checkpoints' own commit and restore times, on the real path, are
``chip_smoke.py``'s checkpoint drill.

The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gib", type=float, default=4.0)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    n = int(args.gib * 2**30)
    gb = n / 1e9
    x = torch.randint(0, 255, (n,), dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()

    for _ in range(2):
        dt, _ = timed(lambda: x.cpu())
    print(f"d2h pageable: {dt:.3f}s {gb / dt:.1f} GB/s", flush=True)
    dt, host = timed(lambda: torch.empty(n, dtype=torch.uint8,
                                         pin_memory=True))
    print(f"cudaHostAlloc (pin_memory): {dt:.3f}s {dt / gb:.3f} s/GB",
          flush=True)
    block = host.numpy()
    for _ in range(2):
        dt, _ = timed(lambda: (host.copy_(x, non_blocking=True),
                               torch.cuda.synchronize()))
    print(f"d2h page-locked: {dt:.3f}s {gb / dt:.1f} GB/s", flush=True)
    dt, _ = timed(lambda: (x.copy_(host, non_blocking=True),
                           torch.cuda.synchronize()))
    print(f"h2d page-locked: {dt:.3f}s {gb / dt:.1f} GB/s", flush=True)

    cudart = torch.cuda.cudart()
    fresh = np.empty(n, np.uint8)
    dt, err = timed(lambda: cudart.cudaHostRegister(fresh.ctypes.data, n,
                                                    0))
    print(f"cudaHostRegister of fresh pages: {dt:.3f}s {dt / gb:.3f} s/GB "
          f"(error {int(err)})", flush=True)
    cudart.cudaHostUnregister(fresh.ctypes.data)
    del fresh

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)

    def matmuls():
        for _ in range(200):
            a @ a
        torch.cuda.synchronize()

    alone, _ = timed(matmuls)
    big = np.empty(4 * n, np.uint8)
    reg = threading.Thread(target=lambda: cudart.cudaHostRegister(
        big.ctypes.data, 4 * n, 0))
    t0 = time.perf_counter()
    reg.start()
    matmuls()
    during = time.perf_counter() - t0
    reg.join()
    print(f"200 bf16 8192^2 matmuls: {alone:.3f}s alone, {during:.3f}s "
          f"while another thread registers {4 * gb:.1f} GB (done after "
          f"{time.perf_counter() - t0:.3f}s)", flush=True)
    cudart.cudaHostUnregister(big.ctypes.data)
    del big, a

    dt, _ = timed(lambda: zlib.crc32(memoryview(block)))
    print(f"crc32, one thread: {dt:.3f}s {gb / dt:.2f} GB/s", flush=True)
    parts = np.array_split(block, 8)
    with ThreadPoolExecutor(8) as pool:
        dt, _ = timed(lambda: list(pool.map(zlib.crc32, parts)))
    print(f"crc32, eight threads: {dt:.3f}s {gb / dt:.2f} GB/s", flush=True)


if __name__ == "__main__":
    main()
