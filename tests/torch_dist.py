"""Run a function on every rank of a CPU gloo group of spawned processes.

``run(fn, world, *args)`` starts ``world`` fresh interpreters, each of
which starts the port's process group through its bootstrap (gloo, the
coordinator on a free loopback port), calls ``fn(rank, world, *args)``
and hands back what it returned (numpy arrays, floats, lists and dicts
of them). ``fn`` must be a module-level function of a module that does
not import JAX (the workers never load it). One thread per worker: the
gang shares the host's cores.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import traceback

import torch.multiprocessing as mp

from polyaxon_tpu_torch.parallel import bootstrap


def _worker(rank: int, fn, world: int, coordinator: str, outdir: str,
            args: tuple) -> None:
    import torch

    from polyaxon_tpu_torch.parallel import bootstrap

    torch.set_num_threads(1)
    try:
        bootstrap.initialize(bootstrap.ProcessGroup(coordinator, world, rank,
                                                    False), device="cpu")
        out = fn(rank, world, *args)
    except BaseException:
        out = {"__error__": traceback.format_exc()}
    finally:
        bootstrap.shutdown()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def run(fn, world: int, *args) -> list:
    """``fn``'s result on each rank, in rank order (raises with a rank's
    traceback if one failed)."""
    with tempfile.TemporaryDirectory() as outdir:
        mp.start_processes(_worker, nprocs=world, start_method="spawn",
                           args=(fn, world,
                                 f"127.0.0.1:{bootstrap.free_port()}",
                                 outdir, args))
        results = []
        for rank in range(world):
            with open(os.path.join(outdir, f"rank{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    for rank, out in enumerate(results):
        if isinstance(out, dict) and "__error__" in out:
            raise AssertionError(f"rank {rank} failed:\n{out['__error__']}")
    return results
