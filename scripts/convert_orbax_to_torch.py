"""Convert an Orbax checkpoint written by the JAX package into a step of
the PyTorch port's checkpoint store, for serving on the GPU.

Runs where JAX and orbax are installed (the CPU is enough), never on
the GPU machine. The Orbax directory is opened with the JAX package's
own ``CheckpointManager``; its newest step is restored at the dtypes
and shapes it was saved with, and written under the same step number.
The ``params`` of a train state, or a bare params tree, go through
numpy to ``polyaxon_tpu_torch.models.convert.params_to_store``, which
checks them against ``--model`` and writes one committed step, with
the port's manifest and CRC-32s, under ``--out``. A LoRA fine-tune's state
stays ``{"base", "lora"}`` with its ``_meta`` (alpha and rank), so the
port's ``load_params`` merges it at load as it merges the port's own.
Optimizer state is not converted.

    JAX_PLATFORMS=cpu python scripts/convert_orbax_to_torch.py \\
        --model llama3_8b --orbax runs/x/checkpoints --out ckpt_torch
    python -m polyaxon_tpu_torch.serving --model llama3_8b \\
        --checkpoint ckpt_torch
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def restore_orbax(directory: str) -> tuple[int, Any]:
    """(step, tree) of the newest step of an Orbax checkpoint directory,
    every leaf a numpy array of its saved dtype."""
    import jax
    import orbax.checkpoint as ocp

    from polyaxon_tpu.polyflow.runs import V1JaxCheckpointing
    from polyaxon_tpu.runtime.checkpoint import CheckpointManager

    manager = CheckpointManager(directory, V1JaxCheckpointing(enabled=True))
    try:
        step = manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        with ocp.CheckpointManager(manager.directory) as reader:
            metadata = reader.item_metadata(step)
        like = jax.tree.map(
            lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype), metadata)
        restored = manager.restore(like, step)
    finally:
        manager.close()
    return step, jax.tree.map(np.asarray, restored)


def convert(model: str, orbax_dir: str, out_dir: str) -> tuple[int, str]:
    """Restore the newest step of ``orbax_dir`` and write its params to
    the port's store under the same step; returns (that step, the
    written step's directory)."""
    from polyaxon_tpu_torch.models.convert import params_to_store

    step, restored = restore_orbax(orbax_dir)
    params = restored.get("params", restored)
    return step, params_to_store(params, model, out_dir, step)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", required=True,
                        help="the model the params belong to")
    parser.add_argument("--orbax", required=True,
                        help="Orbax checkpoint directory (the JAX package's)")
    parser.add_argument("--out", required=True,
                        help="the port's checkpoint directory to write")
    args = parser.parse_args(argv)
    try:
        step, written = convert(args.model, args.orbax, args.out)
    except (FileNotFoundError, FileExistsError, ValueError) as exc:
        print(f"convert failed: {exc}", file=sys.stderr)
        return 1
    print(f"converted {args.model} step {step} from {args.orbax} -> "
          f"{written}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
