"""``plx-torch`` — the port's CLI (port of ``polyaxon_tpu/cli``).

The reference's command surface (run / ops / projects / queue / quota /
config / check / admin / server / agent / serve / convert / models /
version) against the port's embedded control plane. State lives under
``$POLYAXON_TPU_HOME`` (default ``~/.polyaxon_tpu``).

Usage: ``python -m polyaxon_tpu_torch.cli <command> ...``
"""

from polyaxon_tpu_torch.cli.main import cli

__all__ = ["cli"]
