"""Sidecar: periodic sync of a run's local dir to the artifacts store.

Parity with the reference's sidecar container (SURVEY.md §2 "Sidecar",
§3.3 [K]): watch the run dir, incrementally upload logs/events/outputs,
final sync on exit. Store IO goes through ``polyaxon_tpu_torch.fs`` (local fs
today, fsspec-compatible providers when available).

Port of ``polyaxon_tpu/sidecar/__init__.py``, the same code under the port's
module names.
"""

from polyaxon_tpu_torch.sidecar.sync import SidecarSync, sync_tree

__all__ = ["SidecarSync", "sync_tree"]
