"""Native host code of the port: the slice pool (``sliced``), C++ built
with g++ at first use and bound with ctypes."""

from polyaxon_tpu_torch.native.sliced import (
    Event,
    Gang,
    SlicePool,
    SlicedError,
    daemon_path,
    ensure_built,
)

__all__ = ["Event", "Gang", "SlicePool", "SlicedError", "daemon_path",
           "ensure_built"]
