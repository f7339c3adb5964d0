"""Port of ``polyaxon_tpu/connections/__init__.py``, the same code under
the port's module names.
"""

from polyaxon_tpu_torch.connections.catalog import (
    ConnectionCatalog,
    ConnectionResolutionError,
)
from polyaxon_tpu_torch.connections.schemas import (
    V1Connection,
    V1ConnectionKind,
    V1ConnectionResource,
)

__all__ = [
    "ConnectionCatalog",
    "ConnectionResolutionError",
    "V1Connection",
    "V1ConnectionKind",
    "V1ConnectionResource",
]
