"""Port of ``polyaxon_tpu/schemas/__init__.py``, the same code under the
port's module names.
"""

from polyaxon_tpu_torch.schemas.base import BaseSchema, to_camel  # noqa: F401
