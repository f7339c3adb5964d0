"""Device resolution for the port's entry points.

The port runs on the card. ``resolve_device(None)`` gives ``cuda`` or
raises; the CPU is used only when a caller names it (the tests do).
There is no quiet fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda`` (raises without a GPU); anything else is
    taken as given, and a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; polyaxon_tpu_torch runs on the "
            "GPU unless the caller passes device='cpu' explicitly")
    return dev
