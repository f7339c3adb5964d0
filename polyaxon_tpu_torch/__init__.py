"""PyTorch/CUDA port of polyaxon_tpu, built for one NVIDIA H100.

The package mirrors the module paths and function names of
``polyaxon_tpu`` so each counterpart is easy to find, but it imports
nothing from it: it depends on ``torch``, numpy and the standard
library only. Every TPU kernel on a ported path is a hand-written
Hopper kernel under ``ops/csrc``.

Entry points run on the card (``cuda``) unless the caller names
``device="cpu"``; with no GPU and no explicit device they raise
(``device.resolve_device``).
"""
