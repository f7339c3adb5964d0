"""Analytic training FLOPs and the card's peak rate, for the loop's MFU
(port of ``polyaxon_tpu/runtime/flops.py``; the peaks are an H100's and
H200's instead of a TPU's).

The 6N rule (forward 2N + backward 4N matmul FLOPs per token) plus the
causal attention score/value products, as the JAX package counts them.
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak per card, from NVIDIA's data sheets, keyed
# by substrings of ``torch.cuda.get_device_name``; checked in order, so
# the PCIe and NVL parts come before the SXM part they also name.
PEAK_FLOPS = (
    (("H200",), 989e12),
    (("H100", "PCIe"), 756e12),
    (("H100", "NVL"), 835e12),
    (("H100",), 989e12),  # SXM ("NVIDIA H100 80GB HBM3")
)


def peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak, or None for a device without one here
    (the CPU, other cards): MFU is then not reported."""
    for keys, peak in PEAK_FLOPS:
        if all(k in (device_name or "") for k in keys):
            return peak
    return None


def train_flops_per_token(model: str, seq: int,
                          param_count: int) -> Optional[int]:
    """6N over the parameters plus 6 * n_layers * seq * dim for the
    causal attention products; None for a model without a derivation."""
    from polyaxon_tpu_torch.models import llama

    cfg = llama.CONFIGS.get(model)
    if cfg is None:
        return None
    return 6 * param_count + 6 * cfg.n_layers * seq * cfg.dim
