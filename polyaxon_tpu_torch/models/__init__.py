"""The model zoo, ported from ``polyaxon_tpu.models``: every family of
the JAX registry (llama, moe, vit, bert, resnet, mnist, t5).

``get_model`` maps a runtime spec's model name to its ``ModelDef``, with
config overrides from the job's runtime section, as the JAX registry
does.
"""

from __future__ import annotations

from polyaxon_tpu_torch.models import bert, llama, mnist, moe, resnet, t5, vit
from polyaxon_tpu_torch.models.common import ModelDef

FAMILIES = (llama, moe, vit, bert, resnet, mnist, t5)


def family_of(name: str):
    """The family module whose ``CONFIGS`` holds ``name``."""
    for family in FAMILIES:
        if name in family.CONFIGS:
            return family
    raise ValueError(f"Unknown model `{name}`. Available: "
                     f"{available_models()}")


def get_model(name: str, **overrides) -> ModelDef:
    return family_of(name).model_def(name, **overrides)


def available_models() -> list[str]:
    return sorted(n for family in FAMILIES for n in family.CONFIGS)
