"""Model families ported from ``polyaxon_tpu.models`` (llama so far).

``get_model`` maps a runtime spec's model name to its ``ModelDef``, with
config overrides from the job's runtime section, as the JAX registry
does.
"""

from __future__ import annotations

from polyaxon_tpu_torch.models import llama
from polyaxon_tpu_torch.models.common import ModelDef


def get_model(name: str, **overrides) -> ModelDef:
    if name in llama.CONFIGS:
        return llama.model_def(name, **overrides)
    raise NotImplementedError(
        f"model `{name}` is not a llama config ({sorted(llama.CONFIGS)}); "
        "the other model families are not ported yet: ROADMAP.md, Queue 1 "
        "item 6")

